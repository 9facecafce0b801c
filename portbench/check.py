"""Whether what the window served is correct, by the plain reference.

Once the window has closed, rounds are drawn from the seed among those it
completed: one of the longest prompt length and one of another length. Of
each, ``check_requests`` requests (the configuration's number; all of the
round where the family's reference has to see the whole round, as the MoE
capacity does) are run through the family's float32 reference, over their
prompts and their served tokens. At every served position the reference's
best logit and the served token's logit are compared: ``widest_gap`` is the
largest amount by which a served token lies below the reference's best,
over all of them. Greedy decoding in exact arithmetic gives 0; the limit
(``checks/<cell>.json``) was set between what sound runs of the program
and the reference in a lower precision read.

With ``control`` the same verdict, under the same limits, is also given on
the control: the reference in that precision put in the program's place,
its first token read at each of the same positions. It has to come out
not correct.
"""

from __future__ import annotations

import numpy as np
import torch

from . import spec, traffic

SEED_MOD = 2 ** 63


def sample(rounds: list, mix: dict, seed: int, requests: int) -> list:
    """(round, request indices) pairs drawn from ``seed``: a round of the
    longest prompt length and one of another length, when the window
    completed such rounds, each with ``requests`` of its requests, drawn
    from all of them."""
    rng = np.random.default_rng([int(seed) % SEED_MOD, 2 ** 61])
    longest = max(r["length"] for r in rounds)
    picks = []
    for pool in ([r for r in rounds if r["length"] == longest],
                 [r for r in rounds if r["length"] != longest]):
        if pool:
            r = pool[int(rng.integers(len(pool)))]
            idx = np.sort(rng.choice(r["batch"], min(requests, r["batch"]),
                                     replace=False))
            picks.append((r, idx))
    return picks


def gaps(ref_logits: torch.Tensor, served: torch.Tensor) -> torch.Tensor:
    """By how much each served token's logit lies below the best one:
    ``ref_logits`` (..., V) float32, ``served`` (...) token ids."""
    best = ref_logits.max(dim=-1).values
    got = torch.gather(ref_logits, -1, served[..., None].long())[..., 0]
    return best - got


def gaps_of(config: dict, mix: dict, params, rounds: list, seed: int,
            device, control: str = None) -> list:
    """For each sampled round: its length and index, the served tokens'
    gaps (requests, output tokens) against the float32 reference, whether
    every served token was a token id and every logit finite, and with
    ``control`` (a precision, ``"fp8"``) the gaps of the tokens that the
    reference in that precision, put in the program's place, puts first
    at the same positions."""
    ref = spec.reference(config["family"])
    vocab = config["model"]["vocab"]
    out = []
    for r, idx in sample(rounds, mix, seed, config["check_requests"]):
        prompt = torch.from_numpy(
            traffic.prompts(mix, seed, r["index"], vocab)[idx]).to(device)
        served = torch.from_numpy(r["served"][idx]).to(device)
        in_range = bool(((served >= 0) & (served < vocab)).all())
        served = served.clamp(0, vocab - 1)
        fed = served[:, :-1]
        logits = ref.served_logits(config, params, prompt, fed)
        row = dict(length=r["length"], index=r["index"], in_range=in_range,
                   finite=bool(torch.isfinite(logits).all()),
                   gaps=gaps(logits, served).cpu())
        if control:
            own = ref.served_logits(config, params, prompt, fed,
                                    precision=control).argmax(-1)
            row["control_gaps"] = gaps(logits, own).cpu()
        out.append(row)
        del logits
    return out


#: the numbers a cell's limits may name: each from the gaps of every served
#: position of the sample, and whether it must stay at or below its limit
#: or reach it
NUMBERS = {
    "widest_gap": (lambda g: float(g.max()), "at most"),
    "mean_gap": (lambda g: float(g.mean()), "at most"),
    "served_positions": (lambda g: g.numel(), "at least"),
}


def verdict(rows: list, limits: dict, key: str = "gaps") -> dict:
    """``correct`` and ``numbers`` (each number ``limits`` names, with its
    limit) of the gaps ``rows[...][key]``: every served token a token id,
    every logit of the reference finite, every number within its limit.
    ``read`` holds every number of ``NUMBERS``, named in the limits or
    not."""
    g = torch.cat([r[key].reshape(-1) for r in rows])
    correct = all(r["finite"] and r["in_range"] for r in rows)
    numbers = {}
    for name, lim in limits.items():
        read, rule = NUMBERS[name]
        value = read(g)
        numbers[name] = {"value": value, "limit": lim["limit"]}
        correct &= (value <= lim["limit"] if rule == "at most"
                    else value >= lim["limit"])
    read = {name: f(g) for name, (f, _) in NUMBERS.items()}
    return dict(correct=bool(correct), numbers=numbers, read=read)


def run(config: dict, mix: dict, limits: dict, params, rounds: list,
        seed: int, device, control: str = None) -> dict:
    """The comparison: the program's ``verdict``; with ``control`` (a
    precision) also ``control``, the control's verdict under the same
    ``limits``."""
    rows = gaps_of(config, mix, params, rounds, seed, device, control)
    out = verdict(rows, limits)
    if control:
        out["control"] = verdict(rows, limits, key="control_gaps")
    return out
