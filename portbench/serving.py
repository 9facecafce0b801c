"""Rounds of a closed loop through the port's serving steps.

A round is one request from each client, all with prompts of one length:
one ``make_prefill_step`` call at the mix's ``max_len`` gives each request
its first token (greedy), then ``output_tokens - 1`` greedy
``make_decode_step`` calls through the cache give the rest. A request is
sent when its round's tokens start for the card; its time to first token
ends when the first token is on the host, after a synchronize; it
completes when its last token is on the host.

Each round records host-clock spans (``inputs``, ``prefill``, ``sample``,
``decode``), each ending in a synchronize; under the profiler the same
spans are ``record_function`` ranges named ``<span>:<prompt length>``.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from . import traffic

now = time.perf_counter


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _no_mark(name):
    return contextlib.nullcontext()


def greedy(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits, dim=-1).to(torch.int32)


def serve_round(steps, params, tokens_host: np.ndarray, n_out: int, device,
                mark=_no_mark) -> dict:
    """One round: (prefill_step, decode_step) ``steps`` on ``tokens_host``
    (clients, length). Returns its times and the served tokens
    (clients, n_out)."""
    prefill, decode = steps
    s = tokens_host.shape[1]
    with mark(f"inputs:{s}"):
        t_send = now()
        tokens = torch.from_numpy(tokens_host).to(device)
        sync(device)
    with mark(f"prefill:{s}"):
        t0 = now()
        logits, cache = prefill(params, {"tokens": tokens})
        sync(device)
        t1 = now()
    with mark(f"sample:{s}"):
        tok = greedy(logits)
        first_host = tok.cpu()
        t_first = now()
    with mark(f"decode:{s}"):
        t2 = now()
        outs = [tok]
        for j in range(n_out - 1):
            logits, cache = decode(params, cache, tok, s + j)
            tok = greedy(logits)
            outs.append(tok)
        served = torch.stack(outs, dim=1).cpu().numpy()
        t_done = now()
    del cache, logits
    if not np.array_equal(served[:, 0], first_host.numpy()):
        raise RuntimeError("the first token changed on its way to the host")
    return dict(length=s, batch=tokens_host.shape[0], t_send=t_send,
                t_first=t_first, t_done=t_done, prefill_s=t1 - t0,
                decode_s=t_done - t2, decode_steps=n_out - 1,
                served=served)


def run_rounds(steps, params, mix, seed, vocab, device, first: int,
               count: int = None, seconds: float = None, mark=_no_mark):
    """Rounds ``first``, ``first + 1``, ...: ``count`` of them, or whole
    cycles of the mix until ``seconds`` have passed since the first was
    sent. Returns the rounds, each with its index."""
    rounds, i, t0 = [], first, now()
    n_cycle = traffic.cycle(mix)
    while True:
        r = serve_round(steps, params,
                        traffic.prompts(mix, seed, i, vocab),
                        mix["output_tokens"], device, mark)
        r["index"] = i
        rounds.append(r)
        i += 1
        if count is not None and len(rounds) >= count:
            return rounds
        if count is None and (i - first) % n_cycle == 0 \
                and now() - t0 >= seconds:
            return rounds


def warm_up(steps, params, mix, seed, vocab, device) -> None:
    """The cell's own shapes, once: a prefill at the mix's longest prompt
    and one decode step from its cache."""
    prefill, decode = steps
    tokens = traffic.warmup_prompts(mix, seed, vocab)
    logits, cache = prefill(params, {"tokens": torch.from_numpy(tokens)
                                     .to(device)})
    decode(params, cache, greedy(logits), tokens.shape[1])
    sync(device)
