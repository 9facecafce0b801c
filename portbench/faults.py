"""Faults planted under the timed path, to show that the check fails them.
Each takes the port's (prefill, decode) steps and returns broken ones, as
``bench.run_cell``'s ``wrap`` hook takes them. ``calibrate.py --fault``
reads them on the card at a cell's own size; the CPU tests at a small one.
The benchmark's own runs never plant one.

- ``state_unchanged``: each decode step returns the cache as it was given
  (it runs on a copy), so no decoded token enters the state;
- ``half_the_batch``: the prefill runs the first half of the requests
  alone and the other half gets copies of their logits and cache;
- ``token_altered``: at the second decode step of each round every
  request's produced token is another (its logits rolled by one): one
  token of each reply altered where it is produced.
"""

from __future__ import annotations

import torch

#: the decode step (0-based, in each round) at which ``token_altered``
#: alters every request's token
ALTERED_STEP = 1


def _copy(tree):
    if isinstance(tree, dict):
        return {k: _copy(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_copy(v) for v in tree)
    return tree.clone()


def _twice(tree):
    """Every leaf twice along the batch axis (axis 1 of the stacked
    caches, axis 0 of the logits)."""
    if isinstance(tree, dict):
        return {k: _twice(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_twice(v) for v in tree)
    return torch.cat([tree, tree], dim=1 if tree.dim() > 2 else 0)


def state_unchanged(steps):
    prefill, decode = steps

    def step(params, cache, tok, cur):
        logits, _ = decode(params, _copy(cache), tok, cur)
        return logits, cache
    return prefill, step


def half_the_batch(steps):
    prefill, decode = steps

    def step(params, batch):
        t = batch["tokens"]
        logits, cache = prefill(params, {"tokens": t[:t.shape[0] // 2]})
        return torch.cat([logits, logits]), _twice(cache)
    return step, decode


def token_altered(steps):
    prefill, decode = steps
    state = {"step": 0}

    def first(params, batch):
        state["step"] = 0
        return prefill(params, batch)

    def step(params, cache, tok, cur):
        logits, cache = decode(params, cache, tok, cur)
        if state["step"] == ALTERED_STEP:
            logits = logits.roll(1, dims=-1)
        state["step"] += 1
        return logits, cache
    return first, step


FAULTS = {f.__name__: f for f in (state_unchanged, half_the_batch,
                                  token_altered)}
