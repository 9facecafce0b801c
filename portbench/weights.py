"""The weights of a cell, drawn from its seed on the device.

The tree's layout (keys, shapes, dtypes) is the program's, read from the
meta-device tree that ``repro_torch.launch.steps.params_struct`` returns;
the numbers are the benchmark's own. Every leaf of one dtype is a view into
one flat buffer, filled by one normal draw on the device and then scaled or
set by the configuration's ``init`` rules, keyed by the leaf's name:

- ``["fan_in", g]``: the draw times g / sqrt(fan-in), the fan-in being the
  leaf's second-to-last axis (the default for every matrix);
- ``["normal", std]``: the draw times ``std``;
- ``["const", c]``: every element ``c``.

The program and the reference are handed the same tree.
"""

from __future__ import annotations

import math

import torch

SEED_MOD = 2 ** 63


def leaves(tree, path=()):
    """(path, leaf) pairs of a nested dict of tensors, in key order."""
    if isinstance(tree, dict):
        for k in tree:
            yield from leaves(tree[k], path + (k,))
    else:
        yield path, tree


def rebuild(tree, fn, path=()):
    """The tree with every leaf replaced by ``fn(path, leaf)``."""
    if isinstance(tree, dict):
        return {k: rebuild(v, fn, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed) % SEED_MOD)


def _rule(init: dict, path, shape):
    rule = init["leaves"].get(path[-1])
    if rule is not None:
        return rule
    if len(shape) < 2:
        raise ValueError(f"no init rule for the vector {'.'.join(path)}")
    return init["default"]


def draw(meta_tree, init: dict, seed: int, device):
    """A tree shaped as ``meta_tree``, each leaf on ``device`` in its dtype,
    drawn from ``seed`` by the ``init`` rules."""
    specs = list(leaves(meta_tree))
    by_dtype: dict = {}
    for _, t in specs:
        by_dtype[t.dtype] = by_dtype.get(t.dtype, 0) + t.numel()
    gen = generator(seed, device)
    flat, at = {}, {}
    for dtype, n in by_dtype.items():
        flat[dtype] = torch.empty(n, dtype=dtype, device=device)
        flat[dtype].normal_(generator=gen)
        at[dtype] = 0

    def make(path, meta):
        start = at[meta.dtype]
        at[meta.dtype] = start + meta.numel()
        leaf = flat[meta.dtype][start:at[meta.dtype]].view(meta.shape)
        kind, value = _rule(init, path, meta.shape)
        if kind == "const":
            leaf.fill_(value)
        elif kind == "normal":
            leaf.mul_(value)
        elif kind == "fan_in":
            leaf.mul_(value / math.sqrt(meta.shape[-2]))
        else:
            raise ValueError(f"unknown init rule {kind!r} for "
                             f"{'.'.join(path)}")
        return leaf

    return rebuild(meta_tree, make)
