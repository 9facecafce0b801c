"""AdamW over trees of tensors, with decoupled weight decay, global-norm
clipping and a cosine schedule (the counterpart of
``repro/optim/adamw.py``).

Params may be bf16; the moments and the update are float32, as in JAX
(mixed-precision AdamW without a float32 master copy). Every function runs
under ``torch.no_grad()``. The arithmetic is JAX's, operation by
operation: the bias corrections ``1 - b ** step`` are float32 powers of a
float32 base, and the weight decay applies to every leaf with
``ndim >= 2``, which in the stacked layer tree includes the stacked biases
and norm scales of shape (L, n), as it does in JAX.
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple, Tuple

import torch

from ..tree import tree_leaves, tree_map, tree_unflatten


class AdamWState(NamedTuple):
    step: torch.Tensor          # 0-d int32
    mu: Any                     # float32 tree of the params' structure
    nu: Any                     # float32 tree of the params' structure


@torch.no_grad()
def adamw_init(params) -> AdamWState:
    """Zero moments (float32, on each leaf's device) and step 0."""
    leaves = tree_leaves(params)
    dev = leaves[0].device if leaves else torch.device("cpu")

    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      mu=tree_map(zeros, params), nu=tree_map(zeros, params))


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled so that their global float32 norm is at most
    ``max_norm``, each in its own dtype; the norm before clipping)."""
    leaves = tree_leaves(grads)
    sq = sum(torch.sum(torch.square(g.float())) for g in leaves)
    norm = torch.sqrt(torch.as_tensor(sq, dtype=torch.float32))
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), norm


def cosine_schedule(base_lr: float, warmup: int, total: int):
    """step (int tensor) -> learning rate (float32 tensor): linear warmup
    over ``warmup`` steps, then a cosine from ``base_lr`` to 0 at
    ``total``."""
    def lr(step):
        step = torch.as_tensor(step).float()
        warm = base_lr * step / max(warmup, 1)
        frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = 0.5 * base_lr * (1.0 + torch.cos(math.pi * frac))
        return torch.where(step < warmup, warm, cos)
    return lr


@torch.no_grad()
def adamw_update(params, grads, state: AdamWState, *, lr=1e-4,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1, schedule=None
                 ) -> Tuple[Any, AdamWState]:
    """One AdamW step. Returns (params, state).

    In place: each param, ``mu`` and ``nu`` leaf is overwritten with its
    new value, and the returned trees hold those same tensors (a full-size
    step cannot afford a second copy of the model). ``state.step`` is
    replaced by a new tensor. ``grads`` is read only."""
    step = state.step + 1
    lr_t = schedule(step) if schedule is not None else lr
    stepf = step.float()
    b1c = 1.0 - torch.tensor(b1, dtype=torch.float32,
                             device=stepf.device) ** stepf
    b2c = 1.0 - torch.tensor(b2, dtype=torch.float32,
                             device=stepf.device) ** stepf
    flat_p = tree_leaves(params)
    flat_g, flat_m, flat_v = (tree_leaves(t)
                              for t in (grads, state.mu, state.nu))
    if not len(flat_p) == len(flat_g) == len(flat_m) == len(flat_v):
        raise ValueError("params, grads and moments differ in structure")
    for p, g, m, v in zip(flat_p, flat_g, flat_m, flat_v):
        gf = g.float()
        m.mul_(b1).add_((1 - b1) * gf)
        v.mul_(b2).add_((1 - b2) * torch.square(gf))
        delta = (m / b1c) / (torch.sqrt(v / b2c) + eps)
        # decoupled weight decay on matrices only (ndim >= 2)
        if p.ndim >= 2:
            delta = delta + weight_decay * p.float()
        p.copy_(p.float() - lr_t * delta)
    return (tree_unflatten(params, flat_p),
            AdamWState(step=step, mu=state.mu, nu=state.nu))
