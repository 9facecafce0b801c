"""Mixture-of-Experts FFN with capacity-bounded top-k routing: the
counterpart of ``repro/models/moe.py``.

Two dispatch implementations, as in JAX:

* ``gather`` (default): an (E, C) token-index table built from the routing,
  tokens gathered into expert-major layout, the batched expert FFN, and the
  outputs combined back per token. Memory is O(E*C*d).
* ``einsum`` (reference): the GShard one-hot formulation, O(T*E*C) memory,
  a small-shape oracle for ``gather``.

The routing (top-k, the capacity, each (token, choice)'s position in its
expert's buffer) is integer and exact: it equals JAX's for equal router
logits. The flat (T*K, E) rows are token-major, so earlier tokens win
capacity. ``cfg.router_blocked_cumsum`` picks the blocked or the flat
exclusive cumsum (the same integers either way).

JAX combines the expert outputs with a scatter-add, which XLA on the CPU
applies in the order of the flattened (E, C) table: each token's choices in
the order of their expert ids. On the card a scatter-add (``index_add_``)
adds through atomics, in an order that changes from run to run, and a
bfloat16 sum depends on its order. The port gathers each token's K slot
outputs instead and adds them in the order of their expert ids, a fixed
order, and the one XLA's scatter takes.

``cfg.moe_shard_hints`` only places tensors on a device mesh in JAX
(``_ep_hint``). On one device it has no counterpart: the field is
accepted and ignored.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .. import obs
from .common import act_fn


def _one_hot(x: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """``jax.nn.one_hot``: ids outside [0, n) give a row of zeros."""
    return (x[..., None] == torch.arange(n, device=x.device)).to(dtype)


def router_topk(logits: torch.Tensor, k: int, renormalize: bool = True
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """logits (T, E) -> (weights (T, K) float32, idx (T, K))."""
    probs = torch.softmax(logits.float(), dim=-1)
    w, idx = torch.topk(probs, k, dim=-1)
    if renormalize:
        w = w / torch.clamp(torch.sum(w, dim=-1, keepdim=True), min=1e-9)
    return w, idx


def load_balance_loss(logits: torch.Tensor, idx: torch.Tensor,
                      n_experts: int) -> torch.Tensor:
    """Switch-style aux loss: E * sum_e f_e * p_e."""
    probs = torch.softmax(logits.float(), dim=-1)
    me = torch.mean(probs, dim=0)                          # (E,)
    fe = torch.mean(_one_hot(idx[:, 0], n_experts, torch.float32), dim=0)
    return n_experts * torch.sum(fe * me)


def _exclusive_cumsum_rows(cfg, flat: torch.Tensor) -> torch.Tensor:
    """Exclusive cumsum over axis 0 of an integer (N, E): flat, or the
    two-level (blocked) form when ``cfg.router_blocked_cumsum``."""
    if not cfg.router_blocked_cumsum:
        return torch.cumsum(flat, dim=0, dtype=flat.dtype) - flat
    n, e = flat.shape
    blk = min(2048, n)
    while n % blk:
        blk -= 1
    nb = n // blk
    xb = flat.reshape(nb, blk, e)
    within = torch.cumsum(xb, dim=1, dtype=flat.dtype)     # (nb, blk, E)
    totals = within[:, -1]                                 # (nb, E)
    offsets = torch.cumsum(totals, dim=0, dtype=flat.dtype) - totals
    return (within - xb + offsets[:, None]).reshape(n, e)


def _route(cfg, xt, router):
    """Shared routing prologue: (weights, idx, pos, keep, capacity, aux)."""
    with obs.span("moe.route"):
        t = xt.shape[0]
        e, k = cfg.n_experts, cfg.top_k
        logits = torch.einsum("td,de->te", xt.float(), router.float())
        weights, idx = router_topk(logits, k)
        aux = load_balance_loss(logits, idx, e)
        capacity = int(max(k * t // e * cfg.capacity_factor, 4))
        capacity = min(capacity, t)
        # position of each (token, choice) within its expert's buffer
        flat = _one_hot(idx, e, torch.int32).reshape(t * k, e)
        pos = _exclusive_cumsum_rows(cfg, flat)                 # (T*K, E)
        pos = torch.sum(pos * flat, dim=-1).reshape(t, k)       # (T, K)
        keep = pos < capacity
        weights = weights * keep.to(weights.dtype)
        return weights, idx, pos, keep, capacity, aux


def _expert_ffn(cfg, p, xe):
    """xe: (E, C, d) -> (E, C, d)."""
    act = act_fn(cfg.act)
    with obs.span("moe.experts"):
        h = act(torch.einsum("ecd,edf->ecf", xe, p["wg"])) \
            * torch.einsum("ecd,edf->ecf", xe, p["wu"])
        return torch.einsum("ecf,efd->ecd", h, p["wd"])


def _shared_ffn(cfg, p, xt):
    act = act_fn(cfg.act)
    hs = act(torch.einsum("td,df->tf", xt, p["sg"])) \
        * torch.einsum("td,df->tf", xt, p["su"])
    return torch.einsum("tf,fd->td", hs, p["sd"])


def _combine(ye, slot, idx):
    """ye: (E*C + 1, d) weighted slot outputs, the last row a zero trash
    row; slot, idx: (T, K) each (token, choice)'s flat slot (the trash row
    if dropped) and expert. Returns (T, d): each token's K slot outputs
    added one at a time in the order of their expert ids, in ye's dtype."""
    parts = ye[torch.gather(slot, 1, torch.argsort(idx, dim=1))]
    y = parts[:, 0]
    for j in range(1, parts.shape[1]):
        y = y + parts[:, j]
    return y


def moe_ffn_gather(cfg, p, x: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> (y (B, S, d) in x's dtype, aux float32)."""
    b, s, d = x.shape
    t = b * s
    e, k = cfg.n_experts, cfg.top_k
    xt = x.reshape(t, d)
    weights, idx, pos, keep, capacity, aux = _route(cfg, xt, p["router"])

    with obs.span("moe.dispatch"):
        kept = keep.to(weights.dtype)
        obs.count("moe.choices", t * k)
        obs.count("moe.kept", kept)
        obs.count("moe.slots", e * capacity)
        # slot of each (token, choice) in the flat (E*C) table; dropped
        # ones go to a trash slot E*C, cut off afterwards
        trash = e * capacity
        slot = torch.where(keep, idx * capacity + pos, trash)   # (T, K)
        flat_slot = slot.reshape(-1)
        tok = torch.arange(t, device=x.device).repeat_interleave(k)
        table = torch.zeros(trash + 1, dtype=torch.long, device=x.device)
        table[flat_slot] = tok
        filled = torch.zeros(trash + 1, dtype=torch.bool, device=x.device)
        filled[flat_slot] = True
        # out of place: the router weights' gradient flows through wtab
        wtab = torch.zeros(trash + 1, dtype=weights.dtype,
                           device=x.device).index_put(
            (flat_slot,), (weights * kept).reshape(-1))
        xe = xt[table[:trash]] * filled[:trash, None].to(xt.dtype)

    ye = _expert_ffn(cfg, p, xe.reshape(e, capacity, d))
    with obs.span("moe.combine"):
        ye = ye * wtab[:trash].reshape(e, capacity, 1).to(ye.dtype)
        y = _combine(torch.cat([ye.reshape(trash, d),
                                ye.new_zeros((1, d))]), slot, idx)

    if "sg" in p:
        y = y + _shared_ffn(cfg, p, xt)
    return y.reshape(b, s, d).to(x.dtype), aux


def moe_ffn_einsum(cfg, p, x: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Reference GShard one-hot formulation (small shapes only)."""
    b, s, d = x.shape
    t = b * s
    e = cfg.n_experts
    xt = x.reshape(t, d)
    dt = xt.dtype
    weights, idx, pos, keep, capacity, aux = _route(cfg, xt, p["router"])

    disp = (_one_hot(idx, e, dt)[..., None]
            * _one_hot(pos, capacity, dt)[..., None, :]
            * keep[..., None, None].to(dt))
    disp_tec = torch.sum(disp, dim=1)                       # (T, E, C)
    comb_tec = torch.sum(disp * weights[..., None, None].to(dt), dim=1)

    xe = torch.einsum("tec,td->ecd", disp_tec, xt)          # (E, C, d)
    ye = _expert_ffn(cfg, p, xe)
    y = torch.einsum("tec,ecd->td", comb_tec, ye)

    if "sg" in p:
        y = y + _shared_ffn(cfg, p, xt)
    return y.reshape(b, s, d).to(x.dtype), aux


def moe_ffn(cfg, p, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    if getattr(cfg, "moe_impl", "gather") == "einsum":
        return moe_ffn_einsum(cfg, p, x)
    return moe_ffn_gather(cfg, p, x)
