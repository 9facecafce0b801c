"""Gradient compression for the data-parallel all-reduce (the counterpart
of ``repro/distributed/compression.py``).

Int8 symmetric quantization with error feedback: the quantization residual
is carried into the next step, so the compressed trajectory converges to
the uncompressed one (Karimireddy et al. 2019). The pure functions are the
reference's, operation by operation (``torch.round`` rounds half to even,
as ``jnp.round`` does). The reference's ``shard_map`` body
``compressed_psum`` becomes :func:`compressed_all_reduce` over a
``torch.distributed`` process group.
"""

from __future__ import annotations

from typing import Any, Tuple

import torch
import torch.distributed as dist

from ..tree import tree_leaves, tree_map, tree_unflatten


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8: returns (q, scale)."""
    xf = x.float()
    scale = torch.clamp(torch.max(torch.abs(xf)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def ef_compress(g: torch.Tensor, ef: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Error-feedback step: compress (g + ef); the residual is the new
    ef."""
    target = g.float() + ef
    q, scale = quantize_int8(target)
    approx = dequantize_int8(q, scale)
    return q, scale, target - approx


def ef_init(tree: Any) -> Any:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), tree)


def compressed_grad_tree(grads: Any, ef_state: Any) -> Tuple[Any, Any]:
    """Whole-tree error-feedback compression (the local part; the
    all-reduce happens wherever the caller places it)."""
    out_g, out_e = [], []
    for g, e in zip(tree_leaves(grads), tree_leaves(ef_state)):
        q, scale, new_e = ef_compress(g, e)
        out_g.append(dequantize_int8(q, scale).to(g.dtype))
        out_e.append(new_e)
    return tree_unflatten(grads, out_g), tree_unflatten(grads, out_e)


def compressed_all_reduce(g: torch.Tensor, ef: torch.Tensor, group=None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Int8-quantized all-reduce of one gradient over ``group`` (default:
    the whole world): the mean gradient in ``g``'s dtype and this rank's
    new error feedback. Three all-reduces: the int32 sum of the int8
    payloads (it cannot overflow, <= 127 * ranks), the sum of the scales
    and the rank count; then the reference's ``qsum * (ssum / k) / k``."""
    q, scale, new_ef = ef_compress(g, ef)
    qsum = q.to(torch.int32)
    dist.all_reduce(qsum, group=group)
    ssum = scale.clone()
    dist.all_reduce(ssum, group=group)       # conservative shared scale
    k = torch.ones((), dtype=torch.float32, device=g.device)
    dist.all_reduce(k, group=group)
    mean = qsum.float() * (ssum / k) / k
    return mean.to(g.dtype), new_ef
