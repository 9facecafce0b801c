"""Step functions, train / prefill / decode, and the input specs of every
(architecture x shape) cell (the counterpart of ``repro/launch/steps.py``).
PyTorch runs eagerly, so a step is the plain callable JAX would ``jit``;
the input specs are meta-device tensors where JAX has
``ShapeDtypeStruct``s: shapes and dtypes, no memory."""

from __future__ import annotations

from typing import Any, Dict

import torch
import torch.distributed as dist

from ..models import init_decode_cache, init_params, prefill, train_loss, \
    trainable
from ..models.config import SHAPES_BY_NAME, ShapeSpec
from ..models.model import decode_step as _decode_step
from ..optim import adamw_init, adamw_update, clip_by_global_norm
from ..distributed.shardings import dp_axes
from ..tree import tree_leaves, tree_unflatten
from .mesh import current_mesh

ENC_LEN_FOR_DECODE = 4096        # encdec decode cells: stub memory length


def _data_mean(loss, grads, group):
    """The mean of ``loss`` and of each gradient over the ranks of
    ``group``, summed in float32 in one all-reduce of a flat buffer; each
    gradient keeps its dtype."""
    n = dist.get_world_size(group)
    flat = torch.cat([loss.reshape(1).float()]
                     + [g.reshape(-1).float() for g in grads])
    dist.all_reduce(flat, group=group)
    flat /= n
    out, at = [], 1
    for g in grads:
        out.append(flat[at:at + g.numel()].view(g.shape).to(g.dtype))
        at += g.numel()
    return flat[0].clone(), out


def dp_group(mesh):
    """The process group of the ranks that share this rank's coordinates on
    every mesh dimension outside ``dp_axes(mesh)``: the batch's shards, over
    which a step averages. On ("data", "model") the "data" group; on
    ("pod", "data", "model") the pod x data group (32 ranks on the
    production mesh), made once by flattening the two dimensions. None on
    a mesh with no data-parallel dimension (the batch is not split)."""
    dp = dp_axes(mesh)
    if not dp:
        return None
    if len(dp) == 1:
        return mesh.get_group(dp[0])
    return mesh[dp]._flatten().get_group()


def make_train_step(cfg, lr: float = 3e-4, mesh=None):
    """(params, opt_state, batch) -> (loss, params, opt_state).

    ``torch.autograd.grad`` of ``train_loss`` over every leaf of
    ``params`` (marked with ``trainable``). With ``cfg.grad_accum > 1``
    the batch is split into that many microbatches along axis 0, taken in
    order: their float32 gradients are summed and divided by the count,
    and the loss is the mean of theirs, in the reference's order of
    operations. Data parallel: with a ``mesh`` (by default the one of an
    enclosing ``launch.mesh.set_mesh`` block, if any), ``batch`` is this
    rank's block of the global batch, and the loss and the gradients are
    averaged over the mesh's data-parallel group (:func:`dp_group`), as
    JAX's step on a batch sharded over ``dp_axes(mesh)`` under its ambient
    mesh computes them (a group of one rank has nothing to average; on a
    rank outside the mesh the step raises ``RuntimeError``). Then
    ``clip_by_global_norm(grads, 1.0)`` and ``adamw_update``, which
    updates ``params`` and ``opt_state`` in place (see
    ``optim/adamw.py``). The loss comes back as a 0-d float32
    tensor."""
    accum = max(cfg.grad_accum, 1)
    mesh = current_mesh() if mesh is None else mesh
    outside = mesh is not None and mesh.get_coordinate() is None
    group = None
    if mesh is not None and not outside:
        group = dp_group(mesh)
        if group is not None and dist.get_world_size(group) == 1:
            group = None

    def grads_of(params, leaves, batch):
        loss = train_loss(cfg, params, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
        return loss.detach(), grads

    def step(params, opt_state, batch):
        if outside:
            raise RuntimeError("this rank is not in the step's mesh")
        leaves = tree_leaves(trainable(params))
        if accum == 1:
            loss, grads = grads_of(params, leaves, batch)
        else:
            loss_sum = torch.zeros((), dtype=torch.float32,
                                   device=leaves[0].device)
            grads = [torch.zeros(p.shape, dtype=torch.float32,
                                 device=p.device) for p in leaves]
            for i in range(accum):
                mb = {k: t.reshape(accum, t.shape[0] // accum,
                                   *t.shape[1:])[i]
                      for k, t in batch.items()}
                l, g = grads_of(params, leaves, mb)
                loss_sum = loss_sum + l
                for acc, gi in zip(grads, g):
                    acc.add_(gi.float())
                del g
            loss = loss_sum / accum
            grads = [g / accum for g in grads]
        if group is not None:
            loss, grads = _data_mean(loss, grads, group)
        grads, _ = clip_by_global_norm(tree_unflatten(params, grads), 1.0)
        params, opt_state = adamw_update(params, grads, opt_state, lr=lr)
        return loss, params, opt_state

    return step


def make_prefill_step(cfg, max_len: int):
    """(params, batch) -> (last_logits (B,V), cache padded to max_len)."""
    def step(params, batch):
        return prefill(cfg, params, batch, max_len)
    return step


def make_decode_step(cfg):
    """(params, cache, tokens (B,), cur_len) -> (logits (B,V), cache); the
    cache is updated in place."""
    def step(params, cache, tokens, cur_len):
        return _decode_step(cfg, params, cache, tokens, cur_len)
    return step


# ------------------------------------------------------------- input specs
def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_struct(cfg, shape: ShapeSpec, with_labels: bool
                 ) -> Dict[str, torch.Tensor]:
    b, s = shape.global_batch, shape.seq_len
    i32 = torch.int32
    if cfg.family == "encdec":
        enc = dec = s // 2
        out = {"frames": _meta((b, enc, cfg.d_model), torch.float32),
               "dec_tokens": _meta((b, dec), i32)}
        if with_labels:
            out["labels"] = _meta((b, dec), i32)
        return out
    if cfg.frontend == "vision":
        text = s - cfg.n_frontend_tokens
        out = {"tokens": _meta((b, text), i32),
               "vision_embeds": _meta((b, cfg.n_frontend_tokens, 1024),
                                      torch.float32)}
        if with_labels:
            out["labels"] = _meta((b, text), i32)
        return out
    out = {"tokens": _meta((b, s), i32)}
    if with_labels:
        out["labels"] = _meta((b, s), i32)
    return out


def params_struct(cfg) -> Any:
    return init_params(cfg, None, device="meta")


def opt_struct(cfg, p_struct) -> Any:
    return adamw_init(p_struct)


def cache_struct(cfg, shape: ShapeSpec) -> Any:
    return init_decode_cache(cfg, shape.global_batch, shape.seq_len,
                             enc_len=ENC_LEN_FOR_DECODE, device="meta")


def input_specs(cfg, shape_name: str) -> Dict[str, Any]:
    """Meta-device stand-ins for every argument of one cell's step (no
    allocation).

    Returns {"kind", "args": tuple} matching the cell's step fn:
      train:   (params, opt_state, batch)
      prefill: (params, batch)
      decode:  (params, cache, tokens, cur_len)
    """
    shape = SHAPES_BY_NAME[shape_name]
    p = params_struct(cfg)
    if shape.kind == "train":
        return {"kind": "train",
                "args": (p, opt_struct(cfg, p),
                         batch_struct(cfg, shape, with_labels=True))}
    if shape.kind == "prefill":
        return {"kind": "prefill",
                "args": (p, batch_struct(cfg, shape, with_labels=False))}
    tokens = _meta((shape.global_batch,), torch.int32)
    cur = _meta((), torch.int32)
    return {"kind": "decode",
            "args": (p, cache_struct(cfg, shape), tokens, cur)}
