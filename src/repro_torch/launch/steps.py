"""Step functions, train / prefill / decode, and the input specs of every
(architecture x shape) cell (the counterpart of ``repro/launch/steps.py``).
PyTorch runs eagerly, so a step is the plain callable JAX would ``jit``,
except that the decode step replays itself as a CUDA graph on the card
(:func:`make_decode_step`); the input specs are meta-device tensors where
JAX has ``ShapeDtypeStruct``s: shapes and dtypes, no memory."""

from __future__ import annotations

import collections
from typing import Any, Dict

import torch
import torch.distributed as dist

from .. import obs
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


#: decode calls by how they ran, host-side and always on (as
#: ``kernels/_build.launches``): ``captured`` (no graph for the call's key:
#: run eagerly, then captured for the next call with that key),
#: ``replayed``, and ``eager`` (the graph path not taken, or its capture
#: refused); callers clear it before the run whose calls they read
decode_calls: collections.Counter = collections.Counter()

#: the most graphs one decode step keeps, the oldest dropped first: a
#: serving round's cache is a new allocation, whose address may change
MAX_DECODE_GRAPHS = 8


def _graphable(tensors) -> bool:
    """Whether a decode call may take the graph path: every tensor on a
    CUDA card, no recording open (its spans and counters fire in eager
    calls only), nothing autograd would record, no capture underway."""
    if obs.is_recording() or not all(t.is_cuda for t in tensors):
        return False
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return False
    return not torch.cuda.is_current_stream_capturing()


def _signature(leaves) -> tuple:
    return tuple((t.data_ptr(), t.shape, t.stride(), t.dtype)
                 for t in leaves)


def _math_flags() -> tuple:
    """The settings that pick the step's kernels, which a graph fixes."""
    m = torch.backends.cuda.matmul
    return (m.allow_tf32, m.allow_bf16_reduced_precision_reduction,
            m.allow_fp16_reduced_precision_reduction,
            torch.are_deterministic_algorithms_enabled())


class _DecodeGraph:
    """One captured decode step: its static inputs (the tokens, int32, and
    ``cur_len``, a 0-d int64 tensor read on the card only) and its static
    output (the logits). It reads the parameters and reads and writes the
    cache where its key says they lie."""

    def __init__(self, cfg, params, cache, tokens, stream, pool):
        dev = tokens.device
        self.tokens = torch.zeros(tokens.shape, dtype=torch.int32,
                                  device=dev)
        self.cur_len = torch.zeros((), dtype=torch.int64, device=dev)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(stream):
            self.graph.capture_begin(pool=pool,
                                     capture_error_mode="thread_local")
            try:
                self.logits, out = _decode_step(cfg, params, cache,
                                                self.tokens, self.cur_len)
            finally:
                self.graph.capture_end()
        if _signature(tree_leaves(out)) != _signature(tree_leaves(cache)):
            raise RuntimeError("the decode step did not write its cache "
                               "in place")

    def replay(self, tokens, cur_len):
        self.tokens.copy_(tokens)
        if isinstance(cur_len, torch.Tensor):
            self.cur_len.copy_(cur_len)
        else:
            self.cur_len.fill_(int(cur_len))
        self.graph.replay()
        return self.logits.clone()


class _DecodeStep:
    """``make_decode_step``'s step. On the card, each call applies the step
    once: a call whose key (the address, shape, stride and dtype of every
    parameter and cache leaf, the tokens' shape and the math settings) has
    a graph replays it; another runs eagerly, then captures a graph for its
    key, which launches nothing. The graphs share one memory pool on their
    card and write the caller's cache in place (no copy of it). A capture
    that fails leaves its key eager."""

    def __init__(self, cfg):
        self.cfg = cfg
        self.graphs: collections.OrderedDict = collections.OrderedDict()
        self.refused = set()
        self.streams: Dict[torch.device, tuple] = {}

    def __call__(self, params, cache, tokens, cur_len):
        p_leaves, c_leaves = tree_leaves(params), tree_leaves(cache)
        tensors = p_leaves + c_leaves + [tokens]
        if isinstance(cur_len, torch.Tensor):
            tensors.append(cur_len)
        if not _graphable(tensors):
            decode_calls["eager"] += 1
            return _decode_step(self.cfg, params, cache, tokens, cur_len)
        key = (_signature(p_leaves), _signature(c_leaves), tokens.shape,
               _math_flags())
        graph = self.graphs.get(key)
        if graph is not None:
            self.graphs.move_to_end(key)
            decode_calls["replayed"] += 1
            return graph.replay(tokens, cur_len), cache
        out = _decode_step(self.cfg, params, cache, tokens, cur_len)
        if key in self.refused or not self._capture(key, params, cache,
                                                    tokens):
            decode_calls["eager"] += 1
        else:
            decode_calls["captured"] += 1
        return out

    def _capture(self, key, params, cache, tokens) -> bool:
        dev = tokens.device
        if dev not in self.streams:
            self.streams[dev] = (torch.cuda.Stream(dev),
                                 torch.cuda.graph_pool_handle())
        try:
            graph = _DecodeGraph(self.cfg, params, cache, tokens,
                                 *self.streams[dev])
        except RuntimeError:
            # a fresh stream for the next capture: a failed one may leave
            # the allocator routing this stream's allocations to the pool
            self.streams.pop(dev)
            self.refused.add(key)
            return False
        self.graphs[key] = graph
        if len(self.graphs) > MAX_DECODE_GRAPHS:
            self.graphs.popitem(last=False)
        return True


def make_decode_step(cfg):
    """(params, cache, tokens (B,), cur_len) -> (logits (B,V), cache); the
    cache is updated in place. On a CUDA card, outside ``obs.recording()``
    and with nothing for autograd to record, the step replays a CUDA graph
    of itself (:class:`_DecodeStep`); elsewhere it runs eagerly.
    :data:`decode_calls` counts its calls by path."""
    return _DecodeStep(cfg)


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
