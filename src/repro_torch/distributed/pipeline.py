"""GPipe-style pipeline parallelism over a mesh dimension (the counterpart
of ``repro/distributed/pipeline.py``).

``pipeline_apply`` runs S stages (one per rank along ``axis``) over M
microbatches with the classic (M + S - 1)-step schedule: stage s works on
microbatch t - s at step t; activations hop from stage s to s + 1 by
point-to-point ``send``/``recv`` over the dimension's process group, and
the last stage's outputs are then replicated to every stage, which the
reference's ``psum`` does.

It is differentiable through a hand-written ``torch.autograd.Function``
around the schedule's sends and receives (not
``torch.distributed.pipelining``): the forward keeps each microbatch's
stage graph (GPipe's stored activations), and the backward runs the
schedule in reverse, microbatch M - 1 first, each stage receiving its
output's gradient from stage s + 1 and sending its input's gradient to
stage s - 1 by the same hops. The replication's backward is that of one
logical output: the last stage takes its own cotangent of the output as
the output's gradient and the others' are ignored, so a loss must be taken
alike on every rank, as ``jax.grad`` of a loss of the replicated output
takes it once (not S times).

Intended use: the "pod" dimension of a production mesh as the pipeline
dimension (layers split across pods, the slow hops amortized over
microbatches), data and model parallelism inside each pod.
"""

from __future__ import annotations

from typing import Any, Callable, List

import torch
import torch.distributed as dist

from ..tree import tree_leaves, tree_unflatten


class _Schedule:
    """One stage's part of the GPipe schedule on ``group`` (``stage`` of
    ``n_stages``), for ``stage_fn`` with parameters shaped like
    ``template``."""

    def __init__(self, stage_fn, template, group, stage: int,
                 n_stages: int):
        self.stage_fn, self.template = stage_fn, template
        self.group, self.stage, self.n = group, stage, n_stages
        rank = (lambda s: dist.get_global_rank(group, s)) if n_stages > 1 \
            else (lambda s: None)
        self.prev = rank(stage - 1) if stage > 0 else None
        self.next = rank(stage + 1) if stage < n_stages - 1 else None
        self.first, self.last = rank(0), rank(n_stages - 1)

    def forward(self, x, leaves, keep: bool, x_grad: bool = False):
        """The forward steps; returns the (M, mb, ...) outputs replicated on
        every stage. With ``keep``, each microbatch's (input, output) graph
        on detached copies of ``leaves`` (and of its input) is kept in
        ``self.saved`` for :meth:`backward`."""
        m = x.shape[0]
        if keep:
            self.local = [t.detach().requires_grad_(t.requires_grad)
                          for t in leaves]
            leaves = self.local
            self.saved = []
        params = tree_unflatten(self.template, leaves)
        out_buf = torch.zeros_like(x)
        sent = []
        for t in range(m + self.n - 1):
            mb = t - self.stage
            if not 0 <= mb < m:
                continue                         # idle: writes nothing
            if self.prev is None:
                inp = x[mb]
            else:
                inp = torch.empty_like(x[0])
                dist.recv(inp, src=self.prev, group=self.group, tag=mb)
            if keep:
                inp = inp.detach().requires_grad_(
                    self.prev is not None or x_grad)
                with torch.enable_grad():
                    out = self.stage_fn(params, inp)
                self.saved.append((inp, out))
            else:
                out = self.stage_fn(params, inp)
            if out.shape != inp.shape or out.dtype != x.dtype:
                raise ValueError(
                    f"stage_fn must keep a microbatch's shape and dtype: "
                    f"{tuple(inp.shape)} {x.dtype} -> {tuple(out.shape)} "
                    f"{out.dtype}")
            if self.next is None:
                out_buf[mb] = out.detach()
            else:
                act = out.detach().contiguous()
                sent.append((act, dist.isend(act, dst=self.next,
                                             group=self.group, tag=mb)))
        for _, work in sent:
            work.wait()
        if self.n > 1:
            dist.broadcast(out_buf, src=self.last, group=self.group)
        return out_buf

    def backward(self, ct, x_grad: bool):
        """The backward steps from ``ct``, this rank's cotangent of the
        outputs: the gradients of this stage's leaves, and of ``x`` (on
        every stage, from stage 0) when ``x_grad``."""
        m = ct.shape[0]
        # the microbatches' gradients summed in float32, as make_train_step
        # sums its microbatches'; each cast to its leaf's dtype at the end
        grads = [torch.zeros_like(t, dtype=torch.float32)
                 if t.requires_grad else None for t in self.local]
        wrt = [t for t in self.local if t.requires_grad]
        dx = torch.zeros_like(ct) if x_grad else None
        sent = []
        for mb in reversed(range(m)):
            inp, out = self.saved[mb]
            if self.next is None:
                dy = ct[mb]
            else:
                dy = torch.empty_like(out)
                dist.recv(dy, src=self.next, group=self.group, tag=m + mb)
            targets = wrt + ([inp] if inp.requires_grad else [])
            got = torch.autograd.grad(out, targets, dy, allow_unused=True,
                                      materialize_grads=True)
            it = iter(got)
            for g in grads:
                if g is not None:
                    g.add_(next(it))
            if inp.requires_grad:
                da = next(it)
                if self.prev is not None:
                    da = da.contiguous()
                    sent.append((da, dist.isend(da, dst=self.prev,
                                                group=self.group,
                                                tag=m + mb)))
                else:
                    dx[mb] = da
        for _, work in sent:
            work.wait()
        if x_grad and self.n > 1:
            dist.broadcast(dx, src=self.first, group=self.group)
        grads = [None if g is None else g.to(t.dtype)
                 for g, t in zip(grads, self.local)]
        self.saved = self.local = None
        return dx, grads


class _Pipeline(torch.autograd.Function):
    """``_Schedule.forward`` with its graphs kept, and its backward."""

    @staticmethod
    def forward(ctx, sched, x, *leaves):
        ctx.sched = sched
        return sched.forward(x, leaves, keep=True,
                             x_grad=ctx.needs_input_grad[1])

    @staticmethod
    def backward(ctx, ct):
        dx, grads = ctx.sched.backward(ct.contiguous(),
                                       ctx.needs_input_grad[1])
        ctx.sched = None
        return (None, dx, *grads)


def pipeline_apply(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                   stage_params: Any, x: torch.Tensor, mesh,
                   axis: str = "stage") -> torch.Tensor:
    """Run microbatches through a pipeline over the ranks of ``mesh``'s
    ``axis`` dimension (every rank of that group calls it alike).

    stage_fn:     (params of one stage, activations (mb, ...)) -> the same
                  shape and dtype
    stage_params: this rank's stage's parameters (a tree of tensors): its
                  slice of the reference's stacked tree, which ``P(axis)``
                  hands each stage
    x:            (M, mb, ...) microbatches, the same on every rank (only
                  stage 0 reads them)
    Returns the (M, mb, ...) outputs of the LAST stage, on every rank.
    Differentiable in ``stage_params`` and ``x`` (see the module
    docstring)."""
    group = mesh.get_group(axis)
    n_stages = dist.get_world_size(group)
    stage = mesh.get_local_rank(axis)
    leaves: List[torch.Tensor] = tree_leaves(stage_params)
    sched = _Schedule(stage_fn, stage_params, group, stage, n_stages)
    if torch.is_grad_enabled() and (
            x.requires_grad or any(t.requires_grad for t in leaves)):
        return _Pipeline.apply(sched, x, *leaves)
    return sched.forward(x, leaves, keep=False)


def split_microbatches(batch: torch.Tensor, n_micro: int) -> torch.Tensor:
    """(B, ...) -> (M, B//M, ...)."""
    b = batch.shape[0]
    assert b % n_micro == 0, (b, n_micro)
    return batch.reshape(n_micro, b // n_micro, *batch.shape[1:])
