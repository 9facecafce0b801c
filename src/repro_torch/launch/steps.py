"""Step functions, train / prefill / decode (the counterpart of
``repro/launch/steps.py``). PyTorch runs eagerly, so a step is the plain
callable JAX would ``jit``. The input specs (``ShapeDtypeStruct`` stand-ins
for the dry run) wait for the dry-run slice (ROADMAP Queue 1 item 9)."""

from __future__ import annotations

import torch

from ..models import prefill, train_loss, trainable
from ..models.model import decode_step as _decode_step
from ..optim import adamw_update, clip_by_global_norm
from ..tree import tree_leaves, tree_unflatten


def make_train_step(cfg, lr: float = 3e-4):
    """(params, opt_state, batch) -> (loss, params, opt_state).

    ``torch.autograd.grad`` of ``train_loss`` over every leaf of
    ``params`` (marked with ``trainable``). With ``cfg.grad_accum > 1``
    the batch is split into that many microbatches along axis 0, taken in
    order: their float32 gradients are summed and divided by the count,
    and the loss is the mean of theirs, in the reference's order of
    operations. Then ``clip_by_global_norm(grads, 1.0)`` and
    ``adamw_update``, which updates ``params`` and ``opt_state`` in place
    (see ``optim/adamw.py``). The loss comes back as a 0-d float32
    tensor."""
    accum = max(cfg.grad_accum, 1)

    def grads_of(params, leaves, batch):
        loss = train_loss(cfg, params, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
        return loss.detach(), grads

    def step(params, opt_state, batch):
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
