"""Step functions for serving (the counterpart of
``repro/launch/steps.py``'s ``make_prefill_step`` and
``make_decode_step``). PyTorch runs eagerly, so a step is the plain
callable JAX would ``jit``. ``make_train_step`` and the input specs wait
for the optimizer and dry-run slices (ROADMAP Queue 1 items 7-9)."""

from __future__ import annotations

from ..models import prefill
from ..models.model import decode_step as _decode_step


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
