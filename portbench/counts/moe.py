"""Useful FLOPs of a prefill of the ``moe`` family (attention layers with a
routed expert FFN, as olmoe-1b-7b), from the configuration's sizes: every
product counted once at 2 FLOPs a multiply-add, top-k experts a token (not
capacity slots), attention's QK^T and PV over the causal pairs, the LM head
at the last position only."""

from __future__ import annotations

from .kernels import causal_pairs


def layer_flops_per_token(config: dict) -> int:
    """The matrix products of one layer for one token."""
    m = config["model"]
    d, hd = m["d_model"], m["d_model"] // m["n_heads"]
    attn = d * m["n_heads"] * hd * 2 + d * m["n_kv_heads"] * hd * 2
    router = d * m["n_experts"]
    experts = m["top_k"] * 3 * d * m["d_expert"]
    return 2 * (attn + router + experts)


def prefill_flops(config: dict, batch: int, seq: int) -> int:
    m = config["model"]
    hd = m["d_model"] // m["n_heads"]
    per_layer = (batch * seq * layer_flops_per_token(config)
                 + 4 * batch * m["n_heads"] * causal_pairs(seq, seq) * hd)
    head = 2 * batch * m["d_model"] * m["vocab"]
    return m["n_layers"] * per_layer + head
