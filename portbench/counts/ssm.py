"""Useful FLOPs of a prefill of the ``ssm`` family (RWKV-6, as rwkv6-7b),
from the configuration's sizes: every product counted once at 2 FLOPs a
multiply-add (time-mix's five d x d projections and its low-rank mixes,
channel-mix's three), the chunked WKV scan's useful work
(``kernels.wkv_work``), the LM head at the last position only."""

from __future__ import annotations

from .kernels import wkv_work


def layer_flops_per_token(config: dict) -> int:
    m, r = config["model"], config["reference"]
    d, ff = m["d_model"], m["d_ff"]
    mix, decay = r["time_mix_lora"], r["decay_lora"]
    time_mix = 5 * d * d + d * mix + 5 * mix * d + 2 * d * decay
    channel_mix = 2 * d * ff + d * d
    return 2 * (time_mix + channel_mix)


def prefill_flops(config: dict, batch: int, seq: int) -> int:
    m = config["model"]
    h = m["n_heads"]
    dk = m["d_model"] // h
    chunk = min(config["reference"]["wkv_chunk"], seq)
    _, scan = wkv_work(batch, h, seq, dk, dk, chunk, 2)
    head = 2 * batch * m["d_model"] * m["vocab"]
    return m["n_layers"] * (batch * seq * layer_flops_per_token(config)
                            + scan) + head
