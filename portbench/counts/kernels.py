"""The work one kernel call needs, from its shapes alone, and the least time
the card could take for it: frozen copies of the counts that the port's
``chip_smoke.py`` keeps beside its kernel timings, rewritten to take shapes
and element sizes instead of tensors.

Every count is of what the call's shapes need, whatever the kernel does:
each input byte read once and each output byte written once; attention's
products over the causal pairs only; the WKV scan's useful dk x dv x chunk
work, not a padded tile.
"""

from __future__ import annotations

from .peaks import (BF16_FLOP_PER_S, FP32_FLOP_PER_S, HBM_BYTES_PER_S,
                    TF32_FLOP_PER_S)


def bound(nbytes: float, flops: float, peak: float) -> dict:
    """The larger of bytes over HBM bandwidth and operations over ``peak``,
    in seconds, and which of the two sets it."""
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return dict(bytes=nbytes, flops=flops, bound_s=max(by_bytes, by_ops),
                bound_by="bytes" if by_bytes >= by_ops else "operations")


def causal_pairs(sq: int, skv: int) -> int:
    """(query, key) pairs a causal mask keeps, query i at position i."""
    full = min(sq, skv)
    return full * (full + 1) // 2 + max(0, sq - skv) * skv


def flash_work(b: int, hq: int, hkv: int, sq: int, skv: int, d: int,
               causal: bool, itemsize: int) -> tuple:
    """Bytes (q, k, v read once, o written once) and operations (QK^T and
    PV over the pairs the mask keeps) of one attention call."""
    pairs = causal_pairs(sq, skv) if causal else sq * skv
    nbytes = itemsize * (2 * b * hq * sq * d + 2 * b * hkv * skv * d)
    return nbytes, 2 * b * hq * pairs * (d + d)


def flash_bound(b, hq, hkv, sq, skv, d, causal, itemsize) -> dict:
    """One attention call's bound: bf16 on the tensor cores, float32 on the
    CUDA cores."""
    nbytes, flops = flash_work(b, hq, hkv, sq, skv, d, causal, itemsize)
    return bound(nbytes, flops,
                 BF16_FLOP_PER_S if itemsize == 2 else FP32_FLOP_PER_S)


def wkv_work(b: int, h: int, s: int, dk: int, dv: int, c: int,
             itemsize: int, w_itemsize: int = 4) -> tuple:
    """Bytes (r, k, v, logw, u, the final state and o, each once) and
    float32 operations of one chunked WKV scan from a zero state: the
    strictly-lower intra-chunk terms, the decay factors, the state
    products."""
    n = b * h * s
    nbytes = (itemsize * n * (2 * dk + dv)       # r, k, v
              + w_itemsize * n * dk              # logw
              + 4 * h * dk                       # u, float32
              + 4 * b * h * dk * dv              # final state, float32
              + itemsize * n * dv)               # o
    pairs = c * (c - 1) // 2
    per_chunk = (2 * c * dk * dv
                 + 2 * pairs * dk + 2 * pairs * dv
                 + 4 * c * dk + 2 * c * dv
                 + 2 * c * dk * dv + dk * dv
                 + 6 * c * dk)
    return nbytes, per_chunk * b * h * (s // c)


def wkv_split_bound(b, h, s, dk, dv, c, itemsize, w_itemsize=4) -> dict:
    """One WKV scan's bound on the units both WKV routes run it on: the four
    products (scores, att v, r_dec S, k_fin^T v) on the tensor cores as
    three TF32 passes (float32-accurate split TF32), at 495 / 3 TFLOP/s, and
    the rest on the CUDA cores at 67 TFLOP/s beside them, against the
    bytes."""
    nbytes, flops = wkv_work(b, h, s, dk, dv, c, itemsize, w_itemsize)
    pairs = c * (c - 1) // 2
    products = (4 * c * dk * dv + 2 * pairs * (dk + dv)) * b * h * (s // c)
    by_bytes = nbytes / HBM_BYTES_PER_S
    by_ops = max(products / (TF32_FLOP_PER_S / 3),
                 (flops - products) / FP32_FLOP_PER_S)
    return dict(bytes=nbytes, flops=flops, product_flops=products,
                bound_s=max(by_bytes, by_ops),
                bound_by="bytes" if by_bytes >= by_ops else "operations")
