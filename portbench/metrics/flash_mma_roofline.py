"""``flash_mma_roofline``: the least time of every ``flash_attention_mma``
launch of the traced cycle (its useful bytes and causal FLOPs from the call's
shape, ``counts/kernels.py``) over the device time of the
``flash_mma_kernel`` functions, in %. Layer: the kernels
(``kernels/flash_attention``)."""

from portbench.counts.kernels import flash_bound

ROUTE = "flash_attention_mma"
KERNEL = "flash_mma_kernel"


def read(readings):
    trace = readings["trace"]
    if not trace:
        return None
    bound = sum(n * flash_bound(b, hq, hkv, sq, skv, d, causal, 2)["bound_s"]
                for (route, b, hq, hkv, sq, skv, d, causal), n
                in trace["flash_shapes"].items() if route == ROUTE)
    busy = sum(s for name, s in trace["kernel_s"].items() if KERNEL in name)
    if bound <= 0 or busy <= 0:
        return None
    return 100.0 * bound / busy
