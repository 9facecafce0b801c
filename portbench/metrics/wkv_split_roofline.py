"""``wkv_split_roofline``: the least time of every ``wkv_split`` launch of
the traced cycle (``counts/kernels.py`` ``wkv_split_bound`` at each prefill
round's shape: the round's batch, the heads, its prompt length, bf16
r/k/v and float32 logw, chunks of 16) over the device time of the
``wkv_split_kernel`` functions, in %. Read only where the launches counted
are one a layer of each traced prefill, so that the shapes are those
rounds'. Layer: the kernels (``kernels/rwkv6``)."""

from portbench.counts.kernels import wkv_split_bound

ROUTE = "wkv_split"
KERNEL = "wkv_split_kernel"
CHUNK = 16


def read(readings):
    trace = readings["trace"]
    if not trace:
        return None
    m = readings["config"]["model"]
    h = m["n_heads"]
    dk = m["d_model"] // h
    rounds = trace["rounds"]
    launches = trace["launches"].get(ROUTE, 0)
    if launches == 0 or launches != m["n_layers"] * len(rounds):
        return None
    bound = sum(m["n_layers"] * wkv_split_bound(
        r["batch"], h, r["length"], dk, dk, CHUNK, 2)["bound_s"]
        for r in rounds)
    busy = sum(s for name, s in trace["kernel_s"].items() if KERNEL in name)
    if busy <= 0:
        return None
    return 100.0 * bound / busy
