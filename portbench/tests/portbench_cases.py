"""Small cells for the CPU tests: each configuration file with the port's
smoke sizes (every width cut), a mix of 4 clients and short prompts, run
in float32 so that the program and the reference agree to rounding."""

import copy

from portbench import spec

SMALL = {
    "moe": dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=64,
                vocab=256, n_experts=4, top_k=2, d_expert=64),
    "ssm": dict(n_layers=2, d_model=64, n_heads=2, n_kv_heads=2, d_ff=128,
                vocab=256),
}
#: limits of the small cells, set from CPU readings at this size on seeds
#: 1-12: the float32 program reads 0 (the served token is the reference's
#: best at every position); the float8 control 0.13-2.15 at the widest,
#: 0.0067-0.18 on the mean
SMALL_LIMITS = {"widest_gap": {"limit": 1e-3}, "mean_gap": {"limit": 1e-4},
                "served_positions": {"limit": 8}}
#: every configuration file, whether a cell of BENCHMARK.json runs it yet
CONFIGS = sorted(p.stem for p in (spec.HERE / "configs").glob("*.json"))


def small_cell(config, dtype="float32", **model):
    """``config``'s file at the small sizes, under the small mix, with
    every metric of BENCHMARK.json."""
    bench = spec.benchmark()
    c = dict(config=copy.deepcopy(spec.config(config)),
             traffic=copy.deepcopy(spec.traffic("code32")),
             limits=copy.deepcopy(SMALL_LIMITS),
             end_to_end=bench["end_to_end"], per_layer=bench["per_layer"])
    c["config"]["model"].update(SMALL[c["config"]["family"]], **model)
    c["config"]["dtype"] = dtype
    c["config"]["check_requests"] = min(c["config"]["check_requests"], 4)
    c["traffic"].update(clients=4, prompt_lengths=[32, 16, 48],
                        output_tokens=4, max_len=64)
    return c
