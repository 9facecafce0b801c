"""Each family's plain reference agrees with the port's plain path (the
port on the CPU) at the port's smoke sizes in float32: the prefill's last
logits and the logits of every decode step through the cache, with the
MoE capacity dropping tokens in the prefill and in decode."""

import pytest
import torch

from portbench import bench, spec, weights
from portbench.serving import greedy
from portbench_cases import small_cell


def port_logits(cell, prompt, n_out, seed=3):
    """The port's logits at every served position and its greedy tokens,
    with the weights the benchmark draws."""
    from repro_torch.launch.steps import params_struct
    cfg = bench.port_config(cell["config"])
    params = weights.draw(params_struct(cfg), cell["config"]["init"], seed,
                          "cpu")
    prefill, decode = bench.port_steps(cfg, cell["traffic"])
    with torch.inference_mode():
        logits, cache = prefill(params, {"tokens": prompt})
        tok = greedy(logits)
        out, served = [logits], [tok]
        for j in range(n_out - 1):
            logits, cache = decode(params, cache, tok, prompt.shape[1] + j)
            tok = greedy(logits)
            out.append(logits)
            served.append(tok)
    return params, torch.stack(out, 1), torch.stack(served, 1)


@pytest.mark.parametrize("cell,model", [
    ("olmoe-1b-7b", dict(capacity_factor=0.5)),
    ("olmoe-1b-7b", dict(n_kv_heads=2)),
    ("rwkv6-7b", {}),
])
def test_reference_follows_the_port(cell, model):
    c = small_cell(cell, **model)
    gen = torch.Generator().manual_seed(5)
    prompt = torch.randint(0, 256, (12, 48), generator=gen,
                           dtype=torch.int32)
    params, got, served = port_logits(c, prompt, 5)
    ref = spec.reference(c["config"]["family"])
    want = ref.served_logits(c["config"], params, prompt, served[:, :-1])
    assert want.shape == got.shape == (12, 5, 256)
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 2e-5 * scale
    assert torch.equal(want.argmax(-1), served.long())


def test_capacity_drops_tokens_in_the_small_cell():
    """The comparison above covers the capacity's drops: at factor 0.5 the
    prefill's group and each decode step's group lose (token, choice)
    pairs."""
    moe = spec.reference("moe")
    x = torch.randn(12 * 48, 64)
    router = torch.randn(64, 4)
    w, _ = moe._route(x, router, 2, 0.5)
    assert 0 < int((w == 0).sum()) < w.numel()
    w, _ = moe._route(x[:12], router, 2, 0.5)
    assert int((w == 0).sum()) > 0


def test_control_rounds_to_float8():
    from portbench.reference import common
    x = torch.randn(8, 32)
    w = torch.randn(32, 16)
    exact = common.linear(x, w)
    low = common.linear(x, w, "fp8")
    err = float((low - exact).abs().max() / exact.abs().max())
    assert 1e-3 < err < 0.2
    with pytest.raises(ValueError):
        common.linear(x, w, "int3")
