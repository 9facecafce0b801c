"""The decode step that ``launch/steps.py``'s ``make_decode_step`` captures
as a CUDA graph on the card, checked on the CPU: the path the graph
captures (``cur_len`` a 0-d tensor read on the device) equals the int path
bit for bit from a prefill's cache in every family; on the CPU the step
runs eagerly and captures nothing; and the MoE dispatch's table, filled on
the device, gives what the one-hot oracle gives where the capacity drops
choices. The graph itself runs only on the card (``test_torch_gpu.py``)."""

import contextlib
import dataclasses
import importlib.util
import time
from pathlib import Path

import pytest
import torch

from repro_torch import obs
from repro_torch.configs import get_smoke_config
from repro_torch.launch import steps
from repro_torch.models import decode_step, init_params, moe, prefill
from repro_torch.tree import tree_leaves

#: one smoke config a family: dense, local/global dense, MoE, MLA, SSM,
#: hybrid, encoder-decoder
FAMILIES = ["qwen2_0_5b", "gemma2_2b", "olmoe_1b_7b", "deepseek_v2_236b",
            "rwkv6_7b", "zamba2_1_2b", "seamless_m4t_medium"]
PROMPT, MAX_LEN, STEPS = 12, 24, 5
ROOT = Path(__file__).resolve().parents[1]


def _prefilled(arch):
    """The smoke config's parameters and a prefill of two prompts (an
    encoder-decoder's: frames and decoder tokens) into a cache of
    ``MAX_LEN``."""
    cfg = get_smoke_config(arch)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    g = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab, (2, PROMPT), generator=g,
                           dtype=torch.int32)
    batch = {"tokens": tokens}
    if cfg.family == "encdec":
        batch = {"frames": torch.randn((2, PROMPT, cfg.d_model),
                                       generator=g),
                 "dec_tokens": tokens}
    logits, cache = prefill(cfg, params, batch, MAX_LEN)
    return cfg, params, logits, cache


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_clone(v) for v in tree)
    return None if tree is None else tree.clone()


@pytest.mark.parametrize("arch", FAMILIES)
def test_tensor_cur_len_equals_the_int_from_a_prefill(arch):
    """``STEPS`` greedy decode steps from a prefill's cache, ``cur_len`` an
    int or a 0-d int64 tensor (as the graph's static input): the logits,
    the served tokens and every cache leaf equal bit for bit."""
    cfg, params, logits0, cache0 = _prefilled(arch)
    runs = []
    for as_tensor in (False, True):
        cache, logits, served = _clone(cache0), logits0, []
        for j in range(STEPS):
            tok = torch.argmax(logits, -1).to(torch.int32)
            served.append(tok)
            cur = PROMPT + j
            if as_tensor:
                cur = torch.tensor(cur, dtype=torch.int64)
            logits, cache = decode_step(cfg, params, cache, tok, cur)
        runs.append((logits, torch.stack(served), tree_leaves(cache)))
    (l0, s0, c0), (l1, s1, c1) = runs
    assert torch.equal(l0, l1) and torch.equal(s0, s1)
    assert len(c0) == len(c1)
    assert all(torch.equal(a, b) for a, b in zip(c0, c1))


def test_on_the_cpu_the_step_runs_eagerly_and_captures_nothing():
    """Every call counts ``eager``, recording or not, and leaves no graph;
    the step's answers are ``decode_step``'s, bit for bit."""
    cfg, params, logits, cache = _prefilled("olmoe_1b_7b")
    want_cache = _clone(cache)
    step = steps.make_decode_step(cfg)
    steps.decode_calls.clear()
    tok = torch.argmax(logits, -1).to(torch.int32)
    for j in range(3):
        with obs.recording() if j == 2 else contextlib.nullcontext():
            got, cache = step(params, cache, tok, PROMPT + j)
        want, want_cache = decode_step(cfg, params, want_cache, tok,
                                       PROMPT + j)
        assert torch.equal(got, want)
        tok = torch.argmax(got, -1).to(torch.int32)
    assert dict(steps.decode_calls) == {"eager": 3}
    assert not step.graphs and not step.streams
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(cache),
                                                 tree_leaves(want_cache)))


@pytest.mark.parametrize("shape", [(32, 1), (2, 24)], ids=["decode",
                                                          "prefill"])
def test_gather_with_the_device_fill_equals_the_einsum_where_choices_drop(
        shape):
    """olmoe's smoke MoE layer in float32 at a decode step's shape (32
    tokens of one position) and a prefill's, with the router pulled
    towards expert 0 past its capacity: ``moe_ffn_gather`` (its slot table
    filled by ``index_fill_``) equals the one-hot ``moe_ffn_einsum`` within
    1e-5."""
    cfg = dataclasses.replace(get_smoke_config("olmoe_1b_7b"),
                              dtype="float32")
    blocks = init_params(cfg, torch.Generator().manual_seed(2),
                         "cpu")["blocks"]
    p = {k: v[0] for k, v in blocks.items()}
    p["router"] = p["router"].clone()
    p["router"][0, 0] = 3.0
    x = torch.randn((*shape, cfg.d_model),
                    generator=torch.Generator().manual_seed(3))
    x[..., 0] = 1.0
    keep = moe._route(cfg, x.reshape(-1, cfg.d_model), p["router"])[3]
    assert bool((~keep).any())                  # the capacity dropped some
    y, aux = moe.moe_ffn_gather(cfg, p, x)
    oracle, oaux = moe.moe_ffn_einsum(cfg, p, x)
    assert float(aux) == float(oaux)
    torch.testing.assert_close(y, oracle, atol=1e-5, rtol=1e-5)


def _tool():
    spec_ = importlib.util.spec_from_file_location(
        "decode_graphs", ROOT / "tools" / "decode_graphs.py")
    mod = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("config", ["olmoe-1b-7b", "rwkv6-7b"])
def test_the_counting_tool_runs_a_small_cell_on_the_cpu(config):
    """``tools/decode_graphs.py`` on a small cell (``portbench``'s CPU
    sizes, one cycle of three rounds): one entry a round, the warm-up's
    first, each round's decode calls all ``eager`` on the CPU."""
    from portbench.tests.portbench_cases import small_cell
    tool = _tool()
    c = small_cell(config)
    res = tool.counted(c, 2147483649, 0.0, False, torch.device("cpu"),
                       time.perf_counter())
    assert res["correct"] and res["rounds"] == 3
    assert res["decode_calls"] == [{"eager": 1}] + [{"eager": 3}] * 3
    got = tool.summary(res, c)
    assert got["window_calls"] == {"eager": 9}
    assert got["replayed_share"] == 0 and got["captures_per_cycle"] == 0
