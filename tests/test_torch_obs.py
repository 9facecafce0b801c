"""The port's spans and counters (``repro_torch/obs.py``) on the CPU: off,
a span is one shared no-op and a profiler trace holds none of them; on,
they nest as ``user_annotation`` ranges under their names; the MoE
counters count what ``_route`` decided; and recording changes no output,
bit for bit."""

import dataclasses
import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import obs
from repro_torch.configs import get_smoke_config
from repro_torch.models import moe
from repro_torch.models.model import decode_step, prefill
from repro_torch.models.params import init_params

PROGRAM_SPANS = {
    "model.prefill", "model.decode_step", "model.embed", "model.head",
    "layer", "attn.qkv", "attn.core", "attn.cache_write", "attn.out",
    "kv.collect", "moe.route", "moe.dispatch", "moe.experts", "moe.combine",
    "rwkv.time_mix", "rwkv.wkv", "rwkv.channel_mix", "ssm.state_collect",
    "obs.count"}


def _model(arch, seed=0):
    cfg = get_smoke_config(arch)
    params = init_params(cfg, torch.Generator().manual_seed(seed), "cpu")
    g = torch.Generator().manual_seed(seed + 1)
    tokens = torch.randint(0, cfg.vocab, (2, 12), generator=g)
    return cfg, params, tokens


def _serve(cfg, params, tokens, steps=2):
    """Prefill then ``steps`` greedy decode steps: every logit row."""
    logits, cache = prefill(cfg, params, {"tokens": tokens}, 16)
    out = [logits]
    for j in range(steps):
        tok = torch.argmax(logits, -1).to(torch.int32)
        logits, cache = decode_step(cfg, params, cache, tok,
                                    tokens.shape[1] + j)
        out.append(logits)
    return torch.stack(out)


def _annotations(prof, tmp_path):
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
            for e in events
            if e.get("ph") == "X" and e.get("cat") == "user_annotation"]


def test_span_off_is_one_shared_no_op():
    assert obs.span("layer") is obs.span("attn.core")
    assert not isinstance(obs.span("layer"),
                          torch.profiler.record_function)
    with obs.recording():
        on = obs.span("layer")
    assert isinstance(on, torch.profiler.record_function)
    assert obs.span("layer") is obs.span("moe.route")


@pytest.mark.parametrize("arch", ["olmoe_1b_7b", "rwkv6_7b"])
def test_trace_holds_program_spans_only_while_recording(arch, tmp_path):
    cfg, params, tokens = _model(arch)
    with torch.inference_mode():
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            _serve(cfg, params, tokens)
        names = {n for _, _, n in _annotations(prof, tmp_path)}
        assert not names & PROGRAM_SPANS
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with obs.recording():
                _serve(cfg, params, tokens)
    spans = _annotations(prof, tmp_path)
    names = {n for _, _, n in spans}
    common = {"model.prefill", "model.decode_step", "model.embed",
              "model.head", "layer"}
    family = ({"attn.qkv", "attn.core", "attn.cache_write", "attn.out",
               "kv.collect", "moe.route", "moe.dispatch", "moe.experts",
               "moe.combine", "obs.count"} if arch == "olmoe_1b_7b" else
              {"rwkv.time_mix", "rwkv.wkv", "rwkv.channel_mix",
               "ssm.state_collect"})
    assert names <= PROGRAM_SPANS and names == common | family

    def inside(child, *parents):
        """Every ``child`` span lies inside a span named in ``parents``."""
        outer = [(a, b) for a, b, n in spans if n in parents]
        return all(any(a0 <= a and b <= b0 for a0, b0 in outer)
                   for a, b, n in spans if n == child)

    inner = "attn.core" if arch == "olmoe_1b_7b" else "rwkv.wkv"
    assert inside("layer", "model.prefill", "model.decode_step")
    assert not inside("layer", "model.prefill")
    assert inside(inner, "layer")
    if arch == "rwkv6_7b":
        assert inside("rwkv.wkv", "rwkv.time_mix")
    else:
        assert inside("attn.cache_write", "model.decode_step")
        assert inside("moe.experts", "layer")
    steps = sum(n == "model.decode_step" for _, _, n in spans)
    assert steps == 2
    assert sum(n == "layer" for _, _, n in spans) == 3 * cfg.n_layers


def test_tallies_come_back_once_as_ints():
    obs.count("moe.kept", 5)                      # off: nothing
    with obs.recording() as tallies:
        obs.count("a", 3)
        obs.count("a", 4)
        obs.count("b", torch.tensor([True, False, True]))
        obs.count("b", torch.tensor(2))
        obs.count("c", torch.tensor([[1, 2], [3, 4]]))
        for _ in range(3):      # each sum exact in float32, the total not
            obs.count("d", torch.ones(1).expand(2 ** 23 + 1))
        assert tallies == {}
        with pytest.raises(RuntimeError):
            with obs.recording():
                pass
    assert tallies == {"a": 7, "b": 4, "c": 10, "d": 3 * (2 ** 23 + 1)}
    assert all(type(v) is int for v in tallies.values())
    with obs.recording() as again:
        pass
    assert again == {}


def test_tallies_stay_on_the_device_until_the_recording_ends(monkeypatch):
    reads = []
    for method in ("item", "tolist", "cpu"):
        real = getattr(torch.Tensor, method)

        def counted(t, *args, _real=real, _name=method, **kw):
            reads.append(_name)
            return _real(t, *args, **kw)

        monkeypatch.setattr(torch.Tensor, method, counted)
    with obs.recording() as tallies:
        for _ in range(2500):                 # two traced cycles' MoE calls
            obs.count("moe.kept", torch.ones(3, dtype=torch.bool))
        obs.count("moe.slots", torch.tensor(7))
        assert not reads
    assert reads == ["tolist"]
    assert tallies == {"moe.kept": 3 * 2500, "moe.slots": 7}


@pytest.mark.parametrize("bias", [0.0, 8.0])
def test_moe_counters_count_what_the_router_kept(bias, tmp_path):
    cfg = dataclasses.replace(get_smoke_config("olmoe_1b_7b"),
                              capacity_factor=1.0)
    d, e, k = cfg.d_model, cfg.n_experts, cfg.top_k
    params = init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    p = {name: v[0] for name, v in params["blocks"].items()}
    x = torch.randn(2, 24, d, generator=torch.Generator().manual_seed(4))
    x = x.to(cfg.param_dtype)
    if bias:                       # every token to expert 0: it overflows
        x[..., 0] = 1.0
        p["router"] = p["router"].clone()
        p["router"][0, 0] = bias
    t = x.shape[0] * x.shape[1]
    _, _, _, keep, capacity, _ = moe._route(cfg, x.reshape(t, d),
                                            p["router"])
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with obs.recording() as tallies:
            moe.moe_ffn(cfg, p, x)
    # the count is one reduction of a mask the dispatch casts anyway: no
    # cast of its own (on the card, at most a memset and the reduction)
    prof.export_chrome_trace(str(tmp_path / "moe.json"))
    with open(tmp_path / "moe.json") as f:
        ops = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    counts = [(e["ts"], e["ts"] + e["dur"]) for e in ops
              if e["name"] == "obs.count"]
    assert len(counts) == 1
    inside = {e["name"] for e in ops if e.get("cat") == "cpu_op"
              and counts[0][0] <= e["ts"] <= counts[0][1]}
    assert "aten::sum" in inside
    assert not inside & {"aten::to", "aten::_to_copy", "aten::copy_"}
    assert tallies == {"moe.choices": t * k, "moe.kept": int(keep.sum()),
                       "moe.slots": e * capacity}
    dropped = tallies["moe.choices"] - tallies["moe.kept"]
    assert dropped == int((~keep).sum())
    if bias:
        assert dropped > 0


@pytest.mark.parametrize("arch", ["olmoe_1b_7b", "rwkv6_7b"])
def test_recording_changes_no_output(arch):
    cfg, params, tokens = _model(arch, seed=5)
    with torch.inference_mode():
        off = _serve(cfg, params, tokens, steps=3)
        with obs.recording():
            on = _serve(cfg, params, tokens, steps=3)
    assert torch.equal(off, on)
    if arch == "olmoe_1b_7b":
        p = {name: v[1] for name, v in params["blocks"].items()}
        x = torch.randn(3, 7, cfg.d_model,
                        generator=torch.Generator().manual_seed(6))
        x = x.to(cfg.param_dtype)
        y_off, aux_off = moe.moe_ffn(cfg, p, x)
        with obs.recording():
            y_on, aux_on = moe.moe_ffn(cfg, p, x)
        assert torch.equal(y_off, y_on) and torch.equal(aux_off, aux_on)
