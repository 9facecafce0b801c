"""One run of one cell: set-up, the measured window, the traced cycle, the
check, the result line.

Set-up: the port's configuration as the cell's file states it, the weights
drawn from the seed on the device, the port's prefill and decode steps,
and a warm-up at the mix's longest prompt. ``setup_s`` runs from the
start of the process to the start of the window.

The window: whole cycles of the mix (``serving.run_rounds``) until
``seconds`` have passed. ``ttft_p95_ms`` is the 95th percentile of the
time to first token over every request completed in it;
``tokens_per_s`` the prompt and generated tokens of those requests over
the time from the window's start to the last completion.

With ``trace`` one more cycle runs under the profiler after the window;
the per-layer readers read the window's spans and that cycle's trace.
Then the peak of the device's memory is read, the program's state is
freed and the reference checks a sample of the window's replies
(``check.py``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import check, serving, spec, trace, traffic, weights
from .reference.common import full_float32


def port_config(config: dict):
    """The port's configuration of ``config["arch"]`` with every size the
    cell's file states."""
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(config["arch"]), d_head=0,
                               dtype=config["dtype"], **config["model"])


def port_steps(cfg, mix: dict):
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    return make_prefill_step(cfg, mix["max_len"]), make_decode_step(cfg)


def _counters():
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import flash_attention
    return _build.launches, flash_attention.launches_by_shape


def ttft_p95_ms(rounds, mix, t0) -> float:
    ttft = [r["t_first"] - r["t_send"] for r in rounds
            for _ in range(r["batch"])]
    return float(np.percentile(ttft, 95)) * 1e3


def tokens_per_s(rounds, mix, t0) -> float:
    done = sum(traffic.tokens_of_round(mix, r["index"]) for r in rounds)
    return done / (rounds[-1]["t_done"] - t0)


END_TO_END = {"ttft_p95_ms": ttft_p95_ms, "tokens_per_s": tokens_per_s}


def run_cell(cell: dict, seed: int, seconds: float, traced: bool, device,
             t_start: float, wrap=None, control: str = None) -> dict:
    """The result of one run (the line's keys but ``device``'s card fields)
    with ``launches`` (the window's kernel launches by entry point) and
    ``checks``. ``wrap`` replaces the port's (prefill, decode) steps by
    what it returns for them (``faults.py``); with ``control`` (a
    precision) ``control`` is the control's verdict under the cell's
    limits (``check.run``). Neither is used by the benchmark's runs."""
    config, mix = cell["config"], cell["traffic"]
    traffic.validate(mix)
    device = torch.device(device)
    on_card = device.type == "cuda"
    from repro_torch.launch.steps import params_struct
    cfg = port_config(config)
    vocab = cfg.vocab
    launches, shapes = _counters()
    with torch.inference_mode():
        if on_card:
            torch.zeros((), device=device)
            torch.cuda.reset_peak_memory_stats(device)
        params = weights.draw(params_struct(cfg), config["init"], seed,
                              device)
        steps = port_steps(cfg, mix)
        if wrap is not None:
            steps = wrap(steps)
        serving.warm_up(steps, params, mix, seed, vocab, device)
        launches.clear()
        shapes.clear()
        t0 = serving.now()
        setup_s = t0 - t_start
        rounds = serving.run_rounds(steps, params, mix, seed, vocab, device,
                                    first=0, seconds=seconds)
        window_launches = dict(launches)
        red = None
        if traced:
            launches.clear()
            shapes.clear()
            more, red = trace.traced(
                lambda mark: serving.run_rounds(
                    steps, params, mix, seed, vocab, device,
                    first=len(rounds), count=traffic.cycle(mix), mark=mark),
                device)
            red.update(launches=dict(launches), flash_shapes=dict(shapes),
                       rounds=[dict(length=r["length"], batch=r["batch"])
                               for r in more])
            del more
        peak = torch.cuda.max_memory_allocated(device) if on_card else 0
        del steps
        if on_card:
            torch.cuda.empty_cache()
        full_float32()
        t_check = serving.now()
        verdict = check.run(config, mix, cell["limits"], params, rounds,
                            seed, device, control)
        check_s = serving.now() - t_check
    window_s = rounds[-1]["t_done"] - t0

    if traced:
        readings = dict(config=config, mix=mix, rounds=rounds, trace=red,
                        window_s=window_s)
        metrics = {}
        for m in cell["per_layer"]:
            value = spec.metric_reader(m["name"])(readings)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {}
        for m in cell["end_to_end"]:
            value = (setup_s if m["name"] == "setup_s"
                     else END_TO_END[m["name"]](rounds, mix, t0))
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    out = dict(correct=verdict["correct"],
               attempted=sum(r["batch"] for r in rounds), failed=0,
               metrics=metrics, memory_peak_bytes=peak,
               launches=window_launches, checks=verdict["numbers"],
               rounds=len(rounds), check_s=check_s, window_s=window_s,
               read=verdict["read"])
    if control:
        out["control"] = verdict["control"]
    if red is not None:
        out.update(busy_s=red["busy_s"], traced_s=red["window_s"],
                   breakdown=trace.breakdown(red),
                   traced_launches=red["launches"])
    return out
