"""BENCHMARK.json keeps to the benchmark's contract, and every piece a cell
names is found by its name."""

import json
import re

import pytest

from portbench import check, spec, traffic

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def bench():
    return spec.benchmark()


def test_top_level_keys_and_limits():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["portbench"]
    assert b["command"][:2] == ["python3", "portbench/run.py"]
    assert 1 <= b["run_seconds"] <= 51 and isinstance(b["run_seconds"], int)
    assert len(json.dumps(b)) < 64 * 1024
    assert 1 <= len(b["configs"]) <= 24 and 1 <= len(b["workloads"]) <= 24


def test_names_units_and_text_fields():
    b = bench()
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in b[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names), names
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for w in b["workloads"]:
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
        assert w["chips"] in (1, 4)


def test_end_to_end_metrics_and_bounds():
    b = bench()
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert m["moves"] in e2e and m["layer"].strip() == m["layer"]
        if "mfu" in m["name"] or m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


@pytest.mark.parametrize("cell", [w["name"] for w in spec.benchmark()
                                  ["workloads"]])
def test_every_piece_of_a_cell_is_found_by_name(cell):
    c = spec.cell(cell)
    traffic.validate(c["traffic"])
    config = c["config"]
    assert config["name"] == c["workload"]["config"]
    assert c["traffic"]["name"] == c["workload"]["traffic"]
    assert "served_positions" in c["limits"]
    assert set(c["limits"]) <= set(check.NUMBERS)
    assert callable(spec.reference(config["family"]).served_logits)
    assert callable(spec.counts(config["family"]).prefill_flops)
    for m in c["per_layer"]:
        assert callable(spec.metric_reader(m["name"]))
    names = {m["name"] for m in c["end_to_end"]}
    assert "setup_s" in names and len(names) >= 2 and c["per_layer"]
    for m in c["per_layer"]:
        assert m["moves"] in names


@pytest.mark.parametrize("entry", spec.benchmark()["configs"],
                         ids=lambda e: e["name"])
def test_config_file_is_the_one_named(entry):
    assert entry["file"] == f"portbench/configs/{entry['name']}.json"
    config = spec.config(entry["name"])
    assert config["source"] == entry["source"]
    assert config["reduced"] == entry["reduced"]
    assert config["model"]["vocab"] > 0
