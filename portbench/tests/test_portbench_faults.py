"""The check fails what it has to fail. At a small size (``portbench_cases``)
a run through the harness, with the look for a card skipped and the timed
path broken underneath (``portbench/faults.py``), comes out ``correct``
false for each fault a serving cell can have: a decode step that returns
its state unchanged, half of the batch left out (its replies copied from
the other half), a token altered where it is produced. The control, the
reference in float8 in the program's place, comes out not correct under
the same limits through the same verdict; a sound run passes. The sample
of a round's requests is drawn from all of them."""

import time

import numpy as np
import pytest
import torch

from portbench import bench, check
from portbench.faults import FAULTS
from portbench_cases import CONFIGS, small_cell

SEEDS = (11, 2 ** 31 + 7)


def _run(cell, seed, wrap=None):
    return bench.run_cell(small_cell(cell), seed, 0.0, False, "cpu",
                          time.perf_counter(), wrap=wrap)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cell", CONFIGS)
def test_a_sound_run_is_correct(cell, seed):
    res = _run(cell, seed)
    assert res["correct"], res["checks"]
    assert res["checks"]["served_positions"]["value"] == 2 * 4 * 4


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", CONFIGS)
def test_a_broken_timed_path_is_not_correct(cell, fault):
    res = _run(cell, SEEDS[0], wrap=FAULTS[fault])
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("cell", CONFIGS)
def test_the_control_reads_above_the_limit(cell):
    for seed in SEEDS:
        res = bench.run_cell(small_cell(cell), seed, 0.0, False, "cpu",
                             time.perf_counter(), control="fp8")
        assert res["correct"], res["checks"]
        assert not res["control"]["correct"], res["control"]
        assert res["control"]["numbers"]["widest_gap"]["value"] \
            > res["control"]["numbers"]["widest_gap"]["limit"]


def _row(gaps, finite=True, in_range=True):
    g = torch.tensor(gaps)
    return dict(gaps=g, control_gaps=g * 10, finite=finite,
                in_range=in_range)


def test_the_verdict_holds_every_number_to_its_limit():
    limits = {"widest_gap": {"limit": 0.5}, "mean_gap": {"limit": 0.1},
              "served_positions": {"limit": 4}}
    rows = [_row([[0.0, 0.2]]), _row([[0.0, 0.1]])]
    v = check.verdict(rows, limits)
    assert v["correct"] and v["numbers"]["served_positions"]["value"] == 4
    assert v["read"]["widest_gap"] == pytest.approx(0.2)
    assert not check.verdict(rows, limits, key="control_gaps")["correct"]
    assert not check.verdict(rows[:1], limits)["correct"]
    assert not check.verdict([rows[0], _row([[0.0]], finite=False),
                              rows[1]], limits)["correct"]
    assert not check.verdict([rows[0], _row([[0.0, 0.0]], in_range=False)],
                             limits)["correct"]


def test_the_sample_draws_requests_from_the_whole_round():
    rounds = [dict(length=3840, batch=16, index=5),
              dict(length=512, batch=16, index=2),
              dict(length=1024, batch=16, index=0)]
    halves = set()
    for seed in range(40):
        picks = check.sample(rounds, {}, 2 ** 31 + seed, 8)
        assert [r["length"] for r, _ in picks][0] == 3840
        assert len(picks) == 2
        for _, idx in picks:
            assert len(set(idx.tolist())) == 8 and idx.max() < 16
            halves.add(bool((idx >= 8).any()) and bool((idx < 8).any()))
    assert halves == {True}
    full = check.sample(rounds, {}, 3, 32)
    assert all(np.array_equal(idx, np.arange(16)) for _, idx in full)
