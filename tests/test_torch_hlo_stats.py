"""The port's HLO collective parser (``repro_torch.launch.hlo_stats``)
against the JAX package's on a fixed set of HLO texts: counts and result
bytes exactly, link bytes within 1e-9 relative. Both parsers are plain
Python; nothing is compiled."""

import pytest

from repro.launch.hlo_stats import collective_stats as jax_collective_stats
from repro_torch.launch.hlo_stats import collective_stats, link_bytes

AR = ("  %ar = bf16[1024,512]{1,0} all-reduce(%x), channel_id=1, "
      "replica_groups=[32,16]<=[512], to_apply=%add")
AG = ("  %ag = f32[2048]{0} all-gather(%y), channel_id=2, "
      "replica_groups=[16,32]<=[512], dimensions={0}")
CP = ("  ROOT %cp = bf16[64,64]{1,0} collective-permute(%z), channel_id=3, "
      "source_target_pairs={{0,1}}")
RS = ("  %rs = f32[256,128]{1,0} reduce-scatter(%w), channel_id=4, "
      "replica_groups=[32,16]<=[512], dimensions={0}, to_apply=%add")
A2A = ("  %a2a = bf16[16,512,64]{2,1,0} all-to-all(%e), channel_id=5, "
       "replica_groups=[2,256]<=[512], dimensions={0}")
START_DONE = (
    "  %ars = f32[4096]{0} all-reduce-start(%g), channel_id=6, "
    "replica_groups=[16,32]<=[512], to_apply=%add\n"
    "  %ard = f32[4096]{0} all-reduce-done(%ars)")
TUPLE = ("  %tup = (bf16[128,64]{1,0}, f32[32]{0}) all-gather(%a, %b), "
         "channel_id=7, replica_groups=[32,16]<=[512], dimensions={0}")
NO_GROUPS = "  %ng = s32[1000]{0} all-reduce(%c), channel_id=8, to_apply=%add"
UNKNOWN_DTYPE = ("  %ud = f8e4m3fn[4096]{0} all-gather(%d), channel_id=9, "
                 "replica_groups=[16,32]<=[512], dimensions={0}")
OTHER = "  %other = f32[8,8]{1,0} add(%a, %b)"

TEXTS = {
    "reference_three": "\n".join(["", AR, AG, CP, OTHER, ""]),
    "reduce_scatter": RS,
    "all_to_all": A2A,
    "start_done": START_DONE,
    "tuple_result": TUPLE,
    "no_replica_groups": NO_GROUPS,
    "unknown_dtype": UNKNOWN_DTYPE,
    "everything": "\n".join([AR, AG, CP, RS, A2A, START_DONE, TUPLE,
                             NO_GROUPS, UNKNOWN_DTYPE, OTHER]),
    "none": OTHER,
}


def test_hlo_collective_parser():
    """``tests/test_race_and_shardings.py::test_hlo_collective_parser``, on
    the port."""
    hlo = """
  %ar = bf16[1024,512]{1,0} all-reduce(%x), channel_id=1, replica_groups=[32,16]<=[512], to_apply=%add
  %ag = f32[2048]{0} all-gather(%y), channel_id=2, replica_groups=[16,32]<=[512], dimensions={0}
  ROOT %cp = bf16[64,64]{1,0} collective-permute(%z), channel_id=3, source_target_pairs={{0,1}}
  %other = f32[8,8]{1,0} add(%a, %b)
"""
    s = collective_stats(hlo)
    assert s.counts["all-reduce"] == 1
    assert s.counts["all-gather"] == 1
    assert s.counts["collective-permute"] == 1
    assert s.result_bytes["all-reduce"] == 1024 * 512 * 2
    assert s.result_bytes["all-gather"] == 2048 * 4
    # ring model: AR counts 2x(k-1)/k, AG (k-1)/k, CP 1x
    expect = (2 * 1024 * 512 * 2 * 15 / 16
              + 2048 * 4 * 31 / 32 + 64 * 64 * 2)
    assert abs(s.link_bytes - expect) < 1.0


@pytest.mark.parametrize("name", list(TEXTS))
def test_collective_stats_equal_jax(name):
    got, want = collective_stats(TEXTS[name]), \
        jax_collective_stats(TEXTS[name])
    assert got.counts == want.counts
    assert got.result_bytes == want.result_bytes
    assert got.total_result_bytes() == want.total_result_bytes()
    assert abs(got.link_bytes - want.link_bytes) \
        <= 1e-9 * abs(want.link_bytes)


def test_the_texts_reach_every_branch():
    """What each text must show, so that the parity above covers it."""
    s = collective_stats(TEXTS["everything"])
    assert s.counts == {"all-reduce": 3, "all-gather": 3,
                        "reduce-scatter": 1, "all-to-all": 1,
                        "collective-permute": 1}
    assert collective_stats(START_DONE).counts["all-reduce"] == 1
    assert collective_stats(TUPLE).result_bytes["all-gather"] == \
        128 * 64 * 2 + 32 * 4
    assert collective_stats(UNKNOWN_DTYPE).result_bytes["all-gather"] == 0
    # no replica_groups: factor 1
    assert collective_stats(NO_GROUPS).link_bytes == 2.0 * 1000 * 4
    assert collective_stats(RS).link_bytes == 256 * 128 * 4 * 16 * 15 / 16


@pytest.mark.parametrize("op,nbytes,k,want", [
    ("all-reduce", 1000, 32, 2.0 * 1000 * 31 / 32),
    ("all-reduce", 1000, 1, 2000.0),
    ("all-gather", 640, 16, 600.0),
    ("all-to-all", 640, 0, 640.0),
    ("reduce-scatter", 100, 4, 300.0),
    ("collective-permute", 77, 8, 77.0),
])
def test_link_bytes_ring_factors(op, nbytes, k, want):
    assert link_bytes(op, nbytes, k) == want


def test_link_bytes_refuses_an_unknown_op():
    with pytest.raises(ValueError, match="unknown collective"):
        link_bytes("all-sum", 8, 2)
