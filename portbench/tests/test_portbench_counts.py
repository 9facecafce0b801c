"""The frozen counts give the numbers the port's kernel table records, and
the models' useful FLOPs a token."""

import pytest

from portbench import spec
from portbench.counts import kernels


def test_flash_work_at_qwen2s_prefill():
    assert kernels.flash_work(8, 14, 2, 512, 512, 64, True, 2) \
        == (16_777_216, 3_765_436_416)


def test_wkv_split_bound_at_rwkv6s_prefill():
    b = kernels.wkv_split_bound(4, 64, 512, 64, 64, 16, 2)
    assert b["bytes"] == 104_873_984 and b["flops"] == 2_533_359_616
    assert b["bound_s"] * 1e3 == pytest.approx(0.031306, abs=5e-7)
    assert b["bound_by"] == "bytes"


@pytest.mark.parametrize("config,per_token", [("olmoe-1b-7b", 2.15e9),
                                              ("rwkv6-7b", 14.1e9)])
def test_model_flops_a_token(config, per_token):
    c = spec.config(config)
    counts = spec.counts(c["family"])
    n = c["model"]["n_layers"] * counts.layer_flops_per_token(c)
    assert n == pytest.approx(per_token, rel=5e-3)


def test_prefill_counts_add_attention_and_the_head():
    c = spec.config("olmoe-1b-7b")
    counts = spec.counts("moe")
    one = counts.prefill_flops(c, 1, 512)
    pairs = 512 * 513 // 2
    assert one == (512 * 16 * counts.layer_flops_per_token(c)
                   + 16 * 4 * 16 * pairs * 128 + 2 * 2048 * 50304)
    assert counts.prefill_flops(c, 32, 3840) / 1e12 == pytest.approx(
        295.3, rel=1e-3)
