"""The one traffic generator: a mix's fixed cycle of lengths, and a seed
that draws the tokens and nothing else."""

import numpy as np
import pytest

from portbench import spec, traffic

CODE = [1024, 1536, 512, 2048, 1536, 3840]


def test_code32_cycles_through_the_fixed_lengths():
    mix, clients = spec.traffic("code32"), 32
    traffic.validate(mix)
    assert [traffic.round_length(mix, i) for i in range(13)] \
        == CODE * 2 + CODE[:1]
    assert traffic.cycle(mix) == 6
    p = traffic.prompts(mix, 7, 5, 50304)
    assert p.shape == (clients, 3840) and p.dtype == np.int32
    assert traffic.tokens_of_round(mix, 5) == clients * (3840 + 13)


def test_the_seed_changes_only_the_tokens():
    mix = spec.traffic("code32")
    big = 2 ** 31 + 12345
    for i in (0, 3, 5):
        a = traffic.prompts(mix, big, i, 65536)
        b = traffic.prompts(mix, big + 1, i, 65536)
        assert a.shape == b.shape and not np.array_equal(a, b)
        assert np.array_equal(a, traffic.prompts(mix, big, i, 65536))
        assert a.min() >= 0 and a.max() < 65536
    w = traffic.warmup_prompts(mix, big, 65536)
    assert w.shape == (32, 3840)


def test_a_mix_longer_than_its_cache_is_refused():
    mix = dict(spec.traffic("code32"), max_len=3850)
    with pytest.raises(ValueError):
        traffic.validate(mix)
