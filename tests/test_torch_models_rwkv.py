"""rwkv6's model against the JAX package on the CPU, at smoke size (see
``test_torch_models.py`` for the method; ``test_torch_wkv.py`` holds the
WKV scan alone)."""

import pytest

from test_torch_models import check_forward_prefill_decode


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_prefill_decode_match_jax(dtype):
    check_forward_prefill_decode("rwkv6_7b", dtype)
