"""The port's input specs against the JAX package's, for every config and
every shape name, at full size.

``launch.steps.input_specs`` gives meta-device tensors where JAX's gives
``ShapeDtypeStruct``s: the same kind of cell, the same argument trees, and
every leaf the same shape and dtype. No leaf holds memory (deepseek-v2's
236 B parameters and the 32K-token decode caches included).
"""

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch import steps as jsteps
from repro.models.config import ALL_SHAPES
from repro_torch import configs as tconfigs
from repro_torch.launch import steps as tsteps
from repro_torch.tree import tree_leaves, tree_map


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


@pytest.mark.parametrize("arch", tconfigs.all_archs())
def test_input_specs_match_jax(arch):
    cfg, jcfg = tconfigs.get_config(arch), jconfigs.get_config(arch)
    for shape in ALL_SHAPES:
        got = tsteps.input_specs(cfg, shape.name)
        want = jsteps.input_specs(jcfg, shape.name)
        assert got["kind"] == want["kind"] == shape.kind
        assert len(got["args"]) == len(want["args"])
        for a, b in zip(got["args"], want["args"]):
            # the same tree: containers, keys and None entries
            assert tree_map(lambda t: None, a) == jax.tree_util.tree_map(
                lambda t: None, b), (arch, shape.name)
            leaves, jleaves = tree_leaves(a), jax.tree_util.tree_leaves(b)
            assert len(leaves) == len(jleaves) > 0
            for t, s in zip(leaves, jleaves):
                assert isinstance(t, torch.Tensor) and t.is_meta
                assert tuple(t.shape) == tuple(s.shape), (arch, shape.name)
                assert _dtype_name(t) == np.dtype(s.dtype).name, \
                    (arch, shape.name, t.dtype, s.dtype)


def test_encdec_decode_cells_take_the_stub_memory_length():
    assert tsteps.ENC_LEN_FOR_DECODE == jsteps.ENC_LEN_FOR_DECODE == 4096
    cfg = tconfigs.get_config("seamless_m4t_medium")
    cache = tsteps.input_specs(cfg, "decode_32k")["args"][1]
    assert cache["xk"].shape[3] == 4096 and cache["k"].shape[3] == 32_768


def test_params_struct_refuses_to_draw_without_a_generator_off_meta():
    cfg = tconfigs.get_smoke_config("qwen2_0_5b")
    from repro_torch.models import init_params
    with pytest.raises(ValueError, match="only the meta device"):
        init_params(cfg, None, device="cpu")
    with pytest.raises(ValueError, match="only the meta device"):
        init_params(cfg, None)
