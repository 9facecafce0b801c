"""The port's payload-staging ops (``repro_torch.kernels.serverless_stage``)
against the JAX package's: the routing planners, the chunk gather (JAX
through its Pallas kernel in interpret mode, as tests/test_serverless.py
runs it, and through its jnp oracle), and the pack/unpack round trip.

Tolerance: exact. Every path is integer: planners, gather and slabs must
be equal element for element.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.kernels.serverless_stage import ops as jops
from repro.kernels.serverless_stage.ref import (chunk_gather_ref as
                                                jchunk_gather_ref)
from repro.kernels.serverless_stage.ref import pack_ref as jpack_ref
from repro_torch.kernels import _build
from repro_torch.kernels.serverless_stage import ops
from repro_torch.kernels.serverless_stage.ref import (chunk_gather_ref,
                                                      pack_ref)
from repro_torch.kernels.serverless_stage.stage import (
    BYVAL_CAP, CHUNK, ROUTES, _SIGNATURES, chunk_gather_cuda, gather_route)

LENGTHS = [[], [0], [0, 0], [1], [127, 128, 129], [513, 0, 1, 300],
           [128] * 5, [1000, 3, 256, 0, 77]]


def _gather_case(seed, nsrc, nout, chunk, lo=-3, hi=None):
    rng = np.random.RandomState(seed)
    src = rng.randint(-2 ** 31, 2 ** 31 - 1, (nsrc, chunk)).astype(np.int32)
    hi = nsrc + 3 if hi is None else hi
    src_row = rng.randint(lo, hi, nout).astype(np.int32)
    valid = rng.choice([-5, 0, 1, 2, 3, 4, 5, chunk // 2, chunk - 1, chunk,
                        chunk + 1, 4 * chunk], nout).astype(np.int32)
    return src, src_row, valid


def _jax_gather(src, src_row, valid, impl, chunk):
    return np.asarray(jops.chunk_gather(src, src_row, valid, impl=impl,
                                        chunk=chunk))


# ================================================================ planners
@pytest.mark.parametrize("lengths", LENGTHS, ids=str)
@pytest.mark.parametrize("chunk", [128, 4, 6])
def test_planners_match_reference(lengths, chunk):
    np.testing.assert_array_equal(ops.n_chunks(lengths, chunk),
                                  jops.n_chunks(lengths, chunk))
    s_port, t_port = ops.slab_offsets(lengths, chunk)
    s_ref, t_ref = jops.slab_offsets(lengths, chunk)
    np.testing.assert_array_equal(s_port, s_ref)
    assert s_port.dtype == s_ref.dtype and t_port == t_ref
    lmax = max(lengths, default=0)
    for plan in ("pack_plan", "unpack_plan"):
        for got, want in zip(getattr(ops, plan)(lengths, lmax, chunk),
                             getattr(jops, plan)(lengths, lmax, chunk)):
            np.testing.assert_array_equal(got, want)
            assert got.dtype == want.dtype == np.int32


# ============================================================ chunk gather
@pytest.mark.parametrize("nsrc,nout,chunk", [
    (9, 5, 128), (1, 7, 128), (5, 40, 128), (12, 1, 128), (3, 17, 6),
    (7, 9, 1), (4, 11, 36)])
def test_chunk_gather_matches_pallas_and_oracle(nsrc, nout, chunk):
    """Random ids include negatives and ids >= NSRC with valid > 0, valid
    <= 0, valid above the chunk and repeated rows."""
    src, src_row, valid = _gather_case(nsrc * 100 + nout, nsrc, nout, chunk)
    got = ops.chunk_gather(src, src_row, valid, chunk=chunk, device="cpu")
    assert got.dtype == torch.int32 and tuple(got.shape) == (nout, chunk)
    np.testing.assert_array_equal(got.numpy(),
                                  _jax_gather(src, src_row, valid, "pallas",
                                              chunk))
    np.testing.assert_array_equal(got.numpy(),
                                  _jax_gather(src, src_row, valid, "ref",
                                              chunk))
    plain = ops.chunk_gather(src, src_row, valid, impl="ref", chunk=chunk,
                             device="cpu")
    assert torch.equal(got, plain)


def test_chunk_gather_matches_reference_test_case():
    """The case of tests/test_serverless.py, through both packages."""
    rng = np.random.RandomState(3)
    src = rng.randint(0, 1 << 30, (9, 128)).astype(np.int32)
    src_row = np.array([8, 0, 3, 3, 5], np.int32)
    valid = np.array([128, 0, 64, 128, 1], np.int32)
    got = ops.chunk_gather(src, src_row, valid, device="cpu").numpy()
    np.testing.assert_array_equal(got, _jax_gather(src, src_row, valid,
                                                   "pallas", 128))
    np.testing.assert_array_equal(got,
                                  np.asarray(jchunk_gather_ref(src, src_row,
                                                               valid)))


def test_out_of_range_ids_wrap_once_then_clamp_like_jax():
    """The contract for ids outside [0, NSRC) with valid > 0. JAX's Pallas
    kernel (interpret mode) and its oracle agree: a negative id wraps once
    (+ NSRC), then the id is clamped to [0, NSRC-1]. The port does the
    same; this pins every branch of it."""
    nsrc = 5
    src = (np.arange(nsrc * 128, dtype=np.int32).reshape(nsrc, 128) + 1)
    ids = np.array([-1, -2, -5, -6, -2 ** 31, 5, 6, 100, 2 ** 31 - 1],
                   np.int32)
    want_rows = [4, 3, 0, 0, 0, 4, 4, 4, 4]
    valid = np.full(len(ids), 128, np.int32)
    got = ops.chunk_gather(src, ids, valid, device="cpu").numpy()
    np.testing.assert_array_equal(got, src[want_rows])
    np.testing.assert_array_equal(got, _jax_gather(src, ids, valid,
                                                   "pallas", 128))
    np.testing.assert_array_equal(got, _jax_gather(src, ids, valid, "ref",
                                                   128))


def test_valid_extremes():
    src = np.arange(2 * 128, dtype=np.int32).reshape(2, 128) + 7
    rows = np.array([0, 1, 0, 1, 0, 1], np.int32)
    valid = np.array([-3, 0, 1, 64, 200, 129], np.int32)
    got = ops.chunk_gather(src, rows, valid, device="cpu").numpy()
    assert (got != 0).sum(1).tolist() == [0, 0, 1, 64, 128, 128]
    np.testing.assert_array_equal(got, _jax_gather(src, rows, valid,
                                                   "pallas", 128))


def test_empty_nout_and_empty_source():
    src = np.ones((3, 128), np.int32)
    out = ops.chunk_gather(src, np.zeros(0, np.int32), np.zeros(0, np.int32),
                           device="cpu")
    assert tuple(out.shape) == (0, 128) and out.dtype == torch.int32
    assert _jax_gather(src, np.zeros(0, np.int32), np.zeros(0, np.int32),
                       "pallas", 128).shape == (0, 128)
    # NSRC == 0 has no row to gather: JAX raises, and so does the port
    empty = np.zeros((0, 128), np.int32)
    rows, valid = np.array([0], np.int32), np.array([0], np.int32)
    with pytest.raises(TypeError):
        _jax_gather(empty, rows, valid, "pallas", 128)
    with pytest.raises(ValueError, match="no rows"):
        ops.chunk_gather(empty, rows, valid, device="cpu")
    out = ops.chunk_gather(empty, np.zeros(0, np.int32),
                           np.zeros(0, np.int32), device="cpu")
    assert tuple(out.shape) == (0, 128)


def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    src, src_row, valid = _gather_case(1, 6, 10, 128)
    _build.launches.clear()
    got = ops.chunk_gather(torch.from_numpy(src), torch.from_numpy(src_row),
                           torch.from_numpy(valid))
    assert not _build.launches
    assert torch.equal(got, chunk_gather_ref(torch.from_numpy(src),
                                             torch.from_numpy(src_row),
                                             torch.from_numpy(valid)))


def test_kernel_wrapper_refuses_cpu_tensors_and_bad_inputs():
    src = torch.zeros((4, CHUNK), dtype=torch.int32)
    rows = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        chunk_gather_cuda(src, rows, rows)
    with pytest.raises(ValueError, match="unknown impl"):
        ops.chunk_gather(src, rows, rows, impl="pallas")


def test_numpy_inputs_default_to_the_card():
    src, src_row, valid = _gather_case(2, 4, 4, 128)
    if torch.cuda.is_available():
        assert ops.chunk_gather(src, src_row, valid).is_cuda
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ops.chunk_gather(src, src_row, valid)


# =========================================================== pack / unpack
@st.composite
def ragged_lengths(draw):
    k = draw(st.integers(1, 12))
    lmax = draw(st.sampled_from([1, 100, 128, 300, 513]))
    lengths = [draw(st.integers(0, lmax)) for _ in range(k)]
    return lmax, lengths


@settings(max_examples=15, deadline=None)
@given(ragged_lengths())
def test_stage_pack_unpack_match_reference(cfg):
    lmax, lengths = cfg
    rng = np.random.RandomState(sum(lengths) + lmax)
    k = len(lengths)
    payloads = rng.randint(0, 1 << 30, (k, lmax)).astype(np.int32)
    slab, starts = ops.stage_pack(payloads, lengths, device="cpu")
    jslab, jstarts = jops.stage_pack(payloads, lengths)
    np.testing.assert_array_equal(slab, jslab)
    np.testing.assert_array_equal(starts, jstarts)
    assert slab.dtype == np.int32 and starts.dtype == jstarts.dtype
    np.testing.assert_array_equal(slab, pack_ref(payloads, lengths)
                                  .reshape(-1))
    np.testing.assert_array_equal(pack_ref(payloads, lengths),
                                  jpack_ref(payloads, lengths))
    out = ops.stage_unpack(slab, lengths, lmax, device="cpu")
    np.testing.assert_array_equal(out, jops.stage_unpack(jslab, lengths,
                                                         lmax))
    assert out.shape == (k, lmax) and out.dtype == np.int32
    for i, n in enumerate(lengths):
        np.testing.assert_array_equal(out[i, :n], payloads[i, :n])
        assert not out[i, n:].any()          # ragged tail zeroed


@pytest.mark.parametrize("lengths", LENGTHS, ids=str)
def test_stage_pack_unpack_edge_lengths_match_reference(lengths):
    lmax = max(lengths, default=4)
    rng = np.random.RandomState(len(lengths))
    payloads = rng.randint(0, 1 << 30, (len(lengths), lmax)).astype(np.int32)
    slab, starts = ops.stage_pack(payloads, lengths, device="cpu")
    jslab, jstarts = jops.stage_pack(payloads, lengths)
    np.testing.assert_array_equal(slab, jslab)
    np.testing.assert_array_equal(starts, jstarts)
    out = ops.stage_unpack(slab, lengths, lmax, device="cpu")
    np.testing.assert_array_equal(out, jops.stage_unpack(jslab, lengths,
                                                         lmax))
    if len(slab):
        with pytest.raises(ValueError, match="slab too small"):
            ops.stage_unpack(slab[:-1], lengths, lmax, device="cpu")


# ================================================ the gather's two routes
@pytest.mark.parametrize("on_host", [True, False])
@pytest.mark.parametrize("nout", [1, BYVAL_CAP - 1, BYVAL_CAP,
                                  BYVAL_CAP + 1, 131_072])
def test_gather_route_dispatch(on_host, nout):
    """Host routing up to the cap goes by value; routing on the card, or
    longer (64 x 1 MiB is 131,072 chunks), takes the device route."""
    route = gather_route(on_host, nout)
    assert route in ROUTES and route in _SIGNATURES
    assert (route == "chunk_gather_byval") == (on_host and nout <= BYVAL_CAP)


def test_every_chain_gather_fits_the_by_value_route():
    """A slab of 16 payloads of up to 64 KiB (the chain's largest) packs and
    unpacks in at most BYVAL_CAP chunks."""
    elems = 64 * 1024 // 4
    for plan in (ops.pack_plan, ops.unpack_plan):
        src_row, valid = plan(np.full(16, elems), elems)
        assert len(src_row) == len(valid) == BYVAL_CAP
        assert gather_route(True, len(src_row)) == "chunk_gather_byval"


@pytest.mark.parametrize("nout", [1, 9, BYVAL_CAP - 1, BYVAL_CAP,
                                  BYVAL_CAP + 1])
def test_chunk_gather_plain_matches_jax_at_route_edges(nout):
    src, src_row, valid = _gather_case(nout, 37, nout, CHUNK)
    got = ops.chunk_gather(src, src_row, valid, device="cpu")
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jchunk_gather_ref(src, src_row, valid)))


def test_kernel_wrapper_refuses_host_routing_that_is_not_int32():
    src = torch.zeros((4, CHUNK), dtype=torch.int32)
    rows = np.zeros(2, np.int64)
    with pytest.raises(TypeError, match="int32"):
        chunk_gather_cuda(src, rows, rows.astype(np.int32))
    with pytest.raises(ValueError, match="CUDA tensor"):
        chunk_gather_cuda(src, rows.astype(np.int32), rows.astype(np.int32))
