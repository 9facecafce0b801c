"""The port's RACE lookup ops (``repro_torch.kernels.race_lookup``) against
the JAX package's, on the same numpy inputs made from a seed.

On the CPU the port runs its plain PyTorch versions; the JAX side runs its
Pallas kernels in interpret mode (the ops default) and its oracle. Results
must be EXACTLY equal on finite tables: both select one stored row or zeros.
Two stated differences, each checked exactly by its own test: JAX's
one-hot product turns a non-finite value in ANY candidate slot into NaN,
while the port copies the stored row
(``test_non_finite_candidate_diverges_from_one_hot``); and for a hit in a
bucket reached through an out-of-range id, JAX's tiled kernel returns
another slot's row (``test_out_of_range_bucket_ids_clip_like_jax_tiled``).
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import jax.numpy as jnp

from repro.kernels.race_lookup import ops as jops
from repro.kernels.race_lookup.ref import make_table as jax_make_table
from repro.kernels.race_lookup.ref import race_lookup_ref as jax_ref
from repro_torch.kernels.race_lookup import ops, race_lookup as kern, ref
from repro_torch.kernels.race_lookup.ref import make_table

#: port impl -> the JAX impl that runs the same kernel
IMPL_PAIRS = [("kernel", "pallas"), ("tiled", "pallas_tiled"),
              ("scalar", "pallas_scalar"), ("ref", "ref")]


def _port(fp, vt, fps, bidx, impl="kernel", **kw):
    v, f = ops.race_lookup(fp, vt, fps, bidx, impl=impl, device="cpu", **kw)
    assert v.dtype == torch.float32 and f.dtype == torch.int32
    return v.numpy(), f.numpy()


def _equal(port, jax_out):
    np.testing.assert_array_equal(port[1], np.asarray(jax_out[1]))
    np.testing.assert_array_equal(port[0], np.asarray(jax_out[0]))


def _sweep_inputs(nb, nslot, vdim, nkeys):
    rng = np.random.RandomState(nb)
    keys = np.arange(1, nkeys + 1)
    vals = rng.randn(nkeys, vdim).astype(np.float32)
    fp, vt, prep = make_table(nb, nslot, vdim, keys, vals)
    qkeys = np.concatenate([keys[:50], np.arange(10_000, 10_020)])
    return (fp, vt, prep, keys, vals, qkeys)


@pytest.mark.parametrize("nb,nslot,vdim,nkeys", [
    (64, 8, 128, 200), (128, 4, 64, 100), (32, 16, 256, 300),
])
def test_make_table_matches_jax(nb, nslot, vdim, nkeys):
    fp, vt, prep, keys, vals, qkeys = _sweep_inputs(nb, nslot, vdim, nkeys)
    jfp, jvt, jprep = jax_make_table(nb, nslot, vdim, keys, vals)
    np.testing.assert_array_equal(fp, jfp)
    np.testing.assert_array_equal(vt, jvt)
    for a, b in zip(prep(qkeys), jprep(qkeys)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("port_impl,jax_impl", IMPL_PAIRS)
@pytest.mark.parametrize("nb,nslot,vdim,nkeys", [
    (64, 8, 128, 200), (128, 4, 64, 100), (32, 16, 256, 300),
])
def test_race_lookup_sweep_matches_jax(nb, nslot, vdim, nkeys, port_impl,
                                       jax_impl):
    fp, vt, prep, keys, vals, qkeys = _sweep_inputs(nb, nslot, vdim, nkeys)
    fps, bidx = prep(qkeys)
    port = _port(fp, vt, fps, bidx, impl=port_impl)
    _equal(port, jops.race_lookup(fp, vt, fps, bidx, impl=jax_impl))
    assert port[1][:50].all() and not port[1][50:].any()
    np.testing.assert_array_equal(port[0][:50], vals[:50])
    assert not port[0][50:].any()


@settings(max_examples=6, deadline=None)
@given(st.integers(1, 150), st.integers(0, 2 ** 20))
def test_race_lookup_hypothesis_matches_jax(nkeys, seed):
    rng = np.random.RandomState(seed % (2 ** 31))
    keys = rng.choice(np.arange(1, 10_000), size=nkeys, replace=False)
    vals = rng.randn(nkeys, 64).astype(np.float32)
    fp, vt, prep = make_table(256, 8, 64, keys, vals)
    fps, bidx = prep(rng.choice(np.arange(1, 10_000), size=32))
    port = _port(fp, vt, fps, bidx)
    _equal(port, jops.race_lookup(fp, vt, fps, bidx))
    _equal(port, jax_ref(fp, vt, fps, bidx))


@pytest.mark.parametrize("nq,qblock", [(1, 8), (7, 8), (64, 64), (65, 64),
                                       (130, 32)])
def test_ragged_tails_match_jax_tiled(nq, qblock):
    rng = np.random.RandomState(nq * 31 + qblock)
    nkeys, vdim = 150, 64
    keys = np.arange(1, nkeys + 1)
    vals = rng.randn(nkeys, vdim).astype(np.float32)
    fp, vt, prep = make_table(128, 8, vdim, keys, vals)
    fps, bidx = prep(rng.randint(1, 2 * nkeys, nq))
    _equal(_port(fp, vt, fps, bidx, impl="tiled", qblock=qblock),
           jops.race_lookup(fp, vt, fps, bidx, impl="pallas_tiled",
                            qblock=qblock))


def test_out_of_range_bucket_ids_clip_like_jax_tiled():
    """Bucket ids outside [0, NB) are clamped, as the JAX tiled kernel's
    ``mode="clip"`` clamps its fingerprint gather. Stated divergence: JAX
    clips the VALUE gather per flat slot (``row * NSLOT + s``), so a hit
    in a clamped bucket returns flat row 0 (id < 0) or the last flat row
    (id >= NB) instead of the slot that matched; the port returns the
    matched slot's row. Every other row agrees exactly."""
    rng = np.random.RandomState(3)
    nb, nslot, vdim = 32, 4, 16
    keys = np.arange(1, 60)
    vals = rng.randn(len(keys), vdim).astype(np.float32)
    fp, vt, prep = make_table(nb, nslot, vdim, keys, vals)
    qkeys = rng.choice(keys, 40)
    # the key stored in bucket 0's slot 1 and in bucket NB-1's slot 0,
    # each queried through an out-of-range id that clamps onto its bucket
    k0 = keys[(prep(keys)[0] == fp[0, 1])][0]
    k1 = keys[(prep(keys)[0] == fp[nb - 1, 0])][0]
    qkeys[:2] = k0, k1
    fps, bidx = prep(qkeys)
    bidx[2::2] = rng.randint(-7, nb + 7, bidx[2::2].shape)
    bidx[0] = [-3, 5 if bidx[0, 1] == 0 else bidx[0, 1]]
    bidx[1] = [nb + 2, 5 if bidx[1, 1] == nb - 1 else bidx[1, 1]]
    jv, jf = (np.asarray(a) for a in jops.race_lookup(
        fp, vt, fps, bidx, impl="pallas_tiled", qblock=8))
    flat = vt.reshape(nb * nslot, vdim)
    np.testing.assert_array_equal(jv[0], flat[0])          # JAX: slot 0
    np.testing.assert_array_equal(jv[1], flat[-1])         # JAX: last slot
    for impl in ("kernel", "scalar", "ref"):
        v, f = _port(fp, vt, fps, bidx, impl=impl)
        np.testing.assert_array_equal(f, jf)
        np.testing.assert_array_equal(v[0], vt[0, 1])      # matched slot
        np.testing.assert_array_equal(v[1], vt[nb - 1, 0])
        cb = np.clip(bidx, 0, nb - 1)
        cand = fp[cb].reshape(len(fps), 2 * nslot)
        hit = (cand == fps[:, None]) & (cand != 0)
        clamped_hit = (hit[:, :nslot].any(1) & (bidx[:, 0] != cb[:, 0])) | (
            ~hit[:, :nslot].any(1) & hit[:, nslot:].any(1)
            & (bidx[:, 1] != cb[:, 1]))
        assert clamped_hit[:2].all()
        np.testing.assert_array_equal(v[~clamped_hit], jv[~clamped_hit])


def test_bfloat16_table_keeps_dtype_and_matches_jax():
    rng = np.random.RandomState(5)
    keys = np.arange(1, 90)
    vals = rng.randn(len(keys), 32).astype(np.float32)
    fp, vt, prep = make_table(64, 8, 32, keys, vals)
    fps, bidx = prep(np.concatenate([keys[:40], np.arange(500, 520)]))
    vt_bf16 = torch.from_numpy(vt).to(torch.bfloat16)
    jax_vt = jnp.asarray(vt, dtype=jnp.bfloat16)
    want = {"pallas": jops.race_lookup(fp, jax_vt, fps, bidx),
            "ref": jops.race_lookup(fp, jax_vt, fps, bidx, impl="ref")}
    for impl in ("kernel", "scalar", "ref"):
        v, f = ops.race_lookup(torch.from_numpy(fp), vt_bf16,
                               torch.from_numpy(fps), torch.from_numpy(bidx),
                               impl=impl)
        assert v.dtype == torch.bfloat16 and f.dtype == torch.int32
        for jv, jf in want.values():
            np.testing.assert_array_equal(f.numpy(), np.asarray(jf))
            np.testing.assert_array_equal(
                v.float().numpy(), np.asarray(jv).astype(np.float32))


def test_int64_inputs_become_int32():
    rng = np.random.RandomState(8)
    keys = np.arange(1, 50)
    fp, vt, prep = make_table(32, 8, 8, keys,
                              rng.randn(len(keys), 8).astype(np.float32))
    fps, bidx = prep(keys)
    v64, f64 = ops.race_lookup(fp.astype(np.int64), vt, fps.astype(np.int64),
                               bidx.astype(np.int64), device="cpu")
    v32, f32 = ops.race_lookup(fp, vt, fps, bidx, device="cpu")
    assert f64.dtype == torch.int32
    assert torch.equal(v64, v32) and torch.equal(f64, f32)


def test_non_finite_candidate_diverges_from_one_hot():
    """A NaN or inf in a candidate slot that did NOT hit: JAX's one-hot
    product (0 * NaN) poisons the hit's row, the port copies the stored
    row. Stated divergence, kept visible rather than toleranced away."""
    keys = np.arange(1, 30)
    vals = np.arange(len(keys) * 4, dtype=np.float32).reshape(-1, 4)
    fp, vt, prep = make_table(8, 8, 4, keys, vals)
    fps, bidx = prep(keys)
    b = bidx[0, 0]
    empty = np.flatnonzero(fp[b] == 0)
    assert len(empty) > 0
    vt[b, empty[0]] = np.nan                   # an empty slot's value row
    v, f = _port(fp, vt, fps, bidx)
    assert np.isfinite(v).all()
    np.testing.assert_array_equal(v, vals)     # every key's stored row
    jv, jf = jops.race_lookup(fp, vt, fps, bidx, impl="ref")
    np.testing.assert_array_equal(f, np.asarray(jf))
    poisoned = (bidx == b).any(axis=1)
    assert np.isnan(np.asarray(jv)[poisoned]).all()
    np.testing.assert_array_equal(v[~poisoned], np.asarray(jv)[~poisoned])


# ---------------------------------------------------------------- sharded
def _sharded_inputs(ns, nb, nslot, vdim):
    rng = np.random.RandomState(ns * nb)
    fps_t, vals_t, preps, inserted = [], [], [], {}
    for s in range(ns):
        keys = rng.choice(np.arange(1, 5_000), size=nb * nslot // 4,
                          replace=False)
        vals = rng.randn(len(keys), vdim).astype(np.float32)
        fp, vt, prep = make_table(nb, nslot, vdim, keys, vals)
        fps_t.append(fp)
        vals_t.append(vt)
        preps.append(prep)
        inserted[s] = dict(zip((int(k) for k in keys), vals))
    # ragged shard loads; shard 0 gets NO queries
    qkeys, qsidx = [], []
    for s in range(1, ns):
        n_s = 5 + 11 * s
        qkeys.append(rng.choice(np.arange(1, 5_000), size=n_s))
        qsidx.append(np.full(n_s, s))
    qkeys = np.concatenate(qkeys)
    qsidx = np.concatenate(qsidx).astype(np.int32)
    order = rng.permutation(len(qkeys))
    qkeys, qsidx = qkeys[order], qsidx[order]
    fps = np.zeros(len(qkeys), np.int32)
    bidx = np.zeros((len(qkeys), 2), np.int32)
    for i, (k, s) in enumerate(zip(qkeys, qsidx)):
        f, b = preps[s](np.array([k]))
        fps[i], bidx[i] = f[0], b[0]
    return (np.stack(fps_t), np.stack(vals_t), fps, bidx, qsidx, qkeys,
            inserted)


@pytest.mark.parametrize("port_impl,jax_impl", [
    ("kernel", "pallas"), ("scalar", "pallas_scalar"), ("ref", "ref")])
@pytest.mark.parametrize("ns,nb,nslot,vdim", [
    (3, 64, 8, 64), (2, 32, 4, 128), (5, 16, 8, 32),
])
def test_race_lookup_sharded_matches_jax(ns, nb, nslot, vdim, port_impl,
                                         jax_impl):
    fpt, vtt, fps, bidx, sidx, qkeys, inserted = _sharded_inputs(
        ns, nb, nslot, vdim)
    v, f = ops.race_lookup_sharded(fpt, vtt, fps, bidx, sidx, impl=port_impl,
                                   qblock=16, device="cpu")
    assert v.dtype == torch.float32 and f.dtype == torch.int32
    _equal((v.numpy(), f.numpy()),
           jops.race_lookup_sharded(fpt, vtt, fps, bidx, sidx,
                                    impl=jax_impl, qblock=16))
    for i, (k, s) in enumerate(zip(qkeys, sidx)):
        if int(k) in inserted[s]:
            assert f[i] == 1
            np.testing.assert_array_equal(v[i].numpy(), inserted[s][int(k)])


@pytest.mark.parametrize("impl", ["kernel", "scalar", "ref"])
def test_race_lookup_sharded_empty(impl):
    fp = np.zeros((2, 8, 4), np.int32)
    vt = np.zeros((2, 8, 4, 16), np.float32)
    v, f = ops.race_lookup_sharded(fp, vt, np.zeros(0, np.int32),
                                   np.zeros((0, 2), np.int32),
                                   np.zeros(0, np.int32), impl=impl,
                                   device="cpu")
    jv, jf = jops.race_lookup_sharded(fp, vt, np.zeros(0, np.int32),
                                      np.zeros((0, 2), np.int32),
                                      np.zeros(0, np.int32))
    assert tuple(v.shape) == jv.shape == (0, 16)
    assert tuple(f.shape) == jf.shape == (0,)
    assert f.dtype == torch.int32 and v.dtype == torch.float32


def test_shard_id_out_of_range_raises_like_jax():
    fpt, vtt, fps, bidx, sidx, _, _ = _sharded_inputs(3, 16, 8, 8)
    bad = sidx.copy()
    bad[2] = 3
    with pytest.raises(IndexError):
        jops.race_lookup_sharded(fpt, vtt, fps, bidx, bad)
    for impl in ("kernel", "scalar", "ref"):
        with pytest.raises(IndexError):
            ops.race_lookup_sharded(fpt, vtt, fps, bidx, bad, impl=impl,
                                    device="cpu")
        with pytest.raises(IndexError):
            ops.race_lookup_sharded(fpt, vtt, fps, bidx,
                                    torch.from_numpy(bad - 4), impl=impl,
                                    device="cpu")


def test_unknown_impl_and_cpu_tensors_at_kernel_wrappers_raise():
    fp = torch.zeros((4, 2), dtype=torch.int32)
    vt = torch.zeros((4, 2, 3))
    q = torch.zeros(2, dtype=torch.int32)
    b = torch.zeros((2, 2), dtype=torch.int32)
    with pytest.raises(ValueError):
        ops.race_lookup(fp, vt, q, b, impl="pallas")
    with pytest.raises(ValueError):
        ops.race_lookup_sharded(fp[None], vt[None], q, b, q, impl="tiled")
    # the kernel wrappers never stand in the plain version for a CPU tensor
    with pytest.raises(ValueError, match="CUDA"):
        kern.race_lookup_tiled(fp, vt, q, b)
    with pytest.raises(ValueError, match="CUDA"):
        kern.race_lookup_scalar(fp, vt, q, b)
    with pytest.raises(ValueError, match="CUDA"):
        kern.race_lookup_sharded(fp[None], vt[None], q, b, q)


# ------------------------------------------ the sharded kernel's two routes
CAP = kern.BYVAL_CAP


@pytest.mark.parametrize("on_host", [True, False])
@pytest.mark.parametrize("nq", [1, CAP - 1, CAP, CAP + 1, 4096])
def test_sharded_route_dispatch(on_host, nq):
    """Host routing up to the cap goes by value; routing on the card, or
    longer, takes the device route."""
    route = kern.route("sharded", on_host, nq)
    assert route in kern.ROUTES["sharded"] and route in kern._SIGNATURES
    assert (route == "race_lookup_sharded_byval") == (on_host and nq <= CAP)


@pytest.mark.parametrize("as_tensor", [False, True])
def test_pack_routing_round_trips(as_tensor):
    rng = np.random.RandomState(5)
    nq = 37
    q = rng.randint(-2 ** 31, 2 ** 31 - 1, nq).astype(np.int32)
    b = rng.randint(-9, 2 ** 20, (nq, 2)).astype(np.int32)
    s = rng.randint(-2, 7, nq).astype(np.int32)
    args = [torch.from_numpy(a) for a in (q, b, s)] if as_tensor \
        else (q, b, s)
    routing = kern.pack_routing(*args)
    assert routing.dtype == np.int32 and routing.shape == (nq, 4)
    assert routing.flags.c_contiguous
    # the kernels read a query's row as one 16-byte int4: (x, y, z, w)
    x, y, z, w = (routing.view(np.dtype([(c, "<i4") for c in "xyzw"]))
                  .reshape(nq)[c] for c in "xyzw")
    np.testing.assert_array_equal(x, q)
    np.testing.assert_array_equal(np.stack([y, z], 1), b)
    np.testing.assert_array_equal(w, s)
    empty = kern.pack_routing(np.zeros(0, np.int32),
                              np.zeros((0, 2), np.int32),
                              np.zeros(0, np.int32))
    assert empty.shape == (0, 4)


def test_pack_routing_refuses_other_dtypes_and_shapes():
    q = np.zeros(4, np.int32)
    b = np.zeros((4, 2), np.int32)
    with pytest.raises(TypeError, match="int32"):
        kern.pack_routing(q.astype(np.int64), b, q)
    with pytest.raises(ValueError, match="bucket_idx"):
        kern.pack_routing(q, np.zeros((4, 3), np.int32), q)
    with pytest.raises(ValueError, match="shard_idx"):
        kern.pack_routing(q, b, q[:3])


@pytest.mark.parametrize("nslot", [4, 8, 16, 32])
@pytest.mark.parametrize("nq", [1, 7, CAP - 1, CAP, CAP + 1])
def test_sharded_plain_matches_jax_at_route_edges(nslot, nq):
    """The plain version at the batch sizes around the by-value cap, held
    against JAX's oracle over the flattened shards. Fingerprints come from
    a small range, so slots repeat and many are empty."""
    rng = np.random.RandomState(nslot * 10_000 + nq)
    ns, nb, vdim = 3, 16, 8
    fp = rng.randint(0, 40, (ns, nb, nslot)).astype(np.int32)
    vt = rng.randn(ns, nb, nslot, vdim).astype(np.float32)
    q = rng.randint(0, 40, nq).astype(np.int32)
    b = rng.randint(0, nb, (nq, 2)).astype(np.int32)
    s = rng.randint(0, ns, nq).astype(np.int32)
    v, f = ops.race_lookup_sharded(fp, vt, q, b, s, device="cpu")
    _equal((v.numpy(), f.numpy()),
           jax_ref(jnp.asarray(fp.reshape(ns * nb, nslot)),
                   jnp.asarray(vt.reshape(ns * nb, nslot, vdim)),
                   jnp.asarray(q), jnp.asarray(b + s[:, None] * nb)))
    assert 0 < int(f.sum()) < nq or nq < 8


# -------------------------- the tiled and scalar kernels' two routes
@pytest.mark.parametrize("kernel", ["tiled", "scalar"])
@pytest.mark.parametrize("on_host", [True, False])
@pytest.mark.parametrize("nq", [1, CAP - 1, CAP, CAP + 1, 4096])
def test_route_dispatch(kernel, on_host, nq):
    """As for the sharded kernel: host routing up to the cap goes by value,
    routing on the card or longer takes the device route; every route has
    its own C entry point."""
    route = kern.route(kernel, on_host, nq)
    assert route in kern.ROUTES[kernel] and route in kern._SIGNATURES
    assert (route == f"race_lookup_{kernel}_byval") == (on_host and nq <= CAP)
    assert len(set(kern._SIGNATURES)) == 6


@pytest.mark.parametrize("as_tensor", [False, True])
def test_pack_unsharded_routing(as_tensor):
    """The tiled kernel's routing carries shard 0 (the sharded kernel at one
    shard); the scalar kernel's carries each query's output row."""
    rng = np.random.RandomState(6)
    nq = 29
    q = rng.randint(-2 ** 31, 2 ** 31 - 1, nq).astype(np.int32)
    b = rng.randint(-9, 2 ** 20, (nq, 2)).astype(np.int32)
    args = [torch.from_numpy(a) for a in (q, b)] if as_tensor else (q, b)
    tiled = kern.pack_routing(*args)
    assert tiled.dtype == np.int32 and tiled.shape == (nq, 4)
    np.testing.assert_array_equal(tiled[:, 0], q)
    np.testing.assert_array_equal(tiled[:, 1:3], b)
    assert not tiled[:, 3].any()
    scalar = kern._routing(None, *args, rows=True)
    np.testing.assert_array_equal(scalar[:, :3], tiled[:, :3])
    np.testing.assert_array_equal(scalar[:, 3], np.arange(nq))
    sharded = kern._routing(None, *args, np.full(nq, 2, np.int32))
    assert (sharded[:, 3] == 2).all()


def test_pack_unsharded_routing_refuses_other_dtypes_and_shapes():
    q = np.zeros(4, np.int32)
    b = np.zeros((4, 2), np.int32)
    with pytest.raises(TypeError, match="int32"):
        kern.pack_routing(q, b.astype(np.int64))
    with pytest.raises(TypeError, match="int32"):
        kern.pack_routing(q, b, np.arange(4))
    with pytest.raises(ValueError, match="bucket_idx"):
        kern.pack_routing(q, b[:3])
    with pytest.raises(ValueError, match="queries"):
        kern.pack_routing(q[:, None], b)
    with pytest.raises(ValueError, match="all on the card or all"):
        kern._routing(None, q, torch.zeros((4, 2), dtype=torch.int32,
                                           device="meta"))


@settings(max_examples=25, deadline=None)
@given(st.lists(st.integers(0, 40), min_size=1, max_size=6),
       st.integers(0, 2 ** 20))
def test_split_by_shard_keeps_jax_order(counts, seed):
    """Shard counts from hypothesis (zeros included: shards without
    queries): the output rows of all parts form a permutation of
    range(NQ), each part holds one shard's queries in input order (JAX's
    ``s == sid`` mask), and the parts come by ascending shard."""
    rng = np.random.RandomState(seed % (2 ** 31))
    sidx = np.repeat(np.arange(len(counts)), counts).astype(np.int32)
    rng.shuffle(sidx)
    nq = len(sidx)
    q = rng.randint(-2 ** 31, 2 ** 31 - 1, nq).astype(np.int32)
    b = rng.randint(-5, 100, (nq, 2)).astype(np.int32)
    parts = kern.split_by_shard(q, b, sidx)
    assert [sid for sid, _ in parts] == [s for s, n in enumerate(counts)
                                         if n]
    rows = np.concatenate([r[:, 3] for _, r in parts]) if parts \
        else np.zeros(0, np.int32)
    np.testing.assert_array_equal(np.sort(rows), np.arange(nq))
    for sid, r in parts:
        assert r.dtype == np.int32 and r.flags.c_contiguous
        np.testing.assert_array_equal(r[:, 3], np.flatnonzero(sidx == sid))
        np.testing.assert_array_equal(r[:, 0], q[sidx == sid])
        np.testing.assert_array_equal(r[:, 1:3], b[sidx == sid])


def test_routed_plain_version_writes_the_named_rows():
    rng = np.random.RandomState(2)
    keys = np.arange(1, 40)
    vals = rng.randn(len(keys), 8).astype(np.float32)
    fp, vt, prep = make_table(16, 4, 8, keys, vals)
    fps, bidx = prep(np.concatenate([keys[:12], [500, 501]]))
    rows = rng.permutation(20)[:14].astype(np.int32)
    values = torch.full((20, 8), 7.0)
    found = torch.full((20,), 9, dtype=torch.int32)
    ref.race_lookup_routed_ref(torch.from_numpy(fp), torch.from_numpy(vt),
                               kern.pack_routing(fps, bidx, rows), values,
                               found)
    want_v, want_f = _port(fp, vt, fps, bidx, impl="ref")
    np.testing.assert_array_equal(values[rows].numpy(), want_v)
    np.testing.assert_array_equal(found[rows].numpy(), want_f)
    untouched = np.setdiff1d(np.arange(20), rows)
    assert (values[untouched] == 7.0).all() and (found[untouched] == 9).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ns,nb,nslot,vdim", [(3, 64, 8, 64), (5, 16, 8, 32),
                                              (4, 32, 16, 24)])
def test_sharded_scalar_goes_through_the_split_like_jax(monkeypatch, dtype,
                                                        ns, nb, nslot, vdim):
    """``impl="scalar"`` on the CPU: the host split, then one plain call a
    shard with queries, equal to JAX's ``"pallas_scalar"`` (its scalar
    kernel in interpret mode, one call a shard) exactly, in float32 and
    bf16; shard 0 gets no queries."""
    fpt, vtt, fps, bidx, sidx, _, _ = _sharded_inputs(ns, nb, nslot, vdim)
    calls = []
    split = kern.split_by_shard

    def spy(*a):
        calls.append(split(*a))
        return calls[-1]

    monkeypatch.setattr(kern, "split_by_shard", spy)
    port_vt = torch.from_numpy(vtt).to(getattr(torch, dtype))
    jax_vt = jnp.asarray(vtt, dtype=getattr(jnp, dtype))
    for routing in ((fps, bidx, sidx),
                    tuple(torch.from_numpy(a) for a in (fps, bidx, sidx))):
        v, f = ops.race_lookup_sharded(torch.from_numpy(fpt), port_vt,
                                       *routing, impl="scalar")
        assert v.dtype == port_vt.dtype and f.dtype == torch.int32
        jv, jf = jops.race_lookup_sharded(fpt, jax_vt, fps, bidx, sidx,
                                          impl="pallas_scalar")
        np.testing.assert_array_equal(f.numpy(), np.asarray(jf))
        np.testing.assert_array_equal(v.float().numpy(),
                                      np.asarray(jv).astype(np.float32))
    assert len(calls) == 2
    assert [sid for sid, _ in calls[0]] == list(range(1, ns))
