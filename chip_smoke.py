#!/usr/bin/env python3
"""Drive the PyTorch port's two device paths on one CUDA card: the device
RACE-table lookup and the serverless chain hop.

Run from the repository root, on a machine with one CUDA card and the CUDA
toolkit (``nvcc``):

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing falls back to the CPU or to a
plain version):

1. Device report: the card's name and power limit from ``nvidia-smi``.
2. Build: compile every CUDA source of the port (``race_lookup.cu`` and
   ``serverless_stage.cu``; one ``nvcc`` per source, started together) and
   print each ``-Xptxas -v`` report.
3. Kernel parity: each kernel against its plain PyTorch version on the
   card, exact. The lookup kernels: values and ``found`` at the test shapes
   (NSLOT 4/8/16/32, ragged tails, NQ = 0), out-of-range bucket ids, empty
   and ragged shards, float32 and bfloat16 value tables. ``chunk_gather``:
   NOUT 0, 1 and ragged; ``valid`` 0, 1, 64, 127, 128, above 128 and
   negative; repeated rows, NSRC = 1, ids outside [0, NSRC) (a negative id
   wraps once, then ids clamp, as in JAX), other chunk sizes and an
   unaligned source (the scalar path); and ``stage_pack`` /
   ``stage_unpack`` round trips over payloads of 0, 1, 127, 128, 129 and
   513 elements, equal to the same calls on the CPU.
4. Lookup path at real size: a ``DeviceRaceTable`` of 524,287 buckets x 8
   slots x 256 float32 (1 KiB values, the YCSB core record of 10 fields x
   100 B; 4.0 GiB of values) loaded with 1,000,000 keys, then YCSB
   workload C (100% reads, Zipfian theta 0.99) in ``lookup_batch`` calls of
   64, 512 and 4,096 keys plus 4,096 keys never loaded, and the 4,096 batch
   through ``impl="scalar"``; every result equals the inserted value and
   the plain version. Then the same through a 4 x 131,071-bucket
   ``ShardedDeviceRaceTable``. Bucket counts are prime: the reference's
   ``_h1`` and ``shard_of_key`` share a multiplier, and with 4 shards and a
   bucket count divisible by 4 each shard's first choice reaches only a
   quarter of its buckets. Launch counters are cleared just before each
   table's run and read just after.
5. Lookup kernel times: per kernel and batch size, the device time per
   launch from CUDA events over many launches queued behind a spin kernel,
   the plain version's time the same way, the host time of
   ``lookup_batch`` (median and 90th percentile of 200 calls), and the
   bound (bytes the batch needs over 3.35 TB/s).
6. Chain path at real size: ``ChainRunner(..., "krcore", device=cuda)`` over
   ``make_cluster(n_nodes=3, n_meta=1)``, stages extract -> transform ->
   load on n0 -> n1 -> n2 with ``default_registry``: the chain suite's
   cells of ``benchmarks/serverless.py`` (K = 8, 32, 64 payloads of 1 KiB,
   16 payloads a slab), two epochs on one runner of K = 64 payloads
   log-uniform from 1 B to 64 KiB (the second reuses the cached listener
   and session), and a failover epoch (n1 dies; the hop retries on n3).
   Every output equals ``expected_outputs`` byte for byte, and every
   ``ChainReport`` field equals the same epochs run with ``device="cpu"``.
   Gates (``check_gates`` of ``benchmarks/serverless.py``): doorbells per
   hop <= ceil(K/16), and the krcore ``transfer_us`` >= 90% below the verbs
   transport's for the 1 KiB cells. The simulated microseconds of a
   ``ChainReport`` are the cost model's (the paper's constants), not times
   on any chip. Launch counters are cleared just before the card's epochs
   and read just after.
7. Chain times: ``chunk_gather``'s device time per launch on a 16 x 1 KiB
   slab, a 16 x 64 KiB slab and, beyond the chain's sizes, 64 x 1 MiB,
   beside the plain version's, ``index_select``'s (the same gather without
   the mask) and the bound; the host time of ``encode_slab`` and
   ``decode_slab`` (median and 90th percentile of 200 calls) with a
   breakdown by step; the wall time of a chain epoch; and the card's busy
   share of one epoch from ``torch.profiler``.
8. A ``{"kernels": [...]}`` line, then as the last line
   ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import gc
import itertools
import math
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.core import WorkRequest, make_cluster  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.race_lookup import ops  # noqa: E402
from repro_torch.kernels.race_lookup import race_lookup as kern  # noqa: E402
from repro_torch.kernels.race_lookup.ref import (  # noqa: E402
    make_table, race_lookup_ref, race_lookup_sharded_ref)
from repro_torch.kernels.serverless_stage import (  # noqa: E402
    ops as stage_ops)
from repro_torch.kernels.serverless_stage.ref import (  # noqa: E402
    chunk_gather_ref)
from repro_torch.kernels.serverless_stage.stage import (  # noqa: E402
    CHUNK, chunk_gather_cuda)
from repro_torch.kvs.race import (  # noqa: E402
    DeviceRaceTable, ShardedDeviceRaceTable, query_hashes, query_shards)
from repro_torch.serverless import (  # noqa: E402
    ChainRunner, ContainerPool, decode_slab, default_registry, encode_slab,
    expected_outputs)

HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
SOURCES = {
    "race_lookup_tiled":
        "src/repro_torch/kernels/race_lookup/csrc/race_lookup.cu",
    "race_lookup_scalar":
        "src/repro_torch/kernels/race_lookup/csrc/race_lookup.cu",
    "race_lookup_sharded":
        "src/repro_torch/kernels/race_lookup/csrc/race_lookup.cu",
    "chunk_gather":
        "src/repro_torch/kernels/serverless_stage/csrc/serverless_stage.cu",
}
REPLACES = {
    "race_lookup_tiled": "src/repro/kernels/race_lookup/race_lookup.py:167",
    "race_lookup_scalar": "src/repro/kernels/race_lookup/race_lookup.py:76",
    "race_lookup_sharded": "src/repro/kernels/race_lookup/race_lookup.py:226",
    "chunk_gather": "src/repro/kernels/serverless_stage/stage.py:44",
}
#: the deployment the main path runs (see the module docstring)
REAL_SIZE = dict(n_buckets=524_287, shard_buckets=131_071, n_shards=4,
                 nslot=8, vdim=256, n_keys=1_000_000,
                 batches=(64, 512, 4096), reps=8, seed=0)
CHAIN = ("extract", "transform", "load")
#: the chain path: the chain cells of ``benchmarks/serverless.py``'s suite,
#: and a ragged epoch up to the largest payload its transfer suite measures
CHAIN_SIZE = dict(ks=(8, 32, 64), payload_bytes=1024, slab_payloads=16,
                  ragged_k=64, ragged_max_bytes=64 * 1024, seed=0)


class PhaseError(RuntimeError):
    pass


def check(cond, what: str) -> None:
    if not cond:
        raise PhaseError(what)


# ------------------------------------------------------ 1. device report
def device_report() -> None:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"device_count {torch.cuda.device_count()}; "
          f"{torch.cuda.get_device_name(0)}")


# ---------------------------------------------------------------- 2. build
def build_kernels() -> None:
    t0 = time.perf_counter()
    reports = _build.build_all()
    print(f"build: {sorted(reports)} in {time.perf_counter() - t0:.1f} s")
    for name, log in reports.items():
        print(f"--- ptxas report of {name}")
        print(log.strip())


# --------------------------------------------------------------- 3. parity
def _table(rng, nb, nslot, vdim, nkeys, seed=7):
    keys = rng.choice(np.arange(1, 50_000), size=nkeys, replace=False)
    vals = rng.standard_normal((nkeys, vdim)).astype(np.float32)
    fp, vt, prep = make_table(nb, nslot, vdim, keys, vals, seed=seed)
    return fp, vt, prep, keys


def _same(got, want, errs, name, what):
    (gv, gf), (wv, wf) = got, want
    check(gv.dtype == wv.dtype and gf.dtype == torch.int32,
          f"{name} {what}: dtypes {gv.dtype}/{gf.dtype}")
    check(gv.shape == wv.shape and gf.shape == wf.shape,
          f"{name} {what}: shapes {tuple(gv.shape)}/{tuple(wv.shape)}")
    err = (gv.float() - wv.float()).abs().max().item() if gv.numel() else 0.0
    errs[name] = max(errs.get(name, 0.0), err)
    check(torch.equal(gv, wv) and torch.equal(gf, wf),
          f"{name} {what}: differs from the plain version (max abs err "
          f"{err})")


def kernel_parity(device) -> dict:
    """Each kernel against its plain version on ``device``; returns the
    largest absolute difference seen per kernel (0.0: exact)."""
    rng = np.random.default_rng(1)
    errs: dict = {}
    cases = 0
    for nslot, vdim, dtype in ((4, 64, torch.float32), (8, 128, torch.float32),
                               (16, 256, torch.float32),
                               (32, 64, torch.float32),
                               (8, 256, torch.bfloat16),
                               (8, 33, torch.bfloat16), (4, 3, torch.float32)):
        nb = 64
        fp, vt, prep, keys = _table(rng, nb, nslot, vdim, nb * nslot // 3)
        fp_t = torch.from_numpy(fp).to(device)
        vt_t = torch.from_numpy(vt).to(device, dtype)
        for nq, qblock in ((0, 64), (1, 8), (7, 8), (64, 64), (65, 64),
                           (130, 32), (1000, 64)):
            qk = np.concatenate([keys, rng.integers(50_000, 60_000, nq)])
            qk = rng.choice(qk, size=nq)
            fps, bidx = prep(qk)
            if nq and nq % 2:                      # out-of-range bucket ids
                bidx[::3] = rng.integers(-5, nb + 5, bidx[::3].shape)
            q_t = torch.from_numpy(fps).to(device)
            b_t = torch.from_numpy(bidx).to(device)
            want = race_lookup_ref(fp_t, vt_t, q_t, b_t)
            what = f"nslot={nslot} vdim={vdim} {dtype} nq={nq}"
            _same(kern.race_lookup_tiled(fp_t, vt_t, q_t, b_t, qblock=qblock),
                  want, errs, "race_lookup_tiled", what)
            _same(kern.race_lookup_scalar(fp_t, vt_t, q_t, b_t), want, errs,
                  "race_lookup_scalar", what)
            cases += 1
    for ns, nb, nslot, vdim, dtype in ((3, 64, 8, 64, torch.float32),
                                       (5, 16, 8, 32, torch.float32),
                                       (4, 32, 16, 128, torch.bfloat16)):
        tabs = [_table(rng, nb, nslot, vdim, nb * nslot // 4)
                for _ in range(ns)]
        fp_t = torch.from_numpy(np.stack([t[0] for t in tabs])).to(device)
        vt_t = torch.from_numpy(np.stack([t[1] for t in tabs])).to(device,
                                                                   dtype)
        for counts in ([0] * ns, [0] + [5 + 11 * s for s in range(1, ns)],
                       [300] + [0] * (ns - 2) + [1]):
            sidx = np.repeat(np.arange(ns), counts).astype(np.int32)
            rng.shuffle(sidx)
            fps = np.zeros(len(sidx), np.int32)
            bidx = np.zeros((len(sidx), 2), np.int32)
            for i, s in enumerate(sidx):
                pool = np.concatenate([tabs[s][3], [70_000 + i]])
                f, b = tabs[s][2](np.array([rng.choice(pool)]))
                fps[i], bidx[i] = f[0], b[0]
            if len(sidx):
                bidx[::4] = rng.integers(-3, nb + 3, bidx[::4].shape)
            q_t, b_t, s_t = (torch.from_numpy(a).to(device)
                             for a in (fps, bidx, sidx))
            want = race_lookup_sharded_ref(fp_t, vt_t, q_t, b_t, s_t)
            _same(kern.race_lookup_sharded(fp_t, vt_t, q_t, b_t, s_t,
                                           qblock=16),
                  want, errs, "race_lookup_sharded",
                  f"ns={ns} counts={counts} {dtype}")
            cases += 1
    torch.cuda.synchronize(device)
    print(f"parity: {cases} cases, every kernel equal to its plain version "
          f"(max abs err {errs})")
    return errs


def stage_parity(device) -> float:
    """``chunk_gather`` against its plain version on ``device``, and the
    pack/unpack ops against the same calls on the CPU; exact. Returns the
    largest absolute difference seen (0: exact)."""
    rng = np.random.default_rng(2)
    err = 0
    cases = 0

    def one(src, rows, valid, chunk, what, want_rows=None):
        nonlocal err, cases
        if isinstance(src, np.ndarray):
            src = torch.from_numpy(src).to(device)
        rows, valid = (torch.from_numpy(np.asarray(a, np.int32)).to(device)
                       for a in (rows, valid))
        got = chunk_gather_cuda(src, rows, valid, chunk=chunk)
        want = chunk_gather_ref(src, rows, valid, chunk=chunk)
        check(got.dtype == torch.int32 and got.shape == want.shape,
              f"chunk_gather {what}: {got.dtype} {tuple(got.shape)}")
        if got.numel():
            err = max(err, int((got.long() - want.long()).abs().max()))
        check(torch.equal(got, want),
              f"chunk_gather {what}: differs from the plain version")
        if want_rows is not None:
            check(torch.equal(got, src[want_rows]),
                  f"chunk_gather {what}: rows resolved wrongly")
        cases += 1

    def draw(nsrc, nout, chunk):
        src = rng.integers(-2 ** 31, 2 ** 31, (nsrc, chunk),
                           dtype=np.int64).astype(np.int32)
        rows = rng.integers(-nsrc - 3, nsrc + 3, nout).astype(np.int32)
        lives = [0, 1, chunk // 2, chunk - 1, chunk, chunk + 1, 4 * chunk, -1,
                 -chunk]
        valid = rng.choice(lives, nout).astype(np.int32)
        return src, rows, valid

    for nsrc, nout, chunk in ((1, 0, 128), (1, 1, 128), (1, 9, 128),
                              (7, 1, 128), (33, 77, 128), (300, 1001, 128),
                              (2048, 2048, 128), (5, 13, 6), (4, 9, 36),
                              (3, 5, 1), (9, 40, 4)):
        src, rows, valid = draw(nsrc, nout, chunk)
        one(src, rows, valid, chunk, f"nsrc={nsrc} nout={nout} chunk={chunk}")
    src, _, _ = draw(4, 0, 128)
    for v in (0, 1, 64, 127, 128, 129, 1000, -1, -2 ** 31):
        one(src, [2, 2, 0, 3, 2], [v] * 5, 128, f"valid={v}, repeated rows")
    ids = [-1, -4, -5, -2 ** 31, 4, 5, 2 ** 31 - 1, 0, 3]
    one(src, ids, [128] * len(ids), 128, "ids outside [0, NSRC)",
        want_rows=[3, 0, 0, 0, 3, 3, 3, 0, 3])
    # a source 4 bytes past a 16-byte boundary takes the scalar path
    flat = torch.from_numpy(rng.integers(0, 2 ** 30, 6 * 128 + 1)
                            .astype(np.int32)).to(device)
    one(flat[1:].view(6, 128), [5, 0, -1, 9], [128, 3, 130, 0], 128,
        "unaligned source")
    for lengths in ([], [0], [1], [127], [128], [129], [513],
                    [0, 1, 127, 128, 129, 513], [513] * 16 + [1, 0]):
        lmax = max(lengths, default=1)
        payloads = rng.integers(-2 ** 31, 2 ** 31, (len(lengths), lmax),
                                dtype=np.int64).astype(np.int32)
        slab, starts = stage_ops.stage_pack(payloads, lengths, device=device)
        cslab, cstarts = stage_ops.stage_pack(payloads, lengths,
                                              device="cpu")
        check(np.array_equal(slab, cslab) and np.array_equal(starts, cstarts),
              f"stage_pack {lengths}: differs from the CPU")
        out = stage_ops.stage_unpack(slab, lengths, lmax, device=device)
        check(np.array_equal(out, stage_ops.stage_unpack(cslab, lengths, lmax,
                                                         device="cpu")),
              f"stage_unpack {lengths}: differs from the CPU")
        for i, n in enumerate(lengths):
            check(np.array_equal(out[i, :n], payloads[i, :n])
                  and not out[i, n:].any(),
                  f"stage round trip {lengths}: payload {i} differs")
        cases += 1
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    print(f"parity: chunk_gather {cases} cases equal to its plain version "
          f"and the CPU (max abs err {err})")
    return float(err)


# ------------------------------------------------------------ 4. lookup path
def make_workload(seed: int, n_keys: int, vdim: int, batches, reps: int,
                  theta: float = 0.99) -> dict:
    """YCSB workload C over ``n_keys`` loaded keys: 100% reads whose item
    ranks follow a Zipfian law with exponent ``theta``; rank r reads the
    r-th key of a seeded shuffle, so popular keys are spread over the table
    as YCSB's scrambled Zipfian spreads them. ``reps`` batches per size,
    plus one batch of the largest size of keys that were never loaded."""
    rng = np.random.default_rng(seed)
    keys = np.unique(rng.integers(1, 2 ** 32 - 1, int(n_keys * 1.1) + 16,
                                  dtype=np.int64))
    keys = rng.permutation(keys)[:n_keys]
    check(len(keys) == n_keys, "not enough distinct keys drawn")
    values = rng.standard_normal((n_keys, vdim), dtype=np.float32)
    cdf = np.cumsum(1.0 / np.arange(1, n_keys + 1) ** theta)
    cdf /= cdf[-1]
    reads = {b: [np.minimum(np.searchsorted(cdf, rng.random(b)), n_keys - 1)
                 for _ in range(reps)] for b in batches}
    absent = rng.integers(1, 2 ** 32 - 1, 2 * max(batches), dtype=np.int64)
    absent = absent[~np.isin(absent, keys)][:max(batches)]
    return dict(keys=keys, values=values, reads=reads, absent=absent)


def _expect(got, wl, idx, device, what):
    """Lookup result == the inserted values of ``wl['keys'][idx]``
    (``idx`` None: keys never loaded -> found 0 and zero rows)."""
    v, f = got
    if idx is None:
        check(int(f.sum()) == 0 and not v.any().item(),
              f"{what}: a key that was never loaded was found")
        return
    truth = torch.from_numpy(wl["values"][idx]).to(device)
    check(bool((f == 1).all()), f"{what}: a loaded key was not found")
    check(torch.equal(v, truth), f"{what}: values differ from the inserted")


def drive_table(table, wl, device, scalar_batch: int) -> dict:
    """The main path on one loaded table: every workload batch through
    ``lookup_batch`` (default impl), the absent batch, and the first batch
    of size ``scalar_batch`` through ``impl="scalar"``, each checked against
    the inserted values and the plain version. Returns the kernel launches
    of exactly this run."""
    _build.launches.clear()
    calls = []
    for size, batches in wl["reads"].items():
        for idx in batches:
            calls.append(("kernel", idx, f"batch {size}"))
    calls.append(("kernel", None, f"absent {len(wl['absent'])}"))
    calls.append(("scalar", wl["reads"][scalar_batch][0],
                  f"scalar {scalar_batch}"))
    for impl, idx, what in calls:
        keys = wl["absent"] if idx is None else wl["keys"][idx]
        got = table.lookup_batch(keys, impl=impl)
        _expect(got, wl, idx, device, what)
        plain = table.lookup_batch(keys, impl="ref")
        check(torch.equal(got[0], plain[0]) and torch.equal(got[1], plain[1]),
              f"{what}: differs from the plain version")
    launches = dict(_build.launches)
    _build.launches.clear()
    return launches


def load_table(table, wl) -> float:
    t0 = time.perf_counter()
    for k, v in zip(wl["keys"].tolist(), wl["values"]):
        table.insert(k, v)
    table.sync()
    return time.perf_counter() - t0


def main_path(device, *, n_buckets, shard_buckets, n_shards, nslot, vdim,
              n_keys, batches, reps, seed, measure=None) -> dict:
    """Both tables through the main path. ``measure(table, wl, sharded)``
    runs while each table is alive (kernel times on the card); returns the
    launches per kernel summed over both runs and what ``measure`` gave."""
    wl = make_workload(seed, n_keys, vdim, batches, reps)
    launches: dict = {}
    measured = {}
    for sharded in (False, True):
        if sharded:
            table = ShardedDeviceRaceTable(n_shards, shard_buckets, nslot,
                                           vdim, device=device)
        else:
            table = DeviceRaceTable(n_buckets, nslot, vdim, device=device)
        load_s = load_table(table, wl)
        run = drive_table(table, wl, device, max(batches))
        gib = (table.val_table.numel() + table.fp_table.numel()) * 4 / 2**30
        shape = tuple(table.val_table.shape)
        print(f"main path {type(table).__name__} {shape} ({gib:.2f} GiB): "
              f"{n_keys} keys loaded in {load_s:.1f} s, "
              f"max bucket load {int(table._loads.max())}; every lookup "
              f"equals the inserted values and the plain version; launches "
              f"{run}")
        for name, n in run.items():
            launches[name] = launches.get(name, 0) + n
        if measure is not None:
            measured.update(measure(table, wl, sharded))
        del table
        gc.collect()
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
    return dict(launches=launches, measured=measured)


# ------------------------------------------------------- 5. lookup timing
def device_ms(fn, n: int, device) -> float:
    """Device time per call of ``fn`` (ms): ``n`` calls queued behind a spin
    kernel, so the card runs them back to back whatever the host's pace,
    timed by CUDA events around the whole run."""
    cycles = 100_000_000
    for _ in range(6):
        fn()                                           # warm-up
        torch.cuda.synchronize(device)
        start, end, spun = (torch.cuda.Event(enable_timing=True)
                            for _ in range(3))
        torch.cuda._sleep(cycles)
        spun.record()
        start.record()
        for _ in range(n):
            fn()
        end.record()
        backlog = not spun.query()      # the spin still ran: all queued
        torch.cuda.synchronize(device)
        if backlog:
            return start.elapsed_time(end) / n
        cycles *= 2
    raise PhaseError("the host could not queue the launches ahead of the card")


def _bytes_needed(table, fps, bidx, sidx, nslot, vdim, itemsize=4) -> int:
    """Bytes one lookup of this batch must move, each counted once: queries
    and bucket ids (and shard ids) read, distinct candidate buckets'
    fingerprints, distinct hit rows, and the outputs written."""
    nq = len(fps)
    nb = table.n_buckets
    gb = bidx.astype(np.int64) + (0 if sidx is None
                                  else sidx.astype(np.int64)[:, None] * nb)
    cand = table._fp.reshape(-1, nslot)[gb].reshape(nq, 2 * nslot)
    hit = (cand == fps[:, None]) & (cand != 0)
    first = hit.argmax(1)
    rows = np.where(first < nslot, gb[:, 0], gb[:, 1]) * nslot + first % nslot
    hit_rows = np.unique(rows[hit.any(1)])
    per_query = 12 + (0 if sidx is None else 4)
    return (nq * per_query + len(np.unique(gb)) * nslot * 4
            + len(hit_rows) * vdim * itemsize + nq * (vdim * itemsize + 4))


def host_breakdown(table, key_batches, sharded: bool, device,
                   calls: int = 100) -> dict:
    """Median host time (ms) of each step of ``lookup_batch``, run one after
    another as it runs them: key hashing, the dirty-bucket check, the ops
    call (int32 conversion, copy of the hashed keys to the card, checks,
    launch), and the wait for the card. ``h2d`` times the copies alone,
    which the ops call contains."""
    lookup = ops.race_lookup_sharded if sharded else ops.race_lookup
    steps = ("hash", "sync", "ops_call", "wait")
    parts = {name: [] for name in steps + ("h2d",)}
    for i in range(calls):
        keys = key_batches[i % len(key_batches)]
        t = [time.perf_counter()]
        args = query_hashes(keys, table.n_buckets)
        if sharded:
            args += (query_shards(keys, table.n_shards),)
        t.append(time.perf_counter())
        table.sync()
        t.append(time.perf_counter())
        lookup(table.fp_table, table.val_table, *args)
        t.append(time.perf_counter())
        torch.cuda.synchronize(device)
        t.append(time.perf_counter())
        for name, a, b in zip(steps, t, t[1:]):
            parts[name].append((b - a) * 1e3)
        t0 = time.perf_counter()
        for a in args:
            torch.as_tensor(a).to(device)
        torch.cuda.synchronize(device)
        parts["h2d"].append((time.perf_counter() - t0) * 1e3)
    return {name: float(np.median(v)) for name, v in parts.items()}


def measure_table(table, wl, sharded: bool, device, launches_per_batch=64,
                  host_calls=200):
    """Times of the table's kernels at each batch size: kernel and plain
    version device time, the bound, and the host time of ``lookup_batch``
    (median and 90th percentile over ``host_calls`` calls, each ending in a
    synchronisation)."""
    out = {}
    names = ["race_lookup_sharded"] if sharded else ["race_lookup_tiled",
                                                    "race_lookup_scalar"]
    for size, batches in wl["reads"].items():
        inputs, need = [], []
        for idx in batches:
            keys = wl["keys"][idx]
            fps, bidx = query_hashes(keys, table.n_buckets)
            sidx = query_shards(keys, table.n_shards) if sharded else None
            need.append(_bytes_needed(table, fps, bidx, sidx, table.nslot,
                                      table.vdim))
            arrays = (fps, bidx) + ((sidx,) if sharded else ())
            inputs.append([torch.from_numpy(a).to(device) for a in arrays])
        fp, val = table.fp_table, table.val_table

        def cycle(fn):
            it = itertools.cycle(inputs)
            return lambda: fn(*next(it))

        plain = ((lambda q, b, s: race_lookup_sharded_ref(fp, val, q, b, s))
                 if sharded else (lambda q, b: race_lookup_ref(fp, val, q, b)))
        plain_ms = device_ms(cycle(plain), 16, device)
        host = []
        for i in range(host_calls):
            t0 = time.perf_counter()
            table.lookup_batch(wl["keys"][batches[i % len(batches)]])
            torch.cuda.synchronize(device)
            host.append((time.perf_counter() - t0) * 1e3)
        host_p50, host_p90 = np.percentile(host, [50, 90]).tolist()
        split = host_breakdown(table, [wl["keys"][idx] for idx in batches],
                               sharded, device)
        for name in names:
            if name == "race_lookup_sharded":
                fn = lambda q, b, s, qb=kern.QBLOCK: kern.race_lookup_sharded(
                    fp, val, q, b, s, qblock=qb)
            elif name == "race_lookup_scalar":
                fn = lambda q, b: kern.race_lookup_scalar(fp, val, q, b)
            else:
                fn = lambda q, b, qb=kern.QBLOCK: kern.race_lookup_tiled(
                    fp, val, q, b, qblock=qb)
            r = out.setdefault(name, {})[size] = dict(
                ms=device_ms(cycle(fn), launches_per_batch, device),
                plain_ms=plain_ms,
                bound_ms=statistics.mean(need) / HBM_BYTES_PER_S * 1e3,
                bytes=statistics.mean(need),
                lookup_batch_host_ms=host_p50,
                lookup_batch_host_p90_ms=host_p90,
                lookup_batch_calls=host_calls,
                lookup_batch_host_breakdown_ms=split)
            if name != "race_lookup_scalar":    # the JAX kernels' tile
                r["ms_qblock64"] = device_ms(
                    cycle(lambda *a: fn(*a, qb=64)), launches_per_batch,
                    device)
    for name, rows in out.items():
        for size, r in rows.items():
            q64 = r.get("ms_qblock64", float("nan"))
            print(f"time {name} batch {size}: kernel {r['ms']:.6f} ms "
                  f"(qblock 64: {q64:.6f} ms), plain "
                  f"{r['plain_ms']:.6f} ms, bound {r['bound_ms']:.6f} ms "
                  f"({r['bytes']:.0f} B), lookup_batch host p50 "
                  f"{r['lookup_batch_host_ms']:.6f} ms p90 "
                  f"{r['lookup_batch_host_p90_ms']:.6f} ms "
                  f"({r['lookup_batch_calls']} calls); host steps "
                  f"{r['lookup_batch_host_breakdown_ms']}")
    return out


# ------------------------------------------------------------ 6. chain path
def _uniform(rng, k: int, nbytes: int) -> list:
    return [rng.integers(0, 256, nbytes, dtype=np.uint8) for _ in range(k)]


def _ragged(rng, k: int, max_bytes: int) -> list:
    """``k`` payloads of sizes log-uniform in [1, max_bytes] B, the two ends
    included (so every epoch needs the same recv buffers)."""
    sizes = np.exp(rng.uniform(0.0, math.log(max_bytes), k)).astype(np.int64)
    sizes = np.clip(sizes, 1, max_bytes)
    sizes[:2] = (1, max_bytes)
    return [rng.integers(0, 256, int(n), dtype=np.uint8) for n in sizes]


def _kill_after_touch(cluster, dead: str):
    """Cache n0's DCT metadata and a checked MR of ``dead``, then kill it
    (the failover scenario of tests/test_serverless.py)."""
    m0 = cluster.module("n0")
    qd = yield from m0.sys_queue()
    yield from m0.sys_qconnect(qd, dead)
    mr_r = yield from cluster.module(dead).sys_qreg_mr(4096)
    mr_l = yield from m0.sys_qreg_mr(4096)
    rc = yield from m0.sys_qpush(qd, [WorkRequest(
        op="READ", wr_id=1, local_mr=mr_l, local_off=0,
        remote_rkey=mr_r.rkey, remote_off=0, nbytes=8)])
    check(rc == 0, "failover set-up: READ refused")
    yield from m0.qpop_block(qd)
    cluster.fabric.node(dead).alive = False


def run_chain(device, cell: dict, transport: str = "krcore"):
    """Every epoch of ``cell`` on one runner over a fresh cluster; each
    epoch's outputs must equal ``expected_outputs``. Returns the reports and
    each epoch's host wall time (s)."""
    cluster = make_cluster(n_nodes=cell["n_nodes"], n_meta=1)
    reg = default_registry(payload_bytes=cell["registry_bytes"])
    pool = ContainerPool(cluster, transport)
    runner = ChainRunner(cluster, reg, pool, transport,
                         slab_payloads=cell["slab"],
                         standby=cell.get("standby"), device=device)
    reports, walls = [], []
    for e, payloads in enumerate(cell["epochs"]):
        def epoch(e=e, payloads=payloads):
            if e == 0 and cell.get("kill"):
                yield from _kill_after_touch(cluster, cell["kill"])
            return (yield from runner.run_batch(CHAIN, ["n0", "n1", "n2"],
                                                len(payloads), payloads))

        t0 = time.perf_counter()
        rep = cluster.env.run_process(epoch(), f"{cell['name']}.{e}")
        walls.append(time.perf_counter() - t0)
        exp = expected_outputs(reg, CHAIN, payloads)
        check(len(rep.outputs) == len(exp)
              and all(np.array_equal(a, b) for a, b in zip(rep.outputs, exp)),
              f"{cell['name']} epoch {e} ({transport}): outputs differ from "
              f"expected_outputs")
        reports.append(rep)
    return reports, walls


def report_fields(rep) -> dict:
    """Every field of a ``ChainReport`` but the outputs."""
    return dict(total_us=rep.total_us, transfer_us=rep.transfer_us,
                hops=[dataclasses.asdict(h) for h in rep.hops],
                stages=[dataclasses.asdict(s) for s in rep.stages])


def chain_cells(*, ks, payload_bytes, slab_payloads, ragged_k,
                ragged_max_bytes, seed) -> list:
    rng = np.random.default_rng(seed)
    cells = [dict(name=f"K={k} x {payload_bytes} B", n_nodes=3,
                  registry_bytes=payload_bytes, slab=slab_payloads,
                  epochs=[_uniform(rng, k, payload_bytes)], verbs=True)
             for k in ks]
    cells.append(dict(name=f"ragged K={ragged_k} 1 B..{ragged_max_bytes} B",
                      n_nodes=3, registry_bytes=ragged_max_bytes,
                      slab=slab_payloads,
                      epochs=[_ragged(rng, ragged_k, ragged_max_bytes)
                              for _ in range(2)]))
    cells.append(dict(name="failover K=6 x 900 B", n_nodes=4,
                      registry_bytes=900, slab=4, standby={"n1": "n3"},
                      kill="n1", epochs=[_uniform(rng, 6, 900)]))
    return cells


def chain_path(device, **size) -> dict:
    """The chain hop on ``device``: every cell of :func:`chain_cells`, then
    the same epochs with ``device="cpu"``, whose ``ChainReport`` fields
    must be equal, then the gates. Returns the launches of the device run,
    the reports and the epochs' wall times."""
    cells = chain_cells(**size)
    _build.launches.clear()
    runs = {c["name"]: run_chain(device, c) for c in cells}
    launches = dict(_build.launches)
    _build.launches.clear()
    out = {}
    for cell in cells:
        name = cell["name"]
        reports, walls = runs[name]
        cpu_reports, cpu_walls = run_chain("cpu", cell)
        for e, (rep, cpu_rep) in enumerate(zip(reports, cpu_reports)):
            check(report_fields(rep) == report_fields(cpu_rep),
                  f"{name} epoch {e}: ChainReport differs from the CPU run:"
                  f" {report_fields(rep)} vs {report_fields(cpu_rep)}")
            budget = math.ceil(len(cell["epochs"][e]) / cell["slab"])
            for hop in rep.hops:
                check(0 < hop.doorbells <= budget,
                      f"{name} epoch {e}: {hop.doorbells} doorbells on a "
                      f"hop, budget ceil(K/slab) = {budget}")
        row = dict(walls_s=walls, cpu_walls_s=cpu_walls,
                   reports=[report_fields(r) for r in reports])
        if cell.get("verbs"):
            verbs = run_chain(None, cell, "verbs")[0][0]
            row["verbs_transfer_us"] = verbs.transfer_us
            row["reduction_vs_verbs"] = 1 - (reports[0].transfer_us
                                             / verbs.transfer_us)
            check(row["reduction_vs_verbs"] >= 0.90,
                  f"{name}: krcore transfer_us {reports[0].transfer_us} is "
                  f"not 90% below verbs {verbs.transfer_us}")
        if cell.get("kill"):
            rep = reports[0]
            check(sum(h.failovers for h in rep.hops) >= 1
                  and [s.node for s in rep.stages] == ["n0", "n3", "n2"],
                  f"{name}: the hop did not fail over to n3")
        if len(reports) > 1:
            ctl = [sum(h.control_us for h in r.hops) for r in reports]
            check(ctl[1] < 0.2 * ctl[0],
                  f"{name}: the second epoch paid hop control {ctl[1]} us "
                  f"(first {ctl[0]} us): listener/session cache missed")
        out[name] = row
        first = row["reports"][0]
        print(f"chain {name}: {len(reports)} epoch(s) byte-exact and equal "
              f"to the CPU run; simulated total_us {first['total_us']:.3f} "
              f"transfer_us {first['transfer_us']:.3f} doorbells/hop "
              f"{[h['doorbells'] for h in first['hops']]}"
              + (f"; {100 * row['reduction_vs_verbs']:.2f}% below verbs "
                 f"({row['verbs_transfer_us']:.3f} us)"
                 if "reduction_vs_verbs" in row else "")
              + f"; host wall {[round(w * 1e3, 3) for w in walls]} ms "
                f"(CPU plain version {[round(w * 1e3, 3) for w in cpu_walls]}"
                f" ms)")
    print(f"chain path launches {launches}")
    return dict(launches=launches, cells=out)


# ---------------------------------------------------------- 7. chain timing
#: (label, payloads, int32 elements each) of the timed pack gathers
GATHER_SHAPES = (("slab 16 x 1 KiB", 16, 256),
                 ("slab 16 x 64 KiB", 16, 16_384),
                 ("beyond the chain: 64 x 1 MiB", 64, 262_144))


def _pack_inputs(n_payloads: int, elems: int, device):
    """The pack gather of ``n_payloads`` payloads of ``elems`` int32 each,
    routed as ``stage_pack`` routes it: (src, src_row, valid) on the card."""
    rng = np.random.default_rng(n_payloads * elems)
    cmax = -(-elems // CHUNK)
    src = rng.integers(-2 ** 31, 2 ** 31, (n_payloads * cmax, CHUNK),
                       dtype=np.int64).astype(np.int32)
    rows, valid = stage_ops.pack_plan(np.full(n_payloads, elems), elems)
    return [torch.from_numpy(a).to(device) for a in (src, rows, valid)]


def _gather_bytes(rows, valid, chunk: int = CHUNK) -> int:
    """Bytes one gather must move, each counted once: the live elements of
    every distinct source chunk read, the output written, and the two
    int32 routing tables read."""
    rows, valid = rows.cpu().numpy(), valid.cpu().numpy()
    live = valid > 0
    need = np.zeros(int(rows.max(initial=0)) + 1, np.int64)
    np.maximum.at(need, rows[live], np.minimum(valid[live], chunk))
    return int(4 * need.sum() + len(rows) * (4 * chunk + 8))


def measure_gather(device, launches: int = 64) -> dict:
    """Device time per launch of ``chunk_gather`` at each of
    :data:`GATHER_SHAPES`, beside its plain version's, ``index_select``'s
    (the same gather without the mask: one PyTorch call, used nowhere in
    the port) and the bound (bytes over 3.35 TB/s)."""
    out = {}
    for label, n, elems in GATHER_SHAPES:
        src, rows, valid = _pack_inputs(n, elems, device)
        got = chunk_gather_cuda(src, rows, valid)
        check(torch.equal(got, src.index_select(0, rows))
              and torch.equal(got, chunk_gather_ref(src, rows, valid)),
              f"chunk_gather {label}: differs from index_select or the plain "
              f"version")
        nbytes = _gather_bytes(rows, valid)
        r = out[label] = dict(
            nout=len(rows), bytes=nbytes,
            ms=device_ms(lambda: chunk_gather_cuda(src, rows, valid),
                         launches, device),
            plain_ms=device_ms(lambda: chunk_gather_ref(src, rows, valid),
                               16, device),
            library_ms=device_ms(lambda: src.index_select(0, rows),
                                 launches, device),
            bound_ms=nbytes / HBM_BYTES_PER_S * 1e3)
        print(f"time chunk_gather {label} ({r['nout']} chunks, {nbytes} B): "
              f"kernel {r['ms']:.6f} ms, plain {r['plain_ms']:.6f} ms, "
              f"index_select {r['library_ms']:.6f} ms, bound "
              f"{r['bound_ms']:.6f} ms")
        del src, rows, valid, got
        torch.cuda.empty_cache()
    return out


def _p50_p90(fn, calls: int) -> list:
    ts = []
    for _ in range(calls):
        t0 = time.perf_counter()
        fn()
        ts.append((time.perf_counter() - t0) * 1e3)
    return np.percentile(ts, [50, 90]).tolist()


def slab_steps(payloads, raw, device, calls: int) -> dict:
    """Median host time (ms) of each step of ``encode_slab`` and
    ``decode_slab``, replayed one after another as they run them: building
    the payload matrix (``build``; ``parse`` of the header on decode), the
    routing plan, the copies to the card, the kernel and the wait for it,
    the copy back, and assembling the slab (``header``) or the payloads
    (``split``)."""
    parts: dict = {}

    def tick(name, t0):
        parts.setdefault(name, []).append((time.perf_counter() - t0) * 1e3)
        return time.perf_counter()

    def gather(side, src, rows, valid, t):
        args = [torch.from_numpy(a).to(device) for a in (src, rows, valid)]
        torch.cuda.synchronize(device)
        t = tick(f"{side}.h2d", t)
        out = chunk_gather_cuda(*args)
        torch.cuda.synchronize(device)
        t = tick(f"{side}.kernel", t)
        out = out.cpu().numpy()
        return out, tick(f"{side}.d2h", t)

    for _ in range(calls):
        t = time.perf_counter()
        k = len(payloads)
        byte_lens = [len(p) for p in payloads]
        elem_lens = np.array([-(-b // 4) for b in byte_lens], np.int32)
        lmax = int(elem_lens.max())
        mat = np.zeros((k, lmax), np.int32)
        for i, p in enumerate(payloads):
            padded = np.zeros(elem_lens[i] * 4, np.uint8)
            padded[:byte_lens[i]] = p
            mat[i, :elem_lens[i]] = padded.view(np.int32)
        cmax = -(-lmax // CHUNK)
        src = np.pad(mat, ((0, 0), (0, cmax * CHUNK - lmax))) \
            .reshape(k * cmax, CHUNK)
        t = tick("encode.build", t)
        rows, valid = stage_ops.pack_plan(elem_lens, lmax)
        t = tick("encode.plan", t)
        body, t = gather("encode", src, rows, valid, t)
        hdr = np.zeros(-(-(2 + k) // CHUNK) * CHUNK, np.int32)
        hdr[0], hdr[2:2 + k] = k, byte_lens
        np.concatenate([hdr, body.reshape(-1)]).view(np.uint8)
        tick("encode.header", t)

        t = time.perf_counter()
        ints = raw.view(np.int32)
        k = int(ints[0])
        byte_lens = [int(b) for b in ints[2:2 + k]]
        elem_lens = np.array([-(-b // 4) for b in byte_lens], np.int32)
        lmax = int(elem_lens.max())
        total = int(stage_ops.n_chunks(elem_lens).sum())
        body = ints[-(-(2 + k) // CHUNK) * CHUNK:][:total * CHUNK] \
            .reshape(total, CHUNK)
        t = tick("decode.parse", t)
        rows, valid = stage_ops.unpack_plan(elem_lens, lmax)
        t = tick("decode.plan", t)
        mat, t = gather("decode", body, rows, valid, t)
        mat = mat.reshape(k, -1)[:, :lmax]
        [np.ascontiguousarray(mat[i, :elem_lens[i]]).view(np.uint8)
         [:byte_lens[i]].copy() for i in range(k)]
        tick("decode.split", t)
    return {name: float(np.median(v)) for name, v in parts.items()}


def slab_host_times(device, n_payloads: int, nbytes: int,
                    calls: int = 200) -> dict:
    """Host time of ``encode_slab`` and ``decode_slab`` on one slab of
    ``n_payloads`` payloads of ``nbytes`` (median and 90th percentile of
    ``calls`` calls, each ending with its result on the host), the same on
    the CPU's plain version, and the steps of each."""
    payloads = _uniform(np.random.default_rng(nbytes), n_payloads, nbytes)
    raw = encode_slab(payloads, device=device)
    seq, back = decode_slab(raw, device=device)
    check(seq == 0 and all(np.array_equal(a, b)
                           for a, b in zip(back, payloads)),
          f"slab {n_payloads} x {nbytes} B: round trip differs")
    r = dict(
        encode_ms=_p50_p90(lambda: encode_slab(payloads, device=device),
                           calls),
        decode_ms=_p50_p90(lambda: decode_slab(raw, device=device), calls),
        encode_cpu_ms=_p50_p90(lambda: encode_slab(payloads, device="cpu"),
                               calls),
        decode_cpu_ms=_p50_p90(lambda: decode_slab(raw, device="cpu"),
                               calls),
        steps_ms=slab_steps(payloads, raw, device, calls // 2), calls=calls)
    print(f"time slab {n_payloads} x {nbytes} B: encode_slab p50/p90 "
          f"{r['encode_ms']} ms, decode_slab {r['decode_ms']} ms (CPU plain "
          f"version {r['encode_cpu_ms']} / {r['decode_cpu_ms']} ms; "
          f"{calls} calls); steps {r['steps_ms']}")
    return r


def chain_busy_share(device, cell: dict) -> dict:
    """One epoch of ``cell`` under ``torch.profiler``: the card's busy time
    (the union of its kernel and copy spans) over the epoch's host wall
    time. The profiler's own cost is inside that wall time."""
    from torch.profiler import ProfilerActivity, profile
    run_chain(device, cell)                                 # warm-up
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall_s = run_chain(device, cell)[1][0]
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy_us, end = 0.0, -math.inf
    for a, b in spans:
        busy_us += max(0.0, b - max(a, end))
        end = max(end, b)
    kernel_us = sum(e.time_range.elapsed_us() for e in prof.events()
                    if e.device_type == torch.autograd.DeviceType.CUDA
                    and "chunk_gather" in e.name)
    r = dict(cell=cell["name"], wall_ms=wall_s * 1e3, busy_ms=busy_us / 1e3,
             kernel_ms=kernel_us / 1e3, device_events=len(spans),
             idle_share=(1 - busy_us / (wall_s * 1e6)) if spans else None)
    print(f"profile chain {cell['name']}: epoch wall {r['wall_ms']:.3f} ms "
          f"(profiled), card busy {r['busy_ms']:.6f} ms over "
          f"{len(spans)} device spans (chunk_gather {r['kernel_ms']:.6f} "
          f"ms), idle share "
          + (f"{r['idle_share']:.6f}" if spans else "not measured (the "
             "profiler saw no device activity)"))
    return r


# ------------------------------------------------------------------- main
def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    device_report()
    build_kernels()
    errs = kernel_parity(device)
    errs["chunk_gather"] = stage_parity(device)
    cfg = REAL_SIZE
    res = main_path(device, **cfg,
                    measure=lambda t, wl, sh: measure_table(t, wl, sh,
                                                            device))
    chain = chain_path(device, **CHAIN_SIZE)
    gather = measure_gather(device)
    host = {f"{n} x {b} B": slab_host_times(device, n, b)
            for n, b in ((16, 1024), (16, 64 * 1024))}
    k64 = chain_cells(**CHAIN_SIZE)[len(CHAIN_SIZE["ks"]) - 1]
    busy = chain_busy_share(device, k64)
    torch.cuda.synchronize(device)
    launches = dict(res["launches"], **chain["launches"])
    top = max(cfg["batches"])
    kernels = []
    for name in ("race_lookup_tiled", "race_lookup_scalar",
                 "race_lookup_sharded", "chunk_gather"):
        n = launches.get(name, 0)
        check(n > 0, f"{name} was not launched on the main path")
        if name == "chunk_gather":
            shape = GATHER_SHAPES[0][0]
            r = gather[shape]
            extra = dict(library_ms=r["library_ms"],
                         library="torch.index_select (no mask)",
                         shape=shape, by_shape=gather, slab_host=host,
                         epoch_wall_ms={c: [w * 1e3 for w in row["walls_s"]]
                                        for c, row in chain["cells"].items()},
                         profile=busy)
        else:
            r = res["measured"][name][top]
            extra = dict(library_ms=None, batch=top,
                         by_batch={str(s): v for s, v in
                                   res["measured"][name].items()})
        kernels.append(dict(
            name=name, route="cuda", source=SOURCES[name],
            replaces=REPLACES[name], launches=n, max_abs_err=errs[name],
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by="bytes", **extra))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
