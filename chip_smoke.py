#!/usr/bin/env python3
"""Drive the PyTorch port's device RACE-table lookup path on one CUDA card.

Run from the repository root, on a machine with one CUDA card and the CUDA
toolkit (``nvcc``):

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing falls back to the CPU or to a
plain version):

1. Device report: the card's name and power limit from ``nvidia-smi``.
2. Build: compile every CUDA source of the port (one ``nvcc`` per source,
   started together) and print each ``-Xptxas -v`` report.
3. Kernel parity: each kernel against its plain PyTorch version on the
   card, exact equality of values and ``found``, at the test shapes
   (NSLOT 4/8/16/32, ragged tails, NQ = 0), out-of-range bucket ids, empty
   and ragged shards, float32 and bfloat16 value tables.
4. Main path at real size: a ``DeviceRaceTable`` of 524,287 buckets x 8
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
5. Kernel times: per kernel and batch size, the device time per launch
   from CUDA events over many launches queued behind a spin kernel, the
   plain version's time the same way, the host time of ``lookup_batch``
   (median and 90th percentile of 200 calls), and the bound (bytes the
   batch needs over 3.35 TB/s).
6. A ``{"kernels": [...]}`` line, then as the last line
   ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import gc
import itertools
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

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.race_lookup import ops  # noqa: E402
from repro_torch.kernels.race_lookup import race_lookup as kern  # noqa: E402
from repro_torch.kernels.race_lookup.ref import (  # noqa: E402
    make_table, race_lookup_ref, race_lookup_sharded_ref)
from repro_torch.kvs.race import (  # noqa: E402
    DeviceRaceTable, ShardedDeviceRaceTable, query_hashes, query_shards)

HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
SOURCE = "src/repro_torch/kernels/race_lookup/csrc/race_lookup.cu"
REPLACES = {
    "race_lookup_tiled": "src/repro/kernels/race_lookup/race_lookup.py:167",
    "race_lookup_scalar": "src/repro/kernels/race_lookup/race_lookup.py:76",
    "race_lookup_sharded": "src/repro/kernels/race_lookup/race_lookup.py:226",
}
#: the deployment the main path runs (see the module docstring)
REAL_SIZE = dict(n_buckets=524_287, shard_buckets=131_071, n_shards=4,
                 nslot=8, vdim=256, n_keys=1_000_000,
                 batches=(64, 512, 4096), reps=8, seed=0)


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


# ------------------------------------------------------------ 4. main path
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


# --------------------------------------------------------------- 5. timing
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


# ------------------------------------------------------------------- main
def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    device_report()
    build_kernels()
    errs = kernel_parity(device)
    cfg = REAL_SIZE
    res = main_path(device, **cfg,
                    measure=lambda t, wl, sh: measure_table(t, wl, sh,
                                                            device))
    torch.cuda.synchronize(device)
    top = max(cfg["batches"])
    kernels = []
    for name in ("race_lookup_tiled", "race_lookup_scalar",
                 "race_lookup_sharded"):
        n = res["launches"].get(name, 0)
        check(n > 0, f"{name} was not launched on the main path")
        by_size = res["measured"][name]
        kernels.append(dict(
            name=name, route="cuda", source=SOURCE, replaces=REPLACES[name],
            launches=n, max_abs_err=errs[name], ms=by_size[top]["ms"],
            plain_ms=by_size[top]["plain_ms"],
            bound_ms=by_size[top]["bound_ms"], bound_by="bytes",
            library_ms=None, batch=top,
            by_batch={str(s): r for s, r in by_size.items()}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
