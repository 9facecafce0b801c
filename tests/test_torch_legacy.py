"""The port's deprecated raw-queue shim, ``repro_torch.core.legacy``: the
port of ``tests/test_session.py::
test_legacy_shim_warns_once_and_stays_functional``.

Importing it warns exactly once. That is counted in a fresh interpreter,
so that no earlier import in a test worker can hide or repeat the
warning. Then the shim drives the raw syscall surface of the port's
``core`` as the reference's drives ``repro.core``: the same READ, the same
completion, at the same simulated time.
"""

import importlib
import json
import os
import subprocess
import sys
import warnings
from pathlib import Path

import repro.core as jcore
import repro_torch.core as tcore

ROOT = Path(__file__).resolve().parent.parent


def test_legacy_shim_warns_exactly_once_on_import():
    code = (
        "import importlib, json, warnings\n"
        "with warnings.catch_warnings(record=True) as first:\n"
        "    warnings.simplefilter('always')\n"
        "    import repro_torch.core.legacy as legacy\n"
        "with warnings.catch_warnings(record=True) as cached:\n"
        "    warnings.simplefilter('always')\n"
        "    importlib.import_module('repro_torch.core.legacy')\n"
        "with warnings.catch_warnings(record=True) as fresh:\n"
        "    warnings.simplefilter('always')\n"
        "    importlib.reload(legacy)\n"
        "def dep(ws):\n"
        "    return [str(w.message) for w in ws\n"
        "            if issubclass(w.category, DeprecationWarning)]\n"
        "print(json.dumps([dep(first), dep(cached), dep(fresh)]))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    first, cached, fresh = json.loads(out.stdout.strip().splitlines()[-1])
    assert len(first) == 1 and "deprecated" in first[0], first
    assert "repro_torch.core.legacy" in first[0]
    assert cached == []
    assert fresh == first


def _read_through_the_shim(core, legacy):
    """The reference test's scenario: one READ pushed and popped through
    the shim; (rc, the completion's wr_id and err, the simulated time)."""
    cluster = core.make_cluster(n_nodes=2, n_meta=1)
    m0, m1 = cluster.module("n0"), cluster.module("n1")
    seen = {}

    def scenario():
        mr_srv = yield from m1.sys_qreg_mr(4096)
        mr = yield from m0.sys_qreg_mr(4096)
        qd = yield from m0.sys_queue()
        yield from m0.sys_qconnect(qd, "n1")
        seen["rc"] = yield from legacy.qpush(m0, qd, [core.WorkRequest(
            op="READ", wr_id=1, local_mr=mr, local_off=0,
            remote_rkey=mr_srv.rkey, remote_off=0, nbytes=8)])
        ent = yield from legacy.qpop_block(m0, qd)
        seen["completion"] = (ent.status, ent.user_wr_id, ent.err)
        return True

    assert cluster.env.run_process(scenario(), "s")
    return seen["rc"], seen["completion"], cluster.env.now


def test_legacy_shim_drives_the_raw_surface_like_the_reference():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        tlegacy = importlib.import_module("repro_torch.core.legacy")
        jlegacy = importlib.import_module("repro.core.legacy")
    got = _read_through_the_shim(tcore, tlegacy)
    assert got[0] == 0 and got[1][1:] == (1, False)
    assert got == _read_through_the_shim(jcore, jlegacy)
    public = sorted(n for n in vars(jlegacy) if n.startswith("q"))
    assert public == sorted(n for n in vars(tlegacy) if n.startswith("q"))
