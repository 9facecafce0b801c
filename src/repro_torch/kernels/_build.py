"""Build the port's CUDA C++ kernels with ``nvcc``; bind them with ``ctypes``.

Every ``csrc/*.cu`` below ``repro_torch/kernels`` is one shared library with
a plain C interface (no PyTorch headers, so a build takes seconds). On first
use it is compiled for Hopper into ``_cuda_build/<name>-<digest>.so`` beside
this file; the digest covers the source and the flags, so an edited source
is never served from a stale library. :func:`build_all` starts one ``nvcc``
per source, all at once, and keeps each one's ``-Xptxas -v`` report (registers,
shared memory and spills per kernel) in ``<library>.log``.

A failed build or load raises: nothing falls back to a plain version.

Each C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`launch` raises when that is not 0 and only then
counts the launch in :data:`launches`.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

KERNELS_DIR = Path(__file__).resolve().parent
BUILD_DIR = KERNELS_DIR / "_cuda_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: kernel launches by C entry-point name, counted only once the launch was
#: accepted; callers clear it before the run whose launches they read
launches: collections.Counter = collections.Counter()
_libs: dict[str, ctypes.CDLL] = {}


def sources() -> dict[str, Path]:
    """Every CUDA source of the port, by library name (the file's stem)."""
    return {p.stem: p for p in sorted(KERNELS_DIR.glob("*/csrc/*.cu"))}


def library_path(name: str) -> Path:
    src = sources()[name]
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found: set CUDA_HOME or put nvcc "
                           "on PATH")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def build_all(names=None) -> dict[str, str]:
    """Compile the named sources (default: all) that are not built yet, one
    ``nvcc`` process per source, started together. Returns each library's
    ptxas report. Raises ``RuntimeError`` with the compiler's output when a
    build fails."""
    names = sorted(sources()) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        nvcc = nvcc or _nvcc()
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(sources()[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, cmd)
    failed = []
    for name, (proc, tmp, out, cmd) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)}\n{log}")
            continue
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return {name: library_path(name).with_suffix(".log").read_text()
            for name in names}


def build_copy(name: str, source: str, out_dir: Path):
    """Compile ``source``, the text of a copy of one of the port's ``.cu``
    files, with the port's flags into ``out_dir/<name>.so``, beside the
    ``.cu`` and its ``-Xptxas -v`` log (the tools that time copies of a
    kernel against each other). Returns (the loaded library, the log);
    raises ``RuntimeError`` with the compiler's output when nvcc fails."""
    cu, so = out_dir / f"{name}.cu", out_dir / f"{name}.so"
    cu.write_text(source)
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(so), str(cu)],
                          capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    (out_dir / f"{name}.log").write_text(log)
    if proc.returncode:
        raise RuntimeError(f"{name}: nvcc failed\n{log}")
    return ctypes.CDLL(str(so)), log


def library(name: str, signatures: dict) -> ctypes.CDLL:
    """Load (building first if needed) the library ``name`` and declare its
    entry points: ``signatures`` maps each symbol to its ``argtypes``; every
    entry point returns a CUDA error code as ``int``."""
    lib = _libs.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(str(library_path(name)))
        for symbol, argtypes in signatures.items():
            fn = getattr(lib, symbol)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        lib.cuda_error_string.argtypes = [ctypes.c_int]
        lib.cuda_error_string.restype = ctypes.c_char_p
        _libs[name] = lib
    return lib


def launch(lib: ctypes.CDLL, symbol: str, *args) -> None:
    """Call one C entry point; raise if CUDA refused the launch, else count
    it."""
    err = getattr(lib, symbol)(*args)
    if err != 0:
        raise RuntimeError(f"{symbol}: CUDA error {err}: "
                           f"{lib.cuda_error_string(err).decode()}")
    launches[symbol] += 1
