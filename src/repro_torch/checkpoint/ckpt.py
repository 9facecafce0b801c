"""Checkpoints with atomic commits, async writes and auto-resume, in the
format of ``repro/checkpoint/ckpt.py``.

Layout: <dir>/step_<N>/
    arrays.npz      flat leaves keyed by position (leaf_000000, ...)
    MANIFEST.json   step, leaf count, shapes/dtypes, user metadata
    COMMITTED       written last: a directory without it is garbage
                    (restore only ever sees committed steps)

Leaves are numbered in ``jax.tree_util.tree_leaves`` order (see
``repro_torch/tree.py``), and a bfloat16 leaf is stored as the reference
stores it, as its raw ``uint16`` bits with the dtype string
``"bfloat16"``, so a checkpoint written by either package restores into
the other's template. Reading one back needs no ``ml_dtypes``: the bits
become a ``torch.bfloat16`` tensor through an ``int16`` view.

Restore takes a template tree (``init_params`` and ``adamw_init`` output)
and returns its structure with each leaf a tensor on the template leaf's
device.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..tree import tree_leaves, tree_unflatten

#: logical dtypes that numpy cannot hold, stored as raw bits of this width
_RAW = {"bfloat16": (torch.bfloat16, np.int16)}


def _host(leaf) -> Tuple[np.ndarray, str]:
    """(a leaf as a numpy array that owns a copy of its bytes, its dtype
    string). A snapshot: later in-place updates of the tensor do not reach
    it."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        a = t.numpy()
        return a, str(a.dtype)
    a = np.array(leaf)
    return a, str(a.dtype)


def _flatten(tree) -> List[Tuple[np.ndarray, str]]:
    return [_host(leaf) for leaf in tree_leaves(tree)]


def _from_storable(arr: np.ndarray, dtype_str: str) -> torch.Tensor:
    """A stored leaf (a fresh array, read from the archive) as a tensor of
    its logical dtype, sharing the array's memory."""
    if str(arr.dtype) == dtype_str:
        return torch.from_numpy(arr)
    if dtype_str not in _RAW:
        raise ValueError(f"cannot restore a leaf of dtype {dtype_str}")
    dtype, view = _RAW[dtype_str]
    return torch.from_numpy(arr.view(view)).view(dtype)


def _write(ckpt_dir: str, step: int, stored, metadata) -> str:
    step_dir = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp_dir = step_dir + ".tmp"
    if os.path.exists(tmp_dir):
        shutil.rmtree(tmp_dir)
    os.makedirs(tmp_dir, exist_ok=True)
    arrays = {f"leaf_{i:06d}": a for i, (a, _) in enumerate(stored)}
    np.savez(os.path.join(tmp_dir, "arrays.npz"), **arrays)
    manifest = {
        "step": step,
        "n_leaves": len(stored),
        "shapes": [list(a.shape) for a, _ in stored],
        "dtypes": [dt for _, dt in stored],
        "metadata": metadata or {},
        "time": time.time(),
    }
    with open(os.path.join(tmp_dir, "MANIFEST.json"), "w") as f:
        json.dump(manifest, f)
    with open(os.path.join(tmp_dir, "COMMITTED"), "w") as f:
        f.write("ok")
    if os.path.exists(step_dir):
        shutil.rmtree(step_dir)
    os.rename(tmp_dir, step_dir)
    return step_dir


def save_checkpoint(ckpt_dir: str, step: int, tree: Any,
                    metadata: Optional[Dict] = None) -> str:
    """Synchronous atomic save. Returns the step directory."""
    return _write(ckpt_dir, step, _flatten(tree), metadata)


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and not name.endswith(".tmp"):
            if os.path.exists(os.path.join(ckpt_dir, name, "COMMITTED")):
                steps.append(int(name[5:]))
    return max(steps) if steps else None


def restore_checkpoint(ckpt_dir: str, template: Any,
                       step: Optional[int] = None
                       ) -> Tuple[int, Any, Dict]:
    """Restore into the structure of ``template``: (step, tree, metadata).
    Raises ``ValueError`` when the leaf count or a shape differs."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in {ckpt_dir}")
    step_dir = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(step_dir, "MANIFEST.json")) as f:
        manifest = json.load(f)
    t_leaves = tree_leaves(template)
    if len(t_leaves) != manifest["n_leaves"]:
        raise ValueError(f"template has {len(t_leaves)} leaves, checkpoint "
                         f"{manifest['n_leaves']}")
    leaves = []
    with np.load(os.path.join(step_dir, "arrays.npz")) as data:
        for i, (tl, dt) in enumerate(zip(t_leaves, manifest["dtypes"])):
            leaf = _from_storable(data[f"leaf_{i:06d}"], dt)
            if tuple(tl.shape) != tuple(leaf.shape):
                raise ValueError(f"shape mismatch {tuple(tl.shape)} vs "
                                 f"{tuple(leaf.shape)}")
            if isinstance(tl, torch.Tensor):
                leaf = leaf.to(tl.device)
            leaves.append(leaf)
    return step, tree_unflatten(template, leaves), manifest["metadata"]


class CheckpointManager:
    """Async, keep-last-k manager with failure-safe resume."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        os.makedirs(ckpt_dir, exist_ok=True)

    def save_async(self, step: int, tree: Any,
                   metadata: Optional[Dict] = None) -> None:
        """Snapshot on the caller's thread (a host copy of every leaf),
        write on a worker: the training loop goes on while bytes hit
        disk."""
        self.wait()
        stored = _flatten(tree)                     # snapshot NOW

        def work():
            try:
                _write(self.ckpt_dir, step, stored, metadata)
                self._gc()
            except BaseException as e:              # noqa: BLE001
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        """Join the pending write; re-raise its error, if any."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self) -> None:
        steps = sorted(
            int(n[5:]) for n in os.listdir(self.ckpt_dir)
            if n.startswith("step_") and not n.endswith(".tmp")
            and os.path.exists(os.path.join(self.ckpt_dir, n, "COMMITTED")))
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.ckpt_dir, f"step_{s:08d}"),
                          ignore_errors=True)

    def restore_latest(self, template: Any
                       ) -> Optional[Tuple[int, Any, Dict]]:
        step = latest_step(self.ckpt_dir)
        if step is None:
            return None
        return restore_checkpoint(self.ckpt_dir, template, step)
