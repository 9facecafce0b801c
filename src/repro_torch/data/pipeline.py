"""Data pipeline: deterministic synthetic LM streams, document packing,
and the device feed (the counterpart of ``repro/data/pipeline.py``).

``SyntheticLM`` and ``pack_documents`` are numpy copies of the reference's:
for the same seed and step their batches are the reference's bit for bit.
The stream is an order-2 Markov-ish process (the next token is an affine
function of the previous two plus bounded noise), so a real model can
learn it. ``shard_batch`` has no counterpart on one device: ``to_device``
places a host batch on the card, and ``make_batch_iterator`` keeps the
reference's background thread, which overlaps host data work with the
device's step.
"""

from __future__ import annotations

import queue as queue_mod
import threading
from typing import Dict, Iterator, List

import numpy as np
import torch

from ..device import resolve_device


class SyntheticLM:
    """Deterministic, seekable synthetic token stream."""

    def __init__(self, vocab: int, seq_len: int, batch: int,
                 seed: int = 0, noise: float = 0.05):
        self.vocab = vocab
        self.seq_len = seq_len
        self.batch = batch
        self.seed = seed
        self.noise = noise
        self._step = 0

    def seek(self, step: int) -> None:
        """Restart from an arbitrary step (checkpoint-resume determinism)."""
        self._step = step

    def _gen(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.RandomState((self.seed * 1_000_003 + step)
                                    % (2 ** 31))
        b, s, v = self.batch, self.seq_len, self.vocab
        toks = np.zeros((b, s), np.int64)
        toks[:, 0] = rng.randint(0, v, b)
        toks[:, 1] = rng.randint(0, v, b)
        a, c = 31, 17
        for t in range(2, s):
            toks[:, t] = (a * toks[:, t - 1] + 7 * toks[:, t - 2] + c) % v
        flip = rng.rand(b, s) < self.noise
        toks = np.where(flip, rng.randint(0, v, (b, s)), toks)
        return {"tokens": toks.astype(np.int32),
                "labels": toks.astype(np.int32)}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        batch = self._gen(self._step)
        self._step += 1
        return batch


def pack_documents(docs: List[np.ndarray], seq_len: int, pad_id: int = 0
                   ) -> Dict[str, np.ndarray]:
    """Greedy sequence packing: concatenate docs into fixed-length rows;
    label -1 at every document boundary (no cross-doc prediction)."""
    rows: List[np.ndarray] = []
    labels: List[np.ndarray] = []
    cur: List[int] = []
    cur_lab: List[int] = []
    for doc in docs:
        doc = list(doc)
        i = 0
        while i < len(doc):
            space = seq_len - len(cur)
            take = doc[i:i + space]
            cur.extend(take)
            # first token of a doc gets label -1 on its *predecessor* slot
            cur_lab.extend(take)
            if i == 0 and len(cur_lab) >= len(take):
                idx = len(cur_lab) - len(take)
                cur_lab[idx] = -1
            i += len(take)
            if len(cur) == seq_len:
                rows.append(np.array(cur, np.int32))
                labels.append(np.array(cur_lab, np.int32))
                cur, cur_lab = [], []
    if cur:
        pad = seq_len - len(cur)
        rows.append(np.array(cur + [pad_id] * pad, np.int32))
        labels.append(np.array(cur_lab + [-1] * pad, np.int32))
    return {"tokens": np.stack(rows), "labels": np.stack(labels)}


def to_device(batch: Dict[str, np.ndarray], device=None
              ) -> Dict[str, torch.Tensor]:
    """A host batch as int32 tensors on ``device`` (default: the CUDA
    card). To a CUDA device each array goes through pinned memory with a
    non-blocking copy on the current stream."""
    dev = resolve_device(device)
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v, dtype=np.int32))
        if dev.type == "cuda":
            t = t.pin_memory().to(dev, non_blocking=True)
        else:
            t = t.to(dev)
        out[k] = t
    return out


def make_batch_iterator(source: Iterator, device=None,
                        prefetch: int = 2) -> Iterator:
    """Batches of ``source``, placed on ``device`` by :func:`to_device`
    (``None``: left on the host, as the reference leaves them without a
    mesh), prepared ``prefetch`` batches ahead on a background thread."""
    def place(b):
        return b if device is None else to_device(b, device)

    if prefetch <= 0:
        for b in source:
            yield place(b)
        return

    q: "queue_mod.Queue" = queue_mod.Queue(maxsize=prefetch)
    stop = object()
    failure: List[BaseException] = []

    def worker():
        try:
            for b in source:
                q.put(place(b))
        except BaseException as e:                  # noqa: BLE001
            failure.append(e)
        finally:
            q.put(stop)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is stop:
            if failure:
                raise failure[0]
            return
        yield item
