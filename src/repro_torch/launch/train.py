"""End-to-end training loop (the counterpart of
``repro/launch/train.py``): synthetic data with a background prefetch onto
the device, AdamW with clipping, async checkpoints with crash-safe
auto-resume, and per-step logging.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2_0_5b \\
        --smoke --steps 100 --batch 8 --seq 128 --ckpt-dir ckpt [--device cpu]

Without ``--device`` it trains on the CUDA card and raises without one.
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import time

import torch

from ..checkpoint import CheckpointManager
from ..configs import get_config, get_smoke_config
from ..data import SyntheticLM, make_batch_iterator
from ..device import resolve_device
from ..models import init_params
from ..optim import adamw_init
from .steps import make_train_step


def run(arch: str, smoke: bool, steps: int, batch: int, seq: int,
        ckpt_dir: str | None, ckpt_every: int = 20, lr: float = 3e-3,
        log_every: int = 10, seed: int = 0, device=None):
    """Train ``arch`` (its smoke config with ``smoke``) to step ``steps``,
    resuming from the newest committed checkpoint in ``ckpt_dir`` if there
    is one; params drawn from ``seed`` by a generator on ``device``
    (default: the CUDA card). Saves every ``ckpt_every`` steps and at the
    end. Returns the losses of the steps taken, as floats."""
    dev = resolve_device(device)
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    if cfg.grad_accum > 1 and batch % cfg.grad_accum:
        cfg = dataclasses.replace(cfg, grad_accum=1)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(seed))
    opt_state = adamw_init(params)
    start_step = 0
    manager = CheckpointManager(ckpt_dir) if ckpt_dir else None
    if manager is not None:
        restored = manager.restore_latest((params, opt_state))
        if restored is not None:
            start_step, (params, opt_state), _ = restored
            print(f"resumed from step {start_step}")

    data = SyntheticLM(cfg.vocab, seq, batch, seed=seed)
    data.seek(start_step)
    step_fn = make_train_step(cfg, lr=lr)
    it = make_batch_iterator(
        itertools.islice(data, max(steps - start_step, 0)), device=dev)
    losses = []
    t0 = time.time()
    for step, batch_dev in zip(range(start_step, steps), it):
        loss, params, opt_state = step_fn(params, opt_state, batch_dev)
        losses.append(float(loss))
        if (step + 1) % log_every == 0:
            dt = (time.time() - t0) / log_every
            print(f"step {step + 1:5d} loss {losses[-1]:.4f} "
                  f"{dt * 1e3:.1f} ms/step", flush=True)
            t0 = time.time()
        if manager is not None and (step + 1) % ckpt_every == 0:
            manager.save_async(step + 1, (params, opt_state),
                               {"loss": losses[-1]})
    if manager is not None:
        manager.wait()
        manager.save_async(steps, (params, opt_state),
                           {"loss": losses[-1] if losses else None})
        manager.wait()
    return losses


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' runs the plain "
                         "PyTorch versions")
    args = ap.parse_args()
    losses = run(args.arch, args.smoke, args.steps, args.batch, args.seq,
                 args.ckpt_dir, lr=args.lr, device=args.device)
    print(f"first loss {losses[0]:.4f} -> last loss {losses[-1]:.4f}")


if __name__ == "__main__":
    main()
