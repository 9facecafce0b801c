"""Batched serving (the counterpart of ``repro/launch/serve.py``):
greedy decode over ``slots`` concurrent sequences, on the CUDA card by
default.

Serving workers bootstrap through the elastic control plane: the step
callable comes from an ``ExecutablePool``, so a worker joining a serving
fleet reuses the pool entry. In JAX the entry is a compiled executable; in
the port it is the decode step. A cold worker still makes one warm-up
call on representative shapes (it initialises the card's math libraries
and the caching allocator for those shapes); a pool hit skips it. On the
card the step keeps a CUDA graph per cache (``launch/steps.py``): each
worker's first step captures one for the worker's own cache, and its later
steps replay it. ``bootstrap_s`` is timed as in JAX, and on the card it
waits for the warm-up to finish.

    python -m repro_torch.launch.serve --arch qwen2-0.5b --smoke \\
        --device cpu
"""

from __future__ import annotations

import argparse
import time
from typing import Optional

import numpy as np
import torch

from ..configs import get_config, get_smoke_config
from ..device import resolve_device
from ..elastic import ExecutablePool
from ..launch.steps import make_decode_step
from ..models import init_decode_cache, init_params


class ServingWorker:
    """One model replica with ``slots`` concurrent sequences, on the device
    its parameters lie on."""

    def __init__(self, cfg, params, slots: int, max_len: int,
                 pool: Optional[ExecutablePool] = None):
        self.cfg = cfg
        self.params = params
        self.slots = slots
        self.max_len = max_len
        self.pool = pool or ExecutablePool()
        self.device = params["embed"].device
        self.bootstrap_s = None
        t0 = time.time()
        key = ("decode", cfg.name, slots, max_len)
        kind, fn = self.pool.get(key)
        if fn is None:
            fn = make_decode_step(cfg)
            # warm-up against representative shapes
            cache = init_decode_cache(cfg, slots, max_len, enc_len=16,
                                      device=self.device)
            fn(params, cache,
               torch.zeros((slots,), dtype=torch.int32, device=self.device),
               4)
            self.pool.put(key, fn)
        self.decode_fn = fn
        self.cache = init_decode_cache(cfg, slots, max_len, enc_len=16,
                                       device=self.device)
        self.cur_len = 4
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.bootstrap_s = time.time() - t0

    def decode_tokens(self, tokens: np.ndarray, n_steps: int) -> np.ndarray:
        """Greedy continuation for all slots; (slots, n_steps) int32."""
        out = []
        toks = torch.as_tensor(np.asarray(tokens), dtype=torch.int32,
                               device=self.device)
        for _ in range(n_steps):
            logits, self.cache = self.decode_fn(
                self.params, self.cache, toks, self.cur_len)
            toks = torch.argmax(logits, dim=-1).to(torch.int32)
            self.cur_len += 1
            out.append(toks)
        return torch.stack(out, dim=1).cpu().numpy()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--replicas", type=int, default=2)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    device = resolve_device(args.device)
    gen = torch.Generator(device=device).manual_seed(0)
    params = init_params(cfg, gen, device)
    pool = ExecutablePool()
    for i in range(args.replicas):
        w = ServingWorker(cfg, params, args.slots, args.max_len, pool=pool)
        toks = w.decode_tokens(np.zeros(args.slots, np.int32), args.steps)
        print(f"replica {i}: bootstrap {w.bootstrap_s*1e3:8.2f} ms "
              f"({'pool hit' if i else 'cold start'}), "
              f"decoded {toks.shape[1]} steps x {toks.shape[0]} slots")
    print(f"pool stats: hits={pool.stat_hits} misses={pool.stat_misses}")


if __name__ == "__main__":
    main()
