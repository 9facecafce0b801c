#!/usr/bin/env python3
"""Drive the PyTorch port's device paths on one CUDA card: the device
RACE-table lookup, the serverless chain hop, model serving (prefill and
decode) for qwen2-0.5b, rwkv6-7b, olmoe-1b-7b, deepseek-v2-236b (4 of its
60 layers), zamba2-1.2b and seamless-m4t-medium, training (qwen2-0.5b at full
size, rwkv6-7b at full width and 4 of its 32 layers, each with a checkpoint
and a resume bit for bit, then qwen2-0.5b under ``ElasticTrainer``, a pool
hit against a cold build), and the elastic KV service (dkv) with its device
shard map; then the invocation gateway on the host, the GPipe pipeline over
qwen2-0.5b's layers on the card, and the dry run of the production meshes
(deepseek-v2-236b at full depth) on the host.

Run from the repository root, on a machine with one CUDA card and the CUDA
toolkit (``nvcc``):

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing falls back to the CPU or to a
plain version):

1. Device report: the card's name and power limit from ``nvidia-smi``;
   both TF32 switches off (float32 products in full float32).
2. Build: print ``nvcc --version`` (the by-value routes need CUDA 12.1's
   32,764 bytes of kernel parameters), compile every CUDA source of the
   port (``race_lookup.cu``, ``serverless_stage.cu``, ``flash_attention.cu``
   and ``wkv.cu``; one ``nvcc`` per source, started together) and print
   each ``-Xptxas -v`` report.
3. Kernel parity: each kernel against its plain PyTorch version on the
   card, exact. The lookup kernels, each on both routes (routing on the
   host: ``race_lookup_{tiled,scalar,sharded}_byval`` up to 2,032 queries;
   on the card: ``race_lookup_{tiled,scalar,sharded}``), and the scalar
   kernel's calls a shard (``impl="scalar"``, the routing split by shard
   on the host): values and ``found`` at the test shapes (NSLOT
   4/8/16/32, ragged tails, NQ = 0), out-of-range bucket ids, empty and
   ragged shards, float32 and bfloat16 value tables, and at NSLOT
   4/8/16/32 and NQ 1, odd, 2,031, 2,032 and 2,033. ``chunk_gather`` on both
   routes (routing on the host: ``chunk_gather_byval`` up to 2,048 chunks;
   on the card: ``chunk_gather``): NOUT 0, 1, ragged, 2,047, 2,048 and
   2,049; ``valid`` 0, 1, 64, 127, 128, above 128 and negative; repeated
   rows, NSRC = 1, ids outside [0, NSRC) (a negative id wraps once, then
   ids clamp, as in JAX), other chunk sizes and an unaligned source (the
   scalar path); and ``stage_pack`` / ``stage_unpack`` round trips over
   payloads of 0, 1, 127, 128, 129 and 513 elements, equal to the same
   calls on the CPU. Each case checks the route that launched.
   ``flash_attention``: the six cases of ``test_flash_attention_sweep``,
   the block-shape case, qwen2's prefill shape (8, 14, 512, 64) in bf16
   and float32, ragged S = 200 and 544, D = 96 and 256 with window 512 and
   cap 50 in bf16, and
   ``kv_len`` cases; the new families' shapes: olmoe's prefill (4, 16,
   512, 128) bf16, deepseek-v2's MLA (1, 128, 512, 192) bf16 with v's
   columns 128-191 zero (those output columns must be exactly 0, on the
   tensor-core route), seamless's cross-attention (4, 16, 512, 64) against
   Skv 512 and a ragged 1,000, non-causal, in bf16 and float32; all at
   2e-5 (float32) / 2e-2 (bf16); the cases at the
   models' shapes draw inputs large enough that each tolerance lies below
   the output's mean magnitude, which the phase checks; and the result is
   the same bit for bit whatever ``bq``/``bk`` (float32 and bf16).
   ``wkv``: the four ``test_wkv_sweep`` cases, decay at the -4.25 clamp,
   and rwkv6-7b's shape (4, 64, 512, 64) with bf16 r/k/v and float32 logw,
   then in float32: ``o`` and the final state against the plain chunked
   version, ``o`` against ``wkv_sequential``, at 5e-4 / 1e-3 (a bf16 ``o``
   at 2e-2). Every case runs through the route its dispatch picks
   (``flash_route``: bf16 at any D <= 256 on ``flash_attention_mma``,
   float32 on ``flash_attention``; ``wkv_route``: 64 x 64 heads in chunks of
   16 on ``wkv_split``, the rest on ``wkv``), and the phase checks that
   route launched.
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
   table's run and read just after; gates (the hashed routing stays on the
   host): the table launches 16 ``race_lookup_tiled_byval`` (its 64 and 512
   batches), 9 ``race_lookup_tiled`` (the 4,096 batches) and 1
   ``race_lookup_scalar``, the sharded one 16 ``race_lookup_sharded_byval``,
   9 ``race_lookup_sharded`` and 4 ``race_lookup_scalar_byval`` (one a
   shard).
5. Lookup kernel times: per route and batch size, the device time per
   launch from CUDA events over many launches queued behind a spin kernel
   (each route on the routing it takes on the main path), the plain
   version's time the same way, the host time of ``lookup_batch`` (median
   and 90th percentile of 200 calls) with a breakdown by step, the bound
   (bytes the batch needs over 3.35 TB/s), and each tiled and scalar
   route's time over the sharded route's at the same batch (the in-run
   control; the scalar calls a shard over ``race_lookup_sharded_byval``
   on the same queries). Then, both tables alive, ``lookup_batch`` on each
   in turns (p50 and p90 of 200 calls each), so that the two see the same
   host. Gates: one ``lookup_batch`` of 512 keys shows one device span
   under ``torch.profiler`` on either table (the kernel; no copy), and the
   sharded table's ``impl="scalar"`` call of 4,096 keys shows four (a
   kernel a shard; no copy, no gather, no scatter).
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
   and read just after; gate: 70 ``chunk_gather_byval`` launches and none
   of the device route (every chain gather fits 2,048 chunks).
7. Chain times: ``chunk_gather_byval``'s device time per launch on a
   16 x 1 KiB slab and a 16 x 64 KiB slab (routing on the host), and the
   device route's there and, beyond the chain's sizes, at 64 x 1 MiB
   (routing on the card), beside the plain version's, ``index_select``'s
   (the same gather without the mask; the by-value route's ratio to it)
   and the bound; the host time of ``encode_slab`` and ``decode_slab``
   (median and 90th percentile of 200 calls) with a breakdown by step; the
   wall time of a chain epoch; and the card's busy share of one epoch from
   ``torch.profiler``. Gate: that K = 64 x 1 KiB epoch shows 48 device
   spans (16 gathers, each one copy of the source, the kernel, one copy
   back).
8. Serving path at full width, bf16 (the configs' dtype), one model at a
   time (each freed before the next): qwen2-0.5b, rwkv6-7b, olmoe-1b-7b,
   deepseek-v2-236b, zamba2-1.2b, seamless-m4t-medium, parameters drawn on
   the card from the seed; full depth but for deepseek-v2, which runs its
   dense first layer and 3 MoE layers (~26 GB; all 60 need ~470 GB, four
   cards and the sharding plans), printed as ``reduced``.
   ``make_prefill_step`` on 8 x 512 (qwen2) / 4 x 512 (the others) prompt
   tokens (seamless: 512 frames and 512 decoder tokens), max_len 1024, 32
   greedy ``make_decode_step`` steps from that cache, then two
   ``ServingWorker`` replicas on one ``ExecutablePool`` (a cold start,
   then a pool hit). Logits finite, tokens in [0, vocab), cache trees,
   shapes and dtypes JAX's; a prefill launches exactly 24 (qwen2), 16
   (olmoe), 4 (deepseek's MLA at D = 192), 6 (zamba2's shared block) and
   36 (seamless: 12 encoder, 12 decoder, 12 cross) ``flash_attention_mma``
   and 32 ``wkv_split`` (rwkv6), none of ``flash_attention``; none in
   decode. Then prefill ms and tokens/s, decode ms per step, both
   bootstraps, the card's idle share over a prefill (``torch.profiler``)
   and the peak allocated memory.
9. Prefill -> decode consistency at full width in float32 (the port of
   ``tests/test_models.py:86``, with its settings: MoE at a capacity
   factor of 1000): b = 1, s = 544, cut = 512 (zamba2: s = 576, its chunks
   being 64 tokens), atol = rtol = 1e-3, every model of phase 8 at full
   depth but deepseek-v2 (its dense layer and one MoE layer, ~21 GB);
   ``forward_full`` and ``prefill`` run the kernels (the float32
   ``flash_attention`` route, rwkv6's ``wkv_split``), ``decode_step`` the
   plain recurrences, so a wrong kernel shows as a mismatch. For MoE every
   routing decision of the prefill and of each decode step is compared
   with the teacher-forced pass's; the number that differ is printed with
   each one's margin, and one beyond a near-tie (1e-4) fails.
10. Model kernel times, each entry point at the shape its main-path run
    gives it: device time per launch, its ratio to its bound and to
    ``scaled_dot_product_attention`` (flash; WKV has no library call), the
    plain version's time; then the bf16 flash route at the new families'
    prefill shapes (olmoe, deepseek-v2's MLA, zamba2's shared block,
    seamless's encoder / cross and decoder attention) and at gemma2-2b's
    (D = 256, served by no phase) beside SDPA in turns. The
    one-CTA-a-head ``wkv`` route is on no
    main-path run (rwkv6-7b's 512-token prompts take ``wkv_split``); it is
    timed at rwkv6-7b's heads over an 8-token prompt, the one chunk of 8
    tokens it would scan, and held there on ``o`` and the final state.
    Then the registers, stack, spills and static shared memory of the
    redesigned kernels from the ptxas report of the build; gate: the
    lookup kernels (sharded, which the tiled routes launch at one shard,
    and scalar), ``chunk_gather_byval`` and ``flash_mma_kernel`` at
    DP = 192 (deepseek's MLA) have a 0-byte stack frame and no spills.
11. Training path. First the kernels' autograd ``Function``s at the train
    shapes (``train_kernel_grads``): ``flash_attention_mma`` at qwen2's
    train shape, q (4, 14, 4,096, 64) and k/v (4, 2, 4,096, 64) in bf16,
    causal, at the elastic phase's, q (4, 14, 1,024, 64) and k/v
    (4, 2, 1,024, 64), and at the pipeline phase's, q (1, 14, 4,096, 64)
    and k/v (1, 2, 4,096, 64); ``flash_attention`` in float32 at (1, 14,
    512, 64), causal and with a window, a softcap, ``kv_len`` and
    ``q0 > 0``; ``wkv_split`` at (2, 64, 1,024, 64) with bf16 r/k/v views
    and float32 logw from a non-zero state, cotangents on ``o`` and the final state. The forward
    (the kernel, the route checked) against the plain version at 2e-2
    (bf16) / 2e-5 (float32), and the gradients of a seeded random cotangent
    against the plain version's own autograd gradients, bit for bit (the
    backward recomputes through that same function); then, at the models'
    shapes, each forward's and each backward's (the plain recompute's)
    device time. Then ``make_train_step`` (lr 3e-4) on ``SyntheticLM``
    batches through ``make_batch_iterator`` onto the card, parameters drawn
    on the card from seed 0, bf16 (the configs' dtype), each model freed
    before the next: qwen2-0.5b at full size (remat "block"), 4 x 4,096
    tokens a step (``train_4k``'s global batch of 256 cut to 4, printed as
    ``reduced``), 8 steps, ``save_async`` of (params, AdamWState) after step
    4 and ``wait``, then step 4 restored into a freshly drawn template (bit
    for bit the saved tree: params, mu, nu, step) and steps 5-8 taken again;
    rwkv6-7b at full width and 4 of its 32 layers (``reduced``: all 32 with
    float32 moments need ~91 GB), its grad_accum of 2, 4 x 1,024 tokens a
    step, 4 steps, the same with a checkpoint after step 2 and steps 3-4
    again (each model's checkpoint in a directory of its own, removed after
    the model). Then the elastic trainer (``elastic_phase``): qwen2-0.5b as
    above at 4 x 1,024 tokens a step, the first batch also the example
    batch; trainer H (ladder (1,)) ``prewarm``s, and its ``scale_to(1)``
    must be a generic pool hit with no build; trainer C (no ladder) must
    build once in a cold ``scale_to(1)``; each then takes the same 3 steps
    from the same initial state and scales to 1 again on the state it
    holds. The phase runs in a process of its own
    (``chip_smoke.py --train``, started by the script) with
    ``CUBLAS_WORKSPACE_CONFIG=:4096:8``, which cuBLAS needs under
    ``torch.use_deterministic_algorithms`` and which makes every cuBLAS
    call slower on the host, so the other phases run without it; the steps
    run under ``torch.use_deterministic_algorithms(True, warn_only=True)``.
    Gates: the
    gradients of one batch are finite and not all zero in every leaf; every
    loss is finite; qwen2's mean loss of steps 6-8 lies below step 1's; no
    op of the steps warns of a missing deterministic implementation, and
    each model's resumed losses equal the straight run's bit for bit; the
    elastic trainers' kinds and builds as above, no op warning, H's losses
    equal C's bit for bit, each trainer's second ``scale_to(1)`` a hit
    with no build; each step launches exactly what the code
    implies (``train_launches``): the forward's kernel calls once a
    microbatch and once more where remat reruns the layer in the backward,
    so 48 ``flash_attention_mma`` (qwen2: 24 + 24) and 16 ``wkv_split``
    (rwkv6: 4 layers x 2 microbatches x 2) and nothing else (the backward's
    recompute launches no kernel), 48 ``flash_attention_mma`` too in each
    elastic step. Printed: the step time (median of steps
    2-8, host clock ending in a synchronize) and tokens/s, the card's busy
    time and idle share over one more step with the top device functions
    (``torch.profiler``), the peak allocated memory, the share of the step
    spent in the backward's plain recompute (recomputes a step x the
    recompute's device time / the step time), the elastic trainers'
    ``control_s`` (hit, cold, and each second ``scale_to`` on a drawn
    state), H's ``compile_s`` and their step time,
    beside the card's name and power limit, and the phase's wall time.
12. Elastic KV path (``repro_torch.dkv`` over the simulated fabric):
    ``DkvService`` on 3 memory nodes and 4 compute nodes, 8 shards x
    131,071 buckets x 8 slots (128 MiB of simulated store; the
    full-suite layout of ``benchmarks/elastic_kv.py``'s bootstrap suite,
    buckets raised to a prime) seeded with 1,000,000 keys in [1, 2**32)
    and 8-byte values; 24 workers forked as that suite forks them, each
    ``DkvClient.bootstrap()`` then ``get_many`` of a 512-key YCSB-C batch
    (Zipfian 0.99), then 512 keys never loaded. The device mirror, a
    ``ShardedDeviceRaceTable(8, 131_071, 8, vdim=8)`` on the card (one
    float32 lane per value byte, so values are exact) holding the same
    keys, answers the 25 batches of 512 (``race_lookup_sharded_byval``)
    and one of 4,096, the first 8 worker batches together
    (``race_lookup_sharded``): every ``found`` equals "the simulated get
    returned a value", every value the 8 simulated bytes, and so does the
    plain version. Launch counters are cleared just before the mirror's
    lookups and read just after; gate: 25 ``race_lookup_sharded_byval``
    and 1 ``race_lookup_sharded``. Then ``lookup_batch`` p50/p90 over 200
    calls at 512 and 4,096 keys, each call ending in a synchronize, and
    the three suites of ``benchmarks/elastic_kv.py`` re-implemented over
    the port at their full-suite settings, with its gates: the KRCORE
    attach >= 80% below verbs; 0 torn reads and 0 oracle violations with
    at least one read during the migration; served == enqueued and the
    spike wait-p99 >= 20% below verbs. Simulated times are the cost
    model's microseconds, not times on any chip; the host wall times of
    seeding, simulation and mirroring are printed beside them.
13. Gateway (host only, launches no kernel, checked): the trace cells of
    ``benchmarks/serverless.py`` (4 nodes, 200,000 us, 400/s; Poisson,
    spike and diurnal traces, seeds 1-3), its closed-loop response cell (2
    nodes, 120,000 us, 150/s, a x8 spike over 20% of the run) and the
    worker-pull case of ``tests/test_dkv.py``; gates of its
    ``check_gates``: no invocation dropped, invocations in the spike
    window.
14. Pipeline (``pipeline_phase``): ``pipeline_apply`` over a one-rank
    NCCL "stage" mesh, the stage qwen2-0.5b's 24 decoder layers
    (``dense_layer_full``) at full width in bf16, parameters drawn on the
    card from seed 0, 4 microbatches of 1 x 4,096 tokens (embeddings of
    drawn tokens), the loss the outputs' mean square, gradients of every
    layer parameter. Gates: the forward equals the layers run microbatch
    by microbatch bit for bit; two pipelined runs' gradients equal bit for
    bit, and they lie within ``PIPELINE_GRAD_TOL`` (a leaf's largest error
    over its largest value) of the whole batch's run in one call; each
    pipelined run launches exactly 96 ``flash_attention_mma`` (24 layers x
    4 microbatches; its shape, q (1, 14, 4,096, 64), is a case of phase
    11's autograd routes), counted from 0 just before it and read just
    after. Printed: after an untimed run of each, the runs' host times in
    turns (pipeline, whole batch, whole batch, pipeline) and their peak
    allocated memory.
15. Dry run (``chip_smoke.py --dryrun``, a child process, since the fake
    process groups of 256 and 512 ranks are default groups): qwen2-0.5b
    and deepseek-v2-236b at full depth (60 layers; no card holds its ~470
    GB) at ``train_4k`` on 16 x 16 (with the depth variants' exact FLOPs)
    and 2 x 16 x 16, each traced on the meta device on the host
    (``launch.dryrun.run_cell``). Printed: a rank's argument and output
    bytes, FLOPs a rank, the collectives and the trace seconds. Gates:
    every cell "ok", FLOPs and bytes above 0, and the train step's one
    all-reduce over the data-parallel group, 16 ranks on 16 x 16 and 32
    (pod x data) on 2 x 16 x 16.
16. A ``{"kernels": [...]}`` line with every C entry point (its launches
    are those of every main-path run above: lookups, chain hops, prefills,
    the float32 consistency prefills, the train and elastic steps, the
    dkv mirror's lookups and the pipelined runs; each
    entry point but ``wkv`` and the device route of ``chunk_gather`` must
    have launched there), then as the last line ``{"ok": true, "device":
    {...}}``.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import gc
import itertools
import math
import json
import os
import re
import shutil
import statistics
import struct
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.checkpoint import (  # noqa: E402
    CheckpointManager, restore_checkpoint)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import SyntheticLM, make_batch_iterator  # noqa: E402
from repro_torch.core import (  # noqa: E402
    VerbsProcess, WorkRequest, make_cluster)
from repro_torch.dkv import (  # noqa: E402
    DkvClient, DkvService, PullQueue, WorkerPullAutoscaler, shard_key)
from repro_torch.elastic import ElasticTrainer, ExecutablePool  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.kernels.flash_attention.flash_attention import (  # noqa: E402
    flash_attention_cuda, flash_route)
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    flash_attention_ref)
from repro_torch.kernels.race_lookup import ops  # noqa: E402
from repro_torch.kernels.race_lookup import race_lookup as kern  # noqa: E402
from repro_torch.kernels.race_lookup.ref import (  # noqa: E402
    make_table, race_lookup_ref, race_lookup_routed_ref,
    race_lookup_sharded_ref)
from repro_torch.kernels.serverless_stage import (  # noqa: E402
    ops as stage_ops)
from repro_torch.kernels.serverless_stage.ref import (  # noqa: E402
    chunk_gather_ref)
from repro_torch.kernels.serverless_stage.stage import (  # noqa: E402
    BYVAL_CAP as GATHER_CAP, CHUNK, ROUTES as GATHER_ROUTES,
    chunk_gather_cuda, gather_route)
from repro_torch.kernels.rwkv6 import ops as wkv_ops  # noqa: E402
from repro_torch.kernels.rwkv6.ref import (  # noqa: E402
    wkv_chunked_ref, wkv_sequential)
from repro_torch.kernels.rwkv6.rwkv6 import wkv_cuda, wkv_route  # noqa: E402
from repro_torch.kvs.race import (  # noqa: E402
    NSLOT, SLOT_BYTES, DeviceRaceTable, RaceClient, ShardedDeviceRaceTable,
    query_hashes, query_shards)
from repro_torch.distributed.pipeline import pipeline_apply  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import ensure_process_group  # noqa: E402
from repro_torch.launch.serve import ServingWorker  # noqa: E402
from repro_torch.launch.steps import (  # noqa: E402
    make_decode_step, make_prefill_step, make_train_step)
from repro_torch.models import (  # noqa: E402
    TRAIN_4K, count_params, count_params_config, decode_step, forward_full,
    init_params, prefill, train_loss, trainable)
from repro_torch.optim import adamw_init  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402
from repro_torch.models.blocks import dense_layer_full  # noqa: E402
from repro_torch.models.model import (  # noqa: E402
    _layers, embed, unembed_chunk)
from repro_torch.serverless import (  # noqa: E402
    ChainRunner, ContainerPool, InvocationGateway, decode_slab,
    default_registry, diurnal_trace, encode_slab, expected_outputs,
    poisson_trace, spike_trace)

HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
BF16_FLOP_PER_S = 989e12           # dense tensor-core peak, same sheet
FP32_FLOP_PER_S = 67e12            # float32 outside the tensor cores
SOURCES = {
    "race_lookup_tiled_byval":
        "src/repro_torch/kernels/race_lookup/csrc/race_lookup.cu",
    "race_lookup_tiled":
        "src/repro_torch/kernels/race_lookup/csrc/race_lookup.cu",
    "race_lookup_scalar_byval":
        "src/repro_torch/kernels/race_lookup/csrc/race_lookup.cu",
    "race_lookup_scalar":
        "src/repro_torch/kernels/race_lookup/csrc/race_lookup.cu",
    "race_lookup_sharded_byval":
        "src/repro_torch/kernels/race_lookup/csrc/race_lookup.cu",
    "race_lookup_sharded":
        "src/repro_torch/kernels/race_lookup/csrc/race_lookup.cu",
    "chunk_gather_byval":
        "src/repro_torch/kernels/serverless_stage/csrc/serverless_stage.cu",
    "chunk_gather":
        "src/repro_torch/kernels/serverless_stage/csrc/serverless_stage.cu",
    "flash_attention_mma":
        "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
    "flash_attention":
        "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
    "wkv_split": "src/repro_torch/kernels/rwkv6/csrc/wkv.cu",
    "wkv": "src/repro_torch/kernels/rwkv6/csrc/wkv.cu",
}
REPLACES = {
    "race_lookup_tiled_byval":
        "src/repro/kernels/race_lookup/race_lookup.py:167",
    "race_lookup_tiled": "src/repro/kernels/race_lookup/race_lookup.py:167",
    "race_lookup_scalar_byval":
        "src/repro/kernels/race_lookup/race_lookup.py:76",
    "race_lookup_scalar": "src/repro/kernels/race_lookup/race_lookup.py:76",
    "race_lookup_sharded_byval":
        "src/repro/kernels/race_lookup/race_lookup.py:226",
    "race_lookup_sharded": "src/repro/kernels/race_lookup/race_lookup.py:226",
    "chunk_gather_byval": "src/repro/kernels/serverless_stage/stage.py:44",
    "chunk_gather": "src/repro/kernels/serverless_stage/stage.py:44",
    "flash_attention_mma":
        "src/repro/kernels/flash_attention/flash_attention.py:96",
    "flash_attention":
        "src/repro/kernels/flash_attention/flash_attention.py:96",
    "wkv_split": "src/repro/kernels/rwkv6/rwkv6.py:71",
    "wkv": "src/repro/kernels/rwkv6/rwkv6.py:71",
}
#: every C entry point of the port, in the order of the ``kernels`` line
ENTRY_POINTS = tuple(SOURCES)
#: entry points that no main-path run launches: each is held against its
#: plain version and timed at its own shape
OFF_MAIN_PATH = ("chunk_gather", "wkv")
#: the deployment the main path runs (see the module docstring)
REAL_SIZE = dict(n_buckets=524_287, shard_buckets=131_071, n_shards=4,
                 nslot=8, vdim=256, n_keys=1_000_000,
                 batches=(64, 512, 4096), reps=8, seed=0)
CHAIN = ("extract", "transform", "load")
#: the chain path: the chain cells of ``benchmarks/serverless.py``'s suite,
#: and a ragged epoch up to the largest payload its transfer suite measures
CHAIN_SIZE = dict(ks=(8, 32, 64), payload_bytes=1024, slab_payloads=16,
                  ragged_k=64, ragged_max_bytes=64 * 1024, seed=0)
#: the serving path: each published model at full width, bf16, and the
#: route each prefill must launch once an attention call (``attn_calls``);
#: full depth but for deepseek-v2, whose 60 layers (~470 GB of bf16
#: weights) do not fit one card: it runs its dense first layer and 3 MoE
#: layers (~26 GB), a cut the phase prints as ``reduced``
SERVE_SIZE = (dict(arch="qwen2_0_5b", batch=8, prompt=512, max_len=1024,
                   route="flash_attention_mma"),
              dict(arch="rwkv6_7b", batch=4, prompt=512, max_len=1024,
                   route="wkv_split"),
              dict(arch="olmoe_1b_7b", batch=4, prompt=512, max_len=1024,
                   route="flash_attention_mma"),
              dict(arch="deepseek_v2_236b", batch=4, prompt=512,
                   max_len=1024, route="flash_attention_mma", n_layers=4),
              dict(arch="zamba2_1_2b", batch=4, prompt=512, max_len=1024,
                   route="flash_attention_mma"),
              dict(arch="seamless_m4t_medium", batch=4, prompt=512,
                   max_len=1024, route="flash_attention_mma"))
SERVE_STEPS = dict(decode_steps=32, worker_steps=8, seed=0)
#: prefill->decode consistency in float32, at full width: each arch, the
#: route its forward_full and prefill must launch, and its lengths; full
#: depth but for deepseek-v2 (its dense layer and one MoE layer, ~21 GB in
#: float32); zamba2's ``ssd_chunked`` scans whole 64-token chunks, so its
#: lengths are multiples of 64
CONSISTENCY = {
    "qwen2_0_5b": dict(route="flash_attention"),
    "rwkv6_7b": dict(route="wkv_split"),
    "olmoe_1b_7b": dict(route="flash_attention"),
    "deepseek_v2_236b": dict(route="flash_attention", n_layers=2),
    "zamba2_1_2b": dict(route="flash_attention", s=576, cut=512),
    "seamless_m4t_medium": dict(route="flash_attention"),
}
CONSISTENCY_SIZE = dict(s=544, cut=512, tol=1e-3, seed=1)
#: a routing decision that differs between the teacher-forced pass and
#: decode is a fault unless the probabilities of the k-th and the
#: (k+1)-th expert lie closer than this (float32 rounding of the logits)
ROUTING_TIE = 1e-4
#: the training path: qwen2-0.5b at full size (bf16, its remat "block"),
#: 4 x 4,096 tokens a step (``train_4k``'s global batch of 256 cut to 4, to
#: fit one card and the run's time), 8 steps, a checkpoint after step 4 and
#: steps 5-8 again from it; rwkv6-7b at full width, 4 of its 32 layers (all
#: 32 with float32 moments need ~7.6 G x 12 B = 91 GB), its grad_accum of 2,
#: 4 x 1,024 tokens a step (two microbatches of 2), 4 steps, a checkpoint
#: after step 2 and steps 3-4 again from it
TRAIN_SIZE = (dict(arch="qwen2_0_5b", batch=4, seq=4096, steps=8,
                   resume_at=4, descent=True, route="flash_attention_mma"),
              dict(arch="rwkv6_7b", batch=4, seq=1024, steps=4,
                   resume_at=2, route="wkv_split", n_layers=4))
#: the elastic trainer: qwen2-0.5b at full size as the train phase builds it
#: (bf16, remat "block"), 4 x 1,024 tokens a step, 3 steps a trainer
ELASTIC_SIZE = dict(arch="qwen2_0_5b", batch=4, seq=1024, steps=3, seed=0)
#: the pipeline phase: qwen2-0.5b's decoder layers as the one stage of a
#: one-rank "stage" mesh, ``n_micro`` microbatches of 1 x ``seq`` tokens
PIPELINE_SIZE = dict(arch="qwen2_0_5b", n_micro=4, seq=4096, seed=0)
#: where the train phase writes its checkpoint and its results (removed
#: after the phase)
TRAIN_CKPT_DIR = ROOT / "_train_ckpt"
#: what cuBLAS needs to be reproducible under
#: ``torch.use_deterministic_algorithms``: read when a process makes its
#: first cuBLAS handle, and it makes every cuBLAS call slower on the host,
#: so only the train phase's own process sets it
TRAIN_ENV = {"CUBLAS_WORKSPACE_CONFIG": ":4096:8"}
#: the elastic KV path: bench_bootstrap's full-suite layout of
#: ``benchmarks/elastic_kv.py`` (3 memory nodes, 4 compute nodes, 8 shards,
#: 24 workers) with 131,071 buckets a shard (prime, see phase 4), 1,000,000
#: keys, a YCSB-C batch of 512 keys a worker; then the three suites at
#: their full-suite settings
DKV_SIZE = dict(n_mem=3, n_compute=4, n_shards=8, n_buckets=131_071,
                n_keys=1_000_000, n_workers=24, batch=512, big_batch=4096,
                seed=0, calls=200,
                bootstrap=dict(n_workers=24, n_compute=4, n_mem=3,
                               n_shards=8, n_buckets=256),
                migration=dict(n_reads=240, n_buckets=256), autoscaler={})
#: the same path at a size for the CPU (the tests' rehearsal): the suites
#: at ``benchmarks/elastic_kv.py``'s smoke settings
DKV_SMALL = dict(n_mem=3, n_compute=4, n_shards=8, n_buckets=257,
                 n_keys=3_000, n_workers=3, batch=64, big_batch=128, seed=0,
                 calls=2,
                 bootstrap=dict(n_workers=6, n_shards=4, n_buckets=64),
                 migration=dict(n_reads=60, n_buckets=64),
                 autoscaler=dict(duration_us=40_000.0, spike_rate=1_200.0,
                                 work_us=1_200.0, max_workers=6))
#: launches the dkv mirror's lookups must make on the card, exactly: the 24
#: worker batches and the absent batch by value, the batch of 4,096 keys
#: with its routing on the card
DKV_LAUNCHES = {"race_lookup_sharded_byval": 25, "race_lookup_sharded": 1}
#: the gateway cells of ``benchmarks/serverless.py``'s full suite
GATEWAY_SIZE = dict(traces=dict(n_nodes=4, duration_us=200_000.0,
                                rate_per_s=400.0),
                    response=dict(n_nodes=2, duration_us=120_000.0,
                                  base_rate=150.0, spike_mult=8.0))
#: and at its smoke settings, for the CPU
GATEWAY_SMALL = dict(traces=dict(n_nodes=2, duration_us=50_000.0,
                                 rate_per_s=300.0),
                     response=dict(n_nodes=2, duration_us=60_000.0,
                                   base_rate=150.0))


class PhaseError(RuntimeError):
    pass


def check(cond, what: str) -> None:
    if not cond:
        raise PhaseError(what)


# ------------------------------------------------------ 1. device report
def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return smi.stdout.strip().splitlines()[0]


def device_report() -> None:
    print(card_line())
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"device_count {torch.cuda.device_count()}; "
          f"{torch.cuda.get_device_name(0)}")


# ---------------------------------------------------------------- 2. build
def build_kernels() -> None:
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                          text=True, check=True, timeout=60)
    print(f"nvcc --version: {nvcc.stdout.strip().splitlines()[-2:]}")
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


def _check_routes(calls, want, errs, what) -> None:
    """Each (route, fn, label) of ``calls``: fn's result against the plain
    version ``want``, and the one route it launched (none for NQ = 0)."""
    for route, fn, label in calls:
        if not len(want[1]):                               # no launch
            got = fn()
        else:
            got, ran = _route_of_call(fn)
            check(ran == route, f"{what} {label}: ran {ran}, not {route}")
        _same(got, want, errs, route, f"{what} {label}")


def _unsharded_routes(fp_t, vt_t, fps, bidx, errs, what,
                      qblock=kern.QBLOCK) -> None:
    """The tiled and scalar kernels on the card's routing and on the
    host's, each against the plain version, and the route each took."""
    card = tuple(torch.from_numpy(a).to(fp_t.device) for a in (fps, bidx))
    want = race_lookup_ref(fp_t, vt_t, *card)
    calls = []
    for host, args in ((False, card), (True, (fps, bidx))):
        where = f"routing on the {'host' if host else 'card'}"
        calls += [(kern.route("tiled", host, len(fps)),
                   lambda a=args: kern.race_lookup_tiled(
                       fp_t, vt_t, *a, qblock=qblock), f"tiled {where}"),
                  (kern.route("scalar", host, len(fps)),
                   lambda a=args: kern.race_lookup_scalar(fp_t, vt_t, *a),
                   f"scalar {where}")]
    _check_routes(calls, want, errs, what)


def _sharded_routes(fp_t, vt_t, fps, bidx, sidx, errs, what) -> None:
    """The sharded kernel on the card's routing and on the host's, and the
    scalar kernel's calls a shard (``impl="scalar"``: the routing split by
    shard on the host, card routing read back for that), each against the
    plain version, and the route each took."""
    card = tuple(torch.from_numpy(a).to(fp_t.device)
                 for a in (fps, bidx, sidx))
    want = race_lookup_sharded_ref(fp_t, vt_t, *card)
    largest = int(np.bincount(sidx).max()) if len(sidx) else 0
    calls = []
    for host, args in ((False, card), (True, (fps, bidx, sidx))):
        where = f"routing on the {'host' if host else 'card'}"
        calls += [(kern.route("sharded", host, len(fps)),
                   lambda a=args: kern.race_lookup_sharded(fp_t, vt_t, *a),
                   f"sharded {where}"),
                  (kern.route("scalar", True, largest),
                   lambda a=args: ops.race_lookup_sharded(
                       fp_t, vt_t, *a, impl="scalar"),
                   f"scalar by shard, {where}")]
    _check_routes(calls, want, errs, what)


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
            _unsharded_routes(fp_t, vt_t, fps, bidx, errs,
                              f"nslot={nslot} vdim={vdim} {dtype} nq={nq}",
                              qblock=qblock)
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
            _sharded_routes(fp_t, vt_t, fps, bidx, sidx, errs,
                            f"ns={ns} counts={counts} {dtype}")
            cases += 1
    # every route at every NSLOT and at the by-value cap's edges: random
    # fingerprints from a small range, so slots repeat and many are empty;
    # the unsharded kernels on shard 0's table
    cap = kern.BYVAL_CAP
    for nslot, dtype in ((4, torch.float32), (8, torch.float32),
                         (8, torch.bfloat16), (16, torch.float32),
                         (32, torch.float32)):
        ns, nb = 3, 16
        fp_t = torch.from_numpy(rng.integers(0, 40, (ns, nb, nslot))
                                .astype(np.int32)).to(device)
        vt_t = torch.from_numpy(rng.standard_normal((ns, nb, nslot, 256))
                                .astype(np.float32)).to(device, dtype)
        for nq in (1, 7, cap - 1, cap, cap + 1):
            fps = rng.integers(0, 40, nq).astype(np.int32)
            bidx = rng.integers(-3, nb + 3, (nq, 2)).astype(np.int32)
            sidx = rng.integers(0, ns, nq).astype(np.int32)
            what = f"nslot={nslot} {dtype} nq={nq}"
            _sharded_routes(fp_t, vt_t, fps, bidx, sidx, errs, what)
            _unsharded_routes(fp_t[0], vt_t[0], fps, bidx, errs, what)
            cases += 1
    torch.cuda.synchronize(device)
    print(f"parity: {cases} cases, every kernel equal to its plain version "
          f"(max abs err {errs})")
    return errs


def stage_parity(device) -> dict:
    """``chunk_gather``'s routes against its plain version on ``device``,
    and the pack/unpack ops against the same calls on the CPU; exact.
    Returns the largest absolute difference seen by route (0: exact)."""
    rng = np.random.default_rng(2)
    err = dict.fromkeys(GATHER_ROUTES, 0)
    cases = 0

    def one(src, rows, valid, chunk, what, want_rows=None):
        """Both routes: the routing on the card, then on the host."""
        nonlocal cases
        if isinstance(src, np.ndarray):
            src = torch.from_numpy(src).to(device)
        host = [np.asarray(a, np.int32) for a in (rows, valid)]
        card = [torch.from_numpy(a).to(device) for a in host]
        want = chunk_gather_ref(src, *card, chunk=chunk)
        for routing, route in ((card, "chunk_gather"),
                               (host, gather_route(True, len(host[0])))):
            call = lambda: chunk_gather_cuda(src, *routing, chunk=chunk)
            if len(host[0]):
                got, ran = _route_of_call(call)
                check(ran == route, f"chunk_gather {what}: ran {ran}, not "
                      f"{route}")
            else:                                          # no launch
                got = call()
            check(got.dtype == torch.int32 and got.shape == want.shape,
                  f"{route} {what}: {got.dtype} {tuple(got.shape)}")
            if got.numel():
                err[route] = max(err[route], int(
                    (got.long() - want.long()).abs().max()))
            check(torch.equal(got, want),
                  f"{route} {what}: differs from the plain version")
            if want_rows is not None:
                check(torch.equal(got, src[want_rows]),
                      f"{route} {what}: rows resolved wrongly")
        cases += 1

    def draw(nsrc, nout, chunk):
        src = rng.integers(-2 ** 31, 2 ** 31, (nsrc, chunk),
                           dtype=np.int64).astype(np.int32)
        rows = rng.integers(-nsrc - 3, nsrc + 3, nout).astype(np.int32)
        lives = [0, 1, chunk // 2, chunk - 1, chunk, chunk + 1, 4 * chunk, -1,
                 -chunk]
        valid = rng.choice(lives, nout).astype(np.int32)
        return src, rows, valid

    cap = GATHER_CAP
    for nsrc, nout, chunk in ((1, 0, 128), (1, 1, 128), (1, 9, 128),
                              (7, 1, 128), (33, 77, 128), (300, 1001, 128),
                              (300, cap - 1, 128), (2048, cap, 128),
                              (300, cap + 1, 128), (5, 13, 6), (4, 9, 36),
                              (3, 5, 1), (9, 40, 4), (9, cap, 4)):
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
    print(f"parity: chunk_gather {cases} cases, both routes equal to the "
          f"plain version and the CPU (max abs err {err})")
    return {route: float(e) for route, e in err.items()}


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
              n_keys, batches, reps, seed, measure=None,
              compare=None) -> dict:
    """Both tables through the main path. ``measure(table, wl, sharded)``
    runs while each table is alive (kernel times on the card), then
    ``compare(tables, wl)`` with both alive; returns the launches per kernel
    summed over both runs, each table's own, what ``measure`` gave and
    what ``compare`` gave."""
    wl = make_workload(seed, n_keys, vdim, batches, reps)
    launches: dict = {}
    by_table = {}
    measured = {}
    tables = []
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
        by_table[type(table).__name__] = run
        if measure is not None:
            measured.update(measure(table, wl, sharded))
        tables.append(table)
    compared = compare(tables, wl) if compare is not None else None
    del table, tables
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return dict(launches=launches, by_table=by_table, measured=measured,
                compared=compared)


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
    call (int32 conversion, packing, the copy its route makes, checks,
    launch), and the wait for the card. ``pack`` and ``h2d`` time the
    packing of the routing and that copy alone, both inside the ops call:
    nothing on a by-value route, the packed routing on the device route
    (``h2d_copies`` says how many)."""
    lookup = ops.race_lookup_sharded if sharded else ops.race_lookup
    kernel = "sharded" if sharded else "tiled"
    steps = ("hash", "sync", "ops_call", "wait")
    parts = {name: [] for name in steps + ("pack", "h2d")}
    copies = 0
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
        routing = kern.pack_routing(*args)
        parts["pack"].append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        copied = [] if kern.route(kernel, True, len(keys)) \
            == kern.ROUTES[kernel][0] else [routing]
        for a in copied:
            torch.from_numpy(a).to(device)
        torch.cuda.synchronize(device)
        parts["h2d"].append((time.perf_counter() - t0) * 1e3)
        copies = len(copied)
    out = {name: float(np.median(v)) for name, v in parts.items()}
    out["h2d_copies"] = copies
    return out


def device_spans(fn, device, cycles: int = 3) -> dict:
    """Device spans (kernels and copies) of one call of ``fn`` under
    ``torch.profiler``: their count and their names. The profiler loses
    device events now and then: a session started cold has lost its first
    one, and an active step has come back with none at all. So ``fn`` is
    profiled in ``cycles`` cycles, each a warm-up step and then an active
    step of one call, and the cycle with the most spans is kept: a loss can
    only lower a count, never raise it. ``by_cycle`` holds every cycle's
    count."""
    from torch.profiler import ProfilerActivity, profile, schedule
    counted = []

    def read(prof):
        counted.append(collections.Counter(
            e.name[:90] for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not e.name.startswith("ProfilerStep")))  # the step's span

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=cycles),
                 on_trace_ready=read) as prof:
        for _ in range(2 * cycles):
            fn()
            _sync(device)
            prof.step()
    check(len(counted) == cycles, f"the profiler closed {len(counted)} "
          f"cycles, expected {cycles}")
    names = max(counted, key=lambda c: sum(c.values()))
    return dict(spans=sum(names.values()), names=dict(names),
                by_cycle=[sum(c.values()) for c in counted])


def host_interleaved(tables, wl, device, calls: int = 200) -> dict:
    """Host time (ms) of ``lookup_batch`` on each table at each batch size,
    median and 90th percentile of ``calls`` calls each ending in a
    synchronisation, the tables' calls taken in turns so that both see the
    same host: {batch: {table: [p50, p90]}}."""
    out = {}
    for size, batches in wl["reads"].items():
        times = {type(t).__name__: [] for t in tables}
        for i in range(calls):
            keys = wl["keys"][batches[i % len(batches)]]
            for t in tables if i % 2 else tables[::-1]:
                t0 = time.perf_counter()
                t.lookup_batch(keys)
                torch.cuda.synchronize(device)
                times[type(t).__name__].append(
                    (time.perf_counter() - t0) * 1e3)
        out[size] = {name: np.percentile(v, [50, 90]).tolist()
                     for name, v in times.items()}
        print(f"time lookup_batch batch {size}, the tables in turns "
              f"({calls} calls each), p50/p90 ms: {out[size]}")
    return out


def _host_ms(fn, calls: int) -> list:
    """p50 and p90 host time (ms) of ``calls`` calls of ``fn(i)``, each
    ending in a synchronisation."""
    times = []
    for i in range(calls):
        t0 = time.perf_counter()
        fn(i)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return np.percentile(times, [50, 90]).tolist()


def _scalar_by_shard_times(table, inputs, device, launches: int) -> dict:
    """``race_lookup_scalar_byval`` as the sharded table's ``impl="scalar"``
    call launches it: each shard's part of each batch, its routing by
    value, cycled; beside ``race_lookup_sharded_byval`` on the same queries
    (``control_ms``) and the plain version. Per launch."""
    fp, val = table.fp_table, table.val_table
    parts = []
    for x in inputs:
        fps, bidx, sidx = x["arrays"]
        for sid, part in kern.split_by_shard(fps, bidx, sidx):
            m = part[:, 3]
            parts.append(dict(
                sid=sid, part=part, card=torch.from_numpy(part).to(device),
                control=kern.pack_routing(fps[m], bidx[m], sidx[m]),
                need=_bytes_needed(table, fps[m], bidx[m], sidx[m],
                                   table.nslot, table.vdim)))
    out = (torch.empty((len(inputs[0]["arrays"][0]), table.vdim),
                       device=device),
           torch.empty(len(inputs[0]["arrays"][0]), dtype=torch.int32,
                       device=device))

    def cycle(fn):
        it = itertools.cycle(parts)
        return lambda: fn(next(it))

    need = statistics.mean(p["need"] for p in parts)
    return dict(
        ms=device_ms(cycle(lambda p: kern.race_lookup_packed(
            "scalar", fp[p["sid"]], val[p["sid"]], p["part"], out=out)),
            launches, device),
        control_ms=device_ms(cycle(lambda p: kern.race_lookup_packed(
            "sharded", fp, val, p["control"])), launches, device),
        plain_ms=device_ms(cycle(lambda p: race_lookup_routed_ref(
            fp[p["sid"]], val[p["sid"]], p["card"], *out)), 16, device),
        bound_ms=need / HBM_BYTES_PER_S * 1e3, bytes=need,
        queries_per_launch=statistics.mean(len(p["part"]) for p in parts))


def measure_table(table, wl, sharded: bool, device, launches_per_batch=64,
                  host_calls=200, span_batch=512):
    """Times of the table's lookup routes at each batch size: device time
    per launch and the plain version's, the bound, and the host time of
    ``lookup_batch`` (p50 and p90 over ``host_calls`` calls, each ending in
    a synchronisation) with a breakdown by step. The by-value route is
    timed on host routing at the batches it takes (up to the cap), the
    device route on routing already packed on the card at every batch;
    ``main_path`` marks the route that ``lookup_batch`` takes there. The
    scalar kernel is timed at the largest batch, which its ``impl="scalar"``
    call takes on the main path: the table's ``race_lookup_scalar`` on
    routing packed on the card, the sharded table's
    ``race_lookup_scalar_byval`` per shard (see
    :func:`_scalar_by_shard_times`), each with the host time of that call.
    Device spans of one ``lookup_batch``: at ``span_batch`` keys, and at
    the largest batch through ``impl="scalar"``."""
    kernel = "sharded" if sharded else "tiled"
    byval, on_card = kern.ROUTES[kernel]
    fp, val = table.fp_table, table.val_table
    top = max(wl["reads"])
    out = {}
    for size, batches in wl["reads"].items():
        inputs = []
        for idx in batches:
            keys = wl["keys"][idx]
            arrays = query_hashes(keys, table.n_buckets)
            if sharded:
                arrays += (query_shards(keys, table.n_shards),)
            host = kern.pack_routing(*arrays)
            inputs.append(dict(
                arrays=arrays, host=host,
                card=torch.from_numpy(host).to(device),
                plain=[torch.from_numpy(a).to(device) for a in arrays],
                need=_bytes_needed(table, *arrays[:2],
                                   arrays[2] if sharded else None,
                                   table.nslot, table.vdim)))

        def cycle(fn):
            it = itertools.cycle(inputs)
            return lambda: fn(next(it))

        plain = race_lookup_sharded_ref if sharded else race_lookup_ref
        plain_ms = device_ms(cycle(lambda x: plain(fp, val, *x["plain"])),
                             16, device)
        host_p50, host_p90 = _host_ms(lambda i: table.lookup_batch(
            wl["keys"][batches[i % len(batches)]]), host_calls)
        common = dict(
            plain_ms=plain_ms,
            bound_ms=statistics.mean(x["need"] for x in inputs)
            / HBM_BYTES_PER_S * 1e3,
            bytes=statistics.mean(x["need"] for x in inputs),
            lookup_batch_host_ms=host_p50, lookup_batch_host_p90_ms=host_p90,
            lookup_batch_calls=host_calls,
            lookup_batch_host_breakdown_ms=host_breakdown(
                table, [wl["keys"][idx] for idx in batches], sharded,
                device))
        timed = {on_card: lambda x, qb=kern.QBLOCK: kern.race_lookup_packed(
            kernel, fp, val, x["card"], qblock=qb)}
        if size <= kern.BYVAL_CAP:
            timed[byval] = lambda x: kern.race_lookup_packed(
                kernel, fp, val, x["host"])
        main_route = kern.route(kernel, True, size)
        for name, fn in timed.items():
            r = out.setdefault(name, {})[size] = dict(
                ms=device_ms(cycle(fn), launches_per_batch, device),
                main_path=name == main_route, **common)
            if name == "race_lookup_tiled":     # the JAX kernels' tile
                r["ms_qblock64"] = device_ms(
                    cycle(lambda x: fn(x, qb=64)), launches_per_batch,
                    device)
        if size == span_batch:
            spans = device_spans(lambda: table.lookup_batch(
                wl["keys"][batches[0]]), device)
            out[main_route][size].update(
                lookup_batch_device_spans=spans["spans"],
                lookup_batch_device_span_names=spans["names"],
                lookup_batch_device_spans_by_cycle=spans["by_cycle"])
        if size != top:
            continue
        if sharded:
            r = _scalar_by_shard_times(table, inputs, device,
                                       launches_per_batch)
        else:
            rows = [torch.from_numpy(kern.pack_routing(
                *x["arrays"], np.arange(size, dtype=np.int32))).to(device)
                for x in inputs]
            it = itertools.cycle(rows)
            r = dict(ms=device_ms(lambda: kern.race_lookup_packed(
                "scalar", fp, val, next(it)), launches_per_batch, device),
                **{k: common[k] for k in ("plain_ms", "bound_ms", "bytes")})
        spans = device_spans(lambda: table.lookup_batch(
            wl["keys"][batches[0]], impl="scalar"), device)
        p50, p90 = _host_ms(lambda i: table.lookup_batch(
            wl["keys"][batches[i % len(batches)]], impl="scalar"), host_calls)
        name = "race_lookup_scalar_byval" if sharded \
            else kern.route("scalar", True, size)
        out[name] = {size: dict(
            r, main_path=True, lookup_batch_scalar_host_ms=p50,
            lookup_batch_scalar_host_p90_ms=p90,
            lookup_batch_scalar_device_spans=spans["spans"],
            lookup_batch_scalar_device_span_names=spans["names"],
            lookup_batch_scalar_device_spans_by_cycle=spans["by_cycle"])}
    for name, rows in out.items():
        for size, r in rows.items():
            extra = "".join(f", {key} {r[key]}" for key in (
                "ms_qblock64", "control_ms", "queries_per_launch",
                "lookup_batch_device_spans",
                "lookup_batch_device_spans_by_cycle",
                "lookup_batch_scalar_device_spans",
                "lookup_batch_scalar_device_spans_by_cycle",
                "lookup_batch_scalar_host_ms") if key in r)
            host = "" if "lookup_batch_host_ms" not in r else (
                f", lookup_batch host p50 {r['lookup_batch_host_ms']:.6f} "
                f"ms p90 {r['lookup_batch_host_p90_ms']:.6f} ms "
                f"({r['lookup_batch_calls']} calls); host steps "
                f"{r['lookup_batch_host_breakdown_ms']}")
            print(f"time {name} batch {size}"
                  f"{'' if r['main_path'] else ' (not its main-path batch)'}:"
                  f" kernel {r['ms']:.6f} ms{extra}, plain "
                  f"{r['plain_ms']:.6f} ms, bound {r['bound_ms']:.6f} ms "
                  f"({r['bytes']:.0f} B){host}")
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
    routed as ``stage_pack`` routes it: src on the card, (src_row, valid)
    on the host."""
    rng = np.random.default_rng(n_payloads * elems)
    cmax = -(-elems // CHUNK)
    src = rng.integers(-2 ** 31, 2 ** 31, (n_payloads * cmax, CHUNK),
                       dtype=np.int64).astype(np.int32)
    rows, valid = stage_ops.pack_plan(np.full(n_payloads, elems), elems)
    return torch.from_numpy(src).to(device), rows, valid


def _gather_bytes(rows, valid, chunk: int = CHUNK) -> int:
    """Bytes one gather must move, each counted once: the live elements of
    every distinct source chunk read, the output written, and the two
    int32 routing tables read."""
    rows, valid = (np.asarray(a.cpu() if isinstance(a, torch.Tensor) else a)
                   for a in (rows, valid))
    live = valid > 0
    need = np.zeros(int(rows.max(initial=0)) + 1, np.int64)
    np.maximum.at(need, rows[live], np.minimum(valid[live], chunk))
    return int(4 * need.sum() + len(rows) * (4 * chunk + 8))


def measure_gather(device, launches: int = 64) -> dict:
    """Device time per launch of each ``chunk_gather`` route at each of
    :data:`GATHER_SHAPES`: the by-value route on host routing where it
    takes the shape (the chain's path), the device route on routing
    already on the card; beside the plain version's, ``index_select``'s
    (the same gather without the mask: one PyTorch call, used nowhere in
    the port; the by-value route's time over it is ``ratio_to_library``)
    and the bound (bytes over 3.35 TB/s). Returns {route: {shape: row}}."""
    out: dict = {}
    for label, n, elems in GATHER_SHAPES:
        src, rows, valid = _pack_inputs(n, elems, device)
        rows_d, valid_d = (torch.from_numpy(a).to(device)
                           for a in (rows, valid))
        want = src.index_select(0, rows_d)
        check(torch.equal(want, chunk_gather_ref(src, rows_d, valid_d)),
              f"chunk_gather {label}: index_select differs from the plain "
              f"version")
        nbytes = _gather_bytes(rows, valid)
        plain_ms = device_ms(lambda: chunk_gather_ref(src, rows_d, valid_d),
                             16, device)
        library_ms = device_ms(lambda: src.index_select(0, rows_d), launches,
                               device)
        host_route = gather_route(True, len(rows))
        for route, routing in (("chunk_gather_byval", (rows, valid)),
                               ("chunk_gather", (rows_d, valid_d))):
            if route == "chunk_gather_byval" and host_route != route:
                continue
            got, ran = _route_of_call(
                lambda: chunk_gather_cuda(src, *routing))
            check(ran == route and torch.equal(got, want),
                  f"{route} {label}: ran {ran}, or differs from "
                  f"index_select")
            ms = device_ms(lambda: chunk_gather_cuda(src, *routing),
                           launches, device)
            r = out.setdefault(route, {})[label] = dict(
                nout=len(rows), bytes=nbytes, ms=ms, plain_ms=plain_ms,
                library_ms=library_ms, ratio_to_library=ms / library_ms,
                bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                stage_pack_route=route == host_route)
            note = "" if r["stage_pack_route"] else "; not stage_pack's route"
            print(f"time {route} {label} ({r['nout']} chunks, {nbytes} B"
                  f"{note}): "
                  f"kernel {ms:.6f} ms, plain {plain_ms:.6f} ms, "
                  f"index_select {library_ms:.6f} ms (kernel / index_select"
                  f" {r['ratio_to_library']:.3f}), bound "
                  f"{r['bound_ms']:.6f} ms")
        del src, rows_d, valid_d, want, got
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
    routing plan, the copy of the source to the card (the routing stays on
    the host for the by-value route), the kernel and the wait for it, the
    copy back, and assembling the slab (``header``) or the payloads
    (``split``)."""
    parts: dict = {}

    def tick(name, t0):
        parts.setdefault(name, []).append((time.perf_counter() - t0) * 1e3)
        return time.perf_counter()

    def gather(side, src, rows, valid, t):
        src = torch.from_numpy(src).to(device)
        torch.cuda.synchronize(device)
        t = tick(f"{side}.h2d", t)
        out = chunk_gather_cuda(src, rows, valid)
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


def chain_busy_share(device, cell: dict, spans: int) -> dict:
    """One epoch of ``cell`` under ``torch.profiler``: the card's busy time
    over the epoch's host wall time (see :func:`profile_busy`), and the
    device spans of one epoch (:func:`device_spans`); fails unless there
    are ``spans`` of them."""
    run_chain(device, cell)                                 # warm-up
    _sync(device)
    r = dict(cell=cell["name"], **profile_busy(
        lambda: run_chain(device, cell), device, "chunk_gather"))
    counted = device_spans(lambda: run_chain(device, cell), device)
    r.update(epoch_device_spans=counted["spans"],
             epoch_device_span_names=counted["names"],
             epoch_device_spans_by_cycle=counted["by_cycle"])
    print(f"profile chain {cell['name']}: epoch wall {r['wall_ms']:.3f} ms "
          f"(profiled), card busy {r['busy_ms']:.6f} ms over "
          f"{r['device_events']} device spans (chunk_gather "
          f"{r['kernel_ms']:.6f} ms), idle share {_fmt_idle(r)}; device "
          f"spans of one epoch (most of {len(counted['by_cycle'])} profiled "
          f"cycles, each after a warm-up step) {counted}")
    check(counted["spans"] == spans,
          f"chain {cell['name']}: {counted['spans']} device spans, expected "
          f"{spans}")
    return r


# ------------------------------------------- 8. model kernels: parity
def _within(got, want, atol, rtol, what) -> float:
    """Largest |got - want|; fails unless every element is within
    atol + rtol * |want| and ``got`` is finite."""
    g, w = got.float(), want.float()
    err = (g - w).abs()
    bad = int((err > atol + rtol * w.abs()).sum())
    worst = float(err.max()) if err.numel() else 0.0
    check(bad == 0 and bool(torch.isfinite(g).all()),
          f"{what}: {bad} elements out of tolerance (atol {atol}, rtol "
          f"{rtol}; max abs err {worst})")
    return worst


#: the device function name of each model kernel's route, as the profiler
#: shows it
KERNEL_SYMBOLS = {"flash_attention_mma": "flash_mma_kernel",
                  "flash_attention": "flash_kernel",
                  "wkv_split": "wkv_split_kernel", "wkv": "wkv_kernel"}
#: (label, b, hq, hkv, sq, skv, d, causal, window, cap, kv_len, dtype,
#: scale of q/k/v[, columns of v that are not zero]). The sweep keeps the
#: reference tests' inputs (randn * 0.5). The cases at the models' shapes draw at 1.5, so that the scores'
#: spread is ~2 and each output row is a mean of a few keys, of size ~0.4:
#: at 0.5 the softmax is nearly flat, a late row averages hundreds of
#: values to ~0.02, and the bfloat16 tolerance of 2e-2 could not see a
#: wrong kv tile there.
FLASH_CASES = (
    ("sweep 1", 2, 4, 2, 256, 256, 64, True, None, None, None, "float32",
     0.5),
    ("sweep 2", 1, 4, 4, 256, 256, 64, True, 128, 50.0, None, "float32",
     0.5),
    ("sweep 3", 1, 2, 1, 128, 128, 32, False, None, None, None, "float32",
     0.5),
    ("sweep 4", 1, 8, 2, 512, 512, 64, True, None, 30.0, None, "float32",
     0.5),
    ("sweep 5", 2, 2, 2, 256, 256, 128, True, 64, None, None, "float32",
     0.5),
    ("sweep 6", 1, 4, 2, 256, 256, 64, True, None, None, None, "bfloat16",
     0.5),
    ("qwen2 prefill", 8, 14, 2, 512, 512, 64, True, None, None, None,
     "bfloat16", 1.5),
    ("qwen2 prefill fp32", 8, 14, 2, 512, 512, 64, True, None, None, None,
     "float32", 1.5),
    ("ragged 200", 2, 14, 2, 200, 200, 64, True, None, None, None,
     "bfloat16", 1.5),
    ("ragged 544", 1, 14, 2, 544, 544, 64, True, None, None, None,
     "float32", 1.5),
    ("ragged 544 bf16", 1, 14, 2, 544, 544, 64, True, None, None, None,
     "bfloat16", 1.5),
    ("D 96 (phi3)", 1, 32, 32, 1024, 1024, 96, True, 512, 50.0, None,
     "bfloat16", 1.5),
    ("D 256 (gemma2)", 1, 8, 4, 1024, 1024, 256, True, 512, 50.0, None,
     "bfloat16", 1.5),
    ("kv_len 100", 1, 4, 2, 256, 256, 64, True, None, None, 100, "float32",
     0.5),
    ("kv_len 37 non-causal", 1, 4, 2, 256, 256, 64, False, None, None, 37,
     "bfloat16", 0.5),
    ("kv_len 300 qwen2", 2, 14, 2, 512, 512, 64, True, None, None, 300,
     "bfloat16", 1.5),
    ("olmoe prefill", 4, 16, 16, 512, 512, 128, True, None, None, None,
     "bfloat16", 1.5),
    # MLA: q/k at nope + rope = 192, v's 128 columns zero-padded to 192
    ("MLA prefill (deepseek-v2)", 1, 128, 128, 512, 512, 192, True, None,
     None, None, "bfloat16", 1.5, 128),
    ("seamless cross", 4, 16, 16, 512, 512, 64, False, None, None, None,
     "bfloat16", 1.5),
    ("seamless cross ragged Skv", 4, 16, 16, 512, 1000, 64, False, None,
     None, None, "bfloat16", 1.5),
    ("seamless cross fp32", 4, 16, 16, 512, 512, 64, False, None, None,
     None, "float32", 1.5),
    ("seamless cross ragged Skv fp32", 4, 16, 16, 512, 1000, 64, False,
     None, None, None, "float32", 1.5),
)
#: (label, b, h, s, dk, dv, dtype of r/k/v, dtype of logw, strong decay)
WKV_CASES = (
    ("sweep 1", 2, 3, 128, 16, 16, "float32", "float32", False),
    ("sweep 2", 1, 2, 64, 32, 32, "float32", "float32", False),
    ("sweep 3", 1, 1, 256, 64, 64, "float32", "float32", False),
    ("sweep 4", 2, 2, 96, 16, 32, "float32", "float32", False),
    ("strong decay -4.25", 1, 2, 64, 16, 16, "float32", "float32", True),
    ("rwkv6-7b prefill", 4, 64, 512, 64, 64, "bfloat16", "float32", False),
    ("rwkv6-7b prefill fp32", 4, 64, 512, 64, 64, "float32", "float32",
     False),
)


def _flash_inputs(gen, device, b, hq, hkv, sq, skv, d, dtype, scale=0.5):
    dt = getattr(torch, dtype)
    return [(torch.randn(shape, generator=gen, device=device) * scale).to(dt)
            for shape in ((b, hq, sq, d), (b, hkv, skv, d), (b, hkv, skv, d))]


def _wkv_inputs(gen, device, b, h, s, dk, dv, dtype, wdtype, strong):
    dt, wdt = getattr(torch, dtype), getattr(torch, wdtype)
    scale = 1.0 if strong else 0.4
    r, k = (torch.randn(b, h, s, dk, generator=gen, device=device) * scale
            for _ in range(2))
    v = torch.randn(b, h, s, dv, generator=gen, device=device) * scale
    if strong:
        logw = torch.full((b, h, s, dk), -4.25, device=device)
        u = torch.zeros(h, dk, device=device)
    else:
        logw = torch.clamp(-torch.exp(torch.randn(
            b, h, s, dk, generator=gen, device=device) * 0.3 - 0.6),
            -4.25, -1e-6)
        u = torch.randn(h, dk, generator=gen, device=device) * 0.3
    return r.to(dt), k.to(dt), v.to(dt), logw.to(wdt), u


def _route_of_call(fn):
    """Run ``fn``; return its result and the one entry point it launched."""
    before = dict(_build.launches)
    out = fn()
    ran = [n for n in _build.launches if _build.launches[n] != before.get(n)]
    check(len(ran) == 1, f"expected one launch, got {ran}")
    return out, ran[0]


def model_kernel_parity(device) -> dict:
    """``flash_attention`` and ``wkv`` against their plain versions on the
    card, each case through the route its dispatch picks (checked against
    the route that launched), at the reference tests' tolerances (flash:
    2e-5 in float32, 2e-2 in bfloat16; wkv: 5e-4 / 1e-3 on float32 outputs
    and the state, 2e-2 on a bfloat16 ``o``, whose rounding to bfloat16 can
    differ by one ulp). Each flash case's tolerance must lie below its
    output's mean magnitude, so that a wrong tile cannot hide inside it.
    Returns the largest absolute difference seen per route."""
    gen = torch.Generator(device=device).manual_seed(5)
    errs = dict.fromkeys(("flash_attention_mma", "flash_attention",
                          "wkv_split", "wkv"), 0.0)
    cases: dict = {}
    for (label, b, hq, hkv, sq, skv, d, causal, window, cap, kv_len,
         dtype, scale, *v_cols) in FLASH_CASES:
        q, k, v = _flash_inputs(gen, device, b, hq, hkv, sq, skv, d, dtype,
                                scale)
        if v_cols:
            v[..., v_cols[0]:] = 0
        got, route = _route_of_call(lambda: flash_attention_cuda(
            q, k, v, causal=causal, window=window, cap=cap, kv_len=kv_len))
        if v_cols:
            check(not got[..., v_cols[0]:].any(),
                  f"flash_attention {label}: output columns {v_cols[0]}.. "
                  f"of zero v columns are not exactly 0")
        check(route == flash_route(q.dtype, d),
              f"flash_attention {label} ran {route}")
        cases.setdefault(route, []).append(label)
        want = flash_attention_ref(q, k, v, causal=causal, window=window,
                                   cap=cap, kv_len=kv_len)
        check(got.dtype == q.dtype and got.shape == q.shape,
              f"flash_attention {label}: {got.dtype} {tuple(got.shape)}")
        tol = 2e-2 if dtype == "bfloat16" else 2e-5
        mean_abs = float(want.float().abs().mean())
        check(tol < mean_abs, f"flash_attention {label}: tolerance {tol} "
              f"is not below the output's mean magnitude {mean_abs}")
        errs[route] = max(errs[route], _within(
            got, want, tol, tol, f"flash_attention {label} ({route})"))
    for dtype, tol in (("float32", 2e-5), ("bfloat16", 2e-2)):
        q, k, v = _flash_inputs(gen, device, 1, 2, 2, 256, 256, 64, dtype)
        o1 = flash_ops.flash_attention(q, k, v, bq=64, bk=64)
        o2 = flash_ops.flash_attention(q, k, v, bq=128, bk=32)
        check(torch.equal(o1, o2),
              f"flash_attention {dtype}: the result depends on bq/bk")
        _within(o1, flash_attention_ref(q, k, v), tol, tol,
                f"flash_attention {dtype} block shapes")
    for label, b, h, s, dk, dv, dtype, wdtype, strong in WKV_CASES:
        r, k, v, logw, u = _wkv_inputs(gen, device, b, h, s, dk, dv, dtype,
                                       wdtype, strong)
        (o, state), route = _route_of_call(lambda: wkv_cuda(r, k, v, logw,
                                                            u))
        check(route == wkv_route(dk, dv, min(16, s)),
              f"wkv {label} ran {route}")
        cases.setdefault(route, []).append(label)
        zero = torch.zeros((b, h, dk, dv), device=device)
        want_o, want_state = wkv_chunked_ref(r, k, v, logw, u, zero)
        check(o.dtype == r.dtype and state.dtype == torch.float32,
              f"wkv {label}: {o.dtype} / {state.dtype}")
        otol = 2e-2 if dtype == "bfloat16" else 5e-4
        rtol = 2e-2 if dtype == "bfloat16" else 1e-3
        e = max(_within(o, want_o, otol, rtol, f"wkv {label} o"),
                _within(state, want_state, 5e-4, 1e-3,
                        f"wkv {label} final state"))
        if dtype == "float32":
            e = max(e, _within(o, wkv_sequential(r, k, v, logw, u), 5e-4,
                               1e-3, f"wkv {label} o vs wkv_sequential"))
        errs[route] = max(errs[route], e)
    torch.cuda.synchronize(device)
    print(f"parity: flash_attention {len(FLASH_CASES) + 2} cases, wkv "
          f"{len(WKV_CASES)} cases within tolerance of their plain versions "
          f"(max abs err by route {errs}); cases by route {cases}")
    return errs


# --------------------------------------------------- 9. the serving path
def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _expected_cache(cfg, batch: int, max_len: int, enc_len: int = 0
                    ) -> list:
    """(shape, dtype) of every cache leaf, as JAX's ``prefill`` gives them,
    in ``jax.tree_util.tree_leaves`` order (dict keys sorted, None
    skipped)."""
    dt, f32 = cfg.param_dtype, torch.float32
    L, b = cfg.n_layers, batch
    kv = (b, cfg.n_kv_heads, max_len, cfg.d_head)
    if cfg.family == "ssm":
        dk = cfg.d_model // cfg.n_heads
        return [((L, b, cfg.d_model), dt),
                ((L, b, cfg.n_heads, dk, dk), f32),
                ((L, b, cfg.d_model), dt)]
    if cfg.family == "moe" and cfg.mla:
        nd, nm = cfg.first_k_dense, L - cfg.first_k_dense
        r, rope = cfg.kv_lora_rank, cfg.qk_rope_dim
        dense = [((nd, b, max_len, r), dt), ((nd, b, max_len, rope), dt)] \
            if nd else []
        return [((nm, b, max_len, r), dt), *dense,
                ((nm, b, max_len, rope), dt)]
    if cfg.family == "hybrid":
        np_ = L // cfg.attn_every
        tail = L - np_ * cfg.attn_every
        h, pd, n = cfg.n_heads, cfg.d_inner // cfg.n_heads, cfg.ssm_state
        conv = (cfg.conv_kernel - 1, cfg.d_inner + 2 * n)
        tails = [((tail, b, h, pd, n), f32), ((tail, b, *conv), dt)] \
            if tail else []
        return [((np_, *kv), dt),
                ((np_, cfg.attn_every, b, h, pd, n), f32),
                ((np_, cfg.attn_every, b, *conv), dt), *tails,
                ((np_, *kv), dt)]
    if cfg.family == "encdec":
        Ld = cfg.dec_layers
        x = (Ld, b, cfg.n_kv_heads, enc_len, cfg.d_head)
        return [((Ld, *kv), dt), ((Ld, *kv), dt), (x, dt), (x, dt)]
    lead = (L // 2, 2) if cfg.layer_pattern == "local_global" else (L,)
    return [((*lead, *kv), dt), ((*lead, *kv), dt)]


def attn_calls(cfg) -> int:
    """Full-sequence kernel calls of one ``forward_full`` / ``prefill``:
    one a layer (dense, moe, MLA; rwkv6's WKV), zamba2's shared block once
    a period, seamless's encoder, decoder and cross-attention layers."""
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.attn_every
    if cfg.family == "encdec":
        return cfg.enc_layers + 2 * cfg.dec_layers
    return cfg.n_layers


def _cut(cfg, n_layers):
    """``cfg`` at ``n_layers`` (None: as it is) and the cut as printed."""
    if n_layers is None or n_layers == cfg.n_layers:
        return cfg, None
    return dataclasses.replace(cfg, n_layers=n_layers), \
        f"n_layers {cfg.n_layers} -> {n_layers}"


def _model_batch(cfg, tokens, gen, enc_len: int):
    """The prompt batch of ``cfg``'s family: token ids, or for the
    encoder-decoder ``enc_len`` random frames (the stubbed speech
    frontend's output) and the decoder's tokens."""
    if cfg.family == "encdec":
        frames = torch.randn((tokens.shape[0], enc_len, cfg.d_model),
                             generator=gen, device=tokens.device)
        return {"frames": frames, "dec_tokens": tokens}
    return {"tokens": tokens}


class _RoutingLog:
    """Records every ``router_topk`` call of the port's MoE (logits and
    chosen experts) while active; the teacher-forced pass and decode are
    then compared decision by decision."""

    def __init__(self):
        from repro_torch.models import moe
        self._moe, self._topk, self.calls = moe, moe.router_topk, []

    def __enter__(self):
        def topk(logits, k, renormalize=True):
            w, idx = self._topk(logits, k, renormalize)
            self.calls.append((logits.float(), idx))
            return w, idx
        self._moe.router_topk = topk
        return self

    def __exit__(self, *exc):
        self._moe.router_topk = self._topk


def _routing_report(full: list, pre: list, steps: list, cut: int,
                    k: int) -> dict:
    """Decisions of the prefill (rows < cut) and of each decode step
    against the teacher-forced pass's rows for the same positions, per MoE
    layer (one row a token, b = 1): how many differ, and each one's margin,
    the gap between the k-th and the (k+1)-th expert's probability in the
    teacher-forced pass."""
    n = len(full)
    check(len(pre) == n and len(steps) % max(n, 1) == 0,
          f"routing calls: {len(full)} / {len(pre)} / {len(steps)}")
    flips, decisions, min_margin = [], 0, math.inf
    for layer, (logits, idx) in enumerate(full):
        top = torch.topk(torch.softmax(logits, -1), k + 1, dim=-1).values
        margin = (top[:, k - 1] - top[:, k]).cpu()
        min_margin = min(min_margin, float(margin.min()))
        want = torch.sort(idx, -1).values.cpu()
        rows = [(pos, pre[layer][1][pos]) for pos in range(cut)]
        rows += [(cut + t, steps[t * n + layer][1][0])
                 for t in range(len(steps) // max(n, 1))]
        for pos, got in rows:
            decisions += 1
            if not torch.equal(torch.sort(got, -1).values.cpu(), want[pos]):
                flips.append(dict(layer=layer, position=pos,
                                  margin=float(margin[pos])))
    return dict(decisions=decisions, differ=len(flips), flips=flips,
                min_margin=min_margin if n else None)


def profile_busy(fn, device, match: str, top: int = 0) -> dict:
    """Run ``fn`` once under ``torch.profiler``: its host wall time, the
    card's busy time (the union of its kernel and copy spans), the time of
    the kernels whose name contains ``match``, the idle share and, with
    ``top``, the ``top`` device functions by total time. The profiler's own
    cost is inside the wall time."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        _sync(device)
        wall_s = time.perf_counter() - t0
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy_us, end = 0.0, -math.inf
    for a, b in spans:
        busy_us += max(0.0, b - max(a, end))
        end = max(end, b)
    device_events = [e for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA]
    kernel_us = sum(e.time_range.elapsed_us() for e in device_events
                    if match and match in e.name)
    by_name: dict = {}
    for e in device_events:
        ms, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    return dict(wall_ms=wall_s * 1e3, busy_ms=busy_us / 1e3,
                kernel_ms=kernel_us / 1e3, device_events=len(spans),
                idle_share=(1 - busy_us / (wall_s * 1e6)) if spans else None,
                top=[dict(name=name[:90], ms=ms, count=n)
                     for name, (ms, n) in ranked])


def _fmt_idle(r: dict) -> str:
    return (f"{r['idle_share']:.6f}" if r["idle_share"] is not None
            else "not measured (the profiler saw no device activity)")


def serve_model(device, *, arch, batch, prompt, max_len, decode_steps,
                worker_steps, seed, route=None, n_layers=None,
                config=get_config) -> dict:
    """One published model at full width in bf16 (the config's dtype), at
    full depth or at ``n_layers`` (printed as ``reduced``), parameters
    drawn on the card from ``seed``: ``make_prefill_step`` on ``batch``
    prompts of ``prompt`` tokens (the encoder-decoder: ``prompt`` frames
    and ``prompt`` decoder tokens), ``decode_steps`` greedy steps of
    ``make_decode_step`` from its cache, then two ``ServingWorker``s on one
    ``ExecutablePool`` (a cold start, then a pool hit) decoding
    ``worker_steps`` tokens each. Launch counters are cleared just before
    each of the three and read just after; on the card the prefill must
    launch ``route`` once an attention call (``attn_calls``) and nothing
    else. Then the times, while the model is on the card, and the peak of
    the card's allocated memory over the phase. ``config`` maps the arch
    to its config (the tests rehearse this phase on the CPU with the smoke
    configs)."""
    cfg, reduced = _cut(config(arch), n_layers)
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    t0 = time.perf_counter()
    params = init_params(cfg, gen, device)
    _sync(device)
    init_s = time.perf_counter() - t0
    n_params = count_params(params)
    tokens = torch.randint(0, cfg.vocab, (batch, prompt), generator=gen,
                           device=device, dtype=torch.int32)
    batch_in = _model_batch(cfg, tokens, gen, prompt)
    prefill_step = make_prefill_step(cfg, max_len)
    step = make_decode_step(cfg)

    _build.launches.clear()
    logits, cache = prefill_step(params, batch_in)
    _sync(device)
    prefill_launches = dict(_build.launches)
    want = {route: attn_calls(cfg)} if on_card else {}
    check(prefill_launches == want,
          f"{arch} prefill launched {prefill_launches}, expected {want}")
    check(logits.shape == (batch, cfg.vocab)
          and logits.dtype == torch.float32
          and bool(torch.isfinite(logits).all()),
          f"{arch} prefill logits {tuple(logits.shape)} {logits.dtype}, "
          f"finite {bool(torch.isfinite(logits).all())}")
    got = [(tuple(t.shape), t.dtype) for t in tree_leaves(cache)]
    want = _expected_cache(cfg, batch, max_len, enc_len=prompt)
    check(got == want, f"{arch} cache {got} != JAX's {want}")

    _build.launches.clear()
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    finite = torch.ones((), dtype=torch.bool, device=device)
    out = []
    for i in range(decode_steps):
        logits, cache = step(params, cache, tok, prompt + i)
        finite &= torch.isfinite(logits).all()
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        out.append(tok)
    toks = torch.stack(out, 1)
    _sync(device)
    decode_launches = dict(_build.launches)
    check(decode_launches == {}, f"{arch} decode launched {decode_launches}")
    check(bool(finite) and int(toks.min()) >= 0
          and int(toks.max()) < cfg.vocab,
          f"{arch} decode: logits finite {bool(finite)}, tokens in "
          f"[{int(toks.min())}, {int(toks.max())}]")

    _build.launches.clear()
    pool = ExecutablePool()
    workers, boot, wtoks = [], [], []
    for _ in range(2):
        w = ServingWorker(cfg, params, batch, max_len, pool=pool)
        wtoks.append(w.decode_tokens(toks[:, -1].cpu().numpy(),
                                     worker_steps))
        workers.append(w)
        boot.append(w.bootstrap_s)
    _sync(device)
    worker_launches = dict(_build.launches)
    check(worker_launches == {}, f"{arch} workers launched {worker_launches}")
    check((pool.stat_hits, pool.stat_misses) == (1, 1)
          and workers[0].decode_fn is workers[1].decode_fn,
          f"{arch} pool: hits {pool.stat_hits} misses {pool.stat_misses}")
    check(all(t.shape == (batch, worker_steps) and t.min() >= 0
              and t.max() < cfg.vocab for t in wtoks),
          f"{arch} worker tokens out of range")
    del workers
    print(f"serve {arch} ({cfg.n_layers} layers"
          f"{f', reduced: {reduced}' if reduced else ''}, d {cfg.d_model}, "
          f"{n_params} parameters {cfg.dtype} (the reference's analytic "
          f"count_params_config: {count_params_config(cfg)}), drawn in "
          f"{init_s:.3f} s): "
          f"prefill {batch} x {prompt} launched {prefill_launches}; "
          f"{decode_steps} greedy decode steps launched {decode_launches or 0}"
          f"; two ServingWorkers (slots {batch}, max_len {max_len}) "
          f"bootstrapped in {boot[0] * 1e3:.3f} ms (cold) and "
          f"{boot[1] * 1e3:.3f} ms (pool hit) and decoded {worker_steps} "
          f"tokens each; logits finite, tokens in [0, {cfg.vocab}), cache "
          f"shapes and dtypes as JAX's")

    # times, outside the counted runs
    walls = []
    for _ in range(4):
        t0 = time.perf_counter()
        prefill_step(params, batch_in)
        _sync(device)
        walls.append((time.perf_counter() - t0) * 1e3)
    prefill_ms = statistics.median(walls[1:])
    logits, cache = prefill_step(params, batch_in)
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    _sync(device)
    t0 = time.perf_counter()
    for i in range(decode_steps):
        logits, cache = step(params, cache, tok, prompt + i)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
    _sync(device)
    decode_ms = (time.perf_counter() - t0) * 1e3 / decode_steps
    decode_prof = profile_busy(
        lambda: step(params, cache, tok, prompt + decode_steps), device,
        KERNEL_SYMBOLS.get(route), top=6)
    del cache, logits
    prof = profile_busy(lambda: prefill_step(params, batch_in), device,
                        KERNEL_SYMBOLS.get(route), top=6)
    peak = torch.cuda.max_memory_allocated(device) if on_card else None
    r = dict(arch=arch, n_layers=cfg.n_layers, reduced=reduced,
             n_params=n_params, peak_memory_bytes=peak,
             batch=batch, prompt=prompt, max_len=max_len, init_s=init_s,
             prefill_launches=prefill_launches,
             decode_launches=decode_launches, prefill_ms=prefill_ms,
             prefill_walls_ms=walls, prefill_tokens_per_s=batch * prompt
             / (prefill_ms / 1e3), decode_ms_per_step=decode_ms,
             decode_tokens_per_s=batch / (decode_ms / 1e3),
             bootstrap_cold_ms=boot[0] * 1e3, bootstrap_hit_ms=boot[1] * 1e3,
             prefill_profile=prof, decode_profile=decode_prof)
    print(f"time serve {arch}: prefill {batch} x {prompt} median "
          f"{prefill_ms:.3f} ms ({r['prefill_tokens_per_s']:.1f} tokens/s; "
          f"walls {[round(w, 3) for w in walls]} ms, first untimed); decode "
          f"{decode_ms:.3f} ms per step ({r['decode_tokens_per_s']:.1f} "
          f"tokens/s over {batch} slots); bootstrap cold "
          f"{r['bootstrap_cold_ms']:.3f} ms, pool hit "
          f"{r['bootstrap_hit_ms']:.3f} ms; peak allocated memory "
          f"{peak if peak is not None else 'not measured (no card)'} B")
    for what, p in (("prefill", prof), ("decode step", decode_prof)):
        print(f"profile {what} {arch}: wall {p['wall_ms']:.3f} ms "
              f"(profiled), card busy {p['busy_ms']:.3f} ms over "
              f"{p['device_events']} device spans ({route} kernel "
              f"{p['kernel_ms']:.3f} ms), idle share {_fmt_idle(p)}; "
              f"top device functions (ms, count): "
              + "; ".join(f"{t['name']} {t['ms']:.3f} x{t['count']}"
                          for t in p["top"]))
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return r


# ------------------------------------ 10. prefill -> decode consistency
def consistency(device, *, arch, s, cut, tol, seed, route=None,
                n_layers=None, config=get_config) -> dict:
    """The port of ``tests/test_models.py::test_prefill_decode_consistency``
    at full width in float32 (TF32 off), with the reference's settings (a
    no-drop capacity of 1000 for MoE): the teacher-forced logits of
    ``forward_full`` over ``s`` tokens (the kernels) against ``prefill`` of
    the first ``cut`` (the kernels) and ``decode_step`` over the rest (the
    plain ``decode_attention`` / absorbed MLA / ``ssd_decode`` / ``wkv_decode``
    recurrences), at atol = rtol = ``tol``, every layer (or ``n_layers``).
    The encoder-decoder's encoder reads ``cut`` random frames. On the card
    forward_full and prefill must launch ``route`` once an attention call
    each and nothing else. For MoE, every routing decision of the prefill
    and of each decode step is compared with the teacher-forced pass's for
    the same position; one that differs is a fault unless its margin is
    below ``ROUTING_TIE``."""
    cfg, reduced = _cut(config(arch), n_layers)
    cfg = dataclasses.replace(cfg, dtype="float32")
    if cfg.n_experts:
        cfg = dataclasses.replace(cfg, capacity_factor=1000.0)
    gen = torch.Generator(device=device).manual_seed(seed)
    params = init_params(cfg, gen, device)
    tokens = torch.randint(0, cfg.vocab, (1, s), generator=gen,
                           device=device, dtype=torch.int32)
    batch = _model_batch(cfg, tokens, gen, cut)
    key = "dec_tokens" if cfg.family == "encdec" else "tokens"
    _build.launches.clear()
    with _RoutingLog() as full_log:
        hidden = forward_full(cfg, params, batch)[0]
    full = unembed_chunk(cfg, params, hidden[:, cut - 1:s - 1])
    with _RoutingLog() as pre_log:
        logits, cache = prefill(cfg, params,
                                dict(batch, **{key: tokens[:, :cut]}), s)
    _sync(device)
    full_launches = dict(_build.launches)
    want = {route: 2 * attn_calls(cfg)} \
        if torch.device(device).type == "cuda" else {}
    check(full_launches == want,
          f"consistency {arch}: forward_full + prefill launched "
          f"{full_launches}")
    errs = [_within(logits, full[:, 0], tol, tol,
                    f"consistency {arch}: prefill logits")]
    _build.launches.clear()
    with _RoutingLog() as step_log:
        for t in range(s - cut - 1):
            logits, cache = decode_step(cfg, params, cache,
                                        tokens[:, cut + t], cut + t)
            errs.append(_within(logits, full[:, t + 1], tol, tol,
                                f"consistency {arch}: decode step {t}"))
    _sync(device)
    check(dict(_build.launches) == {},
          f"consistency {arch}: decode launched {dict(_build.launches)}")
    routing = None
    if cfg.n_experts:
        routing = _routing_report(full_log.calls, pre_log.calls,
                                  step_log.calls, cut, cfg.top_k)
        bad = [f for f in routing["flips"] if f["margin"] >= ROUTING_TIE]
        check(not bad, f"consistency {arch}: routing decisions differ "
              f"beyond a near-tie: {bad}")
    print(f"consistency {arch} float32 ({cfg.n_layers} layers"
          f"{f', reduced: {reduced}' if reduced else ''}, full width; s "
          f"{s}, cut {cut}): prefill and {s - cut - 1} decode steps match "
          f"forward_full within {tol} (max abs err {max(errs):.3e}; "
          f"forward_full + prefill launched {full_launches})"
          + (f"; routing: {routing['differ']} of {routing['decisions']} "
             f"decisions differ from the teacher-forced pass "
             f"{routing['flips']}, smallest k-th / (k+1)-th margin there "
             f"{routing['min_margin']:.3e}" if routing else ""))
    del params, cache, hidden, full
    gc.collect()
    torch.cuda.empty_cache()
    return dict(arch=arch, n_layers=cfg.n_layers, reduced=reduced,
                max_abs_err=max(errs), launches=full_launches,
                routing=routing)


# --------------------------------------------- 11. model kernel timing
def _graphed(fn, device):
    """``fn`` captured in a CUDA graph; returns its replay. The plain WKV
    scan is ~600 small launches a call, more than the card's launch queue
    holds behind :func:`device_ms`'s spin kernel; a graph replays them as
    one launch, back to back, which is the device time that function
    measures."""
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        fn()                                            # warm-up
    torch.cuda.current_stream(device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return graph.replay


#: the redesigned kernels, by entry point: ptxas must give each a 0-byte
#: stack frame and no spills (the flash and WKV kernels are reported only)
#: (the tiled routes launch the sharded kernels at one shard)
PTXAS_GATED = {"race_lookup_sharded_byval": "race_lookup_sharded_byval_kernel",
               "race_lookup_sharded": "race_lookup_sharded_kernel",
               "race_lookup_tiled_byval": "race_lookup_sharded_byval_kernel",
               "race_lookup_tiled": "race_lookup_sharded_kernel",
               "race_lookup_scalar_byval": "race_lookup_scalar_byval_kernel",
               "race_lookup_scalar": "race_lookup_scalar_kernel",
               "chunk_gather_byval": "chunk_gather_byval_kernel"}
#: compiled instances gated the same way, by the name ``ptxas_report`` gives
#: them: the tensor-core flash kernel at DP = 192 runs deepseek-v2's MLA
#: prefill (DP = 256, gemma2's, is reported only)
PTXAS_GATED_INSTANCES = ("flash_mma_kernelILi192E",)


#: the libraries whose kernels ``ptxas_phase`` reports, and those kernels
PTXAS_LIBRARIES = ("flash_attention", "wkv", "race_lookup", "serverless_stage")
PTXAS_KERNELS = ("flash_mma_kernel", "wkv_split_kernel",
                 *set(PTXAS_GATED.values()))


def ptxas_report(log: str, kernels=PTXAS_KERNELS) -> dict:
    """Registers, stack, spills and static shared memory of every compiled
    instance of ``kernels``, read from the text of an ``-Xptxas -v`` build
    log (the tensor-core flash kernel and the split WKV kernel take their
    shared memory dynamically, at launch: the sizes of ``MmaTile`` and
    ``SplitSmem`` in their sources)."""
    out: dict = {}
    fn = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            hit = [k for k in kernels if k in name]
            fn = name[name.index(hit[0]):].split("EEv")[0] if hit else None
            if fn:
                out[fn] = {}
            continue
        if fn is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                      r"stores, (\d+) bytes spill loads", line)
        if m:
            out[fn].update(stack_bytes=int(m[1]),
                           spill_store_bytes=int(m[2]),
                           spill_load_bytes=int(m[3]))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            smem = re.search(r"(\d+) bytes smem", line)
            out[fn].update(registers=int(m[1]), static_smem_bytes=int(
                smem[1]) if smem else 0)
    return out


def _wkv_views(gen, device, b, h, s, d, dtype="bfloat16"):
    """r, k, v, logw as the model hands them over: head-transposed views of
    (B, S, H, d) projections; r/k/v in ``dtype``, logw float32."""
    dt = getattr(torch, dtype)
    r, k, v = ((torch.randn(b, s, h, d, generator=gen, device=device) * 0.4)
               .to(dt).transpose(1, 2) for _ in range(3))
    logw = torch.clamp(-torch.exp(torch.randn(
        b, s, h, d, generator=gen, device=device) * 0.3 - 0.6),
        -4.25, -1e-6).transpose(1, 2)
    u = torch.randn(h, d, generator=gen, device=device) * 0.3
    return r, k, v, logw, u


def _wkv_work(r, k, v, logw, u, state, o, c):
    """Bytes (each input read once, each output written once) and float32
    operations the chunked scan needs: the strictly-lower intra-chunk
    terms, the decay factors, the state products."""
    b, h, s, dk = r.shape
    dv = v.shape[-1]
    nbytes = sum(t.numel() * t.element_size()
                 for t in (r, k, v, logw, u, state, o))
    pairs = c * (c - 1) // 2                         # strictly lower
    per_chunk = (2 * c * dk * dv                     # r_dec @ S
                 + 2 * pairs * dk + 2 * pairs * dv   # att, att @ v
                 + 4 * c * dk + 2 * c * dv           # bonus, bonus * v
                 + 2 * c * dk * dv + dk * dv         # state update
                 + 6 * c * dk)                       # decay factors
    return nbytes, per_chunk * b * h * (s // c)


def _bound(nbytes, flops, peak):
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return dict(bytes=nbytes, flops=flops,
                bound_ms=max(by_bytes, by_ops) * 1e3,
                bound_by="bytes" if by_bytes >= by_ops else "operations")


#: the flash-attention shapes of the bf16 prefills on the main path
#: (``SERVE_SIZE``), and gemma2-2b's prefill (D = 256, served by no phase):
#: (arch, what, b, hq, hkv, sq, skv, d, causal, columns of v that are not
#: zero). The first row is the headline of ``flash_attention_mma`` in the
#: ``kernels`` line.
FLASH_MODEL_SHAPES = (
    ("qwen2_0_5b", "attention", 8, 14, 2, 512, 512, 64, True, None),
    ("olmoe_1b_7b", "attention", 4, 16, 16, 512, 512, 128, True, None),
    ("deepseek_v2_236b", "MLA, v zero-padded 128 -> 192", 4, 128, 128, 512,
     512, 192, True, 128),
    ("zamba2_1_2b", "shared block", 4, 32, 32, 512, 512, 64, True, None),
    ("seamless_m4t_medium", "encoder self and cross", 4, 16, 16, 512, 512,
     64, False, None),
    ("seamless_m4t_medium", "decoder self", 4, 16, 16, 512, 512, 64, True,
     None),
    ("gemma2_2b", "attention", 4, 8, 4, 512, 512, 256, True, None),
)


def _flash_work(q, k, v, causal) -> tuple:
    """Bytes (q, k, v read once, o written once) and operations (QK^T and
    PV over the pairs the mask keeps) of one attention call."""
    b, hq, sq, d = q.shape
    skv = k.shape[2]
    pairs = sum(min(i + 1, skv) for i in range(sq)) if causal else sq * skv
    nbytes = q.element_size() * (2 * q.numel() + k.numel() + v.numel())
    return nbytes, 4 * b * hq * d * pairs


def _sdpa_name(causal) -> str:
    return (f"torch.nn.functional.scaled_dot_product_attention("
            f"is_causal={causal}, enable_gqa=True)")


def measure_flash_shapes(device) -> list:
    """``flash_attention_cuda`` at each ``FLASH_MODEL_SHAPES`` shape in
    bf16: the route it takes, its output against the plain version and
    SDPA at 2e-2 (below the output's mean magnitude, and with the output
    columns of zero v columns exactly 0), its device time per launch, the
    plain version's, SDPA's on the same inputs and the bound (bf16
    operations at the tensor cores' peak, whichever route runs)."""
    import torch.nn.functional as F
    gen = torch.Generator(device=device).manual_seed(11)
    rows = []
    for arch, what, b, hq, hkv, sq, skv, d, causal, v_cols \
            in FLASH_MODEL_SHAPES:
        label = f"{arch} {what}"
        q, k, v = _flash_inputs(gen, device, b, hq, hkv, sq, skv, d,
                                "bfloat16", 1.5)
        if v_cols:
            v[..., v_cols:] = 0
        got, route = _route_of_call(lambda: flash_attention_cuda(
            q, k, v, causal=causal))
        check(route == flash_route(q.dtype, d), f"{label} ran {route}")
        if v_cols:
            check(not got[..., v_cols:].any(), f"{label}: output columns "
                  f"{v_cols}.. of zero v columns are not exactly 0")
        plain = lambda: flash_attention_ref(  # noqa: E731
            q, k, v, causal=causal)
        want = plain()
        mean_abs = float(want.float().abs().mean())
        check(2e-2 < mean_abs, f"{label}: tolerance 2e-2 is not below the "
              f"output's mean magnitude {mean_abs}")
        err = _within(got, want, 2e-2, 2e-2, f"{label} vs plain")
        lib_call = lambda: F.scaled_dot_product_attention(  # noqa: E731
            q, k, v, is_causal=causal, enable_gqa=True)
        _within(got, lib_call(), 2e-2, 2e-2, f"{label} vs SDPA")
        del want
        kern = lambda: flash_attention_cuda(q, k, v,  # noqa: E731
                                            causal=causal)
        turns = [device_ms(f, 20, device) for f in (kern, lib_call, kern,
                                                     lib_call)]
        rows.append(dict(
            arch=arch, what=what, route=route,
            shape=f"q ({b}, {hq}, {sq}, {d}) bf16, k/v ({b}, {hkv}, {skv}, "
                  f"{d}), {'causal' if causal else 'non-causal'}",
            max_abs_err=err, ms=turns[0], ms_turns=turns[0::2],
            library_ms=turns[1], library_ms_turns=turns[1::2],
            library=_sdpa_name(causal),
            plain_ms=device_ms(plain, 5, device),
            **_bound(*_flash_work(q, k, v, causal), BF16_FLOP_PER_S)))
        del q, k, v, got
    for r in rows:
        print(f"time {r['route']} at {r['arch']}'s {r['what']}, {r['shape']}:"
              f" kernel {r['ms']:.6f} ms (turns {r['ms_turns']}), "
              f"{r['ms'] / r['bound_ms']:.3f} x its bound {r['bound_ms']:.6f}"
              f" ms ({r['bound_by']}; {r['bytes']} B, {r['flops']} FLOP); "
              f"plain {r['plain_ms']:.6f} ms (max abs err "
              f"{r['max_abs_err']}); SDPA {r['library_ms']:.6f} ms "
              f"(turns {r['library_ms_turns']}; kernel / SDPA "
              f"{r['ms'] / r['library_ms']:.3f})")
    return rows


def measure_model_kernels(device, flash_shapes) -> dict:
    """Each model entry point at the shape its main path gives it: device
    time per launch, the plain version's, the library call's where one
    computes the same function (SDPA, GQA; WKV has none) and the bound, the
    larger of bytes over 3.35 TB/s and operations over the peak for their
    type (bf16: the tensor cores; float32: the CUDA cores, since no route
    uses TF32). ``flash_attention_mma`` is qwen2-0.5b's row of
    ``flash_shapes`` (``measure_flash_shapes``). The one-CTA-a-head
    ``wkv``, on no main-path run, at rwkv6-7b's heads over an 8-token
    prompt (one chunk of 8)."""
    import torch.nn.functional as F
    gen = torch.Generator(device=device).manual_seed(9)
    sdpa = F.scaled_dot_product_attention
    check(flash_shapes[0]["arch"] == "qwen2_0_5b"
          and flash_shapes[0]["route"] == "flash_attention_mma",
          f"qwen2's prefill shape ran {flash_shapes[0]['route']}")
    out = {"flash_attention_mma": flash_shapes[0]}

    # flash_attention (CUDA cores) at qwen2's float32 consistency prefill
    hq, hkv, d = 14, 2, 64
    cs = CONSISTENCY_SIZE["cut"]
    q, k, v = _flash_inputs(gen, device, 1, hq, hkv, cs, cs, d, "float32",
                            1.5)
    got, route = _route_of_call(lambda: flash_attention_cuda(q, k, v))
    check(route == "flash_attention", f"float32 ran {route}")
    _within(got, flash_attention_ref(q, k, v), 2e-5, 2e-5,
            "flash_attention float32 vs plain")
    out["flash_attention"] = dict(
        shape=f"q (1, {hq}, {cs}, {d}) float32, k/v (1, {hkv}, {cs}, {d}), "
              f"causal", route=route,
        ms=device_ms(lambda: flash_attention_cuda(q, k, v), 50, device),
        plain_ms=device_ms(lambda: flash_attention_ref(q, k, v), 10, device),
        library_ms=device_ms(lambda: sdpa(q, k, v, is_causal=True,
                                          enable_gqa=True), 50, device),
        library=_sdpa_name(True),
        **_bound(*_flash_work(q, k, v, True), FP32_FLOP_PER_S))
    del q, k, v, got

    # wkv_split at rwkv6-7b's prefill, on the model's head-transposed views
    b, h, s, dk, c = 4, 64, 512, 64, 16
    r, k, v, logw, u = _wkv_views(gen, device, b, h, s, dk)
    (o, st), route = _route_of_call(lambda: wkv_cuda(r, k, v, logw, u))
    check(route == "wkv_split", f"rwkv6-7b's prefill shape ran {route}")
    zero = torch.zeros((b, h, dk, dk), device=device)
    want_o, want_st = wkv_chunked_ref(r, k, v, logw, u, zero)
    _within(o, want_o, 2e-2, 2e-2, "wkv_split o vs plain")
    _within(st, want_st, 5e-4, 1e-3, "wkv_split state vs plain")
    contig = [t.contiguous() for t in (r, k, v, logw)]
    split = lambda: wkv_cuda(r, k, v, logw, u)       # noqa: E731
    turns = [device_ms(f, 20, device) for f in
             (split, lambda: wkv_cuda(*contig, u), split)]
    # how the time grows with the batch (B x H x 2 CTAs): flat while the
    # card has room, linear once the SMs are full
    batch_ms = {}
    for bb in (1, 2):
        views = _wkv_views(gen, device, bb, h, s, dk)
        batch_ms[bb] = device_ms(lambda: wkv_cuda(*views), 20, device)
    batch_ms[b] = turns[0]
    out["wkv_split"] = dict(
        shape=f"r/k/v ({b}, {h}, {s}, {dk}) bf16 head-transposed views, "
              f"logw float32, chunk {c}", route=route, ms=turns[0],
        ms_turns=turns[0::2], contiguous_ms=turns[1], ms_by_batch=batch_ms,
        plain_ms=device_ms(_graphed(
            lambda: wkv_chunked_ref(r, k, v, logw, u, zero), device), 4,
            device),
        library_ms=None, library="none", ctas=b * h * 2,
        sms=torch.cuda.get_device_properties(device).multi_processor_count,
        **_bound(*_wkv_work(r, k, v, logw, u, st, o, c), FP32_FLOP_PER_S))
    del r, k, v, logw, o, st, contig, want_o, want_st

    # wkv (one CTA a head, on no main-path run) at rwkv6-7b's heads over an
    # 8-token prompt: one chunk of 8
    s = c = 8
    r, k, v, logw, u = (t.contiguous() for t in _wkv_views(
        gen, device, b, h, s, dk))
    (o, st), route = _route_of_call(lambda: wkv_cuda(r, k, v, logw, u))
    check(route == "wkv", f"a {s}-token scan ran {route}")
    zero = torch.zeros((b, h, dk, dk), device=device)
    want_o, want_st = wkv_chunked_ref(r, k, v, logw, u, zero)
    _within(o, want_o, 2e-2, 2e-2, "wkv o vs plain")
    _within(st, want_st, 5e-4, 1e-3, "wkv state vs plain")
    out["wkv"] = dict(
        shape=f"r/k/v ({b}, {h}, {s}, {dk}) bf16, logw float32, chunk {c}",
        route=route, ms=device_ms(lambda: wkv_cuda(r, k, v, logw, u), 50,
                                  device),
        plain_ms=device_ms(_graphed(
            lambda: wkv_chunked_ref(r, k, v, logw, u, zero), device), 20,
            device),
        library_ms=None, library="none", ctas=b * h,
        **_bound(*_wkv_work(r, k, v, logw, u, st, o, c), FP32_FLOP_PER_S))

    for name, m in out.items():
        lib = (f"{m['library_ms']:.6f} ms (kernel / library "
               f"{m['ms'] / m['library_ms']:.3f})"
               if m["library_ms"] is not None else "none")
        print(f"time {name} (route {m['route']}) at {m['shape']}: kernel "
              f"{m['ms']:.6f} ms, {m['ms'] / m['bound_ms']:.3f} x its bound "
              f"{m['bound_ms']:.6f} ms ({m['bound_by']}; {m['bytes']} B, "
              f"{m['flops']} FLOP); plain {m['plain_ms']:.6f} ms; library "
              f"{lib}"
              + "".join(f"; {key} {m[key]}" for key in (
                  "ms_turns", "library_ms_turns", "contiguous_ms",
                  "ms_by_batch", "ctas", "sms") if key in m))
    return out


def ptxas_phase() -> dict:
    """Print the ptxas report of every redesigned kernel; fail unless each
    gated one (``PTXAS_GATED``, ``PTXAS_GATED_INSTANCES``) has a 0-byte
    stack frame and no spills. Returns the report by entry point."""
    ptxas = {}
    for lib in PTXAS_LIBRARIES:
        ptxas.update(ptxas_report(
            _build.library_path(lib).with_suffix(".log").read_text()))
    for fn, rep in ptxas.items():
        print(f"ptxas {fn}: {rep}")
    by_entry = {"flash_attention_mma": "flash_mma_kernel",
                "wkv_split": "wkv_split_kernel", **PTXAS_GATED}
    out = {entry: {fn: rep for fn, rep in ptxas.items()
                   if fn.startswith(kernel)}
           for entry, kernel in by_entry.items()}
    gated = {fn: rep for entry in PTXAS_GATED
             for fn, rep in out[entry].items()}
    for entry in PTXAS_GATED:
        check(out[entry], f"ptxas: no report of {entry}'s kernel")
    for fn in PTXAS_GATED_INSTANCES:
        check(fn in ptxas, f"ptxas: no report of {fn}")
        gated[fn] = ptxas[fn]
    for fn, rep in gated.items():
        check(rep.get("stack_bytes") == 0
              and rep.get("spill_store_bytes") == 0
              and rep.get("spill_load_bytes") == 0,
              f"ptxas {fn}: stack or spills {rep}")
    return out


# ------------------------------------------------------- 11. training path
def train_launches(cfg) -> int:
    """Kernel launches of one train step: each forward's (``attn_calls``)
    once a microbatch, and once more where remat reruns the layer in the
    backward. The backward itself launches nothing: the kernels' autograd
    ``Function``s recompute through the plain versions."""
    rerun = 1 if cfg.remat == "none" else 2
    return attn_calls(cfg) * max(cfg.grad_accum, 1) * rerun


@contextlib.contextmanager
def _deterministic():
    """``torch.use_deterministic_algorithms(True, warn_only=True)`` (with
    uninitialised memory left unfilled, as outside the mode); yields a list
    that receives, on exit, the warning of every op that ran without a
    deterministic implementation (empty: the run was deterministic)."""
    seen: list = []
    was = (torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled())
    fill = torch.utils.deterministic.fill_uninitialized_memory
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        torch.utils.deterministic.fill_uninitialized_memory = False
        try:
            yield seen
        finally:
            torch.use_deterministic_algorithms(was[0], warn_only=was[1])
            torch.utils.deterministic.fill_uninitialized_memory = fill
            seen.extend(sorted({str(w.message)[:200] for w in caught
                                if "determinis" in str(w.message)}))


def _bits_equal(a, b) -> bool:
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    a, b = a.detach(), b.detach()
    if a.is_floating_point():
        view = {2: torch.int16, 4: torch.int32, 8: torch.int64}[
            a.element_size()]
        a, b = a.view(view), b.view(view)
    return torch.equal(a, b)


def _train_steps(step_fn, params, opt, batches, device, after=None):
    """Run ``step_fn`` over ``batches``; each step's launches counted from
    0 just before it and read just after, its host time ending in a
    synchronize. ``after(step, params, opt)`` runs after each step."""
    losses, walls, launches = [], [], []
    for i, batch in enumerate(batches, 1):
        _sync(device)
        _build.launches.clear()
        t0 = time.perf_counter()
        loss, params, opt = step_fn(params, opt, batch)
        _sync(device)
        walls.append((time.perf_counter() - t0) * 1e3)
        launches.append(dict(_build.launches))
        losses.append(loss)
        if after is not None:
            after(i, params, opt)
    return [float(x) for x in losses], walls, launches, params, opt


def _batches(cfg, seq, batch, seed, start, n, device):
    data = SyntheticLM(cfg.vocab, seq, batch, seed=seed)
    data.seek(start)
    return make_batch_iterator(itertools.islice(data, n), device=device)


def train_model(device, *, arch, batch, seq, steps, route, resume_at=None,
                descent=False, n_layers=None, seed=0, ckpt_dir=None,
                config=get_config) -> dict:
    """One published model at full width in its dtype (bf16), parameters
    drawn on ``device`` from ``seed``: the gradients of one batch (every
    leaf finite and not all zero), then ``steps`` steps of
    ``make_train_step`` (its default lr) on ``SyntheticLM`` batches of
    ``batch`` x ``seq`` through ``make_batch_iterator``; each step must
    launch exactly ``route`` ``train_launches(cfg)`` times and nothing
    else, and every loss be finite. With ``resume_at``: ``save_async`` of
    (params, AdamWState) after that step, then ``wait``; after the run,
    restore it into a freshly drawn template (bit for bit equal to the
    saved tree) and take the remaining steps again from there: no op may
    warn under ``torch.use_deterministic_algorithms`` (one without a
    deterministic implementation), and the losses equal the straight
    run's bit for bit. With ``descent``: the mean loss of the last three
    steps lies below the first step's. Then one more step under
    ``torch.profiler``."""
    cfg, reduced = _cut(config(arch), n_layers)
    cuts = [f"global batch {TRAIN_4K.global_batch} -> {batch}"] \
        + ([reduced] if reduced else [])
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    accum = max(cfg.grad_accum, 1)
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=device)
                         .manual_seed(seed), device)
    opt = adamw_init(params)
    _sync(device)
    init_s = time.perf_counter() - t0
    n_params = count_params(params)
    step_fn = make_train_step(cfg)
    want = {route: train_launches(cfg)} if on_card else {}

    first = next(iter(_batches(cfg, seq, batch, seed, 0, 1, device)))
    mb = {k: t[:batch // accum] for k, t in first.items()}
    leaves = tree_leaves(trainable(params))
    grads = torch.autograd.grad(train_loss(cfg, params, mb), leaves)
    bad = [i for i, g in enumerate(grads)
           if not (bool(torch.isfinite(g.float()).all()) and bool(g.any()))]
    check(not bad, f"{arch}: gradient leaves {bad} of {len(grads)} are not "
          f"finite or all zero")
    del grads, first, mb

    saved, timing = {}, {}
    manager = CheckpointManager(ckpt_dir) if resume_at else None

    def after(step, params, opt):
        if step != resume_at:
            return
        with torch.no_grad():
            saved["tree"] = tree_map(torch.clone, (params, opt))
        t0 = time.perf_counter()
        manager.save_async(step, (params, opt), {"arch": arch})
        timing["save_async_ms"] = (time.perf_counter() - t0) * 1e3
        manager.wait()
        timing["save_total_ms"] = (time.perf_counter() - t0) * 1e3

    with _deterministic() as nondeterministic:
        losses, walls, launches, params, opt = _train_steps(
            step_fn, params, opt,
            _batches(cfg, seq, batch, seed, 0, steps, device), device, after)
        resumed = None
        if resume_at:
            fresh = init_params(cfg, torch.Generator(device=device)
                                .manual_seed(seed + 1), device)
            t0 = time.perf_counter()
            step, (rp, ropt), meta = restore_checkpoint(
                ckpt_dir, (fresh, adamw_init(fresh)), resume_at)
            _sync(device)
            timing["restore_ms"] = (time.perf_counter() - t0) * 1e3
            del fresh
            got, want_tree = tree_leaves((rp, ropt)), tree_leaves(
                saved.pop("tree"))
            check(step == resume_at and len(got) == len(want_tree)
                  and all(_bits_equal(a, b) for a, b in zip(got, want_tree)),
                  f"{arch}: the restored step {step} differs from the saved "
                  f"tree")
            del got, want_tree
            resumed = _train_steps(
                step_fn, rp, ropt, _batches(cfg, seq, batch, seed, resume_at,
                                            steps - resume_at, device),
                device)
            params, opt = resumed[3], resumed[4]
    for i, got in enumerate(launches + (resumed[2] if resumed else []), 1):
        check(got == want, f"{arch} train step {i} launched {got}, "
              f"expected {want}")
    check(all(math.isfinite(x) for x in losses), f"{arch} losses {losses}")
    check(not descent or statistics.mean(losses[-3:]) < losses[0],
          f"{arch}: the mean loss of the last three steps "
          f"{losses[-3:]} is not below the first {losses[0]}")
    resume = None
    if resumed:
        again = resumed[0]
        straight = losses[resume_at:]
        check(not nondeterministic, f"{arch}: ops without a deterministic "
              f"implementation ran: {nondeterministic}")
        check(again == straight, f"{arch}: resumed losses {again} != "
              f"straight {straight} (deterministic steps)")
        resume = dict(resumed_losses=again, bit_for_bit=True,
                      equal=again == straight, **timing)
    step_ms = statistics.median(walls[1:]) if len(walls) > 1 else walls[0]
    batch_dev = next(iter(_batches(cfg, seq, batch, seed, steps, 1, device)))
    prof = profile_busy(lambda: step_fn(params, opt, batch_dev), device,
                        KERNEL_SYMBOLS.get(route), top=8)
    peak = torch.cuda.max_memory_allocated(device) if on_card else None
    r = dict(arch=arch, n_layers=cfg.n_layers, reduced=cuts,
             n_params=n_params, dtype=cfg.dtype, remat=cfg.remat,
             grad_accum=accum, batch=batch, seq=seq, init_s=init_s,
             losses=losses, walls_ms=walls, step_ms=step_ms,
             tokens_per_s=batch * seq / (step_ms / 1e3),
             launches_a_step=launches[0], launches=sum(
                 (collections.Counter(x) for x in
                  launches + (resumed[2] if resumed else [])),
                 collections.Counter()),
             resume=resume, profile=prof, peak_memory_bytes=peak)
    print(f"train {arch} ({cfg.n_layers} layers, d {cfg.d_model}, "
          f"{n_params} parameters {cfg.dtype}, remat {cfg.remat}, "
          f"grad_accum {accum}; reduced: {'; '.join(cuts)}): {len(losses)} "
          f"steps of {batch} x {seq} tokens, losses {losses}; each step "
          f"launched {launches[0]}"
          + (f"; checkpoint after step {resume_at} (save_async "
             f"{timing['save_async_ms']:.3f} ms, written in "
             f"{timing['save_total_ms']:.3f} ms), restored bit for bit in "
             f"{timing['restore_ms']:.3f} ms; steps {resume_at + 1}-{steps} "
             f"again: losses {resume['resumed_losses']}, equal bit for bit "
             f"(every op of the steps deterministic under "
             f"torch.use_deterministic_algorithms)" if resume else ""))
    print(f"time train {arch}: step median {step_ms:.3f} ms over steps "
          f"2-{len(walls)} ({r['tokens_per_s']:.1f} tokens/s; walls "
          f"{[round(w, 3) for w in walls]} ms); peak allocated memory "
          f"{f'{peak} B' if peak is not None else 'not measured (no card)'}")
    print(f"profile train step {arch}: wall {prof['wall_ms']:.3f} ms "
          f"(profiled), card busy {prof['busy_ms']:.3f} ms over "
          f"{prof['device_events']} device spans ({route} kernel "
          f"{prof['kernel_ms']:.3f} ms), idle share {_fmt_idle(prof)}; top "
          f"device functions (ms, count): "
          + "; ".join(f"{t['name']} {t['ms']:.3f} x{t['count']}"
                      for t in prof["top"]))
    del params, opt, batch_dev, resumed
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    return r


def _wall_ms(fn, device, n: int = 3) -> float:
    """Median host time (ms) of ``n`` calls of ``fn`` after an untimed one,
    each ending in a synchronize."""
    fn()
    _sync(device)
    walls = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        _sync(device)
        walls.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(walls)


def _grads_of(fn, ins, cots):
    """(outputs, gradients of ``ins``) of ``fn`` under the cotangents."""
    ins = [t.detach().requires_grad_() for t in ins]
    outs = fn(*ins)
    outs = outs if isinstance(outs, tuple) else (outs,)
    torch.autograd.backward(outs, cots)
    return [o.detach() for o in outs], [t.grad for t in ins]


#: the autograd routes at the train phase's shapes (label, b, hq, hkv, s, d,
#: dtype, keywords): qwen2's train shape and the elastic phase's on the
#: tensor cores, then the float32 route with each keyword
GRAD_FLASH_CASES = (
    ("qwen2 train", 4, 14, 2, 4096, 64, "bfloat16", dict(causal=True)),
    ("qwen2 elastic", ELASTIC_SIZE["batch"], 14, 2, ELASTIC_SIZE["seq"], 64,
     "bfloat16", dict(causal=True)),
    ("qwen2 pipeline", 1, 14, 2, PIPELINE_SIZE["seq"], 64, "bfloat16",
     dict(causal=True)),
    ("causal", 1, 14, 2, 512, 64, "float32", dict(causal=True)),
    ("window", 1, 14, 2, 512, 64, "float32", dict(causal=True, window=128)),
    ("softcap", 1, 14, 2, 512, 64, "float32", dict(causal=True, cap=50.0)),
    ("kv_len", 1, 14, 2, 512, 64, "float32", dict(causal=False,
                                                  kv_len=300)),
    ("q0", 1, 14, 2, 512, 64, "float32", dict(causal=True, q0=256)),
)
#: rwkv6-7b's microbatch at the train phase's shape
GRAD_WKV_SHAPE = (2, 64, 1024, 64)


def train_kernel_grads(device) -> dict:
    """The kernels' autograd ``Function``s at the train phase's shapes: the
    forward (the kernel) against the plain version at 2e-2 (bf16) / 2e-5
    (float32), and the gradients of a fixed random cotangent against the
    plain version's own autograd gradients, bit for bit (the backward
    recomputes through that same plain function; a mismatch means a
    keyword or a stride did not reach the recompute). Then, at the models'
    shapes (qwen2's train shape, rwkv6's microbatch; the float32 route at
    its causal case), the device time of a forward (the kernel; CUDA
    events), and of a backward (the plain recompute, the ``Function``'s backward) the card's
    busy time under ``torch.profiler`` and the host time ending in a
    synchronize (its time in a step: the WKV recompute's ~10,000 small ops
    leave the card waiting on the host)."""
    gen = torch.Generator(device=device).manual_seed(13)
    out = {}
    for label, b, hq, hkv, s, d, dtype, kw in GRAD_FLASH_CASES:
        q, k, v = _flash_inputs(gen, device, b, hq, hkv, s, s, d, dtype, 1.0)
        do = torch.randn(q.shape, generator=gen, device=device).to(q.dtype)
        _build.launches.clear()
        got_o, got = _grads_of(
            lambda *a: flash_ops.flash_attention(*a, **kw), (q, k, v), (do,))
        route = flash_route(q.dtype, d)
        check(dict(_build.launches) == {route: 1},
              f"grad {label}: launched {dict(_build.launches)}")
        want_o, want = _grads_of(lambda *a: flash_attention_ref(*a, **kw),
                                 (q, k, v), (do,))
        tol = 2e-2 if dtype == "bfloat16" else 2e-5
        err = _within(got_o[0], want_o[0], tol, tol,
                      f"grad {label} forward vs plain")
        same = [_bits_equal(g, w) for g, w in zip(got, want)]
        check(all(same), f"grad {label}: dq/dk/dv bit for bit {same}")
        row = dict(route=route, shape=f"q ({b}, {hq}, {s}, {d}) {dtype}, "
                   f"k/v ({b}, {hkv}, {s}, {d}), {kw}", max_abs_err=err)
        if label in ("qwen2 train", "causal"):
            def backward():
                flash_ops.recompute_grads(q, k, v, do, (True,) * 3, **kw)
            peak = BF16_FLOP_PER_S if dtype == "bfloat16" \
                else FP32_FLOP_PER_S
            row.update(
                ms=device_ms(lambda: flash_attention_cuda(q, k, v, **kw), 5,
                             device),
                backward_wall_ms=_wall_ms(backward, device),
                backward_ms=profile_busy(backward, device, "")["busy_ms"],
                **_bound(*_flash_work(q, k, v, kw["causal"]), peak))
        out.setdefault(route, []).append(row)
        del q, k, v, do, got, want, got_o, want_o
    b, h, s, d = GRAD_WKV_SHAPE
    r, k, v, logw, u = _wkv_views(gen, device, b, h, s, d)
    state = torch.randn((b, h, d, d), generator=gen, device=device) * 0.5
    do = torch.randn((b, h, s, d), generator=gen, device=device).bfloat16()
    dstate = torch.randn((b, h, d, d), generator=gen, device=device)
    ins = (r, k, v, logw, u, state)
    _build.launches.clear()
    got_o, got = _grads_of(lambda *a: wkv_ops.wkv_with_state(*a),
                           ins, (do, dstate))
    check(dict(_build.launches) == {"wkv_split": 1},
          f"grad wkv: launched {dict(_build.launches)}")
    want_o, want = _grads_of(lambda *a: wkv_chunked_ref(*a), ins,
                             (do, dstate))
    err = max(_within(got_o[0], want_o[0], 2e-2, 2e-2, "grad wkv o"),
              _within(got_o[1], want_o[1], 1e-3, 1e-3, "grad wkv state"))
    same = [_bits_equal(g, w) for g, w in zip(got, want)]
    check(all(same), f"grad wkv: dr/dk/dv/dlogw/du/dstate bit for bit {same}")

    def backward():
        wkv_ops.recompute_grads(*ins, do, dstate, (True,) * 6)

    out["wkv_split"] = [dict(
        route="wkv_split", max_abs_err=err,
        shape=f"r/k/v ({b}, {h}, {s}, {d}) bf16 views, logw float32, from "
              f"a non-zero state, cotangents on o and the state",
        ms=device_ms(lambda: wkv_cuda(r, k, v, logw, u, state), 10, device),
        backward_wall_ms=_wall_ms(backward, device),
        backward_ms=profile_busy(backward, device, "")["busy_ms"],
        **_bound(*_wkv_work(r, k, v, logw, u, state, got_o[0], 16),
                 FP32_FLOP_PER_S))]
    for route, rows in out.items():
        for row in rows:
            print(f"grad {route} {row['shape']}: forward max abs err "
                  f"{row['max_abs_err']:.3e}, gradients bit for bit equal "
                  f"to the plain version's autograd"
                  + (f"; forward {row['ms']:.4f} ms (the forward's bound "
                     f"{row['bound_ms']:.4f} ms, {row['bound_by']}), "
                     f"backward (plain recompute) {row['backward_ms']:.4f} "
                     f"ms of card busy time, {row['backward_wall_ms']:.4f} "
                     f"ms of host time a call" if "ms" in row else ""))
    return out


# ------------------------------------------------ 12. elastic KV (dkv) path
_VAL = struct.Struct("<II")        # seq twice: a torn read shows mixed halves


def _enc(seq: int) -> bytes:
    return _VAL.pack(seq & 0xFFFFFFFF, seq & 0xFFFFFFFF)


def _dec(raw: bytes):
    a, b = _VAL.unpack_from(raw, 0)
    return a, a != b


def _dkv_cluster(n_compute: int, n_mem: int):
    cluster = make_cluster(n_nodes=n_compute + n_mem, n_meta=1)
    return cluster, [f"n{i}" for i in range(n_compute, n_compute + n_mem)]


def _verbs_attach(cluster, svc, home: str):
    """Verbs-style cold-connect worker bootstrap, as
    ``benchmarks/elastic_kv.py`` models it: driver init, RC to the meta
    node, one sync READ per shard record, RC per memory node and a scratch
    registration."""
    proc = VerbsProcess(cluster.node(home))
    yield from proc.connect(svc.meta.node)
    mr = yield from proc.reg_mr(4096)
    kv = svc.meta.kv
    for sid in range(svc.n_shards):
        slot = kv.slot_of(shard_key(svc.name, sid))
        yield from proc.read_sync(svc.meta.node.name, mr, 0, kv.mr,
                                  slot * 32, 32)
    for node in {st.node.name for st in svc.stores.values()}:
        yield from proc.connect(cluster.node(node))
    return proc, mr


def _verbs_get(svc, proc, mr, key: int):
    """One lookup the verbs way: two sync bucket READs, local scan."""
    store = svc.stores[svc.shard_of(key)]
    off1, off2 = store.bucket_offsets(key)
    bb = RaceClient.BUCKET_BYTES
    yield from proc.read_sync(store.node.name, mr, 0, store.mr, off1, bb)
    yield from proc.read_sync(store.node.name, mr, bb, store.mr, off2, bb)
    raw = proc.node.read_bytes(mr.addr, 0, 2 * bb).tobytes()
    return RaceClient._scan_buckets(raw, key)


def bench_bootstrap(n_workers: int = 12, n_compute: int = 2, n_mem: int = 2,
                    n_shards: int = 4, n_buckets: int = 128) -> dict:
    """``benchmarks/elastic_kv.py``'s bootstrap suite through the port: a
    spike forks ``n_workers`` workers that attach to the sharded store
    (KRCORE: one batched directory doorbell and a connect per memory node;
    verbs: cold connects) and serve one lookup each. Cost-model µs."""
    out = {"n_workers": n_workers, "n_mem": n_mem, "n_shards": n_shards}
    for kind in ("krcore", "verbs"):
        cluster, mem = _dkv_cluster(n_compute, n_mem)
        env = cluster.env
        svc = DkvService(cluster, mem, n_shards=n_shards,
                         n_buckets=n_buckets)
        for k in range(1, 65):
            svc.seed(k, bytes([k % 250 + 1]))
        attach = []

        def worker(i):
            home = f"n{i % n_compute}"
            key = 1 + i % 64
            t0 = env.now
            if kind == "krcore":
                cl = DkvClient(cluster.module(home))
                yield from cl.bootstrap()
                attach.append(env.now - t0)
                v = yield from cl.get(key)
            else:
                proc, mr = yield from _verbs_attach(cluster, svc, home)
                attach.append(env.now - t0)
                v = yield from _verbs_get(svc, proc, mr, key)
            check(v == bytes([key % 250 + 1]),
                  f"bootstrap ({kind}): key {key} read {v!r}")

        def coordinator():
            t0 = env.now
            procs = []
            for i in range(n_workers):
                yield env.timeout(cluster.fabric.cm.fork_worker_us
                                  / n_compute)
                procs.append(env.process(worker(i), f"w{i}"))
            for p in procs:
                yield p
            return env.now - t0

        fleet_us = env.run_process(coordinator(), "coord")
        a = np.array(attach)
        out[f"{kind}_attach_mean_us"] = float(a.mean())
        out[f"{kind}_attach_p99_us"] = float(np.percentile(a, 99))
        out[f"{kind}_fleet_ready_us"] = float(fleet_us)
    out["attach_reduction_vs_verbs"] = \
        1.0 - out["krcore_attach_mean_us"] / out["verbs_attach_mean_us"]
    return out


def bench_migration(n_reads: int = 120, n_buckets: int = 128,
                    read_gap_us: float = 2.0,
                    write_gap_us: float = 5.0) -> dict:
    """``benchmarks/elastic_kv.py``'s migration suite through the port:
    fenced lookups and a concurrent writer across one live shard migration,
    held against the sequential oracle. Cost-model µs."""
    cluster, mem = _dkv_cluster(2, 2)
    env = cluster.env
    svc = DkvService(cluster, mem[:1], n_shards=2, n_buckets=n_buckets)
    key = 7
    sid = svc.shard_of(key)
    for k in range(1, 33):
        svc.seed(k, _enc(0))
    puts, reads = [], []
    state = {"stop": False, "mig": None, "win": (0.0, 0.0)}

    def writer():
        cl = DkvClient(cluster.module("n1"))
        yield from cl.bootstrap()
        seq = 0
        while not state["stop"]:
            seq += 1
            t0 = env.now
            yield from cl.put(key, _enc(seq))
            puts.append((t0, env.now, seq))
            yield env.timeout(write_gap_us)

    def mover():
        while len(reads) < n_reads // 3:
            yield env.timeout(5.0)
        t0 = env.now
        state["mig"] = yield from svc.migrate(cluster.module("n1"), sid,
                                              mem[1])
        state["win"] = (t0, env.now)

    def reader():
        cl = DkvClient(cluster.module("n0"))
        yield from cl.bootstrap()
        mig = env.process(mover(), "mover")
        for _ in range(n_reads):
            t0 = env.now
            seq, torn = _dec((yield from cl.get(key)))
            reads.append((t0, env.now, seq, torn))
            yield env.timeout(read_gap_us)
        state["stop"] = True
        yield mig
        return cl.stat_redirects

    def scenario():
        wp = env.process(writer(), "writer")
        redirects = yield from reader()
        yield wp
        return redirects

    redirects = env.run_process(scenario(), "mig-bench")
    lo, hi = state["win"]
    bad = 0
    for t0, t1, seq, _torn in reads:
        floor = max([s for (_i, pr, s) in puts if pr <= t0], default=0)
        ceil = max([s for (pi, _r, s) in puts if pi <= t1], default=0)
        bad += not floor <= seq <= ceil
    during = [t1 - t0 for t0, t1, _s, _t in reads if t1 >= lo and t0 <= hi]
    rep = state["mig"]
    return {"n_reads": len(reads), "n_puts": len(puts),
            "torn_reads": sum(1 for r in reads if r[3]),
            "oracle_violations": bad,
            "reads_during_migration": len(during),
            "client_redirects": redirects,
            "p99_during_us": float(np.percentile(during, 99))
            if during else None,
            "migration": None if rep is None else dataclasses.asdict(rep)}


def bench_autoscaler(duration_us: float = 60_000.0, base_rate: float = 120.0,
                     spike_rate: float = 1_500.0, work_us: float = 1_500.0,
                     n_shards: int = 2, max_workers: int = 8) -> dict:
    """``benchmarks/elastic_kv.py``'s autoscaler suite through the port: a
    spike trace into per-shard pull queues, the worker-pull scaler paying
    each worker's real bootstrap (KRCORE or verbs). Cost-model µs."""
    spike_start, spike_len = duration_us * 0.3, duration_us * 0.25
    out = {"work_us": work_us, "n_shards": n_shards}
    for kind in ("krcore", "verbs"):
        cluster, mem = _dkv_cluster(3, 2)
        env = cluster.env
        svc = DkvService(cluster, mem, n_shards=n_shards, n_buckets=128)
        for k in range(1, 65):
            svc.seed(k, bytes([k % 250 + 1]))
        arrivals = spike_trace(base_rate, spike_rate, duration_us,
                               spike_start, spike_len, seed=11)
        keys = 1 + np.random.RandomState(5).randint(0, 64,
                                                    size=len(arrivals))
        queues = [PullQueue(env, f"shard{s}") for s in range(n_shards)]
        homes = itertools.cycle([f"n{i}" for i in range(3)])

        def spawn(queue):
            home = next(homes)
            yield env.timeout(cluster.fabric.cm.fork_worker_us)
            if kind == "krcore":
                cl = DkvClient(cluster.module(home))
                yield from cl.bootstrap()

                def get(key):
                    return (yield from cl.get(key))
            else:
                proc, mr = yield from _verbs_attach(cluster, svc, home)

                def get(key):
                    return (yield from _verbs_get(svc, proc, mr, key))

            def serve(key):
                v = yield from get(int(key))
                check(v is not None, f"autoscaler ({kind}): key {key} lost")
                yield env.timeout(work_us)
            return serve

        scaler = WorkerPullAutoscaler(
            env, queues, spawn, min_workers=1, max_workers=max_workers,
            target_pressure=2, check_period_us=1_000.0).start()

        def admit():
            base = env.now
            for t, key in zip(arrivals, keys):
                if base + float(t) > env.now:
                    yield env.timeout(base + float(t) - env.now)
                queues[svc.shard_of(int(key))].put(int(key))
            last = env.now
            while not all(q.done for q in queues):
                yield env.timeout(500.0)
            scaler.stop()
            scaler.stop_workers()
            return env.now - last

        drain = env.run_process(admit(), f"autoscale.{kind}")
        s = scaler.summary()
        for field in ("served", "enqueued", "workers_peak", "spawns",
                      "wait_p99_us"):
            out[f"{kind}_{field}"] = s[field]
        out[f"{kind}_drain_lag_us"] = float(drain)
    out["arrivals"] = int(len(arrivals))
    out["wait_p99_reduction_vs_verbs"] = 1.0 - out["krcore_wait_p99_us"] \
        / max(out["verbs_wait_p99_us"], 1e-9)
    return out


def elastic_gates(bootstrap: dict, migration: dict,
                  autoscaler: dict) -> list:
    """``check_gates`` of ``benchmarks/elastic_kv.py``."""
    bad = []
    if bootstrap["attach_reduction_vs_verbs"] < 0.80:
        bad.append(f"bootstrap attach reduction below 80%: {bootstrap}")
    if migration["torn_reads"] or migration["oracle_violations"]:
        bad.append(f"torn or non-linearizable reads: {migration}")
    if migration["reads_during_migration"] < 1 \
            or migration["migration"] is None:
        bad.append(f"no lookup overlapped the migration: {migration}")
    for kind in ("krcore", "verbs"):
        if autoscaler[f"{kind}_served"] != autoscaler[f"{kind}_enqueued"]:
            bad.append(f"autoscaler ({kind}) dropped requests: {autoscaler}")
    if autoscaler["wait_p99_reduction_vs_verbs"] < 0.2:
        bad.append(f"spike wait-p99 reduction below 20%: {autoscaler}")
    return bad


def dkv_workload(seed: int, n_keys: int, n_workers: int, batch: int,
                 theta: float = 0.99) -> dict:
    """``n_keys`` distinct keys in [1, 2**32) with 8-byte values, one YCSB-C
    batch of ``batch`` keys a worker (Zipfian ``theta`` over the loaded
    keys, ranks on a seeded shuffle) and one batch never loaded."""
    rng = np.random.default_rng(seed)
    keys = np.unique(rng.integers(1, 2 ** 32, int(n_keys * 1.1) + 16,
                                  dtype=np.int64))
    keys = rng.permutation(keys)[:n_keys]
    check(len(keys) == n_keys, "not enough distinct keys drawn")
    values = rng.integers(0, 256, (n_keys, 8), dtype=np.uint8)
    cdf = np.cumsum(1.0 / np.arange(1, n_keys + 1) ** theta)
    cdf /= cdf[-1]
    reads = [np.minimum(np.searchsorted(cdf, rng.random(batch)), n_keys - 1)
             for _ in range(n_workers)]
    absent = rng.integers(1, 2 ** 32, 2 * batch, dtype=np.int64)
    absent = absent[~np.isin(absent, keys)][:batch]
    return dict(keys=keys, values=values, reads=reads, absent=absent)


def _sim_fleet(cluster, svc, wl, n_compute: int) -> dict:
    """``bench_bootstrap``'s fork schedule at the service's size: each
    worker bootstraps, then ``get_many`` of its batch; then worker 0 reads
    the batch that was never loaded. Cost-model µs."""
    env = cluster.env
    attach, get_us, got, clients = {}, {}, {}, {}
    n_workers = len(wl["reads"])

    def worker(i):
        cl = clients[i] = DkvClient(cluster.module(f"n{i % n_compute}"))
        t0 = env.now
        yield from cl.bootstrap()
        attach[i] = env.now - t0
        t0 = env.now
        got[i] = yield from cl.get_many(wl["keys"][wl["reads"][i]].tolist())
        get_us[i] = env.now - t0

    def coordinator():
        t0 = env.now
        procs = []
        for i in range(n_workers):
            yield env.timeout(cluster.fabric.cm.fork_worker_us / n_compute)
            procs.append(env.process(worker(i), f"w{i}"))
        for p in procs:
            yield p
        fleet = env.now - t0
        absent = yield from clients[0].get_many(wl["absent"].tolist())
        return fleet, absent

    fleet_us, absent = env.run_process(coordinator(), "dkv-fleet")
    a = np.array([attach[i] for i in range(n_workers)])
    g = np.array([get_us[i] for i in range(n_workers)])
    return dict(got=[got[i] for i in range(n_workers)], absent=absent,
                attach_mean_us=float(a.mean()),
                attach_p99_us=float(np.percentile(a, 99)),
                get_many_mean_us=float(g.mean()),
                get_us_per_key=float(g.mean() / len(wl["reads"][0])),
                fleet_ready_us=float(fleet_us),
                redirects=sum(c.stat_redirects for c in clients.values()),
                dir_misses=sum(c.dir.cache.misses for c in clients.values()),
                sim_end_us=float(env.now))


def _check_mirror(got, sim, what: str) -> None:
    """A device lookup == the simulated gets of the same keys: ``found``
    where a get returned a value, and that value's 8 bytes, one lane each
    (rows that were not found are zero)."""
    v, f = (t.cpu().numpy() for t in got)
    want_f = np.array([s is not None for s in sim], np.int32)
    check(np.array_equal(f, want_f),
          f"{what}: found {int(f.sum())} keys, the simulated gets "
          f"{int(want_f.sum())}")
    want_v = np.zeros(v.shape, np.float32)
    for j, s in enumerate(sim):
        if s is not None:
            want_v[j, :len(s)] = np.frombuffer(s, np.uint8)
    check(np.array_equal(v, want_v),
          f"{what}: values differ from the simulated gets")


def dkv_phase(device, *, n_mem, n_compute, n_shards, n_buckets, n_keys,
              n_workers, batch, big_batch, seed, calls, bootstrap, migration,
              autoscaler) -> dict:
    """The elastic KV service through the port (see the module docstring):
    the simulated service at ``n_shards`` x ``n_buckets`` x 8 slots, a fork
    of ``n_workers`` bootstrapping workers with a YCSB-C batch each, the
    device mirror (``ShardedDeviceRaceTable``) held against every simulated
    get, and the three elastic-KV suites with their gates. Returns the
    mirror's launches (counted from zero just before its lookups and read
    just after) and every measurement."""
    device = torch.device(device)
    wl = dkv_workload(seed, n_keys, n_workers, batch)
    t0 = time.perf_counter()
    cluster, mem = _dkv_cluster(n_compute, n_mem)
    svc = DkvService(cluster, mem, n_shards=n_shards, n_buckets=n_buckets)
    for k, v in zip(wl["keys"].tolist(), wl["values"]):
        svc.seed(k, v.tobytes())
    seed_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    sim = _sim_fleet(cluster, svc, wl, n_compute)
    sim_s = time.perf_counter() - t0
    found = sum(s is not None for got in sim["got"] for s in got)
    absent_found = sum(s is not None for s in sim["absent"])
    check(found == n_workers * batch and absent_found == 0,
          f"dkv: {found} of {n_workers * batch} loaded keys and "
          f"{absent_found} absent keys found by the simulated gets")
    mib = n_shards * n_buckets * NSLOT * SLOT_BYTES / 2 ** 20
    print(f"dkv service: {n_mem} memory nodes, {n_compute} compute nodes, "
          f"{n_shards} shards x {n_buckets} buckets x {NSLOT} slots "
          f"({mib:.1f} MiB simulated), {n_keys} keys seeded in "
          f"{seed_s:.2f} s of host time; {n_workers} workers x get_many of "
          f"{batch} keys (YCSB-C, Zipfian 0.99) simulated in {sim_s:.2f} s "
          f"of host time")
    print("dkv simulated fields (cost-model us from the paper's constants, "
          "not times on any chip): " + json.dumps(
              {k: v for k, v in sim.items() if k not in ("got", "absent")}))

    t0 = time.perf_counter()
    table = ShardedDeviceRaceTable(n_shards, n_buckets, NSLOT, vdim=8,
                                   device=device)
    for k, v in zip(wl["keys"].tolist(), wl["values"].astype(np.float32)):
        table.insert(k, v)
    table.sync()
    _sync(device)
    mirror_s = time.perf_counter() - t0
    mirror_mb = (table.val_table.numel() + table.fp_table.numel()) * 4 / 1e6
    per_big = big_batch // batch
    check(big_batch % batch == 0 and per_big <= n_workers,
          f"dkv: a batch of {big_batch} must be whole worker batches")
    lookups = [(wl["keys"][idx], got, f"worker {i}")
               for i, (idx, got) in enumerate(zip(wl["reads"], sim["got"]))]
    lookups.append((wl["absent"], sim["absent"], "absent batch"))
    lookups.append((np.concatenate([wl["keys"][i]
                                    for i in wl["reads"][:per_big]]),
                    [s for got in sim["got"][:per_big] for s in got],
                    f"batch of {big_batch}"))
    _build.launches.clear()
    for keys, want, what in lookups:
        got = table.lookup_batch(keys)
        _check_mirror(got, want, f"dkv mirror, {what}")
    _sync(device)
    launches = dict(_build.launches)
    _build.launches.clear()
    for keys, want, what in lookups:
        _check_mirror(table.lookup_batch(keys, impl="ref"), want,
                      f"dkv mirror (plain version), {what}")
    _build.launches.clear()

    def timed(keys):
        def call():
            table.lookup_batch(keys)
            _sync(device)
        return _p50_p90(call, calls)

    host = {str(len(k)): timed(k) for k, _w, _x in (lookups[0], lookups[-1])}
    _build.launches.clear()
    print(f"dkv device mirror ShardedDeviceRaceTable({n_shards}, "
          f"{n_buckets}, {NSLOT}, vdim=8) on {device} ({mirror_mb:.1f} MB): "
          f"{n_keys} keys inserted in {mirror_s:.2f} s of host time; "
          f"{len(lookups)} lookup_batch calls equal every simulated get; "
          f"launches {launches}; lookup_batch p50/p90 ms over {calls} calls "
          f"(each ending in a synchronize) by batch: {host}")
    del table
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    suites = dict(bootstrap=bench_bootstrap(**bootstrap),
                  migration=bench_migration(**migration),
                  autoscaler=bench_autoscaler(**autoscaler))
    print("dkv suites (cost-model us): " + json.dumps(suites))
    bad = elastic_gates(**suites)
    check(not bad, "; ".join(bad))
    return dict(launches=launches, lookups=len(lookups), host_ms=host,
                seed_s=seed_s, sim_s=sim_s, mirror_s=mirror_s,
                mirror_mb=mirror_mb,
                sim=dict({k: v for k, v in sim.items()
                          if k not in ("got", "absent")},
                         found=found, absent_found=absent_found),
                **suites)


# ----------------------------------------------------- 13. gateway (host)
def bench_traces(n_nodes: int = 4, duration_us: float = 200_000.0,
                 rate_per_s: float = 400.0) -> list:
    """``benchmarks/serverless.py``'s trace cells through the port: the
    gateway under Poisson, spike and diurnal open-loop traces."""
    shapes = {
        "poisson": poisson_trace(rate_per_s, duration_us, seed=1),
        "spike": spike_trace(rate_per_s / 4, rate_per_s * 4, duration_us,
                             duration_us * 0.4, duration_us * 0.2, seed=2),
        "diurnal": diurnal_trace(rate_per_s, duration_us,
                                 period_us=duration_us / 2, seed=3),
    }
    rows = []
    for shape, arrivals in shapes.items():
        cluster = make_cluster(n_nodes=n_nodes + 1, n_meta=1)
        pool = ContainerPool(cluster, "krcore", warm_target=4,
                             prewarm_threshold=2)
        gw = InvocationGateway(cluster, default_registry(payload_bytes=1024),
                               pool, worker_nodes=[f"n{i}" for i in
                                                   range(n_nodes)],
                               data_node=f"n{n_nodes}")
        cluster.env.run_process(gw.submit_trace("extract", arrivals,
                                                payload_bytes=1024),
                                f"trace.{shape}")
        rows.append(dict(gw.summary(), shape=shape, arrivals=len(arrivals)))
    return rows


def bench_response(n_nodes: int = 2, duration_us: float = 120_000.0,
                   base_rate: float = 150.0, spike_mult: float = 8.0,
                   payload_bytes: int = 1024) -> dict:
    """``benchmarks/serverless.py``'s closed-loop cell through the port:
    every output returns to the caller over ``session.call``; tails inside
    the spike window and off-peak."""
    spike_start, spike_len = duration_us * 0.4, duration_us * 0.2
    arrivals = spike_trace(base_rate, base_rate * spike_mult, duration_us,
                           spike_start, spike_len, seed=14)
    cluster = make_cluster(n_nodes=n_nodes + 2, n_meta=1)
    pool = ContainerPool(cluster, "krcore", warm_target=4,
                         prewarm_threshold=2)
    gw = InvocationGateway(cluster,
                           default_registry(payload_bytes=payload_bytes),
                           pool, worker_nodes=[f"n{i}" for i in
                                               range(n_nodes)],
                           data_node=f"n{n_nodes}",
                           caller_node=f"n{n_nodes + 1}")
    cluster.env.run_process(gw.submit_trace("extract", arrivals,
                                            payload_bytes=payload_bytes),
                            "response")
    base = gw.last_trace_base
    return dict(gw.summary(), arrivals=len(arrivals),
                spike_window=gw.window_summary(
                    base + spike_start, base + spike_start + spike_len),
                offpeak=gw.window_summary(base, base + spike_start))


def bench_pull() -> dict:
    """The worker-pull gateway case of ``tests/test_dkv.py``: 12 arrivals
    400 us apart into a pull queue, up to 4 pull workers."""
    cluster = make_cluster(n_nodes=3, n_meta=1)
    gw = InvocationGateway(cluster, default_registry(payload_bytes=256),
                           ContainerPool(cluster, "krcore"),
                           worker_nodes=["n0", "n1"], data_node="n2")
    recs = cluster.env.run_process(gw.submit_trace_pull(
        "extract", [i * 400.0 for i in range(12)], payload_bytes=256,
        max_workers=4, check_period_us=500.0), "pull")
    s = gw.last_autoscaler.summary()
    return dict(n=len(recs), served=s["served"],
                workers_peak=s["workers_peak"], wait_p99_us=s["wait_p99_us"],
                ordered=all(r.end_us >= r.start_us >= r.arrival_us
                            for r in recs))


def gateway_gates(res: dict) -> list:
    """``check_gates`` of ``benchmarks/serverless.py`` for these cells: no
    dropped invocation, and invocations in the spike window."""
    bad = [f"trace dropped invocations: {row}" for row in res["traces"]
           if row["n"] != row["arrivals"]]
    resp = res["response"]
    if resp["n"] != resp["arrivals"]:
        bad.append(f"closed loop dropped invocations: {resp}")
    if resp["spike_window"].get("n", 0) == 0:
        bad.append(f"no invocations landed in the spike window: {resp}")
    pull = res["pull"]
    if not pull["n"] == pull["served"] == 12 or not pull["ordered"]:
        bad.append(f"worker-pull gateway: {pull}")
    return bad


def gateway_phase(traces: dict, response: dict) -> dict:
    """The gateway cells through the port, on the host only: the gateway
    moves no slab, so this phase launches no kernel (checked)."""
    _build.launches.clear()
    t0 = time.perf_counter()
    res = dict(traces=bench_traces(**traces),
               response=bench_response(**response), pull=bench_pull())
    wall = time.perf_counter() - t0
    check(not _build.launches,
          f"the gateway phase launched {dict(_build.launches)}")
    print(f"gateway phase (host only; launches no kernel) in {wall:.2f} s "
          f"of host time; cost-model us: " + json.dumps(res))
    bad = gateway_gates(res)
    check(not bad, "; ".join(bad))
    return res


def _run_summary(r: dict) -> dict:
    """The serving phase's numbers of one model, for the ``kernels`` line."""
    keys = ("n_layers", "reduced", "n_params", "peak_memory_bytes",
            "prefill_launches", "decode_launches", "prefill_ms",
            "decode_ms_per_step", "bootstrap_cold_ms", "bootstrap_hit_ms")
    return dict({k: r[k] for k in keys},
                prefill_idle_share=r["prefill_profile"]["idle_share"],
                decode_idle_share=r["decode_profile"]["idle_share"])


def _by_shape_row(row: dict, route: str, serving: dict) -> dict:
    """One flash shape's times for the ``kernels`` line, with the launches
    of ``route`` counted in its model's prefill; a shape of a model that no
    phase serves is ``served: false`` and has no count."""
    served = row["arch"] in serving
    return dict(row, served=served, launches_a_prefill=serving[row["arch"]][
        "prefill_launches"].get(route, 0) if served else None)


def elastic_phase(device, *, arch, batch, seq, steps, seed,
                  config=get_config) -> dict:
    """``ElasticTrainer`` on one card (one rank: a process group of this
    process alone), the model as ``train_model`` builds it (drawn on
    ``device`` from ``seed``, ``make_train_step`` at its default lr),
    ``steps`` ``SyntheticLM`` batches of ``batch`` x ``seq``, the first
    also the trainers' example batch. Trainer H has the ladder (1,):
    ``prewarm`` builds it, then ``scale_to(1)`` must be a generic hit that
    builds nothing; trainer C has no ladder: ``scale_to(1)`` must be cold
    and build once. Then each takes the same steps from the same initial
    state under ``torch.use_deterministic_algorithms``: no op may warn,
    every loss is finite, H's losses equal C's bit for bit, and each step
    launches exactly ``train_launches`` of the model's flash route, counted
    from 0 just before the step and read just after. Then each scales to 1
    again, on the state it holds: a pool hit with no build (H's generic,
    C's the specialized entry its cold build left), whose ``control_s`` is
    the bootstrap alone (the first ``scale_to`` also draws the initial
    state)."""
    cfg = config(arch)
    on_card = torch.device(device).type == "cuda"
    route = flash_route(cfg.param_dtype, cfg.d_head)
    want = {route: train_launches(cfg)} if on_card else {}
    batches = list(itertools.islice(SyntheticLM(cfg.vocab, seq, batch,
                                                seed=seed), steps))
    card = card_line() if on_card else "no card (CPU rehearsal)"

    def make_step(mesh):
        inner = make_train_step(cfg, mesh=mesh)

        def step(state, b):
            params, opt = state
            loss, params, opt = inner(params, opt, b)
            return loss, (params, opt)
        return step

    def init_state():
        p = init_params(cfg, torch.Generator(device=device).manual_seed(seed),
                        device)
        return (p, adamw_init(p))

    def run(ladder):
        tr = ElasticTrainer(cfg, make_step, init_state, ladder=ladder,
                            example_batch=batches[0], device=device)
        tr.prewarm()
        prewarm_builds = tr.n_builds
        ev = tr.scale_to(1)
        losses, walls, launches = [], [], []
        for b in batches:
            _sync(device)
            _build.launches.clear()
            t0 = time.perf_counter()
            losses.append(tr.train_step(b))
            _sync(device)
            walls.append((time.perf_counter() - t0) * 1e3)
            launches.append(dict(_build.launches))
        built = tr.n_builds
        again = tr.scale_to(1)
        out = dict(event=ev, prewarm_builds=prewarm_builds,
                   scale_builds=built - prewarm_builds, again=again,
                   again_builds=tr.n_builds - built,
                   compile_s={str(k): e.compile_s
                              for k, e in tr.pool._entries.items()},
                   losses=losses, walls_ms=walls, launches=launches)
        del tr
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
        return out

    t0 = time.perf_counter()
    try:
        with _deterministic() as nondeterministic:
            hit, cold = run((1,)), run(())
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    check(not nondeterministic, f"elastic {arch}: ops without a "
          f"deterministic implementation ran: {nondeterministic}")
    check(hit["prewarm_builds"] == 1 and hit["event"]["kind"] == "generic"
          and hit["scale_builds"] == 0,
          f"elastic {arch}: the ladder trainer's scale_to(1) was "
          f"{hit['event']} after {hit['prewarm_builds']} prewarm builds, "
          f"with {hit['scale_builds']} builds")
    check(cold["prewarm_builds"] == 0 and cold["event"]["kind"] == "cold"
          and cold["scale_builds"] == 1,
          f"elastic {arch}: the trainer without a ladder's scale_to(1) was "
          f"{cold['event']} with {cold['scale_builds']} builds")
    for r, kind in ((hit, "generic"), (cold, "specialized")):
        check(r["again"]["kind"] == kind and r["again_builds"] == 0,
              f"elastic {arch}: scaling to 1 again was {r['again']} with "
              f"{r['again_builds']} builds, expected a {kind} hit")
    check(len(hit["losses"]) == len(cold["losses"]) == steps
          and all(_bits_equal(a, b)
                  for a, b in zip(hit["losses"], cold["losses"])),
          f"elastic {arch}: the two trainers' losses differ: "
          f"{[float(x) for x in hit['losses']]} vs "
          f"{[float(x) for x in cold['losses']]}")
    losses = [float(x) for x in hit["losses"]]
    check(all(math.isfinite(x) for x in losses),
          f"elastic {arch}: losses {losses}")
    for name, r in (("H", hit), ("C", cold)):
        for i, got in enumerate(r["launches"], 1):
            check(got == want, f"elastic {arch} trainer {name} step {i} "
                  f"launched {got}, expected {want}")
        r["losses"] = [float(x) for x in r["losses"]]
    step_ms = statistics.median(hit["walls_ms"][1:] + cold["walls_ms"][1:])
    wall_s = time.perf_counter() - t0
    print(f"elastic {arch} ({cfg.n_layers} layers, {cfg.dtype}, remat "
          f"{cfg.remat}; {steps} steps of {batch} x {seq} tokens a trainer; "
          f"on {card}): trainer H (ladder (1,)) prewarm built "
          f"{hit['prewarm_builds']} in compile_s "
          f"{hit['compile_s']} s, scale_to(1) {hit['event']['kind']} with "
          f"{hit['scale_builds']} builds, control_s "
          f"{hit['event']['control_s']:.6f} s; trainer C (no ladder) "
          f"scale_to(1) {cold['event']['kind']} with {cold['scale_builds']} "
          f"build, control_s {cold['event']['control_s']:.6f} s "
          f"(compile_s {cold['compile_s']} s); losses {losses}, equal bit for "
          f"bit in H and C; each step launched {hit['launches'][0]}; "
          f"scale_to(1) again on the drawn state: H {hit['again']['kind']} "
          f"control_s {hit['again']['control_s']:.6f} s, C "
          f"{cold['again']['kind']} control_s "
          f"{cold['again']['control_s']:.6f} s, no build")
    print(f"time elastic {arch} on {card}: step median {step_ms:.3f} ms over "
          f"steps 2-{steps} of both trainers (walls H "
          f"{[round(w, 3) for w in hit['walls_ms']]}, C "
          f"{[round(w, 3) for w in cold['walls_ms']]} ms); the phase "
          f"{wall_s:.3f} s")
    launches = collections.Counter()
    for row in hit["launches"] + cold["launches"]:
        launches.update(row)
    return dict(arch=arch, n_layers=cfg.n_layers, batch=batch, seq=seq,
                steps=steps, hit=hit, cold=cold, losses=losses,
                step_ms=step_ms, wall_s=wall_s, launches=dict(launches),
                card=card)


def train_phase_child(device) -> int:
    """Phase 11 itself, run as ``chip_smoke.py --train`` by
    :func:`train_phase` (the kernels built already): the autograd routes,
    each model's steps (its checkpoint in a directory of its own, removed
    after the model), the recompute's share, then the elastic trainer; its
    results go to ``TRAIN_CKPT_DIR / "result.json"``."""
    t0 = time.perf_counter()
    grads = train_kernel_grads(device)
    training = {}
    for m in TRAIN_SIZE:
        ckpt = TRAIN_CKPT_DIR / m["arch"]
        training[m["arch"]] = train_model(device, **m, ckpt_dir=str(ckpt))
        shutil.rmtree(ckpt, ignore_errors=True)
    recompute = train_recompute_share(training, grads)
    elastic = elastic_phase(device, **ELASTIC_SIZE)
    TRAIN_CKPT_DIR.mkdir(parents=True, exist_ok=True)
    print(f"train phase wall time {time.perf_counter() - t0:.3f} s "
          f"(its own process, with {TRAIN_ENV})", flush=True)
    (TRAIN_CKPT_DIR / "result.json").write_text(json.dumps(dict(
        grads=grads, training=training, recompute=recompute,
        elastic=elastic)))
    return 0


def train_phase() -> tuple:
    """Run phase 11 in a child process with ``TRAIN_ENV`` (see there) and
    return its (grads, training, recompute, elastic); fails if the child
    fails.
    The checkpoint directory is removed either way."""
    shutil.rmtree(TRAIN_CKPT_DIR, ignore_errors=True)
    sys.stdout.flush()
    try:
        proc = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--train"],
            env={**os.environ, **TRAIN_ENV}, timeout=900)
        check(proc.returncode == 0,
              f"the train phase exited {proc.returncode}")
        out = json.loads((TRAIN_CKPT_DIR / "result.json").read_text())
    finally:
        shutil.rmtree(TRAIN_CKPT_DIR, ignore_errors=True)
    return out["grads"], out["training"], out["recompute"], out["elastic"]


def train_recompute_share(training: dict, grads: dict) -> dict:
    """The backward's plain recompute in each train step: the host time
    (ending in a synchronize) of one recompute at the model's shape
    (``train_kernel_grads``) times the recomputes a step makes (one a
    kernel call of the forward), over the median step time; beside it the
    same with the recompute's card busy time."""
    out = {}
    for arch, row in training.items():
        route = next(iter(row["launches_a_step"]))
        calls = row["launches_a_step"][route] // (1 if row["remat"] == "none"
                                                  else 2)
        grad = next(g for g in grads[route] if "backward_ms" in g)
        ms = calls * grad["backward_wall_ms"]
        out[arch] = dict(route=route, recomputes_a_step=calls,
                         backward_ms=grad["backward_ms"],
                         backward_wall_ms=grad["backward_wall_ms"],
                         forward_ms=grad["ms"], shape=grad["shape"],
                         recompute_ms_a_step=ms,
                         recompute_share=ms / row["step_ms"],
                         recompute_device_share=calls * grad["backward_ms"]
                         / row["step_ms"])
        print(f"train {arch}: {calls} backward recomputes of {route}'s plain "
              f"version a step x {grad['backward_wall_ms']:.4f} ms (host; card "
              f"busy {grad['backward_ms']:.4f} ms) = {ms:.3f} ms, "
              f"{out[arch]['recompute_share']:.4f} of the {row['step_ms']:.3f}"
              f" ms step ({out[arch]['recompute_device_share']:.4f} by busy "
              f"time; the kernel's forward at that shape: {grad['ms']:.4f} "
              f"ms)")
    return out


def _train_summary(r: dict, recompute: dict) -> dict:
    """The train phase's numbers of one model, for the ``kernels`` line."""
    keys = ("n_layers", "reduced", "n_params", "grad_accum", "batch", "seq",
            "losses", "step_ms", "tokens_per_s", "launches_a_step",
            "resume", "peak_memory_bytes")
    return dict({k: r[k] for k in keys}, **recompute,
                idle_share=r["profile"]["idle_share"],
                busy_ms=r["profile"]["busy_ms"])


def _elastic_summary(r: dict) -> dict:
    """The elastic phase's numbers, for the ``kernels`` line."""
    return dict({k: r[k] for k in ("n_layers", "batch", "seq", "steps",
                                   "losses", "step_ms", "launches")},
                hit_control_s=r["hit"]["event"]["control_s"],
                cold_control_s=r["cold"]["event"]["control_s"],
                again_control_s=[r[k]["again"]["control_s"]
                                 for k in ("hit", "cold")],
                compile_s=r["hit"]["compile_s"])


# ------------------------------------------------ 14. pipeline, 15. dry run
#: the pipeline's gradients against the whole-batch sequential run's, each
#: leaf's largest error over its largest value: bf16 (8 bits of mantissa)
#: rounded in another order (four microbatch products summed in float32
#: against one product over the batch), through 24 layers
PIPELINE_GRAD_TOL = 5e-2
#: the dry run's cells (arch, shape, two pods, the depth variants' exact
#: FLOPs): deepseek-v2 at full depth, which no card holds (~470 GB), and
#: qwen2-0.5b, on both production meshes
DRYRUN_CELLS = (dict(arch="qwen2_0_5b", shape="train_4k", multi_pod=False),
                dict(arch="qwen2_0_5b", shape="train_4k", multi_pod=True),
                dict(arch="deepseek_v2_236b", shape="train_4k",
                     multi_pod=False),
                dict(arch="deepseek_v2_236b", shape="train_4k",
                     multi_pod=True))


def pipeline_phase(device, *, arch, n_micro, seq, seed,
                   config=get_config) -> dict:
    """``pipeline_apply`` over a one-rank "stage" mesh (NCCL on the card,
    gloo on the CPU; a process group of this process alone, destroyed
    after the phase): the stage function is ``arch``'s decoder layers at
    full width in the config's dtype (``dense_layer_full`` a layer), the
    input the embeddings of ``n_micro`` microbatches of 1 x ``seq`` drawn
    tokens, parameters drawn on ``device`` from ``seed``; the loss the mean
    square of the outputs, taken with ``torch.autograd.grad`` over every
    layer parameter. Gates: the forward equals the same layers run
    microbatch by microbatch bit for bit (same shapes, same kernels); the
    gradients equal those of the whole batch run in one call at
    ``PIPELINE_GRAD_TOL``; each pipelined run launches exactly one flash
    kernel a layer and microbatch (the backward recomputes through the
    plain version), counted from 0 just before it and read just after.
    After an untimed run of each, runs in turns (pipeline, whole batch,
    whole batch, pipeline), each timed on the host clock ending in a
    synchronize, with its peak allocated memory."""
    cfg = config(arch)
    device = torch.device(device)
    on_card = device.type == "cuda"
    card = card_line() if on_card else "no card (CPU rehearsal)"
    route = flash_route(cfg.param_dtype, cfg.d_head)
    want = {route: attn_calls(cfg) * n_micro} if on_card else {}
    t_phase = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(seed)
    params = init_params(cfg, gen, device)
    tokens = torch.randint(0, cfg.vocab, (n_micro, 1, seq), generator=gen,
                           device=device)
    x = embed(cfg, params, tokens).detach()           # (M, 1, seq, d)
    blocks = params["blocks"]
    del params
    leaves = tree_leaves(blocks)
    for t in leaves:
        t.requires_grad_()

    def stage_fn(p, h):
        positions = torch.arange(h.shape[1], device=h.device).expand(
            h.shape[0], -1)
        for p_l in _layers(p):
            h = dense_layer_full(cfg, p_l, h, positions,
                                 cfg.sliding_window)[0]
        return h

    def loss_of(out):
        return (out.float() ** 2).mean()

    def pipelined(mesh):
        out = pipeline_apply(stage_fn, blocks, x, mesh)
        return out.detach(), torch.autograd.grad(loss_of(out), leaves)

    def whole(mesh):
        out = stage_fn(blocks, x.reshape(n_micro, seq, -1))
        return out.detach().reshape(x.shape), \
            torch.autograd.grad(loss_of(out), leaves)

    check(not dist.is_initialized(), "pipeline: a process group exists")
    ensure_process_group(device)
    runs = {}
    try:
        mesh = DeviceMesh(device.type, torch.arange(1),
                          mesh_dim_names=("stage",))
        # an untimed run of each first (the first calls of a process pay
        # for handles, allocations and the plain recompute's first shapes)
        for name in ("warm-up", "warm-up whole", "pipeline", "whole",
                     "whole", "pipeline"):
            fn = pipelined if name in ("warm-up", "pipeline") else whole
            _sync(device)
            if on_card:
                torch.cuda.reset_peak_memory_stats(device)
            _build.launches.clear()
            t0 = time.perf_counter()
            out, grads = fn(mesh)
            _sync(device)
            # gradients kept for the checks: both timed pipelined runs' and
            # the first whole batch's
            keep = name == "pipeline" or (name == "whole"
                                          and "whole" not in runs)
            runs.setdefault(name, []).append(dict(
                out=out, grads=grads if keep else None,
                wall_ms=(time.perf_counter() - t0) * 1e3,
                launches=dict(_build.launches),
                peak_memory_bytes=torch.cuda.max_memory_allocated(device)
                if on_card else None))
        with torch.no_grad():
            by_micro = torch.stack([stage_fn(blocks, x[i])
                                    for i in range(n_micro)])
    finally:
        dist.destroy_process_group()
    pipe, ref = runs["pipeline"], runs["whole"]
    for r in runs["warm-up"] + pipe:
        check(r["launches"] == want, f"pipeline {arch}: a pipelined run "
              f"launched {r['launches']}, expected {want}")
        check(_bits_equal(r["out"], by_micro),
              f"pipeline {arch}: the forward differs from the layers run "
              f"microbatch by microbatch")
    check(all(_bits_equal(a, b) for a, b in zip(pipe[0]["grads"],
                                                  pipe[1]["grads"])),
          f"pipeline {arch}: two pipelined runs' gradients differ")
    grad_err = 0.0
    for g, w in zip(pipe[0]["grads"], ref[0]["grads"]):
        check(bool(torch.isfinite(g).all()), f"pipeline {arch}: a gradient "
              f"is not finite")
        scale = float(w.float().abs().max())
        grad_err = max(grad_err, float((g.float() - w.float()).abs().max())
                       / (scale if scale > 0 else 1.0))
    check(grad_err <= PIPELINE_GRAD_TOL,
          f"pipeline {arch}: gradients {grad_err:.3e} (a leaf's largest "
          f"error over its largest value) from the whole batch's, above "
          f"{PIPELINE_GRAD_TOL}")
    out_err = float((pipe[0]["out"].float() - ref[0]["out"].float()).abs()
                    .max())
    launches = collections.Counter()
    for r in runs["warm-up"] + pipe:
        launches.update(r["launches"])
    res = dict(arch=arch, n_layers=cfg.n_layers, n_micro=n_micro, seq=seq,
               dtype=cfg.dtype, launches=dict(launches),
               launches_a_run=pipe[0]["launches"], grad_err=grad_err,
               grad_tol=PIPELINE_GRAD_TOL, whole_batch_out_max_abs=out_err,
               pipeline_wall_ms=[r["wall_ms"] for r in pipe],
               whole_wall_ms=[r["wall_ms"] for r in ref],
               pipeline_peak_memory_bytes=[r["peak_memory_bytes"]
                                           for r in pipe],
               whole_peak_memory_bytes=[r["peak_memory_bytes"] for r in ref],
               card=card)
    res["wall_s"] = time.perf_counter() - t_phase
    print(f"pipeline {arch} ({cfg.n_layers} layers as one stage, {cfg.dtype},"
          f" {n_micro} microbatches of 1 x {seq} tokens, a one-rank "
          f"{'NCCL' if on_card else 'gloo'} stage mesh; on {card}): forward "
          f"equal bit for bit to the layers run microbatch by microbatch; "
          f"gradients within {grad_err:.3e} of the whole batch's (leaf's "
          f"largest error over its largest value; tolerance "
          f"{PIPELINE_GRAD_TOL}), outputs within {out_err:.3e}; each "
          f"pipelined run launched {pipe[0]['launches']}")
    print(f"time pipeline {arch} on {card}: forward + backward "
          f"{[round(r['wall_ms'], 3) for r in pipe]} ms pipelined against "
          f"{[round(r['wall_ms'], 3) for r in ref]} ms for the whole batch "
          f"in one call (turns: pipeline, whole, whole, pipeline); peak "
          f"allocated {res['pipeline_peak_memory_bytes']} B pipelined, "
          f"{res['whole_peak_memory_bytes']} B whole; the phase "
          f"{res['wall_s']:.3f} s")
    return res


def dryrun_rows(cells=DRYRUN_CELLS, overrides=None) -> list:
    """The dry run's record of each cell (``launch.dryrun.run_cell``; the
    exact FLOPs on the single-pod mesh). Each cell starts the fake process
    group of its mesh and destroys it after."""
    return [dryrun.run_cell(c["arch"], c["shape"], c["multi_pod"], overrides,
                            exact=not c["multi_pod"]) for c in cells]


def dryrun_report(rows, card: str) -> list:
    """Print each record and gate it: status "ok", FLOPs > 0, argument
    bytes > 0, and a train step's collectives one all-reduce over the
    data-parallel group (16 ranks on 16 x 16, pod x data = 32 on
    2 x 16 x 16)."""
    for r in rows:
        check(r["status"] == "ok", f"dry run {r['arch']} {r['shape']} "
              f"{r['mesh']}: {r.get('error')}\n{r.get('trace', '')}")
        col, mem = r["collectives"], r["memory"]
        print(f"dryrun {r['arch']} {r['shape']} {r['mesh']} ({r['ranks']} "
              f"ranks on the fake group, traced on the meta device on the "
              f"host of {card}): argument bytes a rank "
              f"{mem['argument_bytes']}, output bytes {mem['output_bytes']} "
              f"(temp bytes not known), FLOPs a rank "
              f"{r['flops_per_device']:.6e} ({r['flops_source']})"
              + (f", exact {r['exact']['flops_per_device']:.6e} from depths "
                 f"{r['exact']['depth_points']}" if "exact" in r else "")
              + f"; collectives {col['counts']} over groups of "
              f"{col['group_sizes']}, result bytes {col['result_bytes']}, "
              f"link bytes a rank {col['link_bytes_per_device']:.6e}; "
              f"trace {r['trace_s']} s"
              + (f" (+ {r['exact']['trace_s']:.3f} s for the depth variants)"
                 if "exact" in r else ""))
        check(r["flops_per_device"] > 0 and mem["argument_bytes"] > 0,
              f"dry run {r['arch']} {r['mesh']}: no FLOPs or no bytes")
        if r["kind"] == "train":
            k = 32 if r["mesh"] == "2x16x16" else 16
            check(col["counts"]["all-reduce"] == 1
                  and col["group_sizes"] == [k],
                  f"dry run {r['arch']} {r['mesh']}: the train step's "
                  f"collectives {col}, expected one all-reduce over {k} ranks")
    return rows


def dryrun_phase_child() -> int:
    """Phase 15 itself, run as ``chip_smoke.py --dryrun`` by
    :func:`dryrun_phase` (the fake process groups of 256 and 512 ranks are
    default groups of their own process): prints its records as one JSON
    line after ``DRYRUN``."""
    t0 = time.perf_counter()
    rows = dryrun_rows()
    print(f"dry run wall time {time.perf_counter() - t0:.3f} s", flush=True)
    print("DRYRUN " + json.dumps(rows), flush=True)
    return 0


def dryrun_phase() -> list:
    """Run phase 15 in a child process and gate its records."""
    sys.stdout.flush()
    proc = subprocess.run(
        [sys.executable, str(Path(__file__).resolve()), "--dryrun"],
        stdout=subprocess.PIPE, text=True, timeout=600)
    lines = proc.stdout.splitlines()
    print("\n".join(line for line in lines if not line.startswith("DRYRUN ")))
    check(proc.returncode == 0, f"the dry run exited {proc.returncode}")
    rows = json.loads(next(line for line in lines
                           if line.startswith("DRYRUN "))[len("DRYRUN "):])
    return dryrun_report(rows, card_line())


# ------------------------------------------------------------------- main
#: launches each main-path run must make, exactly (see the module docstring)
LOOKUP_LAUNCHES = {
    "DeviceRaceTable": {"race_lookup_tiled_byval": 16,
                        "race_lookup_tiled": 9, "race_lookup_scalar": 1},
    "ShardedDeviceRaceTable": {"race_lookup_sharded_byval": 16,
                               "race_lookup_sharded": 9,
                               "race_lookup_scalar_byval": 4}}
CHAIN_LAUNCHES = {"chunk_gather_byval": 70}
#: keys of the ``lookup_batch`` whose device spans are gated: one span, the
#: kernel, on either table
SPAN_BATCH = 512
#: device spans of the sharded table's ``impl="scalar"`` call of the
#: largest batch: one kernel a shard, no copy
SCALAR_SPANS = 4
#: device spans of one profiled K = 64 x 1 KiB chain epoch: 16 gathers,
#: each one copy of the source, the kernel and one copy back
CHAIN_SPANS = 48


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    started = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if argv == ["--train"]:
        return train_phase_child(device)
    if argv == ["--dryrun"]:
        return dryrun_phase_child()
    if argv:
        print(f"chip_smoke: unknown arguments {argv}", file=sys.stderr)
        return 2
    device_report()
    print("TF32 off: torch.backends.cuda.matmul.allow_tf32 = False, "
          "torch.backends.cudnn.allow_tf32 = False (float32 products in "
          "full float32)")
    build_kernels()
    errs = kernel_parity(device)
    errs.update(stage_parity(device))
    errs.update(model_kernel_parity(device))
    cfg = REAL_SIZE
    res = main_path(device, **cfg,
                    measure=lambda t, wl, sh: measure_table(t, wl, sh,
                                                            device),
                    compare=lambda ts, wl: host_interleaved(ts, wl, device))
    check(res["by_table"] == LOOKUP_LAUNCHES,
          f"lookup launches {res['by_table']}, expected {LOOKUP_LAUNCHES}")
    chain = chain_path(device, **CHAIN_SIZE)
    check(chain["launches"] == CHAIN_LAUNCHES,
          f"chain launches {chain['launches']}, expected {CHAIN_LAUNCHES}")
    gather = measure_gather(device)
    host = {f"{n} x {b} B": slab_host_times(device, n, b)
            for n, b in ((16, 1024), (16, 64 * 1024))}
    k64 = chain_cells(**CHAIN_SIZE)[len(CHAIN_SIZE["ks"]) - 1]
    busy = chain_busy_share(device, k64, CHAIN_SPANS)
    serving = {m["arch"]: serve_model(device, **m, **SERVE_STEPS)
               for m in SERVE_SIZE}
    consistent = [consistency(device, arch=arch,
                              **{**CONSISTENCY_SIZE, **settings})
                  for arch, settings in CONSISTENCY.items()]
    flash_shapes = measure_flash_shapes(device)
    for r in flash_shapes:
        errs[r["route"]] = max(errs[r["route"]], r["max_abs_err"])
    model_times = measure_model_kernels(device, flash_shapes)
    ptxas = ptxas_phase()
    grads, training, recompute, elastic = train_phase()
    for route, rows in grads.items():
        errs[route] = max([errs[route]] + [r["max_abs_err"] for r in rows])
    dkv = dkv_phase(device, **DKV_SIZE)
    check(dkv["launches"] == DKV_LAUNCHES,
          f"dkv launches {dkv['launches']}, expected {DKV_LAUNCHES}")
    gateway_phase(**GATEWAY_SIZE)
    pipeline = pipeline_phase(device, **PIPELINE_SIZE)
    dryrun_phase()
    torch.cuda.synchronize(device)
    # the tiled and scalar routes against the sharded ones, the in-run
    # control, at each batch (the same bytes a lookup); the scalar kernel's
    # calls a shard against the sharded by-value route on the same queries
    measured = res["measured"]
    for name, control in (("race_lookup_tiled_byval",
                           "race_lookup_sharded_byval"),
                          ("race_lookup_tiled", "race_lookup_sharded"),
                          ("race_lookup_scalar", "race_lookup_sharded"),
                          ("race_lookup_scalar_byval", None)):
        ratios = {}
        for size, r in measured[name].items():
            base = r["control_ms"] if control is None \
                else measured[control][size]["ms"]
            r["ratio_to_sharded"] = ratios[size] = r["ms"] / base
        print(f"{name} / {control or 'race_lookup_sharded_byval on the same '
                                    'queries'} by batch: {ratios}")
    top = max(cfg["batches"])
    spans = {name: measured[name][SPAN_BATCH]["lookup_batch_device_spans"]
             for name in ("race_lookup_tiled_byval",
                          "race_lookup_sharded_byval")}
    scalar_spans = {name: measured[name][top][
        "lookup_batch_scalar_device_spans"]
        for name in ("race_lookup_scalar", "race_lookup_scalar_byval")}
    print(f"device spans of one lookup_batch of {SPAN_BATCH} keys by route: "
          f"{spans}; of one impl='scalar' lookup_batch of {top} keys: "
          f"{scalar_spans}")
    for name, n in spans.items():
        check(n == 1, f"a lookup_batch of {SPAN_BATCH} keys on {name} showed "
              f"{n} device spans, expected 1 (the kernel): "
              f"{measured[name][SPAN_BATCH]}")
    n = scalar_spans["race_lookup_scalar_byval"]
    check(n == SCALAR_SPANS,
          f"a sharded impl='scalar' lookup_batch of {top} keys showed {n} "
          f"device spans, expected {SCALAR_SPANS} (a kernel a shard): "
          f"{measured['race_lookup_scalar_byval'][top]}")
    # launches of every main-path run, each counted from zero just before
    # it and read just after: lookups, chain hops, the serving prefills,
    # the float32 consistency prefills and the dkv mirror's lookups
    launches = collections.Counter(res["launches"])
    launches.update(chain["launches"])
    launches.update(dkv["launches"])
    for row in serving.values():
        launches.update(row["prefill_launches"])
    for row in consistent:
        launches.update(row["launches"])
    for row in training.values():
        launches.update(row["launches"])
    launches.update(elastic["launches"])
    launches.update(pipeline["launches"])
    qwen2, rwkv6 = serving["qwen2_0_5b"], serving["rwkv6_7b"]
    by_arch = {row["arch"]: row for row in consistent}
    kernels = []
    model_runs = {"flash_attention_mma": dict(
                      serve=qwen2, train=_train_summary(
                          training["qwen2_0_5b"], recompute["qwen2_0_5b"]),
                      grad=grads["flash_attention_mma"],
                      elastic=_elastic_summary(elastic),
                      pipeline={k: v for k, v in pipeline.items()
                                if k != "card"}),
                  "flash_attention": dict(consistency=by_arch["qwen2_0_5b"],
                                          grad=grads["flash_attention"]),
                  "wkv_split": dict(serve=rwkv6,
                                    consistency=by_arch["rwkv6_7b"],
                                    train=_train_summary(
                                        training["rwkv6_7b"],
                                        recompute["rwkv6_7b"]),
                                    grad=grads["wkv_split"]),
                  "wkv": dict(main_path=False)}
    # the moe, MLA, hybrid and encoder-decoder runs of each flash route,
    # and its times at their prefill shapes with the prefill's launches
    for name in ("flash_attention_mma", "flash_attention"):
        model_runs[name].update(
            serve_models={a: _run_summary(r) for a, r in serving.items()
                          if name in r["prefill_launches"]
                          and a != "qwen2_0_5b"},
            consistency_models={a: r for a, r in by_arch.items()
                                if name in r["launches"]
                                and a != "qwen2_0_5b"},
            by_shape=[_by_shape_row(r, name, serving)
                      for r in flash_shapes if r["route"] == name])
    #: the batch or shape each lookup and gather entry point is reported at
    headline = {"race_lookup_tiled_byval": 512, "race_lookup_tiled": 4096,
                "race_lookup_scalar_byval": 4096, "race_lookup_scalar": 4096,
                "race_lookup_sharded_byval": 512, "race_lookup_sharded": 4096,
                "chunk_gather_byval": GATHER_SHAPES[0][0],
                "chunk_gather": GATHER_SHAPES[2][0]}
    for name in ENTRY_POINTS:
        n = launches.get(name, 0)
        check(n > 0 or name in OFF_MAIN_PATH,
              f"{name} was not launched on the main path")
        bound_by = "bytes"
        if name in model_times:
            r = model_times[name]
            bound_by = r["bound_by"]
            extra = dict(library_ms=r["library_ms"], library=r["library"],
                         shape=r["shape"], bytes=r["bytes"],
                         flops=r["flops"], **{
                             key: r[key] for key in (
                                 "ms_turns", "library_ms_turns",
                                 "contiguous_ms", "ms_by_batch")
                             if key in r},
                         **model_runs[name])
        elif name in gather:
            shape = headline[name]
            r = gather[name][shape]
            extra = dict(library_ms=r["library_ms"],
                         library="torch.index_select (no mask)",
                         shape=shape, by_shape=gather[name])
            if name == "chunk_gather_byval":
                extra.update(slab_host=host, profile=busy, epoch_wall_ms={
                    c: [w * 1e3 for w in row["walls_s"]]
                    for c, row in chain["cells"].items()})
            else:
                extra["main_path"] = False
        else:
            batch = headline[name]
            r = measured[name][batch]
            extra = dict(library_ms=None, batch=batch,
                         by_batch={str(s): v for s, v in
                                   measured[name].items()},
                         lookup_batch_host_in_turns_ms={
                             str(s): v for s, v in res["compared"].items()})
            if name in dkv["launches"]:
                extra.update(dkv_launches=dkv["launches"][name],
                             dkv_lookup_batch_host_ms=dkv["host_ms"])
        if name in ptxas:
            extra["ptxas"] = ptxas[name]
        kernels.append(dict(
            name=name, route="cuda", source=SOURCES[name],
            replaces=REPLACES[name], launches=n, max_abs_err=errs[name],
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=bound_by, **extra))
    print(f"chip_smoke wall time {time.perf_counter() - started:.3f} s "
          f"(from the device report, the build included)")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
