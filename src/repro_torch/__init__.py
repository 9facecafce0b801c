"""PyTorch/CUDA port of ``repro`` for NVIDIA Hopper (H100, ``sm_90a``).

The JAX package ``repro`` stays the reference. This package imports
nothing of it (nor ``jax``): what it needs of numpy-only modules it keeps
as its own copies, under the same module names, so each counterpart is
easy to find. Ported so far (see ``README.md`` beside this file):

  core/                      the simulated RDMA fabric and the KRCore
                             control plane (numpy, as in the reference)
  kernels/race_lookup/       the three RACE-hash lookup kernels in CUDA
                             C++, their plain PyTorch versions and ops
  kernels/serverless_stage/  the chunk-gather kernel in CUDA C++ that
                             packs and unpacks chain-hop slabs
  kvs/race.py                ``DeviceRaceTable`` /
                             ``ShardedDeviceRaceTable`` with
                             device-resident bucket tables
  serverless/                the chain hop: ``ChainRunner`` over the
                             port's core, with its slabs on the card
  configs/, models/          every model family: ``forward_full``,
                             ``prefill``, ``decode_step``, the
                             differentiable ``train_loss``,
                             ``init_params`` and the JAX weight bridge
  kernels/flash_attention/   blockwise GQA attention in CUDA C++ (prefill)
  kernels/rwkv6/             the chunked RWKV-6 WKV scan in CUDA C++
  elastic/, launch/          ``ExecutablePool``, ``ElasticTrainer``,
                             straggler mitigation, the meshes, the train,
                             prefill and decode steps and their input
                             specs, ``ServingWorker``, the training loop
  optim/, data/, checkpoint/ AdamW, the synthetic data feed, checkpoints
                             in the reference's format
  distributed/               the sharding plans and their placements,
                             int8 gradient compression and its all-reduce
"""

from .device import resolve_device

__all__ = ["resolve_device"]
