"""Mesh construction (the counterpart of ``repro/launch/mesh.py``).

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over ranks of the
default process group. Single pod: 16 x 16 = 256 ranks ("data", "model").
Multi-pod: 2 x 16 x 16 = 512 ranks ("pod", "data", "model"); "pod" spans
the slow links between pods, "data" and "model" lie inside one.

Functions, not module constants, so that importing this module touches no
process group. Each function below starts the default group only when
none exists: ``make_production_mesh`` on the ``"fake"`` backend, one
process standing for every rank (a plan, whose collectives compute
nothing: what the reference's 512 host devices are to its dry run),
``make_host_mesh`` as a group of this one process. Either group stays the
default until ``torch.distributed.destroy_process_group()``.
"""

from __future__ import annotations

import contextlib
import contextvars
import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..device import resolve_device

_CURRENT = contextvars.ContextVar("repro_torch_current_mesh", default=None)


@contextlib.contextmanager
def set_mesh(mesh: DeviceMesh):
    """Make ``mesh`` the current mesh inside the ``with`` block.

    ``jax.set_mesh`` sets JAX's ambient mesh, which ``jit`` lowers every
    sharding against. Torch has no ambient mesh: this context stands in for
    it: code reads it through :func:`current_mesh` (``make_train_step``
    made inside the block without a ``mesh`` takes this one and averages
    its gradients over the mesh's "data" group). ``ElasticTrainer`` builds
    each step under the step's mesh."""
    token = _CURRENT.set(mesh)
    try:
        yield mesh
    finally:
        _CURRENT.reset(token)


def current_mesh():
    """The mesh of the innermost :func:`set_mesh` block, or None."""
    return _CURRENT.get()


def _device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    """16 x 16 ("data", "model"), or 2 x 16 x 16 ("pod", "data", "model")
    with ``multi_pod``. Without a process group it starts the fake backend
    of 256 or 512 ranks (this process is rank 0); a group of another size
    raises ``ValueError``."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    world = math.prod(shape)
    if not dist.is_initialized():
        # importing it registers the "fake" backend with c10d
        from torch.testing._internal.distributed.fake_pg import FakeStore
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=world)
    elif dist.get_world_size() != world:
        raise ValueError(f"a {shape} mesh needs {world} ranks, the process "
                         f"group has {dist.get_world_size()}")
    return DeviceMesh(_device_type(), torch.arange(world).reshape(shape),
                      mesh_dim_names=axes)


def ensure_process_group(device=None) -> None:
    """Without a default process group, start one of this process alone on
    ``device`` (default: the CUDA card; NCCL there, gloo on the CPU), over
    an in-memory store; with one, do nothing."""
    if not dist.is_initialized():
        dev = resolve_device(device)
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0, world_size=1)


def make_host_mesh(model: int = 1, device=None) -> DeviceMesh:
    """A ("data", "model") mesh over every rank of the default group, with
    ``model`` ranks on "model" (``ensure_process_group(device)`` first)."""
    ensure_process_group(device)
    n = dist.get_world_size()
    if model < 1 or n % model:
        raise ValueError(f"{n} ranks do not split into model = {model}")
    return DeviceMesh(_device_type(), torch.arange(n).reshape(n // model,
                                                              model),
                      mesh_dim_names=("data", "model"))
