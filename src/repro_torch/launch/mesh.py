"""Device meshes (port of ``repro.launch.mesh``).

Functions, not module-level constants, so importing this module starts no
process group.

- ``make_host_mesh``: a (data, model) mesh over the process's default group;
  where none exists yet, a one-rank group is started on an in-process store
  (``nccl`` for the card, ``gloo`` for the CPU).
- ``make_production_mesh``: single pod (data=16, model=16) = 256 ranks, or
  multi-pod (pod=2, data=16, model=16) = 512, over a *fake* process group
  (its collectives move nothing): for the dry-run only, the counterpart of
  the JAX dry-run's 512 forced host devices.  The leading 'pod' dimension
  carries only data parallelism.
"""
from __future__ import annotations

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from .. import resolve_device

BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def make_host_mesh(model: int = 1, device="cuda") -> DeviceMesh:
    """Mesh over the default group's ranks, (world // model, model)."""
    dev = resolve_device(device)
    if not dist.is_initialized():
        dist.init_process_group(BACKENDS[dev.type], store=dist.HashStore(), rank=0,
                                world_size=1)
    n = dist.get_world_size()
    return init_device_mesh(dev.type, (n // model, model), mesh_dim_names=("data", "model"))


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = 1
    for s in shape:
        n *= s
    if dist.is_initialized():
        if dist.get_backend() != "fake" or dist.get_world_size() != n:
            raise RuntimeError(
                f"a {dist.get_backend()} process group of {dist.get_world_size()} ranks is "
                f"up; the production mesh needs a fake group of {n}")
    else:
        from torch.testing._internal.distributed.fake_pg import FakeStore
        dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    return init_device_mesh("cpu", shape, mesh_dim_names=axes)
