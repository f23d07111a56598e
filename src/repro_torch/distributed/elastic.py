"""Elastic scaling: rebuild the mesh from surviving ranks and reshard (port
of ``repro.distributed.elastic``).

On a real fleet, losing a slice means restarting the job on fewer hosts; the
recovery path is what ``reshard_state`` implements: load the last
checkpoint (host arrays) and place it with shardings derived from the *new*
mesh.  Every sharding here is derived from logical rules and concrete shapes
(``shardings_for``), so nothing else changes: the same step builder runs on
the new topology.
"""
from __future__ import annotations

import numpy as np
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from .sharding import default_rules, place, shardings_for


def degraded_mesh(ranks=None, model: int | None = None) -> DeviceMesh:
    """Largest (data, model) mesh over the given ranks of the default group
    (default: all)."""
    ranks = list(ranks if ranks is not None else range(dist.get_world_size()))
    n = len(ranks)
    if model is None:
        model = 1
        for m in (16, 8, 4, 2):
            if n % m == 0 and m <= n:
                model = m
                break
    data = n // model
    arr = np.array(ranks[: data * model]).reshape(data, model)
    device = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device, arr, mesh_dim_names=("data", "model"))


def reshard_state(state, axes_tree, new_mesh: DeviceMesh, sequence_parallel: bool = False,
                  shapes_tree=None):
    """Re-place a host-loaded (numpy) or tensor state onto a new mesh.
    Returns (placed state, rules).  ``shapes_tree`` (default: the state's
    own shapes) is what the shardings are computed from: pass
    ``runtime.train_step.train_state_shapes(cfg)``, so a head held wider
    than its vocabulary is sharded as its true width is."""
    rules = default_rules(new_mesh, sequence_parallel=sequence_parallel)
    sh = shardings_for(rules, axes_tree, state if shapes_tree is None else shapes_tree)
    return place(state, sh), rules
