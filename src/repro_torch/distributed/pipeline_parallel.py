"""GPipe-style pipeline parallelism over a mesh dimension (port of
``repro.distributed.pipeline_parallel``).

For depth-dominated models, layers are split into ``n_stages`` contiguous
stages placed along a mesh dimension; microbatches flow through the classic
GPipe schedule: with M microbatches and P stages the pipeline runs M + P - 1
ticks, each stage computing its resident microbatch and then passing its
activation to the next stage.  The reference's ``ppermute`` is a
``batch_isend_irecv`` on the stage dimension's group and its final ``psum``
an ``all_reduce``; every rank returns the outputs.

``sequential_reference`` runs every stage in order on each microbatch: the
oracle the schedule must equal.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor

from ..tree import tree_leaves, tree_map


def _stage_slice(a, idx: int):
    """This stage's slice of a stacked leaf: a DTensor sharded on the stage
    dimension holds it already; a full tensor is cut."""
    return a.to_local()[0] if isinstance(a, DTensor) else a[idx]


def _shift(y: torch.Tensor, idx: int, n_stages: int, group) -> torch.Tensor:
    """Stage idx's activation to stage idx + 1 (the reference's ``ppermute``
    with pairs (i, i+1)); stage 0 receives zeros."""
    buf = torch.zeros_like(y)
    ops = []
    if idx < n_stages - 1:
        ops.append(dist.P2POp(dist.isend, y.contiguous(),
                              dist.get_global_rank(group, idx + 1), group))
    if idx > 0:
        ops.append(dist.P2POp(dist.irecv, buf, dist.get_global_rank(group, idx - 1), group))
    for req in dist.batch_isend_irecv(ops) if ops else ():
        req.wait()
    return buf


def pipeline_forward(stage_fn, params_stacked, x_micro, mesh: DeviceMesh,
                     stage_axis: str = "stage"):
    """Run microbatches through pipeline stages laid out on ``stage_axis``.

    stage_fn(stage_params, x) -> x            (one stage's computation)
    params_stacked: tree with leading axis n_stages (full tensors, or
                    DTensors sharded on it over ``stage_axis``); each rank
                    keeps its own stage's slice
    x_micro: (n_micro, mb, ...) microbatched inputs (the same on every rank)

    Returns (n_micro, mb, ...) outputs after all stages, on every rank.
    """
    n_stages = mesh.size(mesh.mesh_dim_names.index(stage_axis))
    idx = mesh.get_local_rank(stage_axis)
    group = mesh.get_group(stage_axis)
    params = tree_map(lambda a: _stage_slice(a, idx), params_stacked)
    n_micro = x_micro.shape[0]
    ticks = n_micro + n_stages - 1
    buf = torch.zeros(x_micro.shape[1:], dtype=x_micro.dtype, device=x_micro.device)
    outs = torch.zeros_like(x_micro)
    for t in range(ticks):
        # stage 0 injects microbatch t (if any remain)
        incoming = x_micro[t].to(buf.dtype) if idx == 0 and t < n_micro else buf
        y = stage_fn(params, incoming)
        # active iff this stage holds a real microbatch at tick t
        active = 0 <= t - idx < n_micro
        if not active:
            y = torch.zeros_like(y)
        # the last stage banks its finished microbatch
        if idx == n_stages - 1 and active:
            outs[min(max(t - (n_stages - 1), 0), n_micro - 1)] = y
        buf = _shift(y, idx, n_stages, group)
    # only the last stage holds real outputs; all-reduce them to every stage
    if idx != n_stages - 1:
        outs.zero_()
    dist.all_reduce(outs, group=group)
    return outs


def sequential_reference(stage_fn, params_stacked, x_micro):
    """Oracle: run every stage in order on each microbatch."""
    n_stages = tree_leaves(params_stacked)[0].shape[0]
    outs = []
    for x in x_micro:
        for s in range(n_stages):
            x = stage_fn(tree_map(lambda a, s=s: a[s], params_stacked), x)
        outs.append(x)
    return torch.stack(outs)
