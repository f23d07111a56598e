"""Logical-axis sharding rules on a ``DeviceMesh`` (port of
``repro.distributed.sharding``).

Model code annotates params and activations with *logical* axis names
('embed', 'heads', 'act_batch', ...).  A :class:`ShardingRules` table maps
those to mesh dimensions; ``constrain`` redistributes a DTensor when a
rule-set is active (a contextvar) and is a no-op otherwise, so the same model
code runs unsharded on plain tensors.

A spec is a tuple with one entry per tensor dimension: ``None``, a mesh
dimension's name, or a tuple of names (one tensor dimension split over
several mesh dimensions, in mesh order).  ``Sharding(mesh, spec)`` turns it
into DTensor placements; ``place`` distributes a tree of tensors with them.

The layouts of ``default_rules`` and the shape-aware logic of
``shardings_for`` (divisibility, each mesh dimension used once, first
tensor dimension wins, the ``act_hd`` <- ``act_kv`` fallback) are the
reference's, held to it by ``tests/test_torch_mesh.py``.

Default 2D layout (+ optional pod axis):
  * batch / act_batch       -> ('pod', 'data')      data parallelism
  * embed                   -> 'data'               FSDP: params + optimizer
                                                    state sharded over DP
  * heads/kv/ffn/vocab/
    experts                 -> 'model'              tensor / expert parallelism
  * act_seq                 -> None ('model' when sequence parallelism is on)
"""
from __future__ import annotations

import contextlib
import contextvars
from dataclasses import dataclass, field
from typing import Any

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

from ..tree import tree_map


@dataclass(frozen=True)
class ShardingRules:
    mesh: DeviceMesh
    table: dict[str | None, Any] = field(default_factory=dict)

    def axis(self, name: str | None):
        return self.table.get(name)


def default_rules(mesh: DeviceMesh, sequence_parallel: bool = False,
                  fsdp: bool = True, layout: str = "2d") -> ShardingRules:
    """Sharding layouts over the fixed production mesh.

    * ``2d`` (default): batch over ('pod','data'), TP over 'model'; fsdp=True
      shards params + optimizer state ('embed') over 'data' (ZeRO-3-style),
      fsdp=False keeps params TP-only/replicated (ZeRO-1 posture).
    * ``fsdp_pure``: no tensor parallelism -- batch AND the FSDP shard span
      ('pod','data','model') jointly (fully-sharded DP).
    * ``ep_dp``: batch over every mesh dimension, experts and vocab over
      'model', attention weights FSDP-sharded over 'data'.
    * ``ep_only``: experts and vocab over 'model', FSDP over 'data', no
      tensor parallelism on the attention and dense paths.
    """
    axes = set(mesh.mesh_dim_names)
    if layout == "fsdp_pure":
        all_axes = tuple(a for a in ("pod", "data", "model") if a in axes)
        table = {
            None: None,
            "batch": all_axes,
            "act_batch": all_axes,
            "embed": all_axes if fsdp else None,
            "heads": None, "kv": None, "ffn": None,
            "vocab": None, "experts": None,
            "layers": None,
            "act_seq": None, "act_embed": None, "act_heads": None,
            "act_kv": None, "act_hd": None, "act_experts": None,
            "act_vocab": None, "act_ffn": None,
        }
        return ShardingRules(mesh=mesh, table=table)
    if layout == "ep_dp":
        all_axes = tuple(a for a in ("pod", "data", "model") if a in axes)
        model = "model" if "model" in axes else None
        data = "data" if "data" in axes else None
        table = {
            None: None,
            "batch": all_axes,
            "act_batch": all_axes,
            "embed": data if fsdp else None,
            "heads": None, "kv": None, "ffn": None,
            "vocab": model, "experts": model,
            "layers": None,
            "act_seq": None, "act_embed": None, "act_heads": None,
            "act_kv": None, "act_hd": None,
            "act_experts": model, "act_vocab": model, "act_ffn": None,
        }
        return ShardingRules(mesh=mesh, table=table)
    if layout == "ep_only":
        batch = tuple(a for a in ("pod", "data") if a in axes) or None
        if isinstance(batch, tuple) and len(batch) == 1:
            batch = batch[0]
        model = "model" if "model" in axes else None
        data = "data" if "data" in axes else None
        table = {
            None: None,
            "batch": batch,
            "act_batch": batch,
            "embed": data if fsdp else None,
            "heads": None, "kv": None, "ffn": None,
            "vocab": model, "experts": model,
            "layers": None,
            "act_seq": None, "act_embed": None, "act_heads": None,
            "act_kv": None, "act_hd": None,
            "act_experts": model, "act_vocab": model, "act_ffn": None,
        }
        return ShardingRules(mesh=mesh, table=table)
    batch = tuple(a for a in ("pod", "data") if a in axes) or None
    if isinstance(batch, tuple) and len(batch) == 1:
        batch = batch[0]
    model = "model" if "model" in axes else None
    data = "data" if "data" in axes else None
    table = {
        None: None,
        "batch": batch,
        "act_batch": batch,
        "embed": data if fsdp else None,
        "heads": model,
        "kv": model,
        "ffn": model,
        "vocab": model,
        "experts": model,
        "layers": None,
        "act_seq": model if sequence_parallel else None,
        "act_embed": None,
        "act_heads": model,
        "act_ffn": model,
        "act_vocab": model,
        "act_kv": model,
        "act_hd": None,
        "act_experts": model,
    }
    return ShardingRules(mesh=mesh, table=table)


_ACTIVE: contextvars.ContextVar[ShardingRules | None] = \
    contextvars.ContextVar("sharding_rules", default=None)


@contextlib.contextmanager
def use_rules(rules: ShardingRules | None):
    tok = _ACTIVE.set(rules)
    try:
        yield rules
    finally:
        _ACTIVE.reset(tok)


def active_rules() -> ShardingRules | None:
    return _ACTIVE.get()


def logical_to_spec(rules: ShardingRules, names: tuple) -> tuple:
    return tuple(rules.axis(n) for n in names)


def _members(ax) -> tuple:
    """The mesh dimensions a spec entry names, in its order."""
    if ax is None:
        return ()
    return tuple(ax) if isinstance(ax, (tuple, list)) else (ax,)


def mesh_shape(mesh: DeviceMesh) -> dict[str, int]:
    """{mesh dimension name: size} (the JAX mesh's ``shape``)."""
    return {name: mesh.size(i) for i, name in enumerate(mesh.mesh_dim_names)}


def _axis_size(mesh: DeviceMesh, ax) -> int:
    n = 1
    for a in _members(ax):
        n *= mesh_shape(mesh)[a]
    return n


@dataclass(frozen=True)
class Sharding:
    """A spec on a mesh (the JAX ``NamedSharding``)."""
    mesh: DeviceMesh
    spec: tuple

    @property
    def placements(self) -> tuple:
        """One placement per mesh dimension: ``Shard(d)`` for the tensor
        dimension d whose spec entry names it, else ``Replicate()``.  A mesh
        dimension of size 1 splits nothing and is ``Replicate()`` (DTensor
        refuses views that drop a size-1 dimension sharded over it)."""
        names = list(self.mesh.mesh_dim_names)
        out: list = [Replicate()] * len(names)
        for d, ax in enumerate(self.spec):
            dims = [names.index(a) for a in _members(ax)]
            if dims != sorted(dims):
                raise ValueError(f"spec entry {ax!r} is not in the mesh's order {names}")
            for i in dims:
                if self.mesh.size(i) > 1:
                    out[i] = Shard(d)
        return tuple(out)

    def shard_shape(self, shape) -> tuple:
        """The local shape of a tensor of global ``shape`` under this
        sharding (every sharded dimension divides evenly)."""
        spec = (*self.spec, *[None] * (len(shape) - len(self.spec)))
        return tuple(n // _axis_size(self.mesh, ax) for n, ax in zip(shape, spec))


def _shape_aware(rules: ShardingRules, names: tuple, dims, fallback: bool = True) -> tuple:
    """The spec of a tensor of shape ``dims`` with logical ``names``: a mesh
    dimension goes to a tensor dimension only when it divides it, and at most
    once (first tensor dimension wins); with ``fallback``, a dropped 'act_kv'
    falls back onto the tensor's 'act_hd' dimension."""
    spec: list = []
    dropped: set[str] = set()
    used: set[str] = set()

    def takes(ax, dim) -> bool:
        return (ax is not None and dim % _axis_size(rules.mesh, ax) == 0
                and not (set(_members(ax)) & used))

    for i, dim in enumerate(dims):
        name = names[i] if i < len(names) else None
        ax = rules.axis(name)
        if takes(ax, dim):
            spec.append(ax)
            used.update(_members(ax))
        else:
            spec.append(None)
            if ax is not None and name is not None:
                dropped.add(name)
    for i, dim in enumerate(dims if fallback else ()):
        name = names[i] if i < len(names) else None
        src = _FALLBACK_TARGETS.get(name or "")
        if src and src in dropped and spec[i] is None and takes(rules.axis(src), dim):
            spec[i] = rules.axis(src)
            used.update(_members(spec[i]))
    return tuple(spec)


def constrain(x, names: tuple):
    """Annotate an intermediate with logical axes (no-op without rules).

    A DTensor is redistributed to the shape-aware spec of
    :func:`shardings_for`'s rules, without its 'act_kv' fallback, as in the
    reference; a plain tensor is already local and is returned as it is."""
    rules = _ACTIVE.get()
    if rules is None or not isinstance(x, DTensor):
        return x
    placements = Sharding(rules.mesh, _shape_aware(rules, names, x.shape, False)).placements
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(x.device_mesh, placements)


def _map_axes(fn, axes_tree, *rest):
    """``fn`` over the logical-axes tuples of ``axes_tree`` (dicts and lists
    are nodes, tuples leaves) and the matching leaves of ``rest``."""
    if isinstance(axes_tree, dict):
        return {k: _map_axes(fn, v, *(r[k] for r in rest)) for k, v in axes_tree.items()}
    if isinstance(axes_tree, list):
        return [_map_axes(fn, v, *(r[i] for r in rest)) for i, v in enumerate(axes_tree)]
    if not isinstance(axes_tree, tuple):
        raise TypeError(f"not a logical-axes tuple: {axes_tree!r}")
    return fn(axes_tree, *rest)


def param_shardings(rules: ShardingRules, axes_tree) -> Any:
    """Map a tree of logical-axis tuples to Shardings."""
    return _map_axes(lambda names: Sharding(rules.mesh, logical_to_spec(rules, names)),
                     axes_tree)


# When a primary dimension can't take its mesh axis (non-divisible), the
# axis may move to a fallback dimension of the same tensor: KV caches with
# few kv-heads shard the head_dim over 'model' instead.
_FALLBACK_TARGETS = {"act_hd": "act_kv"}  # dim name -> dim it substitutes for


def shardings_for(rules: ShardingRules, axes_tree, shapes_tree) -> Any:
    """Shape-aware shardings for step *arguments*: a mesh dimension is
    applied to a tensor dimension only when it divides it evenly.  E.g. kv=4
    heads stay replicated on a model=16 axis; a 50280 vocab stays unsharded
    over 16.  A dropped 'act_kv' axis falls back onto the tensor's 'act_hd'
    dimension.  ``shapes_tree`` holds tensors (meta tensors will do) or
    anything with a ``shape``."""
    def one(names, shp):
        dims = getattr(shp, "shape", None)
        if dims is None:
            return Sharding(rules.mesh, ())
        return Sharding(rules.mesh, _shape_aware(rules, names, tuple(dims)))

    return _map_axes(one, axes_tree, shapes_tree)


def stack_axes(axes_tree, prefix: str | None = "layers"):
    """Prepend a leading (scan/stack) axis to every logical-axes tuple."""
    return _map_axes(lambda names: (prefix, *names), axes_tree)


def place(tree, shardings) -> Any:
    """Distribute each tensor of ``tree`` with the matching Sharding (every
    rank passes the same full tensors, as a restored checkpoint gives them)."""
    def one(t, sh):
        if not isinstance(t, torch.Tensor):
            t = torch.as_tensor(t)
        return distribute_tensor(t.to(sh.mesh.device_type), sh.mesh, list(sh.placements))

    return tree_map(one, tree, shardings)
