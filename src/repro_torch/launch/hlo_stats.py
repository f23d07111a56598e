"""Side-effect-free helpers shared by the dry-run and the tests (port of
``repro.launch.hlo_stats``).

``_SHAPE_RE``, ``_BYTES``, ``_COLL_OPS``, ``_shape_bytes`` and
``collective_stats`` are copies of the reference's HLO-text parsers (pure
text; ``tests/test_torch_dryrun.py`` holds them to the original).  The rest
stands in for XLA's analyses over a step run on fake DTensors:

- ``CommTracker``: torch's ``CommDebugMode`` that also sums each
  collective's output bytes (the local tensors one rank receives);
  ``comm_stats`` reads it in ``collective_stats``'s schema, and
  ``comm_sources`` by what was moved (a weight, or an activation) and the
  line of the port's code that moved it.
- ``WorkTracker``: a dispatch mode below DTensor that counts the FLOPs of
  the ops each rank runs on its local shards (torch's ``FlopCounterMode``
  counts a DTensor op at its global shapes) and the bytes of the local
  tensors alive, with their peak.
- ``_eval_shape_with_axes``, ``_mem_analysis`` and ``_cost_analysis``: the
  reference's names over meta tensors and the trackers.
"""
from __future__ import annotations

import os
import re
import sys
import weakref
from collections import defaultdict

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.debug import CommDebugMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

_SHAPE_RE = re.compile(
    r"(f64|f32|f16|bf16|f8e4m3fn|f8e5m2|s64|s32|s16|s8|u64|u32|u16|u8|pred)\[([\d,]*)\]")
_BYTES = {"f64": 8, "f32": 4, "f16": 2, "bf16": 2, "f8e4m3fn": 1, "f8e5m2": 1,
          "s64": 8, "s32": 4, "s16": 2, "s8": 1, "u64": 8, "u32": 4,
          "u16": 2, "u8": 1, "pred": 1}
_COLL_OPS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
             "collective-permute")


def _shape_bytes(sig: str) -> int:
    total = 0
    for dt, dims in _SHAPE_RE.findall(sig):
        n = 1
        if dims:
            for d in dims.split(","):
                if d:
                    n *= int(d)
        total += n * _BYTES[dt]
    return total


def collective_stats(hlo_text: str) -> dict:
    """Sum output-shape bytes of every collective op in post-SPMD HLO."""
    stats = {op: {"count": 0, "bytes": 0} for op in _COLL_OPS}
    pat = re.compile(r"=\s+((?:\([^)]*\))|(?:\S+))\s+(all-gather|all-reduce|"
                     r"reduce-scatter|all-to-all|collective-permute)")
    for line in hlo_text.splitlines():
        m = pat.search(line)
        if not m:
            continue
        sig, op = m.group(1), m.group(2)
        stats[op]["count"] += 1
        stats[op]["bytes"] += _shape_bytes(sig)
    stats["total_bytes"] = sum(v["bytes"] for v in stats.values()
                               if isinstance(v, dict))
    stats["total_count"] = sum(v["count"] for v in stats.values()
                               if isinstance(v, dict))
    return stats


# torch's collectives (functional, native functional and c10d) by the HLO
# collective they are; anything else (broadcast, scatter, ...) is "other"
_TORCH_COLLECTIVES = {
    "all-gather": ("all_gather_into_tensor", "all_gather_into_tensor_coalesced",
                   "allgather_", "_allgather_base_", "allgather_coalesced_",
                   "allgather_into_tensor_coalesced_"),
    "all-reduce": ("all_reduce", "all_reduce_coalesced", "allreduce_", "allreduce_coalesced_"),
    "reduce-scatter": ("reduce_scatter_tensor", "reduce_scatter_tensor_coalesced",
                       "reduce_scatter_", "_reduce_scatter_base_",
                       "reduce_scatter_tensor_coalesced_"),
    "all-to-all": ("all_to_all_single", "alltoall_", "alltoall_base_"),
    "collective-permute": ("send", "recv_"),
}
_KIND = {name: kind for kind, names in _TORCH_COLLECTIVES.items() for name in names}


def _nbytes(out) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(out)
               if isinstance(t, torch.Tensor))


class CommTracker(CommDebugMode):
    """``CommDebugMode`` that also sums the bytes of each collective's
    outputs, by torch op name (``comm_bytes``), and by what it moved and
    where (``source_bytes``, ``source_counts``).

    What it moved: a weight where its inputs are local tensors given to
    ``weights`` or what collectives made of them alone (a weight gathered
    over one mesh dimension, then another), else an activation (gradients
    included).
    Where: the innermost frame of the port's model code
    (``repro_torch/models/``) that led to the collective, else the innermost
    of the port's other code (a backward runs from ``torch.autograd.grad``'s
    caller)."""

    def __init__(self):
        super().__init__()
        self.comm_bytes: dict[str, int] = defaultdict(int)
        self.source_bytes: dict[tuple, int] = defaultdict(int)
        self.source_counts: dict[tuple, int] = defaultdict(int)
        self._weights: set[int] = set()

    def weights(self, tensors) -> None:
        """Count ``tensors`` (DTensors by their local tensors) as weights."""
        for t in tensors:
            if isinstance(t, DTensor):
                t = t.to_local()
            if isinstance(t, torch.Tensor):
                self._mark(t)

    def _mark(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        if id(st) not in self._weights:
            self._weights.add(id(st))
            weakref.finalize(st, self._weights.discard, id(st))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = super().__torch_dispatch__(func, types, args, kwargs)
        if out is NotImplemented or isinstance(func, torch._ops.HigherOrderOperator):
            return out
        name = func._overloadpacket.__name__
        collective = name in _KIND or any(p.__name__ == name for p in self.get_comm_counts())
        if collective or func.namespace == "_c10d_functional":     # and its wrappers
            ins = [t for t in tree_leaves((args, kwargs)) if isinstance(t, torch.Tensor)]
            of_weights = bool(ins) and all(id(t.untyped_storage()) in self._weights
                                           for t in ins)
            if of_weights:
                self.weights(tree_leaves(out))
        if collective:
            nbytes = _nbytes(out)
            self.comm_bytes[name] += nbytes
            key = (_KIND.get(name, "other"), "weight" if of_weights else "activation",
                   _source())
            self.source_bytes[key] += nbytes
            self.source_counts[key] += 1
        return out


_PORT = f"{os.sep}repro_torch{os.sep}"
_MODELS = f"{_PORT}models{os.sep}"


def _source() -> str:
    """The innermost caller in the port's model code, else in the port
    outside this module, as "path:line function"."""
    inner = None
    f = sys._getframe(2)
    while f is not None:
        path = f.f_code.co_filename
        if _PORT in path and path != __file__:
            where = (f"{path.rsplit(_PORT, 1)[1].replace(os.sep, '/')}:{f.f_lineno} "
                     f"{f.f_code.co_name}")
            if _MODELS in path:
                return where
            inner = inner or where
        f = f.f_back
    return inner or "outside the port"


def comm_stats(mode: CommTracker) -> dict:
    """``collective_stats``'s dict from a ``CommTracker``: counts and output
    bytes per HLO collective kind, plus "other"."""
    stats = {op: {"count": 0, "bytes": 0} for op in (*_COLL_OPS, "other")}
    for packet, n in mode.get_comm_counts().items():
        name = packet.__name__
        kind = _KIND.get(name, "other")
        stats[kind]["count"] += n
        stats[kind]["bytes"] += mode.comm_bytes.get(name, 0)
    stats["total_bytes"] = sum(v["bytes"] for v in stats.values() if isinstance(v, dict))
    stats["total_count"] = sum(v["count"] for v in stats.values() if isinstance(v, dict))
    return stats


def comm_sources(mode: CommTracker) -> dict:
    """``"<kind> <weight|activation> <path:line function>"`` -> count and
    output bytes, for each collective kind, what it moved and where."""
    return {" ".join(k): {"count": mode.source_counts[k], "bytes": b}
            for k, b in sorted(mode.source_bytes.items())}


class WorkTracker(TorchDispatchMode):
    """Counts what one rank does on its local tensors: FLOPs by torch's
    ``flop_registry`` (the formulas ``FlopCounterMode`` uses) and the bytes
    of live local storages, with their peak.

    It lets DTensor ops through (``NotImplemented``) and sees the local ops
    DTensor runs for them.  DTensor's sharding propagation runs each new op
    once more on fake tensors of the global shapes; the local tensors here
    are real or meta, never fake, so an op that reads or makes a fake tensor
    is propagation's and is not counted."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.live = 0
        self.peak = 0
        self._seen: dict[int, int] = {}

    def track(self, tensors) -> None:
        """Count ``tensors``' storages as live (each storage once)."""
        for t in tensors:
            if isinstance(t, DTensor):
                t = t.to_local()
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            key = id(st)
            if key in self._seen:
                continue
            self._seen[key] = st.nbytes()
            self.live += self._seen[key]
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self.live -= self._seen.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not any(isinstance(t, FakeTensor) for t in tree_leaves((args, kwargs, out))):
            packet = getattr(func, "_overloadpacket", None)
            if packet in flop_registry:
                self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
            self.track(tree_leaves(out))
        return out


def _eval_shape_with_axes(fn, *args):
    """The ``(tree, axes)`` a ``fn`` returns, run with the meta device as
    the default: nothing is allocated."""
    with torch.device("meta"):
        tree, axes = fn(*args)
    return tree, axes


def _mem_analysis(args_bytes: int, tracker: WorkTracker) -> dict:
    """Per-device bytes in the reference's keys: the step's arguments (its
    local shards) and the peak of live local tensors over the step."""
    return {"argument_size_in_bytes": int(args_bytes),
            "temp_size_in_bytes": int(max(tracker.peak - args_bytes, 0)),
            "peak_bytes": int(tracker.peak),
            "total_hbm_bytes": int(max(tracker.peak, args_bytes))}


def _cost_analysis(tracker: WorkTracker) -> dict:
    """Per-rank FLOPs of the local work (the reference's ``flops`` key)."""
    return {"flops": float(tracker.flops)}
