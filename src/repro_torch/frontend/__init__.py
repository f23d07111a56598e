"""Real-kernel frontend: lift PyTorch computations into the register IR.

The port's counterpart of `repro.frontend`:

* `fx_lift` — walk a ``make_fx`` aten graph (`torch.fx`) and lower it to the
  asm IR (loops/diamonds for control flow, ld/st for operand traffic, tiled
  inner loops for products/reductions) over unlimited virtual registers.
* `regalloc` — a copy of the reference's linear-scan virtual ->
  architectural assignment under a configurable ``maxregcount``, with
  shared-memory spill fallback; produces the ``regs_per_thread`` metadata
  the occupancy model needs.
* `workloads` — the traced-workload specs (the port's kernel references +
  model layer slices) exposed to the suite registry as the ``traced`` suite.

Attribute access is lazy so importing `repro_torch.frontend` (e.g. for
`TRACED_NAMES`) loads no tracer.
"""
from __future__ import annotations

__all__ = [
    "lift_fn", "lift_graph", "LiftedProgram", "LIFT_REV",
    "allocate_registers", "AllocResult",
    "build_traced_workload", "traced_suite", "TRACED_NAMES", "TRACED_SPECS",
]

_HOMES = {
    "lift_fn": "fx_lift", "lift_graph": "fx_lift",
    "LiftedProgram": "fx_lift", "LIFT_REV": "fx_lift",
    "allocate_registers": "regalloc", "AllocResult": "regalloc",
    "build_traced_workload": "workloads", "traced_suite": "workloads",
    "TRACED_NAMES": "workloads", "TRACED_SPECS": "workloads",
}


def __getattr__(name: str):
    home = _HOMES.get(name)
    if home is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(f".{home}", __name__), name)
