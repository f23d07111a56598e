"""Observability for the port's simulator: copies of ``repro.obs``'s cycle
attribution (``SimResult.cycle_breakdown``) and per-warp event tracer.  The
sweep metrics registry (``repro.obs.metrics``) comes with the sweep service.

This package never imports ``repro_torch.sim`` at module level — the
simulator imports *us*, and `trace_simulation` closes the loop lazily.
"""
from .attribution import (
    CYCLE_CATEGORIES, STALL_CATEGORIES, CycleAttributionError,
    breakdown_fractions, check_breakdown, classify_stall, merge_breakdowns,
    new_breakdown,
)
from .trace import SCHED_TID, TraceSink, trace_simulation

__all__ = [
    "CYCLE_CATEGORIES", "STALL_CATEGORIES", "CycleAttributionError",
    "breakdown_fractions", "check_breakdown", "classify_stall",
    "merge_breakdowns", "new_breakdown",
    "SCHED_TID", "TraceSink", "trace_simulation",
]
