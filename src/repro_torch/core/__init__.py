"""LTRF core: copies of ``repro.core``'s compiler passes (IR, interval
formation, liveness, the Interval Conflict Graph, balanced coloring,
renumbering, prefetch ops, the staged pipeline and its compile cache) and of
the layer-stream plan that orders the matmul kernel's weight-tile stream.
Exports what ``repro.core`` exports, plus the plan."""
from .ir import Instr, BasicBlock, Program, parse_asm
from .intervals import Interval, IntervalAnalysis, form_register_intervals
from .liveness import annotate_dead_operands, block_liveness, build_live_ranges
from .icg import ICG, build_icg
from .coloring import Coloring, chaitin_color
from .renumber import RenumberResult, bank_of, renumber_registers
from .prefetch import PrefetchOp, conflict_distribution, prefetch_schedule
from .plan import IntervalPlan, plan_for_matmul, plan_layer_stream

__all__ = [
    "Instr", "BasicBlock", "Program", "parse_asm",
    "Interval", "IntervalAnalysis", "form_register_intervals",
    "annotate_dead_operands", "block_liveness", "build_live_ranges",
    "ICG", "build_icg", "Coloring", "chaitin_color",
    "RenumberResult", "bank_of", "renumber_registers",
    "PrefetchOp", "conflict_distribution", "prefetch_schedule",
    "IntervalPlan", "plan_for_matmul", "plan_layer_stream",
]
