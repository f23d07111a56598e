"""LTRF core (copies of ``repro.core``'s IR, interval formation, balanced
coloring and the layer-stream plan) used to plan the matmul kernel's
weight-tile stream."""
from .coloring import Coloring, chaitin_color
from .intervals import Interval, IntervalAnalysis, form_register_intervals
from .ir import BasicBlock, Instr, Program, parse_asm
from .plan import IntervalPlan, plan_for_matmul, plan_layer_stream

__all__ = [
    "Instr", "BasicBlock", "Program", "parse_asm",
    "Interval", "IntervalAnalysis", "form_register_intervals",
    "Coloring", "chaitin_color",
    "IntervalPlan", "plan_for_matmul", "plan_layer_stream",
]
