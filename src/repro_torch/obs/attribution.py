"""Cycle-attribution accounting: where did every simulated cycle go?

The paper's headline claim — LTRF overlaps MRF prefetch latency with other
warps' execution — is a statement about *cycle attribution*: the design
converts cycles the baseline loses to register-file and memory latency into
issue cycles.  This module defines the accounting both simulator engines
(`repro.sim.engine` and the frozen golden oracle `repro.sim.golden`) apply
identically: every simulated SM cycle lands in **exactly one** category of
`CYCLE_CATEGORIES`, the per-category totals are carried on
``SimResult.cycle_breakdown``, and `check_breakdown` enforces the hard
invariant ``sum(cycle_breakdown.values()) == SimResult.cycles`` at the end
of every run (fuzz-pinned engine-vs-golden in ``tests/test_sim_fuzz.py``).

Category definitions (documented for humans in docs/observability.md; the
doc-consistency suite asserts every name below appears there):

``issue``
    at least one instruction issued this cycle.
``drain``
    no issue, the admission queue is empty, and retirement has left fewer
    live warps than one scheduler's worth (``active_slots``): the
    unavoidable kernel tail, not a latency-tolerance failure.
``bank_conflict``
    no issue; a warp with ready operands could not issue for a structural
    register-file reason — operand collectors busy, or MRF bank bandwidth
    exhausted (the per-cycle bank-port token model).  Under
    ``bank_model="arbitrated"`` the *extra serialization rounds* are
    additionally charged into operand latency and counted by
    ``SimResult.bank_conflicts``; this category is the cycles where RF
    structure alone blocked an otherwise-ready issue.
``prefetch_stall``
    no issue; at least one active-slot warp is blocked on an in-flight
    register-interval prefetch (the LTRF cost the scheduler tries to hide).
``mem_stall``
    no issue, nothing prefetching; a schedulable warp is waiting on a
    memory-produced operand (L1/DRAM latency exposed).
``alu_dep``
    no issue; schedulable warps are waiting only on ALU / writeback
    dependencies (register read-after-write chains).
``scheduler_idle``
    everything else: the scheduler has no schedulable warp at all — under
    the two-level policy this is the "all active warps swapped out on
    memory" state, the classic latency-tolerance failure mode.

The stall categories are resolved by `classify_stall` with the fixed
precedence drain > bank_conflict > prefetch_stall > mem_stall > alu_dep >
scheduler_idle, so attribution is deterministic even when several causes
coincide in one cycle.

Copy of ``repro.obs.attribution`` for the PyTorch port: the same text, with its
imports of ``repro`` read as ``repro_torch``.
"""
from __future__ import annotations

# Order is presentation order (stacked figures, docs tables); membership is
# the accounting contract.
CYCLE_CATEGORIES = (
    "issue",
    "alu_dep",
    "mem_stall",
    "prefetch_stall",
    "bank_conflict",
    "scheduler_idle",
    "drain",
)

# Everything that is not "issue": the stall side of the ledger.
STALL_CATEGORIES = tuple(c for c in CYCLE_CATEGORIES if c != "issue")


def new_breakdown() -> dict[str, int]:
    """A zero-filled breakdown (every category present, fixed order)."""
    return {c: 0 for c in CYCLE_CATEGORIES}


def classify_stall(drain: bool, struct_stall: bool, saw_prefetch: bool,
                   saw_mem: bool, saw_dep: bool) -> str:
    """Resolve one zero-issue cycle to its category.

    Both engines derive the five booleans from identical observable state
    (admission queue / resident count, the issue loop's structural-stall
    flag, and active-warp status + operand readiness) and call this one
    function, so attribution cannot diverge between them.
    """
    if drain:
        return "drain"
    if struct_stall:
        return "bank_conflict"
    if saw_prefetch:
        return "prefetch_stall"
    if saw_mem:
        return "mem_stall"
    if saw_dep:
        return "alu_dep"
    return "scheduler_idle"


class CycleAttributionError(AssertionError):
    """The accounting invariant broke: breakdown does not sum to cycles."""


def check_breakdown(breakdown: dict[str, int], cycles: int,
                    design: str, workload: str) -> None:
    """Hard invariant: every cycle attributed to exactly one known category.

    Raised (never warned) — a run whose cycles cannot be accounted for is a
    bug in the engine, not a reporting blemish.
    """
    if set(breakdown) != set(CYCLE_CATEGORIES):
        raise CycleAttributionError(
            f"{workload}/{design}: breakdown categories "
            f"{sorted(breakdown)} != {sorted(CYCLE_CATEGORIES)}")
    total = sum(breakdown.values())
    if total != cycles:
        raise CycleAttributionError(
            f"{workload}/{design}: cycle_breakdown sums to {total}, "
            f"but the run took {cycles} cycles "
            f"(unattributed: {cycles - total})")


def breakdown_fractions(breakdown: dict[str, int]) -> dict[str, float]:
    """The breakdown normalized to fractions of total cycles (0.0 on an
    empty run); categories keep `CYCLE_CATEGORIES` order."""
    total = sum(breakdown.values())
    if not total:
        return {c: 0.0 for c in CYCLE_CATEGORIES}
    return {c: breakdown.get(c, 0) / total for c in CYCLE_CATEGORIES}


def merge_breakdowns(breakdowns) -> dict[str, int]:
    """Sum per-category totals (e.g. per-SM results into a GPU total)."""
    out = new_breakdown()
    for bd in breakdowns:
        for c, v in bd.items():
            out[c] = out.get(c, 0) + v
    return out
