"""The staged compiler pass pipeline.

Every compile in the repo — the per-design simulator compile, the frontend
register allocator's liveness query, the figure harness' one-off analyses —
used to chain the passes in `core/` by ad-hoc positional calls, with the
interval-formation algorithm hardwired.  This module makes the pipeline
explicit and extensible:

* :class:`CompileContext` — the single mutable compile state: the program
  (passes may replace it with a split/renumbered copy), the compile knobs,
  named ``artifacts`` each pass reads/writes, and per-pass ``stats``
  (counters + wall time) that travel on the emitted plan;
* :class:`Pass` / :class:`PassManager` — a registered, ordered pass list
  (interval formation -> liveness -> ICG -> coloring/renumber -> prefetch
  planning -> plan emission; liveness follows formation because its
  consumers need liveness over the *split* program) where each pass
  declares when it applies, so one pipeline serves all designs
  (``BL``/``RFC``/``Ideal`` skip straight to emission, only ``LTRF_conf``
  colors, only ``LTRF_plus`` needs block liveness, ...);
* **pluggable interval formation** — `SimConfig.interval_strategy` selects
  a registered strategy instead of the one hardwired algorithm:

  ==============  =========================================================
  strategy        meaning
  ==============  =========================================================
  ``paper``       Algorithms 1+2 of the paper (the default; bit-identical
                  to the frozen golden engine, pinned in test_sim_golden
                  and the differential fuzzer)
  ``capacity``    the paper's algorithm with the cap clamped to the
                  design's RFC **entries-per-warp**, so no interval's
                  working set — hence no prefetch round — can overflow the
                  register cache even when ``interval_cap`` is set larger
  ``fixed:N``     fixed-length intervals (every run of at most N
                  instructions is its own interval, no merging): the naive
                  baseline the ablation figures compare against
  ==============  =========================================================

All heavy lifting stays memoized in `core.plan_cache`; a pass is a thin,
timed orchestration layer over those caches, so the pipeline refactor
cannot change compile *results* — only make the stages visible.

Adding a pass: build a :class:`Pass` (name, run(ctx), applies(ctx)) and
insert it into a `PassManager([...])` of your own, or extend `sim_passes()`.
Adding a strategy: decorate a ``(ctx, arg) -> IntervalAnalysis`` function
with `@register_interval_strategy("name")`; it becomes selectable as
``interval_strategy="name"`` (or ``"name:arg"``) end to end.

Copy of ``repro.core.pipeline`` for the PyTorch port: the same text, with its
imports of ``repro`` read as ``repro_torch``.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable

from .intervals import IntervalAnalysis
from .ir import Program
from .liveness import block_liveness, linear_live_intervals
from .renumber import bank_of

# Pipeline behaviour revision: part of every compiled-plan cache key (see
# plan_cache.compile_for_sim).  Bump when pass ordering/semantics change in a
# way that alters emitted plans.
PIPELINE_REV = 1

# Base names of the built-in interval-formation strategies (``fixed`` takes a
# mandatory ``:N`` argument: ``interval_strategy="fixed:8"``).
INTERVAL_STRATEGIES = ("paper", "capacity", "fixed")

# Designs with no software-managed register cache: no interval passes at all.
UNCACHED_DESIGNS = frozenset({"BL", "RFC", "Ideal"})

# The strategy registry (filled below; extended via
# `register_interval_strategy`).  Registered names are accepted end to end:
# `parse_interval_strategy` consults this table, so a custom strategy is
# selectable straight from ``SimConfig.interval_strategy``.
_STRATEGIES: dict[str, Callable] = {}


def parse_interval_strategy(spec: str) -> tuple[str, int]:
    """``"paper" | "capacity" | "fixed:N" | "<registered>[:N]"`` ->
    ``(kind, arg)``; raises on junk."""
    kind, sep, arg = spec.partition(":")
    n = int(arg) if arg.isdigit() else 0
    if kind == "fixed":
        if n > 0:
            return kind, n
    elif kind in ("paper", "capacity"):
        if not sep:
            return kind, 0
    elif kind in _STRATEGIES:
        if not sep or n > 0:  # bare name, or a positive :N argument
            return kind, n
    raise ValueError(
        f"unknown interval_strategy {spec!r}; one of 'paper', 'capacity', "
        f"'fixed:N' (N >= 1), or a registered strategy name")


def capacity_cap(interval_cap: int, rfc_per_warp: int) -> int:
    """The ``capacity`` strategy's effective working-set cap.

    ``rfc_per_warp`` is the design's register-cache entries-per-warp
    (``SimConfig.rfc_entries // active_slots``); 0 means unbounded (compile
    without a simulator config, e.g. in unit tests)."""
    if rfc_per_warp <= 0:
        return interval_cap
    return max(1, min(interval_cap, rfc_per_warp))


def effective_strategy(design: str, interval_strategy: str,
                       interval_cap: int, rfc_per_warp: int) -> tuple:
    """Normalize a strategy request into the canonical cache-key form.

    The knob is a no-op for the uncached designs and for ``SHRF`` (which
    always uses strand-bounded intervals), and ``capacity`` degenerates to
    ``paper`` whenever the RFC bound does not actually clamp the cap — all
    of those normalize to ``("paper", 0)`` so equivalent compiles share one
    cached plan."""
    kind, arg = parse_interval_strategy(interval_strategy)
    if design in UNCACHED_DESIGNS or design == "SHRF":
        return ("paper", 0)
    if kind == "capacity":
        cap = capacity_cap(interval_cap, rfc_per_warp)
        return ("paper", 0) if cap >= interval_cap else ("capacity", cap)
    return (kind, arg)  # paper, fixed, and registered extension strategies


# ---------------------------------------------------------------------------
# Context + pass machinery
# ---------------------------------------------------------------------------

@dataclass
class CompileContext:
    """Mutable state threaded through one pipeline run."""

    prog: Program                  # current program; passes may replace it
    design: str = ""
    interval_cap: int = 16
    num_banks: int = 16
    renumber: str = "icg"
    interval_strategy: str = "paper"
    rfc_per_warp: int = 0          # capacity strategy's RFC bound (0 = off)
    artifacts: dict = field(default_factory=dict)
    stats: dict[str, dict] = field(default_factory=dict)  # pass -> counters


@dataclass(frozen=True)
class Pass:
    """One pipeline stage: ``run(ctx)`` returns a stats dict (or None)."""

    name: str
    run: Callable[[CompileContext], dict | None]
    applies: Callable[[CompileContext], bool] = lambda ctx: True


class PassManager:
    """Runs an ordered pass list over a context, timing each applied pass."""

    def __init__(self, passes) -> None:
        self.passes = list(passes)

    def run(self, ctx: CompileContext) -> CompileContext:
        for p in self.passes:
            if not p.applies(ctx):
                continue
            t0 = time.perf_counter()
            stats = p.run(ctx) or {}
            stats = dict(stats)
            stats["time_ms"] = round((time.perf_counter() - t0) * 1e3, 3)
            ctx.stats[p.name] = stats
        return ctx


# ---------------------------------------------------------------------------
# Interval-formation strategies (pluggable)
# ---------------------------------------------------------------------------

def register_interval_strategy(kind: str):
    """Register a ``(ctx, arg) -> IntervalAnalysis`` interval strategy.

    Registration makes ``interval_strategy="<kind>"`` (or ``"<kind>:N"``)
    valid end to end — `parse_interval_strategy` accepts it, the plan cache
    keys on ``(kind, N)``, and the ``intervals`` pass dispatches here."""
    def deco(fn):
        _STRATEGIES[kind] = fn
        return fn
    return deco


@register_interval_strategy("paper")
def _paper_strategy(ctx: CompileContext, arg: int) -> IntervalAnalysis:
    from .plan_cache import cached_intervals
    return cached_intervals(ctx.prog, ctx.interval_cap)


@register_interval_strategy("capacity")
def _capacity_strategy(ctx: CompileContext, arg: int) -> IntervalAnalysis:
    from .plan_cache import cached_intervals
    return cached_intervals(
        ctx.prog, capacity_cap(ctx.interval_cap, ctx.rfc_per_warp))


@register_interval_strategy("fixed")
def _fixed_strategy(ctx: CompileContext, arg: int) -> IntervalAnalysis:
    from .plan_cache import cached_fixed_intervals
    return cached_fixed_intervals(ctx.prog, arg)


# ---------------------------------------------------------------------------
# The passes
# ---------------------------------------------------------------------------

def _needs_intervals(ctx: CompileContext) -> bool:
    return ctx.design not in UNCACHED_DESIGNS


def _liveness(ctx: CompileContext) -> dict:
    """Block liveness over the *current* program.

    In the simulator pipeline this runs right after interval formation —
    its consumer (LTRF+'s live-trimmed fetch sets, in the ``emit`` pass)
    needs live-in per *split-program* block label, so running it any
    earlier would compute liveness over labels the plan never executes."""
    live_in, live_out = block_liveness(ctx.prog)
    ctx.artifacts["live_in"] = live_in
    ctx.artifacts["live_out"] = live_out
    return {"blocks": len(live_in),
            "max_live_in": max((len(s) for s in live_in.values()), default=0)}


def _linear_intervals(ctx: CompileContext) -> dict:
    first, last = linear_live_intervals(ctx.prog)
    ctx.artifacts["linear_live_intervals"] = (first, last)
    return {"registers": len(first)}


def _form_intervals(ctx: CompileContext) -> dict:
    if ctx.design == "SHRF":
        # SHRF is strand-bounded by definition; the strategy knob is a no-op.
        from .plan_cache import cached_intervals
        an = cached_intervals(ctx.prog, ctx.interval_cap, strand_mode=True)
        used = "strand"
    else:
        kind, arg = parse_interval_strategy(ctx.interval_strategy)
        an = _STRATEGIES[kind](ctx, arg)
        used = ctx.interval_strategy
    n_blocks_in = len(ctx.prog.order)
    ctx.artifacts["analysis"] = an
    ctx.prog = an.prog  # interval formation may have split blocks
    sizes = [len(iv.working_set) for iv in an.intervals]
    return {"strategy": used, "cap": an.n_cap,
            "intervals": len(an.intervals),
            "block_splits": len(an.prog.order) - n_blocks_in,
            "max_working_set": max(sizes, default=0),
            "mean_working_set": round(sum(sizes) / max(len(sizes), 1), 2)}


def _wants_renumber(ctx: CompileContext) -> bool:
    return (_needs_intervals(ctx) and ctx.design == "LTRF_conf"
            and ctx.renumber == "icg")


def _build_icg(ctx: CompileContext) -> dict:
    from .plan_cache import cached_icg
    icg = cached_icg(ctx.artifacts["analysis"])
    ctx.artifacts["icg"] = icg
    return {"live_ranges": len(icg.ranges), "conflict_edges": icg.num_edges}


def _renumber(ctx: CompileContext) -> dict:
    from .plan_cache import cached_renumber_analysis
    rr = cached_renumber_analysis(ctx.artifacts["analysis"], ctx.num_banks,
                                  icg=ctx.artifacts["icg"])
    ctx.artifacts["renumber"] = rr
    ctx.artifacts["analysis"] = rr.analysis
    ctx.prog = rr.analysis.prog
    return {"applied": rr.applied,
            "colors": len(set(rr.coloring.colors.values()))
            if rr.coloring.colors else 0}


def _plan_prefetch(ctx: CompileContext) -> dict:
    from .plan_cache import cached_prefetch_ops
    ops = cached_prefetch_ops(ctx.artifacts["analysis"], ctx.num_banks)
    ctx.artifacts["pf_ops"] = ops
    vals = list(ops.values())
    return {"prefetch_ops": len(vals),
            "fetched_regs": sum(len(o.bitvector) for o in vals),
            "serial_rounds": sum(o.serial_rounds for o in vals),
            "max_conflicts": max((o.conflicts for o in vals), default=0)}


def _emit_plan(ctx: CompileContext) -> dict:
    from .plan_cache import CompiledPlan

    an = ctx.artifacts.get("analysis")
    prog = an.prog if an is not None else ctx.prog
    block_interval = dict(an.block_interval) if an is not None else {}
    pf_ops = ctx.artifacts.get("pf_ops", {})
    live_sets: dict[int, frozenset[int]] = {}
    plus_fetch: dict[int, tuple[frozenset[int], int]] = {}
    if an is not None and ctx.design == "LTRF_plus":
        # LTRF+ (paper §3.2): only LIVE registers are written back on
        # deactivation and refetched on activation; dead working-set entries
        # get cache space but no data movement.
        live_in = ctx.artifacts["live_in"]  # from the liveness pass
        for iv in an.intervals:
            live = frozenset(live_in[iv.header] & iv.working_set)
            live_sets[iv.iid] = live
            occ = [0] * ctx.num_banks
            for r in live:
                occ[bank_of(r, ctx.num_banks)] += 1
            rounds = max(occ) if any(occ) else 1
            plus_fetch[iv.iid] = (live, rounds)
    banks: dict[int, tuple[tuple[int, ...], tuple[int, ...]]] = {}
    for _, _, ins in prog.instructions():
        banks[id(ins)] = (
            tuple(bank_of(r, ctx.num_banks) for r in ins.srcs),
            tuple(bank_of(r, ctx.num_banks) for r in ins.dsts),
        )
    # ctx.stats is shared by reference: the manager appends this pass' own
    # timing entry right after, so the emitted plan carries the full record.
    ctx.artifacts["plan"] = CompiledPlan(
        prog=prog, block_interval=block_interval, pf_ops=pf_ops,
        live_sets=live_sets, plus_fetch=plus_fetch,
        order_index={l: i for i, l in enumerate(prog.order)},
        instr_banks=banks, pass_stats=ctx.stats,
    )
    return {"instructions": prog.num_instrs(),
            "intervals": len(an.intervals) if an is not None else 0}


def sim_passes() -> list[Pass]:
    """The simulator compile pipeline (one list per run: safe to extend).

    The liveness pass sits after interval formation because its consumer
    (LTRF+'s live fetch sets) needs liveness over the split program the
    emitted plan actually executes; it only applies where it is consumed.
    """
    return [
        Pass("intervals", _form_intervals, _needs_intervals),
        Pass("liveness", _liveness,
             lambda ctx: ctx.design == "LTRF_plus"),
        Pass("icg", _build_icg, _wants_renumber),
        Pass("renumber", _renumber, _wants_renumber),
        Pass("prefetch", _plan_prefetch, _needs_intervals),
        Pass("emit", _emit_plan),
    ]


def frontend_passes() -> list[Pass]:
    """The liveness pipeline the frontend register allocator runs: the
    linearized, loop-extended live intervals linear scan consumes."""
    return [
        Pass("live-intervals", _linear_intervals),
    ]


def run_compile(prog: Program, design: str, interval_cap: int, num_banks: int,
                renumber: str = "icg", interval_strategy: str = "paper",
                rfc_per_warp: int = 0):
    """Run the full simulator pipeline; returns the emitted `CompiledPlan`.

    Callers wanting memoization should go through
    `plan_cache.compile_for_sim`, which keys on the normalized strategy and
    delegates here on a miss."""
    ctx = CompileContext(prog=prog, design=design, interval_cap=interval_cap,
                         num_banks=num_banks, renumber=renumber,
                         interval_strategy=interval_strategy,
                         rfc_per_warp=rfc_per_warp)
    PassManager(sim_passes()).run(ctx)
    return ctx.artifacts["plan"]
