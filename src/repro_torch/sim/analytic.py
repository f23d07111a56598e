"""Calibrated analytical fast tier: closed-form per-interval cost model.

The cycle-accurate event engine (`repro.sim.engine`) does ~100k sim-instr/s
per core, which caps design sweeps at hundreds of points.  This module is
the PPT-GPU-style escape hatch (SNIPPETS.md Snippet 1): a closed-form model
that prices one design point in microseconds, accurate enough to *rank*
points, so a hybrid sweep can screen thousands of configurations
analytically and spend engine time only on the Pareto frontier
(`repro.serving.sweep` tier="analytic"|"engine"|"hybrid").

The model consumes exactly what the compiler already proved about the
program — `CompiledPlan.pass_stats` (validated against
`ANALYTIC_PASS_SCHEMA` so pipeline drift cannot silently skew estimates),
the interval/prefetch structure (working-set bit-vectors, per-interval
serial bank rounds, LTRF+ `plus_fetch` live-trimmed refetch sets) and the
per-instruction operand bank vectors — plus the per-design latency terms a
`SimConfig` carries (`repro.sim.designs`).

Structure of the estimate, mirroring the engine's cycle attribution
(`repro.obs.attribution.CYCLE_CATEGORIES`):

``cycles = startup + T_issue + struct_excess + dram_excess + theta . X``

* **exact dynamic profile** — the engine's instruction stream is
  timing-independent: loop branches depend only on ``Workload.trips`` and
  diamond branches on ``(wid*31 + v*17 + seed) & 1``, i.e. on the *parity*
  of ``wid``.  Walking two representative warps (wid 0 and 1) at basic-block
  segment granularity therefore reproduces the exact dynamic instruction
  count, per-interval entry counts and operand totals for every warp — the
  model's ``instructions`` field equals the engine's exactly.
* **startup** — the first interval prefetch (``serial_rounds * mrf_cycles +
  |working set| / xbar_regs_per_cycle``) is serial before any issue, exactly
  as the engine charges it.
* **throughput bounds** — issue width, MRF bank bandwidth (BL/RFC operand
  traffic vs the token-bucket rate), the single-server DRAM queue, and
  operand-collector occupancy; the binding bound sets the floor.
* **calibrated exposure terms** ``X`` — prefetch latency not hidden by
  multithreading, memory latency, dependency chains, and bank-conflict
  serialization, each divided by the active-warp overlap factor and scaled
  by a non-negative fitted coefficient (`Calibration`).  Coefficients are
  fit by non-negative least squares on a small engine-run training set
  (`fit_calibration`) and persisted with `CALIB_REV`/`ANALYTIC_REV` keys so
  stale constants are rejected, never silently reused.

Non-negative coefficients make the estimate monotone non-decreasing in the
RF access latency multiplier and in working-set size by construction, and
the Ideal design is enforced as a lower bound on every other design —
properties pinned in ``tests/test_sim_analytic.py``.  On degenerate
straight-line, no-load, conflict-free programs every exposure term is
structurally zero and the estimate equals the engine cycle-for-cycle.

Trust is established by the differential harness
(``benchmarks/bench_sim.py --analytic-smoke`` and the ``analytic_tier``
section of ``BENCH_sim.json``): Spearman rank correlation and per-point
relative error vs the engine over the tracked sweep, with hard pass/fail
verdicts.  See docs/analytical.md.

Copy of ``repro.sim.analytic`` for the PyTorch port: the same text, with its
imports of ``repro`` read as ``repro_torch``.
"""
from __future__ import annotations

import json
import math
import os
import pathlib
from dataclasses import asdict, dataclass, field, replace

from ..core.ir import Instr, Program
from ..core.plan_cache import (CompiledPlan, cached_value, compile_for_sim,
                               program_fingerprint)
from ..obs.attribution import CYCLE_CATEGORIES
from .engine import _CACHED_DESIGNS, _EDGE_PREFETCH, DESIGNS, SimConfig

# Analytical-model revision: part of every persisted analytic result key
# (`repro.serving.sweep.analytic_sim_key`) and of the calibration file
# schema.  Bump when the cost equations, the profile walk, or the feature
# definitions change — cached estimates from an older model must never be
# replayed as current.
ANALYTIC_REV = 1

# Calibration-constant revision: the *fitting contract* (feature vector
# layout + coefficient meaning).  A persisted calibration carries both revs;
# `load_calibration` rejects a mismatch on either so constants fitted
# against an older model are never applied to a newer one.
CALIB_REV = 1

# The sweep tiers wired through `repro.serving.sweep.SimRunner.prefill` and
# `benchmarks/sweep_subset.py`.
TIERS = ("engine", "analytic", "hybrid")


class AnalyticModelError(ValueError):
    """The analytical model cannot price this point (bad inputs/schema)."""


class CalibrationError(ValueError):
    """A persisted calibration file is corrupt, stale, or malformed."""


# ---------------------------------------------------------------------------
# pass_stats schema contract
# ---------------------------------------------------------------------------
# The model's compiler inputs: for each pipeline pass it consumes, the
# counter keys it reads (directly or as sanity anchors for the structures it
# walks).  `check_pass_stats` enforces presence so a pipeline refactor that
# renames/drops a counter fails loudly *here* instead of silently skewing
# estimates; tests/test_sim_analytic.py pins names and execution order.
ANALYTIC_PASS_SCHEMA: dict[str, tuple[str, ...]] = {
    "intervals": ("strategy", "cap", "intervals", "block_splits",
                  "max_working_set", "mean_working_set"),
    "liveness": ("blocks", "max_live_in"),
    "prefetch": ("prefetch_ops", "fetched_regs", "serial_rounds",
                 "max_conflicts"),
    "emit": ("instructions", "intervals"),
}

# Pipeline execution order of the passes above (subset of
# `core.pipeline.sim_passes()` order); pinned by the schema regression test.
ANALYTIC_PASS_ORDER = ("intervals", "liveness", "prefetch", "emit")


def required_passes(design: str) -> tuple[str, ...]:
    """The pass_stats entries the model reads for ``design``, in order."""
    if design in ("BL", "RFC", "Ideal"):
        return ("emit",)
    if design == "LTRF_plus":
        return ("intervals", "liveness", "prefetch", "emit")
    return ("intervals", "prefetch", "emit")


def check_pass_stats(pass_stats: dict, design: str) -> None:
    """Validate the compiler counters the analytical model consumes.

    Raises `AnalyticModelError` naming every missing pass/key; the message
    points at this module so whoever changes `core.pipeline` lands here.
    """
    problems = []
    for name in required_passes(design):
        entry = pass_stats.get(name)
        if entry is None:
            problems.append(f"pass {name!r} missing entirely")
            continue
        missing = [k for k in ANALYTIC_PASS_SCHEMA[name] if k not in entry]
        if missing:
            problems.append(f"pass {name!r} lost counters {missing}")
    if problems:
        raise AnalyticModelError(
            f"CompiledPlan.pass_stats no longer matches what the analytical "
            f"fast tier consumes for design {design!r}: {'; '.join(problems)}. "
            f"The consumers live in src/repro/sim/analytic.py "
            f"(ANALYTIC_PASS_SCHEMA) — update the model and bump ANALYTIC_REV "
            f"together with the pipeline change.")


# ---------------------------------------------------------------------------
# Calibration
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Calibration:
    """Non-negative exposure coefficients (theta) for the calibrated terms.

    All four are dimensionless multipliers on cycle-valued features; keeping
    them >= 0 (enforced on load and by the NNLS fitter) is what makes the
    estimate provably monotone in RF latency and working-set size.
    """

    theta_pf: float = 1.0     # un-hidden prefetch latency
    theta_mem: float = 1.0    # exposed memory latency
    theta_dep: float = 1.0    # dependency-chain (RAW scoreboard) latency
    theta_bank: float = 1.0   # bank-conflict serialization rounds
    source: str = "default"   # "default" | "builtin" | "fitted"
    n_samples: int = 0        # engine runs the fit saw (0 for defaults)

    def coeffs(self) -> tuple[float, float, float, float]:
        return (self.theta_pf, self.theta_mem, self.theta_dep,
                self.theta_bank)

    def fingerprint(self) -> list:
        """Stable identity for cache keys: the rounded coefficient vector."""
        return [round(c, 6) for c in self.coeffs()]


# Fitted on the tracked sweep domain (sweep_jobs(): 14 synthetic workloads x
# 7 designs + baseline x table2 configs 6-7) via `fit_calibration` against
# the event engine; baked in so the fast tier needs no calibration file to
# hit its accuracy gates.  Re-fit per host with
# `python -m benchmarks.bench_sim --fit-calibration` when the constants
# drift (the differential smoke will tell you).
DEFAULT_CALIBRATION = Calibration(
    theta_pf=0.993022, theta_mem=0.0394, theta_dep=0.0, theta_bank=0.0,
    source="builtin", n_samples=196)


def calibration_to_dict(calib: Calibration) -> dict:
    return {
        "analytic_rev": ANALYTIC_REV,
        "calib_rev": CALIB_REV,
        "coeffs": {"theta_pf": calib.theta_pf, "theta_mem": calib.theta_mem,
                   "theta_dep": calib.theta_dep,
                   "theta_bank": calib.theta_bank},
        "source": calib.source,
        "n_samples": calib.n_samples,
    }


def calibration_from_dict(payload) -> Calibration:
    """Parse + validate a persisted calibration; `CalibrationError` on any
    corruption, schema violation, stale revision, or non-finite/negative
    coefficient — a bad file must degrade the tier, never skew it."""
    if not isinstance(payload, dict):
        raise CalibrationError(f"calibration payload is {type(payload).__name__}, "
                               f"expected an object")
    for rev_key, want in (("analytic_rev", ANALYTIC_REV),
                          ("calib_rev", CALIB_REV)):
        got = payload.get(rev_key)
        if got != want:
            raise CalibrationError(
                f"calibration {rev_key}={got!r} does not match current "
                f"{rev_key}={want}: constants fitted against another model "
                f"revision are stale — re-fit with fit_calibration")
    coeffs = payload.get("coeffs")
    if not isinstance(coeffs, dict):
        raise CalibrationError("calibration 'coeffs' missing or not an object")
    vals = {}
    for name in ("theta_pf", "theta_mem", "theta_dep", "theta_bank"):
        v = coeffs.get(name)
        if not isinstance(v, (int, float)) or isinstance(v, bool) \
                or not math.isfinite(v) or v < 0:
            raise CalibrationError(
                f"calibration coefficient {name}={v!r} is not a finite "
                f"non-negative number")
        vals[name] = float(v)
    return Calibration(source=str(payload.get("source", "fitted")),
                       n_samples=int(payload.get("n_samples", 0) or 0),
                       **vals)


def save_calibration(calib: Calibration, path) -> None:
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".tmp{os.getpid()}")
    tmp.write_text(json.dumps(calibration_to_dict(calib), indent=1,
                              sort_keys=True))
    tmp.replace(path)


def load_calibration(path) -> Calibration | None:
    """Load a persisted calibration; None when the file does not exist,
    `CalibrationError` when it exists but cannot be trusted."""
    path = pathlib.Path(path)
    if not path.exists():
        return None
    try:
        payload = json.loads(path.read_text())
    except (OSError, UnicodeDecodeError, json.JSONDecodeError) as e:
        raise CalibrationError(f"unreadable calibration file {path}: {e}") \
            from e
    return calibration_from_dict(payload)


# ---------------------------------------------------------------------------
# Result
# ---------------------------------------------------------------------------

@dataclass
class AnalyticResult:
    """One analytically-priced design point.

    ``instructions`` is *exact* (the profile walk reproduces the engine's
    dynamic stream); ``cycles`` is the calibrated estimate; the breakdown
    mirrors `CYCLE_CATEGORIES` in float cycles and sums to the pre-rounding
    estimate.  ``tier`` marks the provenance so a replayed analytic record
    can never be mistaken for an engine verdict.
    """

    design: str
    workload: str
    cycles: int
    instructions: int
    resident_warps: int
    est_prefetch_events: int = 0
    est_mrf_accesses: int = 0
    cycle_breakdown: dict[str, float] = field(default_factory=dict)
    calib_source: str = "default"
    tier: str = "analytic"

    @property
    def ipc(self) -> float:
        return self.instructions / max(self.cycles, 1)

    def to_dict(self) -> dict:
        d = asdict(self)
        d["ipc"] = self.ipc
        return d


def analytic_supported(cfg: SimConfig) -> bool:
    """Can the fast tier price this config?  Multi-SM dispatch is engine-only
    for now; unsupported jobs fall through to the engine in every tier."""
    return cfg.num_sms == 1 and cfg.design in DESIGNS


# ---------------------------------------------------------------------------
# Exact dynamic profile (the parity-class walk)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class _Seg:
    """A run of straight-line instructions inside one basic block, ending at
    a branch, an exit, or the block end.  All counts are static; the walk
    weighs them by visit count."""

    n_instr: int          # instructions in the segment (incl. terminator)
    n_ctl: int            # bra/exit instructions (no operand collector)
    n_ld: int
    n_acc: int            # operand accesses (len(srcs)+len(dsts), non-ctl)
    n_dep: int            # instrs reading a reg written <=2 instrs earlier
    n_ld_consumed: int    # distinct earlier-ld dests read inside the segment
    self_rd_rounds: int   # guaranteed same-instr src bank collisions
    self_wr_rounds: int   # guaranteed same-instr dst bank collisions
    bra: Instr | None     # terminator branch (None: fell off / exit)
    bra_idx: int          # index of the bra within the block (diamond key)
    has_exit: bool


def _build_segments(plan: CompiledPlan) -> dict[str, list[_Seg]]:
    segs: dict[str, list[_Seg]] = {}
    banks = plan.instr_banks
    for label in plan.prog.order:
        bb = plan.prog.blocks[label]
        out: list[_Seg] = []
        n_i = n_ctl = n_ld = n_acc = n_dep = n_cons = s_rd = s_wr = 0
        writer_pos: dict[int, int] = {}
        ld_dsts: set[int] = set()
        consumed: set[int] = set()
        pos = 0
        for idx, ins in enumerate(bb.instrs):
            n_i += 1
            if ins.op in ("bra", "exit"):
                n_ctl += 1
                if ins.op == "bra":
                    out.append(_Seg(n_i, n_ctl, n_ld, n_acc, n_dep, n_cons,
                                    s_rd, s_wr, ins, idx, False))
                else:
                    out.append(_Seg(n_i, n_ctl, n_ld, n_acc, n_dep, n_cons,
                                    s_rd, s_wr, None, idx, True))
                n_i = n_ctl = n_ld = n_acc = n_dep = n_cons = 0
                s_rd = s_wr = 0
                writer_pos.clear()
                ld_dsts.clear()
                consumed.clear()
                pos = 0
                continue
            n_acc += len(ins.srcs) + len(ins.dsts)
            if any(writer_pos.get(s, -9) >= pos - 2 for s in ins.srcs) \
                    or ins.psrcs:
                n_dep += 1
            for s in ins.srcs:
                if s in ld_dsts and s not in consumed:
                    consumed.add(s)
                    n_cons += 1
            if ins.op == "ld":
                n_ld += 1
                ld_dsts.update(ins.dsts)
            bank_vec = banks.get(id(ins))
            if bank_vec is not None:
                for vec, is_rd in ((bank_vec[0], True), (bank_vec[1], False)):
                    seen: dict[int, int] = {}
                    extra = 0
                    for b in vec:
                        c = seen.get(b, 0)
                        seen[b] = c + 1
                        extra += 1 if c else 0
                    if is_rd:
                        s_rd += extra
                    else:
                        s_wr += extra
            for d in ins.dsts:
                writer_pos[d] = pos
            pos += 1
        if n_i:
            out.append(_Seg(n_i, n_ctl, n_ld, n_acc, n_dep, n_cons,
                            s_rd, s_wr, None, -1, False))
        segs[label] = out
    return segs


@dataclass(frozen=True)
class _ClassProfile:
    """Exact dynamic totals for one warp behavior class (wid parity)."""

    n_instr: int
    n_ctl: int
    n_ld: int
    n_acc: int
    n_dep: int
    n_ld_consumed: int
    self_rd_rounds: int
    self_wr_rounds: int
    entries: tuple[tuple[int, int], ...]      # (interval id, entry events)
    instrs_by_iid: tuple[tuple[int, int], ...]  # (interval id, dyn instrs)


# Hard stop for the profile walk, mirroring the engine's own wedge guard:
# a walk this long means a malformed/unterminated control-flow graph.
_WALK_GUARD = 4_000_000


def _walk_class(plan: CompiledPlan, segs: dict[str, list[_Seg]],
                trips: dict[str, int], wid: int, seed: int) -> _ClassProfile:
    """Replay one warp's control flow at segment granularity.

    Branch decisions replicate `engine.Simulator._branch_taken` exactly:
    loop branches count trips per target (warp-independent), diamond
    branches hash ``(wid*31 + v*17 + seed) & 0xFF`` — so one walk per wid
    parity reproduces every warp in that class.
    """
    prog = plan.prog
    order = prog.order
    order_index = plan.order_index
    block_interval = plan.block_interval

    n_instr = n_ctl = n_ld = n_acc = n_dep = n_cons = s_rd = s_wr = 0
    entries: dict[int, int] = {}
    instrs_by_iid: dict[int, int] = {}
    loop_counters: dict[str, int] = {}
    diamond_visits: dict[tuple[str, int], int] = {}

    def advance(label: str) -> tuple[str, int] | None:
        """First block at/after ``label`` (in order) that has segments."""
        i = order_index[label]
        while not segs.get(order[i]):
            if i + 1 >= len(order):
                return None
            i += 1
        return order[i], 0

    # Activation state: the engine's first forced prefetch targets the entry
    # block's interval (`_start_prefetch` sets wp.interval before issuing
    # anything), which is the first entry event.
    cur_iid = block_interval.get(prog.entry, -1)
    if cur_iid >= 0:
        entries[cur_iid] = 1
    pos = advance(prog.entry)
    guard = 0
    while pos is not None:
        guard += 1
        if guard > _WALK_GUARD:
            raise AnalyticModelError(
                f"analytic profile walk wedged after {_WALK_GUARD} segments "
                f"on program {prog.name!r} (unterminated control flow?)")
        block, si = pos
        iid = block_interval.get(block, -1)
        if iid >= 0 and iid != cur_iid:
            entries[iid] = entries.get(iid, 0) + 1
            cur_iid = iid
        seg = segs[block][si]
        n_instr += seg.n_instr
        n_ctl += seg.n_ctl
        n_ld += seg.n_ld
        n_acc += seg.n_acc
        n_dep += seg.n_dep
        n_cons += seg.n_ld_consumed
        s_rd += seg.self_rd_rounds
        s_wr += seg.self_wr_rounds
        if iid >= 0:
            instrs_by_iid[iid] = instrs_by_iid.get(iid, 0) + seg.n_instr
        if seg.has_exit:
            break
        bra = seg.bra
        if bra is None:  # fell off the block end
            i = order_index[block]
            pos = advance(order[i + 1]) if i + 1 < len(order) else None
            continue
        # --- _branch_taken, replicated bit-for-bit -----------------------
        if not bra.psrcs:
            taken = True
        else:
            t = trips.get(bra.target)
            if t is not None:
                c = loop_counters.get(bra.target, 0) + 1
                if c < t:
                    loop_counters[bra.target] = c
                    taken = True
                else:
                    loop_counters[bra.target] = 0
                    taken = False
            else:
                key = (block, seg.bra_idx)
                v = diamond_visits.get(key, 0)
                diamond_visits[key] = v + 1
                taken = bool(((wid * 31 + v * 17 + seed) & 0xFF) & 1)
        if taken:
            pos = advance(bra.target)
        elif si + 1 < len(segs[block]):
            pos = (block, si + 1)
        else:
            i = order_index[block]
            pos = advance(order[i + 1]) if i + 1 < len(order) else None
    return _ClassProfile(
        n_instr=n_instr, n_ctl=n_ctl, n_ld=n_ld, n_acc=n_acc, n_dep=n_dep,
        n_ld_consumed=n_cons, self_rd_rounds=s_rd, self_wr_rounds=s_wr,
        entries=tuple(sorted(entries.items())),
        instrs_by_iid=tuple(sorted(instrs_by_iid.items())))


def _profiles(plan: CompiledPlan, workload, seed: int,
              num_banks: int) -> tuple[_ClassProfile, _ClassProfile]:
    """(even-wid profile, odd-wid profile), memoized across estimates."""
    fp = program_fingerprint(plan.prog)
    bi_sig = tuple(sorted(plan.block_interval.items()))
    trips_sig = tuple(sorted(workload.trips.items()))

    def build():
        segs = cached_value(
            (("analytic-segs", ANALYTIC_REV), fp, num_banks),
            lambda: _build_segments(plan))
        return (_walk_class(plan, segs, workload.trips, 0, seed),
                _walk_class(plan, segs, workload.trips, 1, seed))

    return cached_value(
        (("analytic-profile", ANALYTIC_REV), fp, bi_sig, trips_sig, seed,
         num_banks), build)


# ---------------------------------------------------------------------------
# The cost model
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class _Terms:
    """Deterministic cost components + calibrated feature vector for one
    (workload, config) point; `_total` folds in the coefficients."""

    startup: float
    t_issue: float
    struct_excess: float   # max(bw, collector) beyond the issue bound
    dram_excess: float     # DRAM queue beyond every other bound
    x_pf: float
    x_mem: float
    x_dep: float
    x_bank: float
    instructions: int
    resident: int
    prefetch_events: int
    mrf_accesses: float


def _terms(workload, cfg: SimConfig) -> _Terms:
    design = cfg.design
    plan = compile_for_sim(workload.program, design, cfg.interval_cap,
                           cfg.num_banks, renumber=cfg.renumber,
                           interval_strategy=cfg.interval_strategy,
                           rfc_per_warp=cfg.rfc_entries_per_warp)
    check_pass_stats(plan.pass_stats, design)
    even, odd = _profiles(plan, workload, cfg.seed, cfg.num_banks)

    n_even = (cfg.num_warps + 1) // 2     # wids 0, 2, 4, ...
    n_odd = cfg.num_warps // 2
    classes = ((even, n_even), (odd, n_odd))

    def total(attr: str) -> int:
        return sum(getattr(p, attr) * c for p, c in classes)

    n_instr = total("n_instr")
    n_ld = total("n_ld")
    n_acc = total("n_acc")
    n_dep = total("n_dep")
    n_cons = total("n_ld_consumed")
    n_ctl = total("n_ctl")

    # Occupancy / overlap, exactly as the engine computes them.
    cap_kb = cfg.rf_size_kb + (cfg.rfc_size_kb if cfg.add_rfc_to_main else 0)
    warp_capacity = cap_kb * 1024 // 128
    resident = max(1, min(cfg.num_warps,
                          warp_capacity // max(workload.regs_per_thread, 1)))
    two_level = cfg.scheduler == "two_level"
    overlap = min(cfg.active_slots, resident) if two_level else resident

    cached = design in _CACHED_DESIGNS
    is_plus = design == "LTRF_plus"
    mrf_cyc = cfg.mrf_cycles
    l1_hit = getattr(workload, "l1_hit", cfg.l1_hit_rate)
    n_miss = n_ld * (1.0 - l1_hit)
    n_hit = n_ld * l1_hit

    # Per-interval prefetch event cost, mirroring `_start_prefetch` (LTRF+
    # substitutes the live-trimmed fetch set + rounds from plus_fetch).
    def pf_cost_len(iid: int) -> tuple[float, int]:
        op = plan.pf_ops.get(iid)
        if op is None or not op.bitvector:
            return 0.0, 0
        fetch, rounds = op.bitvector, op.serial_rounds
        if is_plus:
            ent = plan.plus_fetch.get(iid)
            if ent is not None:
                fetch, rounds = ent
                if not fetch:  # fully-dead working set: no data movement
                    return 0.0, 0
        return rounds * mrf_cyc + len(fetch) / cfg.xbar_regs_per_cycle, \
            len(fetch)

    startup = 0.0
    x_pf = 0.0
    prefetch_events = 0
    pf_fetch_regs = 0.0
    deact_lat = 0.0
    deact_regs = 0.0
    if cached:
        entry_iid = plan.block_interval.get(plan.prog.entry, -1)
        entry_cost, _entry_len = pf_cost_len(entry_iid)
        startup = float(int(entry_cost))
        event_lat = 0.0
        if design in _EDGE_PREFETCH:
            for prof, cnt in classes:
                for iid, n in prof.entries:
                    c, flen = pf_cost_len(iid)
                    if c > 0:
                        event_lat += cnt * n * c
                        prefetch_events += cnt * n
                        pf_fetch_regs += cnt * n * flen
        else:  # LTRF+: prefetch only on (re)activation, at the current block
            if entry_cost > 0:
                event_lat = cfg.num_warps * entry_cost
                prefetch_events += cfg.num_warps
                pf_fetch_regs += cfg.num_warps * _entry_len
        # Two-level deactivations on L1 misses force a writeback + refetch on
        # reactivation; weight refetch cost by where warps spend their time.
        if two_level and n_instr:
            share_lat = share_regs = share_wb = 0.0
            for prof, cnt in classes:
                for iid, n in prof.instrs_by_iid:
                    c, flen = pf_cost_len(iid)
                    w = cnt * n / n_instr
                    share_lat += w * c
                    share_regs += w * flen
                    op = plan.pf_ops.get(iid)
                    if op is not None and op.bitvector:
                        wb = len(plan.live_sets.get(iid, op.bitvector)) \
                            if is_plus else len(op.bitvector)
                        share_wb += w * wb
            n_deact = n_cons * (1.0 - l1_hit)
            deact_lat = n_deact * share_lat
            deact_regs = n_deact * (share_regs + share_wb)
            prefetch_events += int(n_deact)
            pf_fetch_regs += n_deact * share_regs
        x_pf = (max(0.0, event_lat - overlap * entry_cost) + deact_lat) \
            / overlap

    # Issue-throughput floor.  The engine's run loop breaks *before*
    # charging the final issuing cycle whenever retirement is discovered in
    # the same iteration, which nets out to floor(N / issue_width) — exact
    # on degenerate programs, the right floor elsewhere.
    t_issue = float(n_instr // cfg.issue_width)

    # MRF bandwidth bound (token bucket; only BL/RFC operand traffic draws
    # tokens — prefetch and writeback traffic is counted, not arbitrated).
    n_regs = len(plan.prog.registers())
    rfc_miss = 0.0
    if design == "RFC":
        cold = min(float(n_acc), float(cfg.num_warps * n_regs))
        pressure = resident * n_regs
        churn = max(0.0, 1.0 - cfg.rfc_entries / pressure) if pressure else 0.0
        rfc_miss = min(float(n_acc), cold + (n_acc - cold) * churn)
    bw_demand = float(n_acc) if design == "BL" else rfc_miss
    mrf_rate = cfg.num_banks / max(mrf_cyc / 6.0, 1.0)
    t_bw = max(0.0, (bw_demand - cfg.num_banks) / mrf_rate)

    # Operand-collector occupancy bound (bra/exit bypass the collectors).
    t_col = (n_instr - n_ctl) * cfg.base_rf_cycles / max(cfg.num_collectors, 1)

    # Single-server DRAM queue bound (one line per dram_interval per SM).
    t_dram = n_miss * cfg.dram_interval

    base = max(t_issue, t_bw, t_col)
    struct_excess = base - t_issue
    dram_excess = max(base, t_dram) - base

    x_mem = (n_miss * cfg.mem_cycles + n_hit * cfg.l1_cycles) / overlap \
        if n_ld else 0.0

    if design == "Ideal":
        read_unit = float(cfg.base_rf_cycles)
        wlat = float(cfg.base_rf_cycles)
    elif design == "BL":
        read_unit = float(mrf_cyc)
        wlat = float(mrf_cyc)
    elif design == "RFC":
        m = rfc_miss / max(n_acc, 1)
        read_unit = m * mrf_cyc + (1.0 - m) * cfg.rfc_cycles
        wlat = float(cfg.rfc_cycles)
    else:
        read_unit = float(cfg.rfc_cycles)
        wlat = float(cfg.rfc_cycles)
    x_dep = n_dep * (read_unit + cfg.alu_cycles + wlat) / overlap

    x_bank = 0.0
    if cfg.bank_model == "arbitrated" and design != "Ideal":
        arb_rd = cfg.base_rf_cycles if design == "BL" else cfg.rfc_cycles
        arb_wb = cfg.base_rf_cycles if design == "BL" else cfg.rfc_cycles
        self_rd = total("self_rd_rounds")
        self_wr = total("self_wr_rounds")
        cross = n_acc * n_acc / (2.0 * cfg.num_banks * max(t_issue, 1.0))
        x_bank = (self_rd * arb_rd + self_wr * arb_wb + cross * arb_rd) \
            / overlap

    # Estimated MRF traffic (the Pareto frontier's second axis).
    if design == "BL":
        mrf_accesses = float(n_acc)
    elif design == "RFC":
        mrf_accesses = rfc_miss
    elif design == "Ideal":
        mrf_accesses = 0.0
    else:
        mrf_accesses = pf_fetch_regs + deact_regs

    return _Terms(startup=startup, t_issue=t_issue,
                  struct_excess=struct_excess, dram_excess=dram_excess,
                  x_pf=x_pf, x_mem=x_mem, x_dep=x_dep, x_bank=x_bank,
                  instructions=n_instr, resident=resident,
                  prefetch_events=prefetch_events, mrf_accesses=mrf_accesses)


def _total(t: _Terms, calib: Calibration) -> float:
    return (t.startup + t.t_issue + t.struct_excess + t.dram_excess
            + calib.theta_pf * t.x_pf + calib.theta_mem * t.x_mem
            + calib.theta_dep * t.x_dep + calib.theta_bank * t.x_bank)


def _idealized(cfg: SimConfig) -> SimConfig:
    """The Ideal-design twin of ``cfg`` (matches `designs.design_config`'s
    Ideal normalization: 1x latency, RFC capacity folded into the MRF)."""
    return replace(cfg, design="Ideal", mrf_latency_mult=1.0,
                   add_rfc_to_main=True)


def estimate(workload, cfg: SimConfig,
             calib: Calibration | None = None) -> AnalyticResult:
    """Price one design point analytically.  Microseconds, not seconds.

    The returned cycles are ``max(model, model of the Ideal twin)`` so the
    Ideal design lower-bounds every other design by construction (any floor
    shortfall is attributed to ``scheduler_idle``).
    """
    if not analytic_supported(cfg):
        raise AnalyticModelError(
            f"analytic tier cannot price design={cfg.design!r} "
            f"num_sms={cfg.num_sms} (engine-only point)")
    calib = calib or DEFAULT_CALIBRATION
    t = _terms(workload, cfg)
    total = _total(t, calib)
    bd = {c: 0.0 for c in CYCLE_CATEGORIES}
    bd["issue"] = t.t_issue
    bd["prefetch_stall"] = t.startup + calib.theta_pf * t.x_pf
    bd["mem_stall"] = calib.theta_mem * t.x_mem + t.dram_excess
    bd["alu_dep"] = calib.theta_dep * t.x_dep
    bd["bank_conflict"] = calib.theta_bank * t.x_bank + t.struct_excess
    if cfg.design != "Ideal":
        ideal_total = _total(_terms(workload, _idealized(cfg)), calib)
        if ideal_total > total:
            bd["scheduler_idle"] = ideal_total - total
            total = ideal_total
    return AnalyticResult(
        design=cfg.design, workload=workload.name, cycles=int(round(total)),
        instructions=t.instructions, resident_warps=t.resident,
        est_prefetch_events=int(t.prefetch_events),
        est_mrf_accesses=int(round(t.mrf_accesses)),
        cycle_breakdown=bd, calib_source=calib.source)


# ---------------------------------------------------------------------------
# Calibration fitting (clamped non-negative least squares)
# ---------------------------------------------------------------------------

def fit_calibration(samples) -> Calibration:
    """Fit the four exposure coefficients on engine ground truth.

    ``samples``: iterable of ``(workload, cfg, engine_cycles)``.  Solves
    ``min || base + X.theta - y ||`` with ``theta >= 0`` via iterated
    least squares with negative-coefficient clamping (no scipy dependency);
    a coefficient clamped to zero simply means that exposure is already
    covered by the deterministic bounds on this training set.
    """
    import numpy as np

    rows, resid = [], []
    n = 0
    for workload, cfg, engine_cycles in samples:
        t = _terms(workload, cfg)
        base = t.startup + t.t_issue + t.struct_excess + t.dram_excess
        rows.append([t.x_pf, t.x_mem, t.x_dep, t.x_bank])
        resid.append(float(engine_cycles) - base)
        n += 1
    if n < 4:
        raise AnalyticModelError(
            f"fit_calibration needs at least 4 samples, got {n}")
    A = np.asarray(rows, dtype=float)
    y = np.asarray(resid, dtype=float)
    theta = np.zeros(4)
    active = [j for j in range(4) if A[:, j].any()]
    for _ in range(8):
        if not active:
            break
        sol, *_ = np.linalg.lstsq(A[:, active], y, rcond=None)
        neg = [j for j, v in zip(active, sol) if v < 0]
        if not neg:
            for j, v in zip(active, sol):
                theta[j] = v
            break
        active = [j for j in active if j not in neg]
    return Calibration(theta_pf=float(theta[0]), theta_mem=float(theta[1]),
                       theta_dep=float(theta[2]), theta_bank=float(theta[3]),
                       source="fitted", n_samples=n)


# ---------------------------------------------------------------------------
# Ranking helpers shared by the sweep tiers, the bench harness and the tests
# ---------------------------------------------------------------------------

def _avg_ranks(values) -> list[float]:
    """Average (tie-aware) ranks, 1-based."""
    order = sorted(range(len(values)), key=lambda i: values[i])
    ranks = [0.0] * len(values)
    i = 0
    while i < len(order):
        j = i
        while j + 1 < len(order) \
                and values[order[j + 1]] == values[order[i]]:
            j += 1
        r = (i + j) / 2.0 + 1.0
        for k in range(i, j + 1):
            ranks[order[k]] = r
        i = j + 1
    return ranks


def spearman_rho(xs, ys) -> float:
    """Spearman rank correlation (average ranks for ties; 1.0 on degenerate
    constant inputs — identical rankings cannot disagree)."""
    xs, ys = list(xs), list(ys)
    if len(xs) != len(ys):
        raise ValueError(f"length mismatch: {len(xs)} vs {len(ys)}")
    n = len(xs)
    if n < 2:
        return 1.0
    rx, ry = _avg_ranks(xs), _avg_ranks(ys)
    mx = sum(rx) / n
    my = sum(ry) / n
    cov = sum((a - mx) * (b - my) for a, b in zip(rx, ry))
    vx = sum((a - mx) ** 2 for a in rx)
    vy = sum((b - my) ** 2 for b in ry)
    if vx == 0 or vy == 0:
        return 1.0
    return cov / math.sqrt(vx * vy)


def pareto_frontier(points) -> list[int]:
    """Indices of the 2-D minimization Pareto frontier of ``(a, b)`` pairs
    (a point survives unless some other point is <= on both axes and < on
    one), in ascending-``a`` order."""
    idx = sorted(range(len(points)), key=lambda i: (points[i][0],
                                                    points[i][1]))
    out: list[int] = []
    best_b = math.inf
    for i in idx:
        a, b = points[i]
        if b < best_b:
            out.append(i)
            best_b = b
    return out
