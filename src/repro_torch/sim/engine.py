"""Discrete-event SM performance model (GPGPU-Sim stand-in).

Models one streaming multiprocessor at warp/instruction granularity with the
structures the paper evaluates:

* a banked **main register file** (MRF) with a configurable latency
  multiplier (Table 2's design points: 1x .. 6.3x) read through a limited
  pool of operand collectors — a collector is held for the full register
  read, so slow MRFs throttle issue bandwidth structurally (this is what
  makes the non-cached BL design suffer at 5.3x/6.3x);
* an optional **register file cache** (RFC, 16KB = 128 warp-registers, LRU);
* a **two-level warp scheduler** (8 active slots): a warp that *stalls on a
  value still in flight from memory* is swapped out for a ready warp
  (Gebhart'11/Narasiman'11), paying write-back + working-set refetch in the
  LTRF designs;
* LTRF's **interval prefetch** engine: a warp entering a new
  register-interval blocks until its working set streams from the MRF
  (serial bank rounds x MRF bank latency + crossbar transfer) on one of a
  small number of prefetch slots, while other active warps keep issuing;
* an L1 model (hit: short latency, no deactivation; miss: long latency,
  deactivation) with deterministic per-access jitter;
* an optional **bank-arbitration stage** (``SimConfig.bank_model``):
  operand reads and writebacks hitting the same register bank in the same
  cycle serialize, making the §4.3 renumbering ablation measurable end to
  end (``SimConfig.renumber`` switches LTRF_conf between ICG coloring and
  identity numbering).  ``bank_model="none"`` (default) stays bit-identical
  to the frozen golden engine.

The model is event-driven (idle cycles are skipped), deterministic, and
counts MRF/RFC traffic so both performance (IPC) and the paper's power-proxy
(MRF access reduction, §5.3) can be reported.

This is the *fast* engine: warp wake-ups and collector allocation go through
min-heaps, per-warp operand readiness is cached between issues, and the
compiler passes are memoized in `repro.core.plan_cache` — while staying
cycle-exact with the seed implementation.  `golden.py` preserves that
original engine; the golden-equivalence harness asserts `SimResult` equality
between the two across the full design x workload matrix.

Copy of ``repro.sim.engine`` for the PyTorch port: the same text, with its
imports of ``repro`` read as ``repro_torch``.
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass, field
from heapq import heappop, heappush, heapreplace

from repro_torch.core.pipeline import INTERVAL_STRATEGIES, parse_interval_strategy
from repro_torch.core.plan_cache import compile_for_sim
from repro_torch.core.ir import Instr, Program
from repro_torch.obs.attribution import (
    check_breakdown, classify_stall, new_breakdown,
)
from repro_torch.obs.trace import SCHED_TID, TraceSink
from repro_torch.workloads.suite import Workload

DESIGNS = ("BL", "RFC", "SHRF", "LTRF", "LTRF_conf", "LTRF_plus", "Ideal")

# Bump whenever SimResult counters intentionally change: it keys the on-disk
# sim cache (benchmarks.orchestrator), so stale artifacts never replay across
# engine-behavior revisions.
# rev 2: bank_model/renumber config axes + bank-conflict counters.
# rev 3: interval_strategy config axis + prefetch_stall_cycles counter.
# rev 4: cycle_breakdown attribution (repro.obs) carried on every result.
ENGINE_REV = 4

# Designs with a software-managed register cache (two-level scheduling).
_CACHED_DESIGNS = frozenset({"LTRF", "LTRF_conf", "LTRF_plus", "SHRF"})
# Designs that prefetch the next interval at block edges.
_EDGE_PREFETCH = frozenset({"LTRF", "LTRF_conf", "SHRF"})

# Warp-scheduler policies (see repro.sim.gpu for the policy table):
#   two_level - the paper's scheduler: `active_slots` active warps, L1-miss
#               stalls swap the warp out (write-back + re-prefetch when cached)
#   gto       - greedy-then-oldest over all resident warps, no deactivation
#   lrr       - loose round-robin over all resident warps, no deactivation
SCHEDULERS = ("two_level", "gto", "lrr")

# Register-file bank-arbitration models (``SimConfig.bank_model``):
#   none       - banks only serialize interval prefetches (the seed behavior;
#                bit-identical to the frozen golden engine)
#   arbitrated - operand reads and writebacks that hit the same bank in the
#                same cycle serialize too (§4.3); extra rounds are charged at
#                the design's read/write target latency and counted in
#                SimResult.bank_conflicts / bank_conflict_cycles.  The Ideal
#                design is exempt (it is the no-structural-limits bound).
BANK_MODELS = ("none", "arbitrated")

# Renumbering modes (``SimConfig.renumber``) — the §4 ablation axis:
#   icg      - the paper's pipeline: ICG coloring + bank-aware renumbering
#              (only LTRF_conf renumbers; the golden engine implements this)
#   identity - skip the coloring pass: LTRF_conf keeps the original register
#              numbers, exposing the bank conflicts renumbering would remove
RENUMBER_MODES = ("icg", "identity")

# Interval-formation strategies (``SimConfig.interval_strategy``), resolved
# by the compiler pass pipeline (repro.core.pipeline):
#   paper      - Algorithms 1+2 (the default; golden-pinned bit-identical)
#   capacity   - the paper's algorithm with the working-set cap clamped to
#                the design's RFC entries-per-warp, so prefetch rounds can
#                never overflow the register cache
#   fixed:N    - naive fixed-length (<= N instructions) intervals
# The knob only affects the interval-prefetching designs (LTRF family);
# SHRF always uses strands, BL/RFC/Ideal compile no intervals at all.
# INTERVAL_STRATEGIES lists the base names.


@dataclass(frozen=True)
class SimConfig:
    design: str = "BL"
    mrf_latency_mult: float = 1.0
    rf_size_kb: int = 256          # main register file capacity
    rfc_size_kb: int = 16          # register file cache capacity
    add_rfc_to_main: bool = False  # §6: BL gets the RFC's 16KB added to MRF
    num_warps: int = 64            # total warp contexts worth of work
    active_slots: int = 8
    issue_width: int = 3
    num_banks: int = 16
    interval_cap: int = 16         # registers allowed per register-interval
    base_rf_cycles: int = 4        # MRF bank access at 1x
    rfc_cycles: int = 1
    alu_cycles: int = 3
    mem_cycles: int = 380          # L1-miss latency (average)
    l1_cycles: int = 8             # L1-hit latency
    l1_hit_rate: float = 0.85
    num_collectors: int = 32       # operand collectors shared by the SM
    xbar_regs_per_cycle: int = 8   # prefetch crossbar bandwidth (1024-bit)
    max_inflight_prefetch: int = 12
    dram_interval: int = 4         # cycles between DRAM line services (bw/SM)
    seed: int = 0
    max_cycles: int = 0            # cycle-budget watchdog: a simulation that
                                   # passes this cycle raises SimBudgetExceeded
                                   # (0 = unlimited).  Never changes the
                                   # counters of a run that completes, so the
                                   # sweep cache (serving.sweep.sim_key)
                                   # deliberately excludes it.
    scheduler: str = "two_level"   # warp-scheduler policy (SCHEDULERS)
    num_sms: int = 1               # SMs on the chip; >1 via repro.sim.gpu
    mem_partitions: int = 0        # DRAM partitions feeding the SMs
                                   # (0 = one per SM, i.e. uncontended)
    bank_model: str = "none"       # RF bank arbitration (BANK_MODELS)
    renumber: str = "icg"          # renumbering ablation axis (RENUMBER_MODES)
    interval_strategy: str = "paper"  # interval formation (INTERVAL_STRATEGIES)
    trace: bool = False            # opt-in per-warp event tracer (repro.obs.
                                   # trace): records issue/stall/prefetch/swap
                                   # events on Simulator.trace for Chrome
                                   # trace-event export.  Pure observation —
                                   # never changes counters — so the sweep
                                   # cache (serving.sweep.sim_key) excludes it
                                   # like max_cycles.

    @property
    def mrf_cycles(self) -> float:
        return self.base_rf_cycles * self.mrf_latency_mult

    @property
    def rfc_entries(self) -> int:
        return self.rfc_size_kb * 1024 // 128  # 1024-bit warp registers

    @property
    def rfc_entries_per_warp(self) -> int:
        """Register-cache entries one active warp can claim — the bound the
        ``capacity`` interval strategy clamps working sets to."""
        return self.rfc_entries // max(self.active_slots, 1)


@dataclass
class SimResult:
    design: str
    workload: str
    cycles: int
    instructions: int
    resident_warps: int
    rfc_hits: int = 0
    rfc_accesses: int = 0
    mrf_accesses: int = 0
    prefetch_ops: int = 0
    prefetch_cycles: int = 0
    prefetch_stall_cycles: int = 0  # cycles warps spent blocked on an
                                    # in-flight interval prefetch (queueing
                                    # for a prefetch slot + the fetch itself)
    writeback_regs: int = 0
    activations: int = 0
    bank_conflicts: int = 0        # extra serialization rounds (arbitrated)
    bank_conflict_cycles: int = 0  # latency cycles those rounds added
    cycle_breakdown: dict[str, int] = field(default_factory=dict)
    # ^ where every cycle went: one entry per repro.obs.attribution category
    #   (issue/alu_dep/mem_stall/prefetch_stall/bank_conflict/scheduler_idle/
    #   drain); both engines enforce sum(cycle_breakdown.values()) == cycles.

    @property
    def ipc(self) -> float:
        return self.instructions / max(self.cycles, 1)

    @property
    def hit_rate(self) -> float:
        return self.rfc_hits / max(self.rfc_accesses, 1)

    @property
    def bank_conflict_rate(self) -> float:
        """Extra bank-serialization rounds per retired instruction."""
        return self.bank_conflicts / max(self.instructions, 1)


class SimBudgetExceeded(RuntimeError):
    """A simulation ran past its ``SimConfig.max_cycles`` budget.

    Structured (design/workload/budget/cycles attributes) and raised at the
    same simulated cycle by both the fast engine and the golden oracle (the
    watchdog sits at the identical point of both run loops), so the sweep
    service can classify runaway configs deterministically.  Args are passed
    positionally to ``RuntimeError`` so the exception survives pickling
    across process-pool workers."""

    def __init__(self, design: str, workload: str,
                 budget: int, cycles: int) -> None:
        super().__init__(design, workload, budget, cycles)
        self.design = design
        self.workload = workload
        self.budget = budget
        self.cycles = cycles

    def __str__(self) -> str:
        return (f"{self.workload}/{self.design}: simulation exceeded "
                f"max_cycles={self.budget} (reached cycle {self.cycles})")


ACTIVE, INACTIVE_READY, INACTIVE_WAIT, PREFETCH, DONE = range(5)


@dataclass
class _Warp:
    wid: int
    block: str
    idx: int = 0
    status: int = INACTIVE_READY
    ready_at: int = 0
    reg_ready: dict[int, float] = field(default_factory=dict)
    reg_from_mem: dict[int, bool] = field(default_factory=dict)
    pred_ready: dict[int, float] = field(default_factory=dict)
    loop_counters: dict[str, int] = field(default_factory=dict)
    diamond_visits: dict[tuple[str, int], int] = field(default_factory=dict)
    interval: int = -1
    issued: int = 0
    mem_ops: int = 0
    # Operand-readiness cache: a warp's register/predicate state only changes
    # when IT issues (or its prefetch lands), so the current instruction's
    # readiness is computed once per issue instead of once per scheduler scan.
    ver: int = 0                   # bumped whenever reg/pred state or PC moves
    c_ver: int = -1                # ver the cache below was computed at
    c_ins: Instr | None = None     # current instruction
    c_maxrdy: float = 0.0          # cycle at which all operands are ready
    c_times: tuple = ()            # pending operand-ready times (for events)
    c_mem: tuple = ()              # pending times of memory-produced operands


class Simulator:
    def __init__(self, cfg: SimConfig, workload: Workload) -> None:
        if cfg.num_sms != 1:
            raise ValueError(
                f"Simulator models one SM (num_sms={cfg.num_sms}); "
                "use repro.sim.gpu.simulate_gpu for whole-GPU runs")
        if cfg.scheduler not in SCHEDULERS:
            raise ValueError(
                f"unknown scheduler {cfg.scheduler!r}; one of {SCHEDULERS}")
        if cfg.bank_model not in BANK_MODELS:
            raise ValueError(
                f"unknown bank_model {cfg.bank_model!r}; one of {BANK_MODELS}")
        if cfg.renumber not in RENUMBER_MODES:
            raise ValueError(
                f"unknown renumber mode {cfg.renumber!r}; "
                f"one of {RENUMBER_MODES}")
        parse_interval_strategy(cfg.interval_strategy)  # raises on junk
        self.cfg = cfg
        self.w = workload
        plan = compile_for_sim(workload.program, cfg.design,
                               cfg.interval_cap, cfg.num_banks,
                               renumber=cfg.renumber,
                               interval_strategy=cfg.interval_strategy,
                               rfc_per_warp=cfg.rfc_entries_per_warp)
        self.prog: Program = plan.prog
        self.block_interval = plan.block_interval
        self.pf_ops = plan.pf_ops
        self.live_sets = plan.live_sets
        self._plus_fetch = plan.plus_fetch
        self.result = SimResult(design=cfg.design, workload=workload.name,
                                cycles=0, instructions=0,
                                resident_warps=self._occupancy())
        self._order_index = plan.order_index
        self._dram_next = 0
        # Hot-loop constants (avoid per-access property/str dispatch).
        self._mrf_cyc = cfg.mrf_cycles
        self._rfc_cyc = float(cfg.rfc_cycles)
        self._mem_thresh = 2 * cfg.l1_cycles
        self._l1_hit = getattr(workload, "l1_hit", cfg.l1_hit_rate)
        self._edge_prefetch = cfg.design in _EDGE_PREFETCH
        self._is_plus = cfg.design == "LTRF_plus"
        # writeback latency is design-static (see seed `_write_latency`)
        if cfg.design == "Ideal":
            self._wlat = cfg.base_rf_cycles
        elif cfg.design == "BL":
            self._wlat = cfg.mrf_cycles
        else:
            self._wlat = float(cfg.rfc_cycles)
        # per-instruction operand metadata: (n_accesses, combined reg tuple)
        meta: dict[int, tuple[int, tuple[int, ...]]] = {}
        for _, _, ins in self.prog.instructions():
            regs = tuple(ins.srcs) + tuple(ins.dsts)
            meta[id(ins)] = (len(regs), regs)
        self._instr_meta = meta
        self._done_dirty = False
        self._stall_pure = True
        self._sched = cfg.scheduler
        self._gto_last = -1
        # Bank arbitration (bank_model="arbitrated"): per-cycle read/write
        # port usage per bank.  Ideal is exempt — it is the design with no
        # structural register-file limits, the paper's upper bound.
        self._arb = cfg.bank_model == "arbitrated" and cfg.design != "Ideal"
        self._instr_banks = plan.instr_banks
        self._read_from_mrf = False     # set per issue by _operand_latency
        self._arb_wb_unit = cfg.base_rf_cycles if cfg.design == "BL" \
            else cfg.rfc_cycles
        self._bank_cycle = -1
        self._rd_use: list[int] = []
        self._wr_use: list[int] = []
        # Opt-in event tracer (None = disabled: the hot loop pays one `is
        # not None` test per hook and nothing else).
        self.trace: TraceSink | None = TraceSink() if cfg.trace else None

    # ------------------------------------------------------------------ static
    def _occupancy(self) -> int:
        cfg = self.cfg
        cap_kb = cfg.rf_size_kb + (cfg.rfc_size_kb if cfg.add_rfc_to_main else 0)
        warp_regs_capacity = cap_kb * 1024 // 128
        per_warp = max(self.w.regs_per_thread, 1)
        return max(1, min(cfg.num_warps, warp_regs_capacity // per_warp))

    # ----------------------------------------------------------------- dynamic
    def run(self) -> SimResult:
        cfg = self.cfg
        res = self.result
        cached = cfg.design in _CACHED_DESIGNS
        # RFC is a plain hardware cache shared by ALL resident warps -- the
        # paper's Fig. 4 thrashing story (8-30% hit rate) requires the full
        # warp population to contend for the 128 entries.
        # Only the two_level policy restricts issue to `active_slots` warps
        # and swaps out memory-stalled warps; gto/lrr schedule over the whole
        # resident population (prefetch still runs on activation/interval
        # edges for the cached designs, but there is no deactivation churn).
        two_level = cached and self._sched == "two_level"
        use_gto = self._sched == "gto"
        resident_cap = res.resident_warps
        active_cap = min(cfg.active_slots, resident_cap) if two_level else resident_cap
        # Kernel-tail threshold for cycle attribution: once retirement leaves
        # fewer live warps than one scheduler's worth (`active_slots`),
        # zero-issue cycles are the unavoidable drain of the last warps, not
        # a latency-tolerance failure (same for every scheduler policy).
        tail_cap = min(cfg.active_slots, resident_cap)

        warps = [_Warp(wid=i, block=self.prog.entry) for i in range(cfg.num_warps)]
        pending = list(range(cfg.num_warps))
        pending_pos = 0  # head of the admit queue (avoids O(n) pop(0))
        resident: list[int] = []   # stays sorted ascending by wid
        active: list[int] = []
        self._pf_free = [0] * cfg.max_inflight_prefetch   # min-heap
        self._col_free = [0] * cfg.num_collectors         # min-heap
        # MRF bank throughput: slow cells (DWM shift, TFET) pipeline only
        # partially (sub-banked arrays, depth ~6), so aggregate MRF bandwidth
        # is num_banks / (initiation interval = latency/6) accesses per cycle.
        self._mrf_rate = cfg.num_banks / max(cfg.mrf_cycles / 6.0, 1.0)
        self._mrf_tokens = float(cfg.num_banks)
        self._mrf_last = 0
        rfc_lru: OrderedDict[tuple[int, int], None] = OrderedDict()

        # Event structures: `wake` holds (ready_at, wid) for warps that left
        # the active set (INACTIVE_WAIT) or are mid-prefetch (PREFETCH);
        # `ready_q` holds INACTIVE_READY resident warps.  Because `resident`
        # is always ascending by wid, the seed's "first ready resident warp"
        # is exactly the ready_q minimum.
        wake: list[tuple[int, int]] = []
        ready_q: list[int] = []
        self._wake = wake

        def admit() -> None:
            nonlocal pending_pos
            while pending_pos < len(pending) and len(resident) < resident_cap:
                wid = pending[pending_pos]
                pending_pos += 1
                resident.append(wid)
                heappush(ready_q, wid)

        trace = self.trace

        def activate(cycle: int) -> None:
            while len(active) < active_cap:
                while ready_q and warps[ready_q[0]].status != INACTIVE_READY:
                    heappop(ready_q)  # stale entry
                if not ready_q:
                    break
                wid = heappop(ready_q)
                wp = warps[wid]
                res.activations += 1
                if trace is not None:
                    trace.instant(wid, "activate", cycle)
                if cached:
                    self._start_prefetch(wp, cycle, force=True)
                active.append(wid)
                if wp.status != PREFETCH:
                    wp.status = ACTIVE

        def deactivate(wid: int, until: float, cycle: int) -> None:
            wp = warps[wid]
            active.remove(wid)
            wp.status = INACTIVE_WAIT
            wp.ready_at = int(until)
            if trace is not None:
                trace.instant(wid, "swap_out", cycle,
                              {"until": wp.ready_at})
            heappush(wake, (wp.ready_at, wid))
            if cached and wp.interval >= 0:
                ws = self.pf_ops.get(wp.interval)
                if ws is not None:
                    n_wb = len(self.live_sets.get(wp.interval, ws.bitvector)) \
                        if self._is_plus else len(ws.bitvector)
                    res.writeback_regs += n_wb
                    res.mrf_accesses += n_wb
            wp.interval = -1  # must re-prefetch on activation
            activate(cycle)

        admit()
        activate(0)

        issue_width = cfg.issue_width
        max_cycles = cfg.max_cycles
        # Cycle attribution (repro.obs.attribution): the loop below advances
        # `cycle` at exactly two sites — +1 after an issuing cycle, or a jump
        # to the next event after a zero-issue cycle — and every advance is
        # charged to exactly one category, so the breakdown sums to the final
        # cycle count by construction (and is hard-checked at the end).
        bd = res.cycle_breakdown = new_breakdown()
        cycle = 0
        guard = 0
        while True:
            guard += 1
            if guard > 8_000_000:
                raise RuntimeError("simulator wedged")
            if max_cycles and cycle > max_cycles:
                raise SimBudgetExceeded(cfg.design, self.w.name,
                                        max_cycles, cycle)

            while wake and wake[0][0] <= cycle:
                _, wid = heappop(wake)
                wp = warps[wid]
                if wp.ready_at > cycle:
                    continue  # stale: warp re-entered a wait with a later deadline
                if wp.status == INACTIVE_WAIT:
                    wp.status = INACTIVE_READY
                    heappush(ready_q, wid)
                elif wp.status == PREFETCH:
                    wp.status = ACTIVE
            activate(cycle)

            issued_now = 0
            struct_stall = False
            mem_stalled: list[tuple[int, float]] = []
            for _ in range(issue_width):
                wid = (self._pick_gto(warps, active, cycle) if use_gto else
                       self._pick(warps, active, cycle, mem_stalled, two_level))
                if wid is None:
                    break
                if self._issue(warps[wid], cycle, rfc_lru):
                    issued_now += 1
                    if use_gto:
                        self._gto_last = wid
                else:
                    # a ready warp blocked by RF structure (collector / MRF
                    # bandwidth): remembered for cycle attribution
                    struct_stall = True
                    if self._stall_pure:
                        # Pure structural stall: the failed issue consumed
                        # nothing, so the seed's remaining issue slots would
                        # re-pick this same warp and fail identically.  (A
                        # collector stall that already consumed MRF bandwidth
                        # tokens is NOT pure — the retry must run, token state
                        # changed.)
                        break

            if two_level:
                for wid, until in mem_stalled:
                    if warps[wid].status == ACTIVE and wid in active:
                        deactivate(wid, until, cycle)

            if self._done_dirty:
                self._done_dirty = False
                for wid in list(active):
                    if warps[wid].status == DONE:
                        active.remove(wid)
                        resident.remove(wid)
                        admit()
                        activate(cycle)
            if not resident and pending_pos >= len(pending):
                break

            if issued_now:
                bd["issue"] += 1
                cycle += 1
            else:
                drain = (pending_pos >= len(pending)
                         and len(resident) < tail_cap)
                cat = self._classify_stall(warps, active, cycle,
                                           struct_stall, drain)
                nxt = self._next_event(warps, active, cycle)
                bd[cat] += nxt - cycle
                if trace is not None:
                    trace.span(SCHED_TID, cat, cycle, nxt - cycle)
                cycle = nxt

        res.cycles = cycle
        res.instructions = sum(w.issued for w in warps)
        check_breakdown(bd, cycle, cfg.design, self.w.name)
        return res

    # ----------------------------------------------------------------- helpers
    def _start_prefetch(self, wp: _Warp, cycle: int, force: bool = False) -> None:
        cfg = self.cfg
        iid = self.block_interval.get(wp.block, -1)
        if iid < 0:
            return
        if not force and iid == wp.interval:
            return
        op = self.pf_ops.get(iid)
        wp.interval = iid
        if op is None or not op.bitvector:
            return
        fetch = op.bitvector
        rounds = op.serial_rounds
        if self._is_plus:
            # fetch only the live subset (dead entries: space, no data)
            ent = self._plus_fetch.get(iid)
            if ent is not None:
                fetch, rounds = ent
                if not fetch:
                    return
        if self._arb and rounds > 1:
            # prefetch bank serialization is already charged in the latency
            # below (it predates the arbitration model); under the arbitrated
            # model it is also *counted*, so the renumbering ablation sees
            # every conflict source in one pair of counters.
            self.result.bank_conflicts += rounds - 1
            self.result.bank_conflict_cycles += int((rounds - 1) * self._mrf_cyc)
        lat = rounds * self._mrf_cyc \
            + len(fetch) / cfg.xbar_regs_per_cycle
        pf = self._pf_free
        start = pf[0]
        if start < cycle:
            start = cycle
        done = int(start + lat)
        heapreplace(pf, done)
        wp.status = PREFETCH
        wp.ready_at = done
        if self.trace is not None:
            self.trace.span(wp.wid, "prefetch", cycle, done - cycle,
                            {"interval": iid, "regs": len(fetch),
                             "rounds": rounds})
        heappush(self._wake, (done, wp.wid))
        self.result.prefetch_ops += 1
        self.result.prefetch_cycles += int(lat)
        # the warp is blocked from issue until the prefetch lands (including
        # any wait for a free prefetch slot)
        self.result.prefetch_stall_cycles += done - cycle
        self.result.mrf_accesses += len(fetch)
        reg_ready = wp.reg_ready
        for r in op.bitvector:
            t = reg_ready.get(r, 0)
            reg_ready[r] = done if done > t else t
        wp.ver += 1

    def _refresh_ready(self, wp: _Warp, ins: Instr) -> None:
        """Recompute the warp's operand-readiness cache for ``ins``."""
        reg_ready = wp.reg_ready
        from_mem = wp.reg_from_mem
        maxr = 0.0
        times = []
        mem = []
        for s in ins.srcs:
            t = reg_ready.get(s, 0)
            if t:
                times.append(t)
                if t > maxr:
                    maxr = t
                if from_mem.get(s):
                    mem.append(t)
        if ins.psrcs:
            pred_ready = wp.pred_ready
            for p in ins.psrcs:
                t = pred_ready.get(p, 0)
                if t:
                    times.append(t)
                    if t > maxr:
                        maxr = t
        wp.c_ins = ins
        wp.c_maxrdy = maxr
        wp.c_times = times
        wp.c_mem = mem
        wp.c_ver = wp.ver

    def _pick(self, warps, active, cycle, mem_stalled, track_mem=True):
        """Round-robin over active warps; also reports warps stalled on
        memory-produced values (two-level deactivation candidates —
        ``track_mem`` is False for single-level designs, which ignore them)."""
        n = len(active)
        if not n:
            return None
        start = cycle % n
        thresh = self._mem_thresh
        for k in range(n):
            i = start + k
            if i >= n:
                i -= n
            wid = active[i]
            wp = warps[wid]
            if wp.status != ACTIVE:
                continue
            if wp.c_ver == wp.ver:
                ins = wp.c_ins
            else:
                ins = self._fetch(wp)
                if ins is None:
                    wp.status = DONE
                    self._done_dirty = True
                    continue
                self._refresh_ready(wp, ins)
            if wp.c_maxrdy <= cycle:
                return wid
            if not track_mem:
                continue
            # only a *long-latency* (L1-miss) wait justifies swapping the
            # warp out of the active set
            blocked = 0.0
            for t in wp.c_mem:
                if t > cycle and t - cycle > thresh and t > blocked:
                    blocked = t
            if blocked:
                mem_stalled.append((wid, blocked))
        return None

    def _pick_gto(self, warps, active, cycle):
        """Greedy-then-oldest: keep issuing from the warp that issued last;
        when it can't, fall back to the oldest ready warp (lowest wid —
        ``active`` is filled in admission order and only shrinks, so it is
        ascending by wid whenever this policy is selected)."""
        last = self._gto_last
        if 0 <= last and warps[last].status == ACTIVE:
            order = [last]
            order.extend(active)
        else:
            order = active
        for wid in order:
            wp = warps[wid]
            if wp.status != ACTIVE:
                continue
            if wp.c_ver == wp.ver:
                ins = wp.c_ins
            else:
                ins = self._fetch(wp)
                if ins is None:
                    wp.status = DONE
                    self._done_dirty = True
                    continue
                self._refresh_ready(wp, ins)
            if wp.c_maxrdy <= cycle:
                return wid
        return None

    def _fetch(self, wp: _Warp) -> Instr | None:
        blocks = self.prog.blocks
        bb = blocks[wp.block]
        while wp.idx >= len(bb.instrs):
            i = self._order_index[wp.block]
            if i + 1 >= len(self.prog.order):
                return None
            wp.block = self.prog.order[i + 1]
            wp.idx = 0
            bb = blocks[wp.block]
        return bb.instrs[wp.idx]

    def _mrf_bandwidth(self, cycle: int, n: int) -> bool:
        """Consume ``n`` MRF bank slots; False => structural stall."""
        cfg = self.cfg
        if cycle > self._mrf_last:
            self._mrf_tokens = min(
                float(cfg.num_banks),
                self._mrf_tokens + self._mrf_rate * (cycle - self._mrf_last))
            self._mrf_last = cycle
        if self._mrf_tokens < n:
            return False
        self._mrf_tokens -= n
        return True

    def _mrf_next_free(self, cycle: int, n: int = 1) -> int:
        deficit = max(0.0, n - self._mrf_tokens)
        return cycle + max(1, int(deficit / self._mrf_rate))

    def _grab_collector(self, cycle: int) -> bool:
        # banks are pipelined: a collector is held for the *gather* time (a
        # few cycles), not the full access latency — latency shows up in the
        # dependency chain (read + execute + writeback), not as a hard
        # throughput ceiling.
        cf = self._col_free
        if cf[0] > cycle:
            return False
        heapreplace(cf, cycle + self.cfg.base_rf_cycles)
        return True

    def _operand_latency(self, wp: _Warp, ins: Instr, rfc_lru, cycle: int) -> float | None:
        """Register read latency; None => structural stall (no collector).

        On a stall, ``self._stall_pure`` records whether the attempt consumed
        any state: a bandwidth stall consumes nothing (pure), but a collector
        stall after a successful bandwidth check has already deducted MRF
        tokens — the seed's retry of such an issue is NOT a no-op."""
        cfg = self.cfg
        design = cfg.design
        res = self.result
        if design == "Ideal":
            if not self._grab_collector(cycle):
                self._stall_pure = True
                return None
            return cfg.base_rf_cycles
        if design == "BL":
            n_acc = self._instr_meta[id(ins)][0]
            if n_acc and not self._mrf_bandwidth(cycle, n_acc):
                self._stall_pure = True
                return None
            if not self._grab_collector(cycle):
                self._stall_pure = n_acc == 0
                return None
            res.mrf_accesses += n_acc
            self._read_from_mrf = True
            return self._mrf_cyc
        if design == "RFC":
            n_acc, regs = self._instr_meta[id(ins)]
            wid = wp.wid
            misses = 0
            hits = []
            for r in regs:
                key = (wid, r)
                if key in rfc_lru:
                    hits.append(key)
                else:
                    misses += 1
            if misses and not self._mrf_bandwidth(cycle, misses):
                self._stall_pure = True
                return None
            if not self._grab_collector(cycle):
                self._stall_pure = misses == 0
                return None
            res.rfc_accesses += n_acc
            res.rfc_hits += len(hits)
            res.mrf_accesses += misses
            for key in hits:
                rfc_lru.move_to_end(key)
            entries = cfg.rfc_entries
            for r in regs:
                key = (wid, r)
                if key not in rfc_lru:
                    rfc_lru[key] = None
                    if len(rfc_lru) > entries:
                        rfc_lru.popitem(last=False)
            self._read_from_mrf = misses > 0
            return self._mrf_cyc if misses else self._rfc_cyc
        # LTRF-family: every in-interval access hits the register cache
        if not self._grab_collector(cycle):
            self._stall_pure = True
            return None
        n_acc = self._instr_meta[id(ins)][0]
        res.rfc_accesses += n_acc
        res.rfc_hits += n_acc
        self._read_from_mrf = False
        return self._rfc_cyc

    def _bank_arbitrate(self, ins: Instr, cycle: int) -> tuple[int, int]:
        """(extra read rounds, extra writeback rounds) from same-cycle
        same-bank contention, under ``bank_model="arbitrated"``.

        Per-cycle per-bank access counters model each bank's single read and
        single write port: the k-th access to a bank within a cycle waits k
        extra serialization rounds, and an instruction is held up by its
        worst operand (ports pipeline across *different* banks for free)."""
        if cycle != self._bank_cycle:
            self._bank_cycle = cycle
            n = self.cfg.num_banks
            self._rd_use = [0] * n
            self._wr_use = [0] * n
        src_banks, dst_banks = self._instr_banks[id(ins)]
        rd_extra = 0
        use = self._rd_use
        for b in src_banks:
            pos = use[b]
            use[b] = pos + 1
            if pos > rd_extra:
                rd_extra = pos
        wr_extra = 0
        use = self._wr_use
        for b in dst_banks:
            pos = use[b]
            use[b] = pos + 1
            if pos > wr_extra:
                wr_extra = pos
        return rd_extra, wr_extra

    def _mem_latency(self, wp: _Warp, cycle: int) -> tuple[int, bool]:
        """(latency, is_l1_miss) with deterministic jitter + DRAM queuing.

        Misses are serviced by a single-server DRAM queue (one cache line per
        ``dram_interval`` cycles per SM): memory-heavy kernels saturate DRAM
        bandwidth regardless of TLP — which is exactly why the paper's
        register-insensitive workloads gain nothing from bigger register
        files."""
        cfg = self.cfg
        h = (wp.wid * 2654435761 + wp.mem_ops * 40503 + cfg.seed * 97) & 0xFFFF
        wp.mem_ops += 1
        if (h / 0xFFFF) < self._l1_hit:
            return cfg.l1_cycles, False
        spread = ((h >> 3) / 0x1FFF - 0.5) * 0.6
        start = max(cycle, self._dram_next)
        self._dram_next = start + cfg.dram_interval
        queue = start - cycle
        return int(queue + cfg.mem_cycles * (1.0 + spread)), True

    def _issue(self, wp: _Warp, cycle: int, rfc_lru) -> bool:
        """Issue the warp's next instruction. Returns True if issued."""
        cfg = self.cfg
        ins = wp.c_ins if wp.c_ver == wp.ver else self._fetch(wp)
        assert ins is not None and wp.status == ACTIVE

        if ins.op == "bra":
            wp.issued += 1
            wp.ver += 1
            if self.trace is not None:
                self.trace.span(wp.wid, "bra", cycle, 1)
            if self._branch_taken(wp, ins):
                wp.block, wp.idx = ins.target, 0
            else:
                wp.idx += 1
            self._maybe_prefetch_edge(wp, cycle)
            return True
        if ins.op == "exit":
            wp.issued += 1
            wp.ver += 1
            wp.status = DONE
            self._done_dirty = True
            if self.trace is not None:
                self.trace.span(wp.wid, "exit", cycle, 1)
            return True

        read_lat = self._operand_latency(wp, ins, rfc_lru, cycle)
        if read_lat is None:
            return False  # structural stall: collectors busy
        wp.issued += 1
        wp.ver += 1
        done_at = cycle + read_lat
        wlat = self._wlat
        if self._arb:
            rd_extra, wr_extra = self._bank_arbitrate(ins, cycle)
            res = self.result
            if rd_extra:
                # extra rounds re-access the bank at its nominal cell latency:
                # the design's read target (MRF at base_rf_cycles, RFC/LTRF
                # register cache at rfc_cycles)
                pen = rd_extra * (cfg.base_rf_cycles if self._read_from_mrf
                                  else cfg.rfc_cycles)
                done_at += pen
                res.bank_conflicts += rd_extra
                res.bank_conflict_cycles += pen
            if wr_extra:
                pen = wr_extra * self._arb_wb_unit
                wlat = wlat + pen
                res.bank_conflicts += wr_extra
                res.bank_conflict_cycles += pen
            if self.trace is not None and (rd_extra or wr_extra):
                self.trace.instant(wp.wid, "bank_conflict", cycle,
                                   {"rd_rounds": rd_extra,
                                    "wr_rounds": wr_extra})
        if ins.op == "set":
            done_at += cfg.alu_cycles
            if ins.pdst is not None:
                wp.pred_ready[ins.pdst] = done_at  # predicates live in the scoreboard
        elif ins.op == "ld":
            lat, _miss = self._mem_latency(wp, cycle)
            done_at += lat + wlat
            for d in ins.dsts:
                wp.reg_ready[d] = done_at
                wp.reg_from_mem[d] = True
        else:
            done_at += cfg.alu_cycles + wlat
            for d in ins.dsts:
                wp.reg_ready[d] = done_at
                wp.reg_from_mem[d] = False
        if self.trace is not None:
            self.trace.span(wp.wid, ins.op, cycle, int(done_at) - cycle,
                            {"block": wp.block})
        wp.idx += 1
        self._maybe_prefetch_edge(wp, cycle)
        return True

    def _maybe_prefetch_edge(self, wp: _Warp, cycle: int) -> None:
        if not self._edge_prefetch:
            return
        if wp.status != ACTIVE:
            return
        if self._fetch(wp) is None:
            return
        iid = self.block_interval.get(wp.block, -1)
        if iid >= 0 and iid != wp.interval:
            self._start_prefetch(wp, cycle)

    def _branch_taken(self, wp: _Warp, ins: Instr) -> bool:
        if not ins.psrcs:
            return True
        target = ins.target
        trips = self.w.trips.get(target)
        if trips is not None:
            c = wp.loop_counters.get(target, 0) + 1
            if c < trips:
                wp.loop_counters[target] = c
                return True
            wp.loop_counters[target] = 0
            return False
        key = (wp.block, wp.idx)
        v = wp.diamond_visits.get(key, 0)
        wp.diamond_visits[key] = v + 1
        h = (wp.wid * 31 + v * 17 + self.cfg.seed) & 0xFF
        return bool(h & 1)

    def _classify_stall(self, warps, active, cycle: int,
                        struct_stall: bool, drain: bool) -> str:
        """Attribute one zero-issue cycle (see repro.obs.attribution).

        Scans the active set for the observable stall causes and defers the
        precedence decision to `classify_stall`, which the golden oracle
        calls with identically-derived booleans — attribution is part of the
        bit-identical `SimResult` contract.  Reading a warp's pending
        operands may refresh its readiness cache via `_fetch` (the same
        idempotent block-walk `_next_event` performs); it never changes
        schedulable state.
        """
        if drain or struct_stall:
            return classify_stall(drain, struct_stall, False, False, False)
        saw_prefetch = saw_mem = saw_dep = False
        for wid in active:
            wp = warps[wid]
            st = wp.status
            if st == PREFETCH:
                saw_prefetch = True
            elif st == ACTIVE:
                if wp.c_ver != wp.ver:
                    ins = self._fetch(wp)
                    if ins is None:
                        continue
                    self._refresh_ready(wp, ins)
                for t in wp.c_mem:
                    if t > cycle:
                        saw_mem = True
                        break
                if not saw_dep:
                    for t in wp.c_times:
                        if t > cycle:
                            saw_dep = True
                            break
        return classify_stall(False, False, saw_prefetch, saw_mem, saw_dep)

    def _next_event(self, warps, active, cycle: int) -> int:
        """Earliest future time anything can change state.

        Candidates: the next collector release, the next warp wake-up
        (deactivation deadline / prefetch completion, via the wake heap), and
        the earliest pending operand of any active warp (via the per-warp
        readiness cache).  Matches the seed engine's full-scan result.
        """
        best = 0.0
        m = self._col_free[0]
        if m > cycle:
            best = m
        wake = self._wake
        if wake:
            t = wake[0][0]
            if t > cycle and (not best or t < best):
                best = t
        for wid in active:
            wp = warps[wid]
            if wp.status != ACTIVE:
                continue
            if wp.c_ver != wp.ver:
                ins = self._fetch(wp)
                if ins is None:
                    continue
                self._refresh_ready(wp, ins)
            for t in wp.c_times:
                if t > cycle and (not best or t < best):
                    best = t
        if not best:
            return cycle + 1
        nxt = int(best)
        return nxt if nxt > cycle else cycle + 1


def simulate(workload: Workload, cfg: SimConfig) -> SimResult:
    return Simulator(cfg, workload).run()
