"""Golden reference simulator: the original (pre-optimization) engine.

This is the seed implementation of the discrete-event SM model, kept
verbatim (unoptimized, no compile cache, linear scans) as the behavioural
oracle for the event-heap engine in `engine.py`.  The golden-equivalence
harness (tests/test_sim_golden.py, benchmarks) asserts that both engines
produce bit-identical `SimResult` counters for every (design, workload)
pair.  Do not optimize this file; optimize `engine.py` and prove equality.

The golden engine predates the pluggable pass pipeline: it always runs the
paper's interval-formation algorithm (``SimConfig.interval_strategy`` is
ignored, exactly like the gto/lrr schedulers and multi-SM knobs), so
differential comparisons must pin ``interval_strategy="paper"``.

Copy of ``repro.sim.golden`` for the PyTorch port (the same text, its imports
of ``repro`` read as ``repro_torch``): the oracle the port's frontend CLI
(``python -m repro_torch.frontend``) holds its scalar engine to.
"""
from __future__ import annotations

from collections import OrderedDict

from repro_torch.core.intervals import form_register_intervals
from repro_torch.core.ir import Instr
from repro_torch.core.prefetch import prefetch_schedule
from repro_torch.core.renumber import renumber_registers
from repro_torch.obs.attribution import (
    check_breakdown, classify_stall, new_breakdown,
)
from repro_torch.workloads.suite import Workload

from .engine import (
    ACTIVE, DONE, INACTIVE_READY, INACTIVE_WAIT, PREFETCH,
    SimBudgetExceeded, SimConfig, SimResult, _Warp,
)

class GoldenSimulator:
    def __init__(self, cfg: SimConfig, workload: Workload) -> None:
        self.cfg = cfg
        self.w = workload
        self.prog, self.block_interval, self.pf_ops = self._compile()
        self.result = SimResult(design=cfg.design, workload=workload.name,
                                cycles=0, instructions=0,
                                resident_warps=self._occupancy())
        self._order_index = {l: i for i, l in enumerate(self.prog.order)}
        self._lru_counter = 0
        self._dram_next = 0

    # ------------------------------------------------------------------ static
    def _compile(self):
        cfg = self.cfg
        prog = self.w.program
        self.live_sets = {}
        if cfg.design in ("BL", "RFC", "Ideal"):
            return prog, {}, {}
        if cfg.design == "SHRF":
            an = form_register_intervals(prog, cfg.interval_cap, strand_mode=True)
        else:
            an = form_register_intervals(prog, cfg.interval_cap)
            if cfg.design == "LTRF_conf":
                rr = renumber_registers(an, num_banks=cfg.num_banks)
                an = rr.analysis
        ops = {op.interval_id: op
               for op in prefetch_schedule(an, num_banks=cfg.num_banks)}
        if cfg.design == "LTRF_plus":
            # LTRF+ (paper §3.2): only LIVE registers are written back on
            # deactivation and refetched on activation; dead working-set
            # entries get cache space but no data movement.
            from repro_torch.core.liveness import block_liveness
            live_in, _ = block_liveness(an.prog)
            for iv in an.intervals:
                self.live_sets[iv.iid] = frozenset(
                    live_in[iv.header] & iv.working_set)
        return an.prog, dict(an.block_interval), ops

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
        cached = cfg.design in ("LTRF", "LTRF_conf", "LTRF_plus", "SHRF")
        # RFC is a plain hardware cache shared by ALL resident warps -- the
        # paper's Fig. 4 thrashing story (8-30% hit rate) requires the full
        # warp population to contend for the 128 entries.
        two_level = cached
        resident_cap = res.resident_warps
        active_cap = min(cfg.active_slots, resident_cap) if two_level else resident_cap
        # Kernel-tail threshold for cycle attribution (see engine.run).
        tail_cap = min(cfg.active_slots, resident_cap)

        warps = [_Warp(wid=i, block=self.prog.entry) for i in range(cfg.num_warps)]
        pending = list(range(cfg.num_warps))
        resident: list[int] = []
        active: list[int] = []
        self._pf_free = [0] * cfg.max_inflight_prefetch
        self._col_free = [0] * cfg.num_collectors
        # MRF bank throughput: slow cells (DWM shift, TFET) pipeline only
        # partially (sub-banked arrays, depth ~6), so aggregate MRF bandwidth
        # is num_banks / (initiation interval = latency/6) accesses per cycle.
        self._mrf_rate = cfg.num_banks / max(cfg.mrf_cycles / 6.0, 1.0)
        self._mrf_tokens = float(cfg.num_banks)
        self._mrf_last = 0
        rfc_lru: OrderedDict[tuple[int, int], None] = OrderedDict()

        def admit() -> None:
            while pending and len(resident) < resident_cap:
                resident.append(pending.pop(0))

        def activate(cycle: int) -> None:
            while len(active) < active_cap:
                cand = [w for w in resident if warps[w].status == INACTIVE_READY]
                if not cand:
                    break
                wid = cand[0]
                wp = warps[wid]
                res.activations += 1
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
            if cached and wp.interval >= 0:
                ws = self.pf_ops.get(wp.interval)
                if ws is not None:
                    n_wb = len(self.live_sets.get(wp.interval, ws.bitvector)) \
                        if cfg.design == "LTRF_plus" else len(ws.bitvector)
                    res.writeback_regs += n_wb
                    res.mrf_accesses += n_wb
            wp.interval = -1  # must re-prefetch on activation
            activate(cycle)

        admit()
        activate(0)

        # Cycle attribution (repro_torch.obs.attribution): charged at the same two
        # advance sites as the fast engine, from identically-derived state —
        # `cycle_breakdown` is part of the bit-identical SimResult contract.
        bd = res.cycle_breakdown = new_breakdown()
        cycle = 0
        max_cycles = cfg.max_cycles
        guard = 0
        while True:
            guard += 1
            if guard > 8_000_000:
                raise RuntimeError("simulator wedged")
            if max_cycles and cycle > max_cycles:
                raise SimBudgetExceeded(cfg.design, self.w.name,
                                        max_cycles, cycle)

            for wid in resident:
                wp = warps[wid]
                if wp.status == INACTIVE_WAIT and wp.ready_at <= cycle:
                    wp.status = INACTIVE_READY
                elif wp.status == PREFETCH and wp.ready_at <= cycle:
                    wp.status = ACTIVE
            activate(cycle)

            issued_now = 0
            struct_stall = False
            mem_stalled: list[tuple[int, float]] = []
            for _ in range(cfg.issue_width):
                wid = self._pick(warps, active, cycle, mem_stalled)
                if wid is None:
                    break
                if self._issue(warps[wid], cycle, rfc_lru):
                    issued_now += 1
                else:
                    # a ready warp blocked by RF structure (collector / MRF
                    # bandwidth): remembered for cycle attribution
                    struct_stall = True

            if two_level:
                for wid, until in mem_stalled:
                    if warps[wid].status == ACTIVE and wid in active:
                        deactivate(wid, until, cycle)

            for wid in list(active):
                if warps[wid].status == DONE:
                    active.remove(wid)
                    resident.remove(wid)
                    admit()
                    activate(cycle)
            if not resident and not pending:
                break

            if issued_now:
                bd["issue"] += 1
                cycle += 1
            else:
                drain = not pending and len(resident) < tail_cap
                cat = self._classify_stall(warps, active, cycle,
                                           struct_stall, drain)
                nxt = self._next_event(warps, resident, cycle)
                bd[cat] += nxt - cycle
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
        if cfg.design == "LTRF_plus":
            # fetch only the live subset (dead entries: space, no data)
            live = self.live_sets.get(iid)
            if live is not None:
                fetch = live if live else frozenset()
                if not fetch:
                    return
                occ = [0] * cfg.num_banks
                from repro_torch.core.renumber import bank_of
                for r in fetch:
                    occ[bank_of(r, cfg.num_banks)] += 1
                rounds = max(occ) if any(occ) else 1
        lat = rounds * cfg.mrf_cycles \
            + len(fetch) / cfg.xbar_regs_per_cycle
        slot = min(range(len(self._pf_free)), key=self._pf_free.__getitem__)
        start = max(cycle, self._pf_free[slot])
        done = int(start + lat)
        self._pf_free[slot] = done
        wp.status = PREFETCH
        wp.ready_at = done
        self.result.prefetch_ops += 1
        self.result.prefetch_cycles += int(lat)
        # the warp is blocked from issue until the prefetch lands (including
        # any wait for a free prefetch slot)
        self.result.prefetch_stall_cycles += done - cycle
        self.result.mrf_accesses += len(fetch)
        for r in op.bitvector:
            wp.reg_ready[r] = max(wp.reg_ready.get(r, 0), done)

    def _pick(self, warps, active, cycle, mem_stalled):
        """Round-robin over active warps; also reports warps stalled on
        memory-produced values (two-level deactivation candidates)."""
        if not active:
            return None
        start = cycle % len(active)
        order = active[start:] + active[:start]
        for wid in order:
            wp = warps[wid]
            if wp.status != ACTIVE:
                continue
            ins = self._fetch(wp)
            if ins is None:
                wp.status = DONE
                continue
            blocked_on_mem = 0.0
            ready = True
            for s in ins.srcs:
                t = wp.reg_ready.get(s, 0)
                if t > cycle:
                    ready = False
                    # only a *long-latency* (L1-miss) wait justifies swapping
                    # the warp out of the active set
                    if wp.reg_from_mem.get(s) and t - cycle > 2 * self.cfg.l1_cycles:
                        blocked_on_mem = max(blocked_on_mem, t)
            for p in ins.psrcs:
                if wp.pred_ready.get(p, 0) > cycle:
                    ready = False
            if ready:
                return wid
            if blocked_on_mem:
                mem_stalled.append((wid, blocked_on_mem))
        return None

    def _fetch(self, wp: _Warp) -> Instr | None:
        bb = self.prog.blocks[wp.block]
        while wp.idx >= len(bb.instrs):
            i = self._order_index[wp.block]
            if i + 1 >= len(self.prog.order):
                return None
            wp.block = self.prog.order[i + 1]
            wp.idx = 0
            bb = self.prog.blocks[wp.block]
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

    def _grab_collector(self, cycle: int, hold: float) -> bool:
        # banks are pipelined: a collector is held for the *gather* time (a
        # few cycles), not the full access latency — latency shows up in the
        # dependency chain (read + execute + writeback), not as a hard
        # throughput ceiling.
        del hold
        slot = min(range(len(self._col_free)), key=self._col_free.__getitem__)
        if self._col_free[slot] > cycle:
            return False
        self._col_free[slot] = cycle + self.cfg.base_rf_cycles
        return True

    def _write_latency(self, wp: _Warp, ins: Instr, rfc_lru) -> float:
        """Cycles until a written register becomes readable (writeback)."""
        cfg = self.cfg
        if cfg.design == "Ideal":
            return cfg.base_rf_cycles
        if cfg.design == "BL":
            return cfg.mrf_cycles
        # RFC and the LTRF family write into the register cache
        return float(cfg.rfc_cycles)

    def _operand_latency(self, wp: _Warp, ins: Instr, rfc_lru, cycle: int) -> float | None:
        """Register read latency; None => structural stall (no collector)."""
        cfg = self.cfg
        res = self.result
        if cfg.design == "Ideal":
            if not self._grab_collector(cycle, cfg.base_rf_cycles):
                return None
            return cfg.base_rf_cycles
        if cfg.design == "BL":
            n_acc = len(ins.srcs) + len(ins.dsts)
            if n_acc and not self._mrf_bandwidth(cycle, n_acc):
                return None
            if not self._grab_collector(cycle, cfg.mrf_cycles):
                return None
            res.mrf_accesses += n_acc
            return cfg.mrf_cycles
        if cfg.design == "RFC":
            misses = 0
            hits = []
            for r in list(ins.srcs) + list(ins.dsts):
                key = (wp.wid, r)
                if key in rfc_lru:
                    hits.append(key)
                else:
                    misses += 1
            if misses and not self._mrf_bandwidth(cycle, misses):
                return None
            if not self._grab_collector(cycle, cfg.mrf_cycles if misses else cfg.rfc_cycles):
                return None
            res.rfc_accesses += len(ins.srcs) + len(ins.dsts)
            res.rfc_hits += len(hits)
            res.mrf_accesses += misses
            for key in hits:
                rfc_lru.move_to_end(key)
            for r in list(ins.srcs) + list(ins.dsts):
                key = (wp.wid, r)
                if key not in rfc_lru:
                    rfc_lru[key] = None
                    if len(rfc_lru) > cfg.rfc_entries:
                        rfc_lru.popitem(last=False)
            return cfg.mrf_cycles if misses else float(cfg.rfc_cycles)
        # LTRF-family: every in-interval access hits the register cache
        if not self._grab_collector(cycle, cfg.rfc_cycles):
            return None
        res.rfc_accesses += len(ins.srcs) + len(ins.dsts)
        res.rfc_hits += len(ins.srcs) + len(ins.dsts)
        return float(cfg.rfc_cycles)

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
        hit_rate = getattr(self.w, 'l1_hit', cfg.l1_hit_rate)
        if (h / 0xFFFF) < hit_rate:
            return cfg.l1_cycles, False
        spread = ((h >> 3) / 0x1FFF - 0.5) * 0.6
        start = max(cycle, self._dram_next)
        self._dram_next = start + cfg.dram_interval
        queue = start - cycle
        return int(queue + cfg.mem_cycles * (1.0 + spread)), True

    def _issue(self, wp: _Warp, cycle: int, rfc_lru) -> bool:
        """Issue the warp's next instruction. Returns True if issued."""
        cfg = self.cfg
        ins = self._fetch(wp)
        assert ins is not None and wp.status == ACTIVE

        if ins.op == "bra":
            wp.issued += 1
            if self._branch_taken(wp, ins):
                wp.block, wp.idx = ins.target, 0
            else:
                wp.idx += 1
            self._maybe_prefetch_edge(wp, cycle)
            return True
        if ins.op == "exit":
            wp.issued += 1
            wp.status = DONE
            return True

        read_lat = self._operand_latency(wp, ins, rfc_lru, cycle)
        if read_lat is None:
            return False  # structural stall: collectors busy
        wp.issued += 1
        done_at = cycle + read_lat
        wlat = self._write_latency(wp, ins, rfc_lru)
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
        wp.idx += 1
        self._maybe_prefetch_edge(wp, cycle)
        return True

    def _maybe_prefetch_edge(self, wp: _Warp, cycle: int) -> None:
        if self.cfg.design not in ("LTRF", "LTRF_conf", "SHRF"):
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
        """Attribute one zero-issue cycle (see repro_torch.obs.attribution).

        Derives the same booleans as the fast engine's classifier — a
        prefetching warp in the active set, a pending memory-produced
        source, any pending operand — by direct scan, and defers the
        precedence decision to the shared `classify_stall`."""
        if drain or struct_stall:
            return classify_stall(drain, struct_stall, False, False, False)
        saw_prefetch = saw_mem = saw_dep = False
        for wid in active:
            wp = warps[wid]
            if wp.status == PREFETCH:
                saw_prefetch = True
            elif wp.status == ACTIVE:
                ins = self._fetch(wp)
                if ins is None:
                    continue
                pend = False
                for s in ins.srcs:
                    t = wp.reg_ready.get(s, 0)
                    if t > cycle:
                        pend = True
                        if wp.reg_from_mem.get(s):
                            saw_mem = True
                for p in ins.psrcs:
                    if wp.pred_ready.get(p, 0) > cycle:
                        pend = True
                if pend:
                    saw_dep = True
        return classify_stall(False, False, saw_prefetch, saw_mem, saw_dep)

    def _next_event(self, warps, resident, cycle: int) -> int:
        nxt = [min(self._col_free)] if self._col_free else []
        nxt = [t for t in nxt if t > cycle]
        for wid in resident:
            wp = warps[wid]
            if wp.status in (INACTIVE_WAIT, PREFETCH):
                nxt.append(wp.ready_at)
            elif wp.status == ACTIVE:
                ins = self._fetch(wp)
                if ins is not None:
                    for s in ins.srcs:
                        t = wp.reg_ready.get(s, 0)
                        if t > cycle:
                            nxt.append(t)
                    for p in ins.psrcs:
                        t = wp.pred_ready.get(p, 0)
                        if t > cycle:
                            nxt.append(t)
        if not nxt:
            return cycle + 1
        return max(int(min(nxt)), cycle + 1)


def golden_simulate(workload: Workload, cfg: SimConfig) -> SimResult:
    return GoldenSimulator(cfg, workload).run()
