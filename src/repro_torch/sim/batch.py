"""Vectorized batch simulation engine: many independent sims in lockstep.

Port of ``repro.sim.batch`` to PyTorch.  The scalar engines (`engine.py`
event-heap, the JAX package's ``golden.py`` oracle) spend ~10us of Python per
retired instruction.  This module runs the *same* discrete-event tick as a
masked step over tensors indexed ``(lane, warp)`` in int64/float64: one step
advances a whole batch of independent simulations together.  The reference
runs its loop as one jitted ``lax.while_loop``; on a CUDA card its
counterpart is one hand-written kernel (``csrc/sim_batch.cu``, wrapper
``repro_torch.kernels.sim_batch``) that runs every tick of every lane of a
chunk in one launch.  The tick below (``_tick_fn``) is that kernel's plain
version: eager PyTorch, run in blocks of ticks.  The CPU runs it; the card
runs it only where a caller asks for it (``engine="plain"`` on
``_run_torch`` and ``_run_chunks``), each block then captured once as a
``torch.cuda.CUDAGraph`` and replayed, so the host checks whether any lane
is still running once a block, not once a tick.

Correctness contract (the reference's): for every supported config the
batch engine produces **bit-identical** `SimResult`s — every counter and the
full `cycle_breakdown` — to the event engine and the golden oracle, on the
CPU and on the card.  The host code (plan encoding, lane padding, chunking,
result extraction) is the reference's, unchanged.  The tick mirrors
``repro.sim.batch._run_jax`` (the activation loop aside, below), leaves out
a branch that only some kinds of lane take where the chunk has none of them
(the reference's ``E > 1`` gate, extended), and names, at each place where
PyTorch differs from ``jnp``, the reference line it mirrors:

* out-of-bounds scatters, which XLA drops, land in one trash slot of the
  plane (``rv``, ``rc``, ``act`` and ``cf`` carry one extra row, sliced
  off before the state is returned);
* ``.at[...].max`` / ``.min`` become ``scatter_reduce_`` (``amax`` /
  ``amin``, ``include_self=True``) over a linear index;
* ``argmin`` / ``argmax`` return the first index on ties, and never run on
  bool tensors;
* every float64 site performs the reference's operations in its order, one
  PyTorch kernel each: no fused multiply-add can form (no ``alpha=``, no
  ``addcmul``/``lerp``/``addmm``, no ``torch.compile``, no Triton), and a
  float64 division by a constant divides by a device tensor, because CUDA
  PyTorch turns a division by a Python scalar into a product with its
  reciprocal, which is not the IEEE quotient.

Blocks and the activation loop.  A lane that is no longer alive is a no-op
in the tick (every write is masked by ``act`` or ``adv``), so ticks run past
the last lane's end change nothing; only the scalar ``guard`` (the tick
count) is advanced only while the reference's ``running`` holds.  The
reference's ``activation`` is a data-dependent ``while_loop`` that activates
one warp a pass.  Here one call activates them all at once: the warps a call
takes are each lane's first READY resident warps in wid order, up to its
free slots, and every effect of an activation lands on that warp's own rows
except the inflight-prefetch slots, which the prefetching warps take in wid
order, in a short loop.  Where the plain tick runs on the card, that loop
has a fixed length ``k``; a device flag records whether some lane needed
more, and a block that set it is rolled back to the snapshot taken at its
start and replayed under the chunk's static bound (its lanes' largest
active-slot cap), which cannot overflow.  On the CPU, where a sync costs
nothing, the loop runs as long as the call's largest lane needs.  The
kernel needs none of this: its activation is exact.

Supported domain (`batch_supported`): the paper's two-level scheduler,
``bank_model="none"``, untraced, single-SM configs — exactly the tracked
fast-path sweep.  Unsupported configs fall back to the scalar event engine,
job by job.
"""
from __future__ import annotations

import time
from contextlib import nullcontext
from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.pipeline import parse_interval_strategy
from repro_torch.core.plan_cache import compile_for_sim
from repro_torch.kernels.sim_batch import sim_batch
from repro_torch.obs.attribution import CYCLE_CATEGORIES, check_breakdown, new_breakdown
from repro_torch.workloads.suite import Workload

from .engine import (
    ACTIVE, DONE, INACTIVE_READY, INACTIVE_WAIT, PREFETCH,
    _CACHED_DESIGNS, _EDGE_PREFETCH,
    SimBudgetExceeded, SimConfig, SimResult, simulate,
)

# The reference's revision: the port must stay bit-identical to it.
BATCH_REV = 2

# Opcode kinds in the flat-PC instruction encoding.
_OP_OTHER, _OP_BRA, _OP_EXIT, _OP_SET, _OP_LD = range(5)

_BIG = np.int64(1) << 60          # sentinel "never" timestamp / rank
_GUARD = 8_000_000                # same wedge guard as the scalar engines

_CAT_INDEX = {c: i for i, c in enumerate(CYCLE_CATEGORIES)}

# warp-family (``wf``) fixed field columns; loop counters start at
# _F_LC, diamond counters at _F_LC + n_loop_slots + 1 (chunk-dependent).
F_ST, F_PC, F_IV, F_RA, F_IS, F_MO = range(6)
_F_LC = 6

# packed per-pc metadata (``meta``) fixed columns; the variable-width
# src/psrc/dst/acc column groups follow (see `_meta_cols`).
M_KIND, M_NACC, M_PDST, M_TGT, M_TRIPS, M_LSL, M_DSL, M_IVPC = range(8)


def _meta_cols(S: int, PS: int, DD: int):
    """Column offsets of the variable-width groups in the meta table."""
    m_s = 8
    m_ps = m_s + S
    m_d = m_ps + PS
    m_g = m_d + DD
    return m_s, m_ps, m_d, m_g


def batch_supported(cfg: SimConfig) -> bool:
    """Can this config run on the vectorized fast path?

    The batch engine implements the paper's two-level scheduler with no
    bank arbitration and no tracer — the golden-pinned domain, and exactly
    what the tracked sweep runs.  Everything compile-side (design, interval
    strategy, renumbering) is supported because the plan is shared.
    """
    return (cfg.scheduler == "two_level"
            and cfg.bank_model == "none"
            and not cfg.trace
            and cfg.num_sms == 1)


# --------------------------------------------------------------------------
# Static per-lane encoding: flat-PC program tables + interval tables.
# --------------------------------------------------------------------------

@dataclass
class _PlanCode:
    """Flat-PC encoding of one compiled plan (+ workload trip counts).

    All arrays are numpy; shared read-only across lanes and batches.
    ``P`` rows of instruction metadata plus one sentinel row at index P
    (the "past the end" position the clamped pc gather lands on).
    """
    n_pc: int                 # instruction count (flat program length)
    op_kind: np.ndarray       # (P+1,) int32
    srcs: np.ndarray          # (P+1, S) int32, sentinel = n_regs
    psrcs: np.ndarray         # (P+1, PS) int32, sentinel = n_preds
    dsts: np.ndarray          # (P+1, D) int32, sentinel = n_regs
    pdst: np.ndarray          # (P+1,) int32, sentinel = n_preds
    n_acc: np.ndarray         # (P+1,) int32
    acc_regs: np.ndarray      # (P+1, G) int32 srcs+dsts in order, -1 pad
    target: np.ndarray        # (P+1,) int32 flat target pc (bra)
    trips: np.ndarray         # (P+1,) int32 loop trip count (0 if not loop)
    loop_slot: np.ndarray     # (P+1,) int32, sentinel = n_loops
    dia_slot: np.ndarray      # (P+1,) int32, sentinel = n_dias
    interval_of_pc: np.ndarray  # (P+1,) int32, -1 = none
    n_regs: int
    n_preds: int
    n_loops: int
    n_dias: int
    # interval tables, indexed by interval id (row IV = "no interval")
    iv_rounds: np.ndarray     # (IV+1,) int32
    iv_nfetch: np.ndarray     # (IV+1,) int32 effective fetch count
    iv_nwb: np.ndarray        # (IV+1,) int32 writeback regs on deactivation
    iv_has_op: np.ndarray     # (IV+1,) bool  prefetch actually fires
    iv_regs: np.ndarray       # (IV+1, GV) int32 FULL bitvector, -1 pad
    n_ivs: int


_ENCODE_MEMO: dict = {}


def _encode_plan(workload: Workload, cfg: SimConfig) -> _PlanCode:
    plan = compile_for_sim(workload.program, cfg.design,
                           cfg.interval_cap, cfg.num_banks,
                           renumber=cfg.renumber,
                           interval_strategy=cfg.interval_strategy,
                           rfc_per_warp=cfg.rfc_entries_per_warp)
    trips_key = tuple(sorted(workload.trips.items()))
    key = (id(plan), cfg.design == "LTRF_plus", trips_key)
    hit = _ENCODE_MEMO.get(key)
    if hit is not None:
        return hit[0]

    prog = plan.prog
    is_plus = cfg.design == "LTRF_plus"
    flat: list[tuple[str, int, object]] = []     # (label, idx, ins)
    block_first: dict[str, int] = {}             # label -> flat pc of first
    for label in prog.order:
        bb = prog.blocks[label]
        block_first[label] = len(flat)           # even for empty blocks:
        for i, ins in enumerate(bb.instrs):      # first instr at-or-after
            flat.append((label, i, ins))
    P = len(flat)

    def target_pc(label: str) -> int:
        # flat pc of the first instruction in-or-after `label` (the scalar
        # engines' lazy block walk); past-the-end collapses to P.
        start = block_first.get(label)
        return P if start is None else start

    n_regs = 0
    n_preds = 0
    max_s = 1
    max_ps = 1
    max_d = 1
    for _, _, ins in flat:
        for r in tuple(ins.srcs) + tuple(ins.dsts):
            n_regs = max(n_regs, r + 1)
        for p in ins.psrcs:
            n_preds = max(n_preds, p + 1)
        if ins.pdst is not None:
            n_preds = max(n_preds, ins.pdst + 1)
        max_s = max(max_s, len(ins.srcs))
        max_ps = max(max_ps, len(ins.psrcs))
        max_d = max(max_d, len(ins.dsts))
    for op in plan.pf_ops.values():
        for r in op.bitvector:
            n_regs = max(n_regs, r + 1)

    # loop slots: one counter per trip-count label (shared across branch
    # sites, like the scalar `loop_counters[target]`); diamond slots: one
    # visit counter per conditional non-loop branch *site* (flat pc).
    loop_labels: dict[str, int] = {}
    n_dias = 0

    max_g = max(1, max_s + max_d)
    op_kind = np.zeros(P + 1, np.int32)
    srcs = np.full((P + 1, max_s), n_regs, np.int32)
    psrcs = np.full((P + 1, max_ps), n_preds, np.int32)
    dsts = np.full((P + 1, max_d), n_regs, np.int32)
    pdst = np.full(P + 1, n_preds, np.int32)
    n_acc = np.zeros(P + 1, np.int32)
    acc_regs = np.full((P + 1, max_g), -1, np.int32)
    target = np.zeros(P + 1, np.int32)
    trips = np.zeros(P + 1, np.int32)
    interval_of_pc = np.full(P + 1, -1, np.int32)

    loop_slot_rows = np.zeros(P + 1, np.int32)
    dia_slot_rows = np.zeros(P + 1, np.int32)
    kinds = {"bra": _OP_BRA, "exit": _OP_EXIT, "set": _OP_SET, "ld": _OP_LD}

    for pc, (label, idx, ins) in enumerate(flat):
        interval_of_pc[pc] = plan.block_interval.get(label, -1)
        op_kind[pc] = kinds.get(ins.op, _OP_OTHER)
        for j, r in enumerate(ins.srcs):
            srcs[pc, j] = r
        for j, p in enumerate(ins.psrcs):
            psrcs[pc, j] = p
        for j, r in enumerate(ins.dsts):
            dsts[pc, j] = r
        if ins.pdst is not None:
            pdst[pc] = ins.pdst
        regs = tuple(ins.srcs) + tuple(ins.dsts)
        n_acc[pc] = len(regs)
        for j, r in enumerate(regs):
            acc_regs[pc, j] = r
        if ins.op == "bra":
            target[pc] = target_pc(ins.target)
            t = workload.trips.get(ins.target)
            if ins.psrcs and t is not None:
                trips[pc] = t
                slot = loop_labels.setdefault(ins.target, len(loop_labels))
                loop_slot_rows[pc] = slot + 1  # 0 = "not a loop" below
            elif ins.psrcs:
                n_dias += 1
                dia_slot_rows[pc] = n_dias     # 0 = "not a diamond"
    # the lazy block walk parks a finished warp on the LAST block in order,
    # so the sentinel row's interval is that block's (activation prefetch
    # of an at-end warp — unreachable in practice, encoded for fidelity).
    interval_of_pc[P] = plan.block_interval.get(prog.order[-1], -1) \
        if prog.order else -1
    op_kind[P] = _OP_EXIT

    n_loops = len(loop_labels)
    loop_slot = np.where(loop_slot_rows > 0, loop_slot_rows - 1,
                         n_loops).astype(np.int32)
    dia_slot = np.where(dia_slot_rows > 0, dia_slot_rows - 1,
                        n_dias).astype(np.int32)

    # ------------------------------------------------------ interval tables
    n_ivs = 0
    for iid in plan.pf_ops:
        n_ivs = max(n_ivs, iid + 1)
    for iid in plan.block_interval.values():
        n_ivs = max(n_ivs, iid + 1)
    max_gv = 1
    for op in plan.pf_ops.values():
        max_gv = max(max_gv, len(op.bitvector))
    iv_rounds = np.zeros(n_ivs + 1, np.int32)
    iv_nfetch = np.zeros(n_ivs + 1, np.int32)
    iv_nwb = np.zeros(n_ivs + 1, np.int32)
    iv_has_op = np.zeros(n_ivs + 1, bool)
    iv_regs = np.full((n_ivs + 1, max_gv), -1, np.int32)
    for iid, op in plan.pf_ops.items():
        fetch = op.bitvector
        rounds = op.serial_rounds
        has = bool(fetch)
        if is_plus:
            ent = plan.plus_fetch.get(iid)
            if ent is not None:
                live, live_rounds = ent
                if fetch:                       # engine consults plus_fetch
                    fetch, rounds = live, live_rounds   # only past this guard
                    has = bool(live)
            nwb = len(plan.live_sets.get(iid, op.bitvector))
        else:
            nwb = len(op.bitvector)
        iv_rounds[iid] = rounds
        iv_nfetch[iid] = len(fetch)
        iv_nwb[iid] = nwb
        iv_has_op[iid] = has
        # reg_ready refresh uses the FULL bitvector even for LTRF+ (cache
        # slots are reserved for dead entries; only the data movement is
        # trimmed) — order irrelevant (independent per-register max).
        for j, r in enumerate(sorted(op.bitvector)):
            iv_regs[iid, j] = r

    code = _PlanCode(
        n_pc=P, op_kind=op_kind, srcs=srcs, psrcs=psrcs, dsts=dsts,
        pdst=pdst, n_acc=n_acc, acc_regs=acc_regs, target=target,
        trips=trips, loop_slot=loop_slot, dia_slot=dia_slot,
        interval_of_pc=interval_of_pc, n_regs=n_regs, n_preds=n_preds,
        n_loops=n_loops, n_dias=n_dias,
        iv_rounds=iv_rounds, iv_nfetch=iv_nfetch, iv_nwb=iv_nwb,
        iv_has_op=iv_has_op, iv_regs=iv_regs, n_ivs=n_ivs,
    )
    _ENCODE_MEMO[key] = (code, plan)  # keep `plan` alive: memo key uses id()
    return code


# --------------------------------------------------------------------------
# Batch assembly: pad lanes into shared (lane, ...) arrays.
# --------------------------------------------------------------------------

@dataclass
class _Lane:
    workload: Workload
    cfg: SimConfig
    code: _PlanCode
    occupancy: int


def _occupancy(workload: Workload, cfg: SimConfig) -> int:
    cap_kb = cfg.rf_size_kb + (cfg.rfc_size_kb if cfg.add_rfc_to_main else 0)
    per_warp = max(workload.regs_per_thread, 1)
    return max(1, min(cfg.num_warps, cap_kb * 1024 // 128 // per_warp))


def _acap(ln: "_Lane") -> int:
    """Active-slot cap for one lane (mirrors the scalar engines')."""
    if ln.cfg.design in _CACHED_DESIGNS:
        return min(ln.cfg.active_slots, ln.occupancy)
    return ln.occupancy


def _bucket(n: int, floor: int) -> int:
    """Next power-of-two >= n (>= floor): shape buckets bound recompiles."""
    b = floor
    while b < n:
        b *= 2
    return b


def _build(lanes: Sequence[_Lane]):
    """Pad every lane's tables/config into batch arrays (numpy, 64-bit)."""
    i32, i64, f64 = np.int32, np.int64, np.float64
    K = _bucket(len(lanes), 2)
    W = _bucket(max(ln.cfg.num_warps for ln in lanes), 4)
    # Active-list width: cached designs cap it at `active_slots` (8), the
    # uncached ones scan every resident warp.  Keeping this dimension tight
    # is the difference between (K, 8) and (K, 64) work in the per-slot
    # scheduler scans — `run_batch` groups lanes by it.
    A = _bucket(max(_acap(ln) for ln in lanes), 2)
    P = _bucket(max(ln.code.n_pc for ln in lanes), 16)
    S = max(ln.code.srcs.shape[1] for ln in lanes)
    PS = max(ln.code.psrcs.shape[1] for ln in lanes)
    DD = max(ln.code.dsts.shape[1] for ln in lanes)
    G = max(ln.code.acc_regs.shape[1] for ln in lanes)
    GV = _bucket(max(ln.code.iv_regs.shape[1] for ln in lanes), 4)
    R = _bucket(max(ln.code.n_regs for ln in lanes), 8)
    PR = _bucket(max(ln.code.n_preds for ln in lanes), 2)
    L = _bucket(max(ln.code.n_loops for ln in lanes), 2)
    DM = _bucket(max(ln.code.n_dias for ln in lanes), 2)
    IV = _bucket(max(ln.code.n_ivs for ln in lanes), 4)
    C = max(ln.cfg.num_collectors for ln in lanes)
    PF = max(ln.cfg.max_inflight_prefetch for ln in lanes)
    # E == 1 statically means "no RFC lane in this chunk": the jitted run
    # skips the whole cache-classification + LRU block (RFC chunks are
    # padded to >= 2 entries so the gate never misfires).
    _rfc_es = [ln.cfg.rfc_entries for ln in lanes if ln.cfg.design == "RFC"]
    E = max(2, *_rfc_es) if _rfc_es else 1
    IW = max(ln.cfg.issue_width for ln in lanes)

    m_s, m_ps, m_d, m_g = _meta_cols(S, PS, DD)
    MW = m_g + G                      # packed meta row width
    NWF = _F_LC + (L + 1) + (DM + 1)  # warp-family row width
    RVW = (R + 1) + (PR + 1)          # register+predicate value rows

    meta = np.zeros((K, P + 1, MW), i32)
    meta[:, :, M_KIND] = _OP_EXIT
    meta[:, :, M_PDST] = PR
    meta[:, :, M_LSL] = L
    meta[:, :, M_DSL] = DM
    meta[:, :, M_IVPC] = -1
    meta[:, :, m_s: m_s + S] = R
    meta[:, :, m_ps: m_ps + PS] = PR
    meta[:, :, m_d: m_d + DD] = R
    meta[:, :, m_g: m_g + G] = -1

    co = {
        # packed per-pc instruction metadata (sentinel row at pc=P)
        "meta": meta,
        # per-interval table: [rounds, nfetch, nwb, has_op] (sentinel at IV)
        "ivt": np.zeros((K, IV + 1, 4), i32),
        "ivregs": np.full((K, IV + 1, GV), -1, i32),
        # per-lane scalars
        "endpc": np.zeros(K, i32),
        "mrfc": np.zeros(K, f64), "rfcc": np.zeros(K, f64),
        "brf_f": np.zeros(K, f64), "wlat": np.zeros(K, f64),
        "rate": np.zeros(K, f64), "l1h": np.zeros(K, f64),
        "xbar": np.ones(K, f64), "banksf": np.zeros(K, f64),
        "aluf": np.zeros(K, f64), "memf": np.zeros(K, f64),
        "brf_i": np.zeros(K, i64), "l1c": np.zeros(K, i64),
        # dram_interval is a float on gpu.per_sm_configs shards (the per-SM
        # effective interval is dram_interval*num_sms/partitions) — golden
        # does the same arithmetic in Python floats, exactly representable
        "thr": np.zeros(K, i64), "drint": np.zeros(K, f64),
        "seed": np.zeros(K, i64), "maxc": np.zeros(K, i64),
        "iw": np.zeros(K, i32), "nw": np.zeros(K, i32),
        "rcap": np.zeros(K, i32), "acap": np.zeros(K, i32),
        "tcap": np.zeros(K, i32), "ecap": np.ones(K, i32),
        "cached": np.zeros(K, bool), "edge": np.zeros(K, bool),
        "bl": np.zeros(K, bool), "rfc": np.zeros(K, bool),
        "ideal": np.zeros(K, bool), "fam": np.zeros(K, bool),
        # wedge guard / tick cap: a traced scalar so profiling harnesses can
        # cap the fused loop without recompiling (production leaves _GUARD)
        "tmax": np.asarray(_GUARD, i64),
        # dummies whose SHAPES carry the static widths the traced step
        # needs (issue-slot unroll, meta column groups, value/counter rows)
        "slots": np.zeros(IW, np.int8),
        "mdims": np.zeros((S, PS, DD, G), np.int8),
        "rdims": np.zeros((R + 1, PR + 1), np.int8),
        "ldims": np.zeros((L + 1, DM + 1), np.int8),
    }

    def remap(a, sent_old, sent_new):
        return np.where(a == sent_old, sent_new, a).astype(np.int32)

    for k, ln in enumerate(lanes):
        c, cfg = ln.code, ln.cfg
        n = c.n_pc
        m = meta[k]
        m[: n + 1, M_KIND] = c.op_kind
        m[: n + 1, M_NACC] = c.n_acc
        m[: n + 1, M_PDST] = remap(c.pdst, c.n_preds, PR)
        m[: n + 1, M_TGT] = c.target
        m[: n + 1, M_TRIPS] = c.trips
        m[: n + 1, M_LSL] = remap(c.loop_slot, c.n_loops, L)
        m[: n + 1, M_DSL] = remap(c.dia_slot, c.n_dias, DM)
        m[: n + 1, M_IVPC] = c.interval_of_pc
        m[: n + 1, m_s: m_s + c.srcs.shape[1]] = remap(c.srcs, c.n_regs, R)
        m[: n + 1, m_ps: m_ps + c.psrcs.shape[1]] = \
            remap(c.psrcs, c.n_preds, PR)
        m[: n + 1, m_d: m_d + c.dsts.shape[1]] = remap(c.dsts, c.n_regs, R)
        m[: n + 1, m_g: m_g + c.acc_regs.shape[1]] = c.acc_regs
        nv = c.n_ivs
        co["ivt"][k, : nv + 1, 0] = c.iv_rounds
        co["ivt"][k, : nv + 1, 1] = c.iv_nfetch
        co["ivt"][k, : nv + 1, 2] = c.iv_nwb
        co["ivt"][k, : nv + 1, 3] = c.iv_has_op.astype(i32)
        co["ivregs"][k, : nv + 1, : c.iv_regs.shape[1]] = c.iv_regs
        # sentinel rows must stay inert even where lane rows ended early
        co["ivt"][k, nv, 3] = 0

        co["endpc"][k] = n
        design = cfg.design
        cached = design in _CACHED_DESIGNS
        rcap = ln.occupancy
        co["mrfc"][k] = cfg.mrf_cycles
        co["rfcc"][k] = float(cfg.rfc_cycles)
        co["brf_f"][k] = float(cfg.base_rf_cycles)
        co["wlat"][k] = (float(cfg.base_rf_cycles) if design == "Ideal"
                         else cfg.mrf_cycles if design == "BL"
                         else float(cfg.rfc_cycles))
        co["rate"][k] = cfg.num_banks / max(cfg.mrf_cycles / 6.0, 1.0)
        co["l1h"][k] = ln.workload.l1_hit
        co["xbar"][k] = float(cfg.xbar_regs_per_cycle)
        co["banksf"][k] = float(cfg.num_banks)
        co["aluf"][k] = float(cfg.alu_cycles)
        co["memf"][k] = float(cfg.mem_cycles)
        co["brf_i"][k] = cfg.base_rf_cycles
        co["l1c"][k] = cfg.l1_cycles
        co["thr"][k] = 2 * cfg.l1_cycles
        co["drint"][k] = cfg.dram_interval
        co["seed"][k] = cfg.seed
        co["maxc"][k] = cfg.max_cycles
        co["iw"][k] = cfg.issue_width
        co["nw"][k] = cfg.num_warps
        co["rcap"][k] = rcap
        co["acap"][k] = min(cfg.active_slots, rcap) if cached else rcap
        co["tcap"][k] = min(cfg.active_slots, rcap)
        co["ecap"][k] = max(1, min(cfg.rfc_entries, E))
        co["cached"][k] = cached
        co["edge"][k] = design in _EDGE_PREFETCH
        co["bl"][k] = design == "BL"
        co["rfc"][k] = design == "RFC"
        co["ideal"][k] = design == "Ideal"
        co["fam"][k] = cached

    wf = np.zeros((K, W, NWF), i64)
    wf[:, :, F_ST] = INACTIVE_READY
    wf[:, :, F_IV] = -1
    rc = np.full((K, E, 2), -1, i64)
    rc[:, :, 1] = _BIG
    st = {
        "cycle": np.zeros(K, i64),
        "guard": np.zeros((), i64),
        "alive": np.zeros(K, bool),
        "budget": np.zeros(K, bool),
        "wf": wf,
        "cf": np.zeros((K, W, 2 + S + PS), f64),
        "rv": np.zeros((K, W, RVW, 2), f64),
        "act": np.zeros((K, A), i32),
        "na": np.zeros(K, i32),
        "res": np.zeros((K, W), bool),
        "nr": np.zeros(K, i32),
        "ptr": np.zeros(K, i32),
        "pf": np.full((K, PF), _BIG, i64),
        "col": np.full((K, C), _BIG, i64),
        "tok": np.zeros(K, f64),
        "mlast": np.zeros(K, i64),
        "dnext": np.zeros(K, f64),
        "rc": rc,
        "rcnt": np.zeros(K, i32),
        "rstamp": np.zeros(K, i64),
        "bd": np.zeros((K, len(CYCLE_CATEGORIES)), i64),
        "ch": np.zeros(K, i64), "ca": np.zeros(K, i64),
        "cm": np.zeros(K, i64), "cpo": np.zeros(K, i64),
        "cpc": np.zeros(K, i64), "cps": np.zeros(K, i64),
        "cwb": np.zeros(K, i64), "cact": np.zeros(K, i64),
    }
    for k, ln in enumerate(lanes):
        cfg = ln.cfg
        st["alive"][k] = True
        # initial admit(): the first resident_cap warps, in wid order
        st["res"][k, : ln.occupancy] = True
        st["nr"][k] = ln.occupancy
        st["ptr"][k] = ln.occupancy
        st["pf"][k, : cfg.max_inflight_prefetch] = 0
        st["col"][k, : cfg.num_collectors] = 0
        st["tok"][k] = float(cfg.num_banks)
    return co, st

# --------------------------------------------------------------------------
# The lockstep run: blocks of ticks over the whole batch, on the device.
# --------------------------------------------------------------------------

_I64, _I32, _F64, _U8 = torch.int64, torch.int32, torch.float64, torch.uint8

# The plain tick's ticks a block and activation prefetch bound, per device
# type.  The CPU runs one tick a block with the exact activation (a host sync
# costs nothing there); on the card (``engine="plain"``) it runs
# `_BLOCK["cuda"]` ticks a block, captured as a CUDA graph, charging at most
# `_ACT_K["cuda"]` activation prefetches a lane and call before the block is
# rolled back and rerun exactly.
_BLOCK = {"cpu": 1, "cuda": 32}
_ACT_K = {"cpu": None, "cuda": 2}


def _scatter_reduce(x: torch.Tensor, lin: torch.Tensor, vals: torch.Tensor, reduce: str) -> None:
    """``x.at[idx].max(vals)`` / ``.min(vals)`` in place (``reduce`` is
    ``"amax"`` or ``"amin"``, ``include_self``), over the linear index
    ``lin`` of contiguous ``x``."""
    if lin.shape != vals.shape:
        lin, vals = torch.broadcast_tensors(lin, vals)
    x.view(-1).scatter_reduce_(0, lin.reshape(-1), vals.reshape(-1), reduce=reduce,
                               include_self=True)


def _trash(st: dict) -> dict:
    """Numpy state -> the same arrays with one trash slot on the planes that
    take out-of-bounds or masked-off scatters: ``rv`` (index RVW), ``rc``
    (row E), ``act`` (column A) and ``cf`` (warp W).  XLA drops an
    out-of-bounds write; PyTorch raises on the CPU and asserts on the card."""
    st = dict(st)
    K, W, RVW, _ = st["rv"].shape
    st["rv"] = np.concatenate([st["rv"], np.zeros((K, W, 1, 2), st["rv"].dtype)], axis=2)
    pad = np.full((K, 1, 2), -1, st["rc"].dtype)
    pad[:, :, 1] = _BIG
    st["rc"] = np.concatenate([st["rc"], pad], axis=1)
    st["act"] = np.concatenate([st["act"], np.zeros((K, 1), st["act"].dtype)], axis=1)
    st["cf"] = np.concatenate([st["cf"], np.zeros((K, 1, st["cf"].shape[2]), st["cf"].dtype)],
                              axis=1)
    return st


def _untrash(s: dict, W: int, RVW: int, E: int, A: int) -> dict:
    out = dict(s)
    out["rv"] = s["rv"][:, :, :RVW]
    out["rc"] = s["rc"][:, :E]
    out["act"] = s["act"][:, :A]
    out["cf"] = s["cf"][:, :W]
    return out


def _tick_fn(co, dims):
    """The reference's ``tick`` (``repro.sim.batch._run_jax``) over device
    tensors.  ``co`` holds the constants, ``dims`` the static widths; the
    returned ``tick(s, k)`` advances the state dict ``s`` (with trash slots)
    by one tick, updating its planes in place, and returns a device flag:
    whether some lane had more than ``k`` activation prefetches in one call
    (``None`` when ``k`` is ``None``: exact, with a host sync a call)."""
    (K, W, NWF, A, E, P, S, PS, DD, G, R, PRS, RVW, LS, DS, IVS, IW) = dims
    dev = co["meta"].device
    NCAT = len(CYCLE_CATEGORIES)
    M_S, M_PS, M_D, M_G = _meta_cols(S, PS, DD)
    F_DC = _F_LC + LS + 1
    READY, WAIT = INACTIVE_READY, INACTIVE_WAIT
    RV1 = RVW + 1                        # rv rows with the trash slot
    kk = torch.arange(K, device=dev)
    kc = kk[:, None]
    wI = torch.arange(W, device=dev)
    aI = torch.arange(A, device=dev)
    ctrI = torch.arange(NWF - _F_LC, device=dev)
    catI = torch.arange(NCAT, device=dev)
    BIG = int(_BIG)
    INF = float("inf")
    # float64 divisors as device tensors: a CUDA division by a Python scalar
    # is a product with its reciprocal (not the IEEE quotient)
    D65535 = torch.tensor(65535.0, dtype=_F64, device=dev)
    D8191 = torch.tensor(8191.0, dtype=_F64, device=dev)
    # the int32 tables widened once, so no gathered value needs a cast
    meta, ivtab, ivregs = co["meta"].long(), co["ivt"].long(), co["ivregs"].long()
    # per-chunk tables derived once: each pc's readiness operands as rv rows
    # (sources, then predicates at R+1+p), its interval, and the lanes'
    # read latency for a non-RFC read (the reference's `read_lat` chain)
    sp_idx = torch.cat([meta[:, :, M_S: M_S + S], R + 1 + meta[:, :, M_PS: M_PS + PS]],
                       dim=2).long()
    ivpc = meta[:, :, M_IVPC].contiguous()
    rl0 = torch.where(co["ideal"], co["brf_f"], torch.where(co["bl"], co["mrfc"], co["rfcc"]))
    slot_on_iw = [j < co["iw"] for j in range(IW)]
    rv_row = kk * (W * RV1 * 2)          # linear offset of each lane's rv plane
    # each pc's static facts, gathered once an issue: its kind and branch
    # class, and which writeback columns (DD registers, then the predicate)
    # a successful issue writes, into which rv rows (RVW: none), and which
    # of them record a load (the reference's `ond`/`onp` and `vm`, :866-878)
    kind = meta[:, :, M_KIND]
    lsl, dsl, pd = meta[:, :, M_LSL], meta[:, :, M_DSL], meta[:, :, M_PDST]
    k_bra, k_ext, k_ld, k_set = (kind == _OP_BRA, kind == _OP_EXIT, kind == _OP_LD,
                                 kind == _OP_SET)
    uncond = meta[:, :, M_PS] >= PRS
    no_b = torch.zeros_like(k_set)
    pflags = torch.stack(
        [k_bra, k_ext, ~(k_bra | k_ext), k_ld, k_set, uncond, lsl < LS, ~uncond & (lsl >= LS),
         ~k_ext] + [~k_set] * DD + [k_set] + [k_ld] * DD + [no_b], dim=2)
    dsts = meta[:, :, M_D: M_D + DD]
    pcols = torch.cat([
        torch.stack([_F_LC + lsl, F_DC + dsl, LS + 1 + dsl], dim=2),
        torch.where(dsts < R, dsts, RVW), torch.where(pd < PRS, R + 1 + pd, RVW)[:, :, None]],
        dim=2)
    meta = torch.cat([meta, pcols], dim=2)
    X_LCOL, X_DCOL, X_DCTR, X_WIX = range(M_G + G, M_G + G + 4)   # derived columns
    (B_BRA, B_EXT, B_OPND, B_LD, B_SET, B_UNC, B_LOOP, B_DIA, B_NEXT,
     B_WR) = range(10)
    B_VM = B_WR + DD + 1
    # the hash terms fixed per (lane, warp): reference :850-851 and :899
    h_w = wI * 2654435761 + co["seed"][:, None] * 97
    hh_w = wI * 31 + co["seed"][:, None]
    # which lane kinds the chunk holds: a branch of the tick that only some
    # kinds take is left out where the chunk has none of them (the
    # reference's `E > 1` gate, extended); it would select its no-op for
    # every lane
    has_cached = bool(co["cached"].any())    # activation prefetch, deactivation
    has_edge = bool(co["edge"].any())        # edge prefetch
    has_bl = bool(co["bl"].any())
    has_bw = has_bl or E > 1                 # the MRF token bucket
    has_budget = bool((co["maxc"] > 0).any())  # the cycle-budget watchdog
    alw = co["aluf"] + co["wlat"]
    zero_b = torch.zeros(K, dtype=torch.bool, device=dev)
    # the most activation prefetches one call can charge a lane (its acap)
    pf_bound = int(torch.where(co["cached"], co["acap"], 0).max()) if has_cached else 0

    def rnd(x):
        """The reference's ``rnd`` (:655-662) keeps XLA from contracting a
        float product into the add that consumes it (one rounding instead of
        two).  Eager PyTorch runs the product as its own kernel, which rounds
        it to float64 in memory, so this is the identity; it names the sites
        where a fused multiply-add must never form."""
        return x

    # each lane's interval prefetch latency, per interval (the reference's
    # `lat`, :729 and :916, by the same operations)
    ivlat = rnd(ivtab[:, :, 0].to(_F64) * co["mrfc"][:, None]) \
        + ivtab[:, :, 1].to(_F64) / co["xbar"][:, None]

    def refresh_cf(s, wid, mask, pcc):
        """Readiness-cache row of one selected warp per lane at pc ``pcc``
        (:664-683); a masked-off row goes to the trash warp W."""
        rvw = s["rv"][kc, wid[:, None], sp_idx[kk, pcc]]     # (K, S+PS, 2)
        t = rvw[:, :, 0]
        cmem = torch.where(rvw[:, :S, 1] > 0.0, t[:, :S], 0.0).amax(dim=1)
        newcf = torch.cat([t.amax(dim=1, keepdim=True), cmem[:, None], t], dim=1)
        s["cf"][kk, torch.where(mask, wid, W)] = newcf

    def prefetch_slot(s, body, lat):
        """One prefetch op into the inflight-slot array, masked (:685-694)."""
        slot = torch.argmin(s["pf"], dim=1, keepdim=True)   # first min (:689)
        freet = s["pf"].gather(1, slot)[:, 0]
        done = (torch.maximum(s["cycle"], freet).to(_F64) + lat).to(_I64)  # int(start + lat)
        s["pf"].scatter_(1, slot, torch.where(body, done, freet)[:, None])
        return done

    def rv_lin(wid, ridx, col):
        """Linear rv index of (lane, warp ``wid``, row ``ridx``, ``col``)."""
        return (rv_row + wid * (RV1 * 2))[:, None] + (ridx * 2 + col)

    def activation(s, act, k):
        """Greedy lowest-wid-ready activation (:705-755), all of a call's
        activations at once.  The reference's loop activates, one pass at a
        time, each lane's lowest-wid READY resident warp while the lane has
        room; the warps it takes are the lane's first ``acap - na`` READY
        resident ones in wid order, and every effect of an activation is on
        that warp's own rows except the inflight-prefetch slots, which the
        prefetching warps take in wid order (a loop of ``k`` steps, or as
        many as the largest lane needs when ``k`` is None)."""
        st_col = s["wf"][:, :, F_ST]
        cand = s["res"] & (st_col == READY)
        rank = torch.cumsum(cand.to(_I32), dim=1) - 1
        room = torch.where(act, co["acap"] - s["na"], 0)
        actv = cand & (rank < room[:, None])
        s["act"][kc, torch.where(actv, s["na"][:, None] + rank, A).long()] = wI.to(_I32)
        n = actv.sum(dim=1)
        s["na"] = s["na"] + n.to(_I32)
        s["cact"] += n
        if not has_cached:       # no lane prefetches at activation
            s["wf"][:, :, F_ST] = torch.where(actv, ACTIVE, st_col)
            return None if k is None else torch.zeros((), dtype=torch.bool, device=dev)
        # _start_prefetch(force=True) for every activating warp
        pcc = torch.clamp(s["wf"][:, :, F_PC], max=P)
        iid = ivpc[kc, pcc]                                  # (K, W)
        go = actv & co["cached"][:, None] & (iid >= 0)
        ii = torch.where(go, iid, IVS).long()
        ivt = ivtab[kc, ii]                              # (K, W, 4)
        body = go & (ivt[:, :, 3] > 0)
        nf = ivt[:, :, 1]
        lat = ivlat[kc, ii]
        # the slot array, taken by the prefetching warps in wid order
        bcum = torch.cumsum(body.to(_I32), dim=1) - 1
        nb = body.sum(dim=1)
        steps = int(nb.max()) if k is None else min(k, pf_bound)
        order = torch.full((K, pf_bound + 1), W, dtype=_I64, device=dev)
        order[kc, torch.where(body, bcum, pf_bound).long()] = wI
        latp = torch.cat([lat, torch.zeros((K, 1), dtype=_F64, device=dev)], dim=1)
        dones = []
        for j in range(steps):
            lat_j = latp.gather(1, order[:, j: j + 1])[:, 0]
            dones.append(prefetch_slot(s, nb > j, lat_j))
        if dones:
            done = torch.stack(dones, dim=1).gather(1, torch.clamp(bcum, 0, steps - 1).long())
        else:
            done = torch.zeros((K, W), dtype=_I64, device=dev)
        s["cpo"] += nb
        s["cpc"] += torch.where(body, lat.to(_I64), 0).sum(dim=1)
        s["cps"] += torch.where(body, done - s["cycle"][:, None], 0).sum(dim=1)
        s["cm"] += torch.where(body, nf, 0).sum(dim=1)
        # max each fetched interval's registers up to its landing time
        regs = ivregs[kc, ii]                                # (K, W, GV)
        vp = (regs >= 0) & body[:, :, None]
        lin = (rv_row[:, None] + wI * (RV1 * 2))[:, :, None] + torch.where(vp, regs, RVW) * 2
        _scatter_reduce(s["rv"], lin, torch.where(vp, done.to(_F64)[:, :, None], 0.0), "amax")
        s["wf"][:, :, F_ST] = torch.where(body, PREFETCH, torch.where(actv, ACTIVE, st_col))
        s["wf"][:, :, F_IV] = torch.where(go, iid.to(_I64), s["wf"][:, :, F_IV])
        s["wf"][:, :, F_RA] = torch.where(body, done, s["wf"][:, :, F_RA])
        # readiness rows of the prefetching warps
        rvw = s["rv"][kc[:, :, None], wI[None, :, None], sp_idx[kc, pcc]]  # (K, W, S+PS, 2)
        t = rvw[:, :, :, 0]
        cmem = torch.where(rvw[:, :, :S, 1] > 0.0, t[:, :, :S], 0.0).amax(dim=2)
        newcf = torch.cat([t.amax(dim=2, keepdim=True), cmem[:, :, None], t], dim=2)
        s["cf"][:, :W] = torch.where(body[:, :, None], newcf, s["cf"][:, :W])
        return None if k is None else (nb > steps).any()

    def issue_one(s, picked, wsel, cycf, base):
        """The _issue body for one selected warp per lane (:757-944);
        ``base`` is the tick's (cycle + read latency, + alu, + alu + write)
        for lanes without an RFC."""
        row = s["wf"][kk, wsel]                              # (K, NWF)
        pcs = row[:, F_PC]
        pcc = torch.clamp(pcs, max=P)
        md = meta[kk, pcc]                                   # (K, MW + derived)
        fl = pflags[kk, pcc]                                 # (K, flags)
        bra = picked & fl[:, B_BRA]
        ext = picked & fl[:, B_EXT]
        opnd = picked & fl[:, B_OPND]
        is_ld, is_set = fl[:, B_LD], fl[:, B_SET]
        nacc = md[:, M_NACC]
        if E > 1:
            # RFC classification against the pre-issue cache state
            regs = md[:, M_G: M_G + G]                       # (K, G)
            onr = (regs >= 0) & (opnd & co["rfc"])[:, None]
            keyv = torch.where(onr, wsel[:, None] * (R + 1) + regs, -2)
            eq = s["rc"][:, None, :E, 0] == keyv[:, :, None]  # (K, G, E)
            memb = eq.any(dim=2)
            n_miss = (onr & ~memb).sum(dim=1)
            n_hit = memb.sum(dim=1)
            n_bw = torch.where(co["bl"], torch.where(opnd, nacc, 0),
                               torch.where(co["rfc"], n_miss, 0))
        elif has_bl:   # no RFC lane: the reference's RFC branches select their zeros
            n_bw = torch.where(co["bl"] & opnd, nacc, 0)
        cslot = torch.argmin(s["col"], dim=1, keepdim=True)  # first min (:798)
        cfree = s["col"].gather(1, cslot)[:, 0]
        ok = opnd & (cfree <= s["cycle"])
        if has_bw:
            # MRF bandwidth token bucket, refilled only on a non-zero request
            do_bw = opnd & (n_bw > 0)
            refill = do_bw & (s["cycle"] > s["mlast"])
            newtok = torch.minimum(
                co["banksf"],
                s["tok"] + rnd(co["rate"] * (s["cycle"] - s["mlast"]).to(_F64)))
            tok = torch.where(refill, newtok, s["tok"])
            s["mlast"] = torch.where(refill, s["cycle"], s["mlast"])
            n_bwf = n_bw.to(_F64)
            bw_ok = ~do_bw | (tok >= n_bwf)
            s["tok"] = torch.where(do_bw & bw_ok, tok - n_bwf, tok)
            ok = ok & bw_ok
        s["col"].scatter_(1, cslot, torch.where(ok, base["col"], cfree)[:, None])
        sfail = opnd & ~ok
        if E > 1:
            read_lat = torch.where(co["rfc"] & (n_miss > 0), co["mrfc"], rl0)
            s["cm"] += torch.where(ok, torch.where(co["bl"], nacc,
                                                   torch.where(co["rfc"], n_miss, 0)), 0)
            s["ca"] += torch.where(ok & (co["rfc"] | co["fam"]), nacc, 0)
            s["ch"] += torch.where(ok, torch.where(co["rfc"], n_hit,
                                                   torch.where(co["fam"], nacc, 0)), 0)
            # RFC LRU: move-to-end by one scatter-max of monotone stamps
            # (:820-829; a masked write goes to the trash row E), then the
            # insert/evict phase in operand order (:830-845)
            lru = ok & co["rfc"]
            hvs = lru[:, None] & memb                        # (K, G)
            hvi = hvs.to(_I64)
            stamps = s["rstamp"][:, None] + torch.cumsum(hvi, dim=1) - hvi
            pos = torch.argmax(eq.to(_U8), dim=2)            # first match (:825)
            lin = (kk * ((E + 1) * 2))[:, None] + torch.where(hvs, pos, E) * 2 + 1
            _scatter_reduce(s["rc"], lin, stamps, "amax")
            s["rstamp"] = s["rstamp"] + hvi.sum(dim=1)
            for i in range(G):
                ki = keyv[:, i]
                membL = (s["rc"][:, :E, 0] == ki[:, None]).any(dim=1)
                ins = lru & (ki >= 0) & ~membL
                full = s["rcnt"] >= co["ecap"]
                slot = torch.where(full, torch.argmin(s["rc"][:, :E, 1], dim=1).to(_I32),
                                   s["rcnt"])                # first min (:836)
                slot = torch.clamp(slot, max=E - 1).long()
                newr = torch.stack([ki, s["rstamp"]], dim=1)
                s["rc"][kk, slot] = torch.where(ins[:, None], newr, s["rc"][kk, slot])
                s["rstamp"] = s["rstamp"] + ins.to(_I64)
                s["rcnt"] = s["rcnt"] + (ins & ~full).to(_I32)
            rl = cycf + read_lat
            set_at, alu_at = rl + co["aluf"], rl + alw
        else:
            rl, set_at, alu_at = base["rl"], base["set"], base["alu"]
            if has_bl:
                s["cm"] += torch.where(ok & co["bl"], nacc, 0)
            if has_cached:
                fam = torch.where(ok & co["fam"], nacc, 0)
                s["ca"] += fam
                s["ch"] += fam
        # memory latency: jitter hash (int64 throughout) + DRAM queue (:846-858)
        ldo = ok & is_ld
        mops = row[:, F_MO]
        h = (h_w[kk, wsel] + mops * 40503) & 0xFFFF
        hit = (h.to(_F64) / D65535) < co["l1h"]
        spread = rnd(((h >> 3).to(_F64) / D8191 - 0.5) * 0.6)
        dstart = torch.maximum(cycf, s["dnext"])
        s["dnext"] = torch.where(ldo & ~hit, dstart + co["drint"], s["dnext"])
        mlat = torch.where(hit, co["l1c"],
                           (dstart - cycf + rnd(co["memf"] * (1.0 + spread))).to(_I64))
        # writeback chain (:859-864): done_at = base + ..., base = cycle + read_lat
        da = torch.where(is_set, set_at,
                         torch.where(is_ld, rl + (mlat.to(_F64) + co["wlat"]), alu_at))
        # dst-register + dst-predicate writeback, one scatter; masked rows go
        # to the trash slot RVW (:865-880)
        wmask = ok[:, None] & fl[:, B_WR: B_WR + DD + 1]
        wix = torch.where(wmask, md[:, X_WIX: X_WIX + DD + 1], RVW)   # (K, DD+1)
        vm = (ok[:, None] & fl[:, B_VM: B_VM + DD + 1]).to(_F64)
        s["rv"][kc, wsel[:, None], wix] = torch.stack([da[:, None].expand(K, DD + 1), vm], dim=2)
        happened = bra | ext | ok
        # branch resolution (:882-904); a loop's counter column and a
        # diamond's are the pc's own (masked by isl / isd where the reference
        # clamps to its sentinel column), so both gathers stay in bounds
        isl = bra & fl[:, B_LOOP]
        c = row.gather(1, md[:, X_LCOL: X_LCOL + 1])[:, 0] + 1   # (:892)
        tkl = c < md[:, M_TRIPS]
        isd = bra & fl[:, B_DIA]
        v = row.gather(1, md[:, X_DCOL: X_DCOL + 1])[:, 0]       # (:898)
        # (hh & 0xFF) & 1 == hh & 1
        hodd = ((hh_w[kk, wsel] + v * 17) & 1) == 1
        taken = fl[:, B_UNC] | torch.where(isl, tkl, hodd)
        pc1 = pcs + 1
        npc = torch.where(bra, torch.where(taken, md[:, M_TGT], pc1),
                          torch.where(ok, pc1, pcs))
        npce = torch.where(picked & fl[:, B_NEXT], npc, pcs)
        # edge prefetch at the post-update pc (:905-923)
        pccp = torch.clamp(npce, max=P)
        st_new, iv_new, ra_new = row[:, F_ST], row[:, F_IV], row[:, F_RA]
        if has_edge:
            ep = co["edge"] & (bra | ok) & (npc < co["endpc"])
            iid = ivpc[kk, pccp]
            go = ep & (iid >= 0) & (iid != row[:, F_IV])
            ii = torch.where(go, iid, IVS)
            ivt = ivtab[kk, ii]
            body = go & (ivt[:, 3] > 0)
            nf = ivt[:, 1]
            lat = ivlat[kk, ii]
            done = prefetch_slot(s, body, lat)
            s["cpo"] += body.to(_I64)
            s["cpc"] += torch.where(body, lat.to(_I64), 0)
            s["cps"] += torch.where(body, done - s["cycle"], 0)
            s["cm"] += torch.where(body, nf, 0)
            regs = ivregs[kk, ii]                            # (K, GV)
            vp = (regs >= 0) & body[:, None]
            _scatter_reduce(s["rv"], rv_lin(wsel, torch.where(vp, regs, RVW), 0),
                            torch.where(vp, done[:, None].to(_F64), 0.0), "amax")
            st_new = torch.where(body, PREFETCH, st_new)
            iv_new = torch.where(go, iid, iv_new)
            ra_new = torch.where(body, done, ra_new)
        # one warp-family row write (:924-942)
        ctr = row[:, _F_LC:]
        ctr = torch.where(isl[:, None] & (ctrI == (md[:, X_LCOL] - _F_LC)[:, None]),
                          torch.where(tkl, c, 0)[:, None], ctr)
        ctr = torch.where(isd[:, None] & (ctrI == md[:, X_DCTR, None]), (v + 1)[:, None], ctr)
        s["wf"][kk, wsel] = torch.cat(
            [torch.where(ext, DONE, st_new)[:, None], npce[:, None], iv_new[:, None],
             ra_new[:, None], (row[:, F_IS] + happened.to(_I64))[:, None],
             (mops + ldo.to(_I64))[:, None], ctr], dim=1)
        refresh_cf(s, wsel, happened, pccp)
        return happened, sfail

    def tick(s, k):
        # the reference's loop condition `running` (:1099-1100), evaluated on
        # the device: a tick past it changes nothing and is not counted
        run = s["alive"].any() & (s["guard"] <= co["tmax"])
        s["guard"] = s["guard"] + run.to(_I64)
        if has_budget:   # cycle-budget watchdog (:948-952)
            exceed = s["alive"] & run & (co["maxc"] > 0) & (s["cycle"] > co["maxc"])
            s["budget"] = s["budget"] | exceed
            s["alive"] = s["alive"] & ~exceed
        act = s["alive"] & run
        # wake: WAIT->READY, PREFETCH->ACTIVE once ready_at arrives (:954-960)
        stp = s["wf"][:, :, F_ST]
        wake = s["res"] & act[:, None] & (s["wf"][:, :, F_RA] <= s["cycle"][:, None])
        s["wf"][:, :, F_ST] = torch.where(
            wake & (stp == WAIT), READY, torch.where(wake & (stp == PREFETCH), ACTIVE, stp))
        ovf = activation(s, act, k)
        # issue slots: round-robin rank arithmetic (:962-1005); `%` is
        # torch.remainder, Python's sign rule, as jnp's
        actl = s["act"][:, :A]
        posv = aI < s["na"][:, None]
        wida = torch.where(posv, actl, 0).long()
        nz = torch.clamp(s["na"], min=1).to(_I64)
        rank = torch.where(posv, (aI - (s["cycle"] % nz)[:, None]) % nz[:, None], BIG)
        cycf = s["cycle"].to(_F64)
        thr = (s["cycle"] + co["thr"]).to(_F64)[:, None]
        base = {"col": s["cycle"] + co["brf_i"]}
        if E == 1:
            base["rl"] = cycf + rl0
            base["set"], base["alu"] = base["rl"] + co["aluf"], base["rl"] + alw
        wrow = kc * W + wida                                 # (K, A) warp rows of the active list
        ndacc = msacc = None
        issue_any = struct = None
        for j in range(IW):
            slot_on = act & slot_on_iw[j]
            wfa = s["wf"].view(-1, NWF)[wrow]                # (K, A, NWF)
            cfa = s["cf"][kc, wida]                          # (K, A, CW)
            isact = posv & (wfa[:, :, F_ST] == ACTIVE)
            atend = wfa[:, :, F_PC] >= co["endpc"][:, None]
            live = isact & ~atend
            ready = live & (cfa[:, :, 0] <= cycf[:, None])
            rrk = torch.where(ready & slot_on[:, None], rank, BIG)
            crank = rrk.amin(dim=1)
            picked = (crank < BIG) & slot_on
            visited = posv & slot_on[:, None] & (rank <= crank[:, None])
            nd = visited & isact & atend
            ndacc = nd if ndacc is None else ndacc | nd
            if has_cached:   # only cached lanes deactivate the stalled warps
                # blocked on long memory <=> blocked > 0 (:991-1001)
                ms = visited & live & ~ready & (cfa[:, :, 1] > thr)
                mv = torch.where(ms, cfa[:, :, 1], 0.0)
                msacc = mv if msacc is None else torch.maximum(msacc, mv)
            wsel = actl.gather(1, torch.argmin(rrk, dim=1, keepdim=True))[:, 0].long()  # (:1002)
            happened, sfail = issue_one(s, picked, wsel, cycf, base)
            issue_any = happened if issue_any is None else issue_any | happened
            struct = sfail if struct is None else struct | sfail
        # deferred DONE marks and stall times, scatter-max (:1006-1008)
        _scatter_reduce(s["wf"], wrow * NWF + F_ST, torch.where(ndacc, DONE, 0), "amax")
        if has_cached:
            stall_until = torch.zeros((K, W), dtype=_F64, device=dev)
            _scatter_reduce(stall_until, wrow, msacc, "amax")
            # two-level deactivation (:1009-1022)
            stp2 = s["wf"][:, :, F_ST]
            de = (stall_until > 0) & (stp2 == ACTIVE) & (co["cached"] & act)[:, None]
            ivv = s["wf"][:, :, F_IV]
            ii = torch.where(de & (ivv >= 0), ivv, IVS)
            nwb = torch.where(de, ivtab[kc, ii, 2], 0).sum(dim=1)
            s["cwb"] += nwb
            s["cm"] += nwb
            newst = torch.where(de, WAIT, stp2)
            newra = torch.where(de, stall_until.to(_I64), s["wf"][:, :, F_RA])
            newiv = torch.where(de, -1, ivv)
            s["wf"][:, :, F_ST] = newst
            s["wf"][:, :, F_RA] = newra
            s["wf"][:, :, F_IV] = newiv
        # compact the active list; dropped positions go to the trash
        # column A (:1023-1033)
        stw = s["wf"].view(-1)[wrow * NWF + F_ST]
        done_w = stw == DONE
        gone = posv & act[:, None] & ((stw == WAIT) | done_w)
        keep = posv & ~gone
        cpos = torch.where(keep, torch.cumsum(keep.to(_I32), dim=1) - 1, A).long()
        newact = torch.zeros_like(s["act"])
        newact[kc, cpos] = wida.to(_I32)
        s["act"] = newact
        s["na"] = keep.sum(dim=1).to(_I32)
        # retire DONE warps (a bool scatter-min, done in uint8: :1034-1036),
        # admit pending warps (:1037-1045)
        donep = posv & act[:, None] & done_w
        res8 = s["res"].to(_U8)
        _scatter_reduce(res8, wrow, (~donep).to(_U8), "amin")
        s["nr"] = s["nr"] - donep.sum(dim=1).to(_I32)
        nadm = torch.clamp(torch.minimum(co["nw"] - s["ptr"], co["rcap"] - s["nr"]), min=0)
        nadm = torch.where(act, nadm, 0)
        newres = (wI >= s["ptr"][:, None]) & (wI < (s["ptr"] + nadm)[:, None])
        s["res"] = res8.bool() | newres
        s["nr"] = s["nr"] + nadm
        s["ptr"] = s["ptr"] + nadm
        ovf2 = activation(s, act, k)
        # terminate finished lanes (:1050-1053)
        fin = act & (s["nr"] == 0) & (s["ptr"] >= co["nw"])
        s["alive"] = s["alive"] & ~fin
        adv = act & ~fin
        # classify the zero-issue cycle, find the next event (:1054-1092)
        cf = s["cf"][:, :W]
        stc = s["wf"][:, :, F_ST]
        livew = (stc == ACTIVE) & (s["wf"][:, :, F_PC] < co["endpc"][:, None])
        cyc = s["cycle"]
        # WAIT and PREFETCH are cached lanes' states (deactivation, prefetch)
        saw_pf = (stc == PREFETCH).any(dim=1) if has_cached else zero_b
        saw_mem = (livew & (cf[:, :, 1] > cycf[:, None])).any(dim=1)
        saw_dep = (livew & (cf[:, :, 0] > cycf[:, None])).any(dim=1)
        drain = (s["ptr"] >= co["nw"]) & (s["nr"] < co["tcap"])
        cat = torch.where(drain, _CAT_INDEX["drain"],
              torch.where(struct, _CAT_INDEX["bank_conflict"],
              torch.where(saw_pf, _CAT_INDEX["prefetch_stall"],
              torch.where(saw_mem, _CAT_INDEX["mem_stall"],
              torch.where(saw_dep, _CAT_INDEX["alu_dep"],
                          _CAT_INDEX["scheduler_idle"])))))
        colf = s["col"].amin(dim=1)
        c1 = torch.where(colf > cyc, colf.to(_F64), INF)
        if has_cached:
            wnp = s["res"] & ((stc == WAIT) | (stc == PREFETCH))
            c1 = torch.minimum(c1, torch.where(wnp, s["wf"][:, :, F_RA].to(_F64), INF).amin(dim=1))
        # pending source and predicate times (:1079-1084): one min over both
        tv = cf[:, :, 2:]
        tsp = torch.where(livew[:, :, None] & (tv > cycf[:, None, None]), tv, INF).amin(dim=(1, 2))
        best = torch.minimum(c1, tsp)
        cyc1 = cyc + 1
        nxt = torch.where(torch.isinf(best), cyc1, torch.maximum(best.to(_I64), cyc1))
        delta = torch.where(issue_any, 1, nxt - cyc)
        cati = torch.where(issue_any, 0, cat)
        oh = (catI == cati[:, None]) & adv[:, None]
        s["bd"] = s["bd"] + torch.where(oh, delta[:, None], 0)
        s["cycle"] = cyc + torch.where(adv, delta, 0)
        if k is None:
            return None
        return ovf | ovf2

    tick.static_bound = pf_bound     # an activation bound that cannot overflow
    return tick


def _dims(co: dict, st: dict) -> tuple:
    """Static widths of one chunk (``st`` without trash slots)."""
    K, W, NWF = st["wf"].shape
    S, PS, DD, G = co["mdims"].shape
    return (K, W, NWF, st["act"].shape[1], st["rc"].shape[1],
            co["meta"].shape[1] - 1, S, PS, DD, G,
            co["rdims"].shape[0] - 1, co["rdims"].shape[1] - 1, st["rv"].shape[2],
            co["ldims"].shape[0] - 1, co["ldims"].shape[1] - 1,
            co["ivt"].shape[1] - 1, co["slots"].shape[0])


class _Chunk:
    """One chunk's lockstep run on a device.

    State tensors are allocated once (static, so a CUDA graph can capture
    them); `launch` enqueues one block of ticks on the chunk's stream and
    `settle` reads the block's flags (one host sync a block), rolls the block
    back and reruns it exactly when its activation bound ``k`` overflowed,
    and marks the chunk done once no lane runs.  The first block always runs
    eagerly and exactly (it activates every lane's first warps).  On the card
    the next blocks replay one captured graph (snapshot, then the block under
    ``k``), and a rerun replays a second one (restore, then the block under
    the chunk's static bound, which cannot overflow); without graphs a rerun
    is the exact block run eagerly."""

    def __init__(self, co: dict, st: dict, device: torch.device, *,
                 block: int | None = None, act_k="device", graphs: bool | None = None):
        kind = device.type
        self.device = device
        self.block = block or _BLOCK.get(kind, 1)
        self.k = _ACT_K.get(kind) if act_k == "device" else act_k
        self.graphs = (kind == "cuda") if graphs is None else graphs
        self.dims = _dims(co, st)
        self.co = _place(co, device)
        self.s = _place(_trash(st), device)
        self.tick = _tick_fn(self.co, self.dims)
        self.flags = torch.ones(2, dtype=torch.bool, device=device)  # running, overflow
        self.snap = {k: torch.empty_like(t) for k, t in self.s.items()}
        self.captured = {}
        self.stream = torch.cuda.Stream(device) if kind == "cuda" else None
        self.started = False
        self.done = False
        self.stats = {"blocks": 0, "eager_blocks": 0, "replays": 0, "reruns": 0,
                      "captures": 0, "capture_s": 0.0}

    def _ctx(self):
        return torch.cuda.stream(self.stream) if self.stream is not None else nullcontext()

    def _running(self):
        return self.s["alive"].any() & (self.s["guard"] <= self.co["tmax"])

    def _block(self, k) -> None:
        """T ticks on the static state, in place; flags <- (running, overflow)."""
        s = dict(self.s)
        ovf = None
        for _ in range(self.block):
            o = self.tick(s, k)
            if o is not None:
                ovf = o if ovf is None else ovf | o
        for key, t in self.s.items():
            if s[key] is not t:
                t.copy_(s[key])
        if ovf is None:
            ovf = torch.zeros((), dtype=torch.bool, device=self.device)
        self.flags.copy_(torch.stack([self._running(), ovf]))

    def _copy(self, dst: dict, src: dict) -> None:
        for key, t in dst.items():
            t.copy_(src[key])

    def _graph(self, rerun: bool):
        """The block's graph (captured at first use): snapshot, then the
        block under ``k``; or, for a rerun, restore, then the block under the
        static bound."""
        g = self.captured.get(rerun)
        if g is None:
            t0 = time.perf_counter()
            g = self.captured[rerun] = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g, stream=self.stream):
                if rerun:
                    self._copy(self.s, self.snap)
                    self._block(self.tick.static_bound)
                else:
                    self._copy(self.snap, self.s)
                    self._block(self.k)
            self.stats["captures"] += 1
            self.stats["capture_s"] += time.perf_counter() - t0
        return g

    def launch(self) -> None:
        if self.done:
            return
        with self._ctx():
            if not self.started or self.k is None:
                self.started = True
                self._block(None)
                self.stats["eager_blocks"] += 1
            elif not self.graphs:
                self._copy(self.snap, self.s)
                self._block(self.k)
                self.stats["eager_blocks"] += 1
            else:
                self._graph(False).replay()
                self.stats["replays"] += 1
            self.stats["blocks"] += 1

    def settle(self) -> None:
        if self.done:
            return
        with self._ctx():
            running, overflow = self.flags.tolist()
            if overflow:
                # the bound k left activation work undone inside the block:
                # roll it back and rerun it exactly
                if self.graphs:
                    self._graph(True).replay()
                else:
                    self._copy(self.s, self.snap)
                    self._block(None)
                self.stats["reruns"] += 1
                running = bool(self.flags[0])
        self.done = not running

    def state(self) -> dict:
        """The final state: the reference's keys, shapes and dtypes."""
        K, W, NWF, A, E = self.dims[:5]
        return _untrash(self.s, W, self.dims[12], E, A)


# The numbering csrc/sim_batch.cu is compiled with, the part of its layout
# string after the planes and widths (``kernels.sim_batch.layout``): warp
# status, opcode kind, warp row and meta columns, each in number order, then
# the cycle categories.
_KERNEL_NUMBERING = ";".join(
    f"{section}=" + ",".join(name for _, name in sorted(names.items())) for section, names in (
        ("status", {ACTIVE: "ACTIVE", INACTIVE_READY: "READY", INACTIVE_WAIT: "WAIT",
                    PREFETCH: "PREFETCH", DONE: "DONE"}),
        ("ops", {_OP_OTHER: "OTHER", _OP_BRA: "BRA", _OP_EXIT: "EXIT", _OP_SET: "SET",
                 _OP_LD: "LD"}),
        ("wf", {F_ST: "ST", F_PC: "PC", F_IV: "IV", F_RA: "RA", F_IS: "IS", F_MO: "MO",
                _F_LC: "LC"}),
        ("meta", {M_KIND: "KIND", M_NACC: "NACC", M_PDST: "PDST", M_TGT: "TGT",
                  M_TRIPS: "TRIPS", M_LSL: "LSL", M_DSL: "DSL", M_IVPC: "IVPC"}),
        ("cats", dict(enumerate(CYCLE_CATEGORIES)))))


def _place(arrays: dict, device: torch.device) -> dict:
    """Numpy arrays -> tensors on ``device``."""
    return {k: torch.from_numpy(np.array(v)).to(device) for k, v in arrays.items()}


def _card_stream(device: torch.device):
    return torch.cuda.Stream(device)


class _KernelChunk:
    """One chunk's run on the card as one launch of ``csrc/sim_batch.cu``,
    on the chunk's own stream: the planes are placed as `_Chunk` places
    them, the kernel runs every lane to completion, and the state reads as
    `_Chunk`'s does.  No block, no activation bound, no snapshot, no graph;
    ``stats`` keeps `_Chunk`'s keys (one block, nothing captured) and adds
    ``kernel_ms``, the launch's time on the card (CUDA events), and the
    launch's ``route`` and ``image_bytes`` (a lane's image in shared memory)."""

    def __init__(self, co: dict, st: dict, device: torch.device):
        if device.type != "cuda":
            raise ValueError(f"the batch simulator's kernel runs on a CUDA device, not "
                             f"{device}; the CPU runs the plain tick (engine='plain')")
        self.device = device
        self.dims = _dims(co, st)
        self.co = _place(co, device)
        self.s = _place(_trash(st), device)
        self.stream = _card_stream(device)
        self.events = None
        self.done = False
        self.stats = {"blocks": 0, "eager_blocks": 0, "replays": 0, "reruns": 0,
                      "captures": 0, "capture_s": 0.0, "kernel_ms": None, "route": None,
                      "image_bytes": None}

    def launch(self) -> None:
        if self.done:
            return
        # the planes were copied on the device's current stream
        self.stream.wait_stream(torch.cuda.current_stream(self.device))
        self.events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        with torch.cuda.stream(self.stream):
            self.events[0].record()
            self.stats.update(sim_batch(self.co, self.s, self.dims, self.stream.cuda_stream,
                                        _KERNEL_NUMBERING))
            self.events[1].record()
        self.stats["blocks"] += 1
        self.done = True

    def settle(self) -> None:
        """Wait for the launch; the caller's stream then follows the chunk's."""
        if self.stats["kernel_ms"] is None:
            self.events[1].synchronize()
            self.stats["kernel_ms"] = self.events[0].elapsed_time(self.events[1])
            torch.cuda.current_stream(self.device).wait_stream(self.stream)

    def state(self) -> dict:
        """The final state: the reference's keys, shapes and dtypes."""
        K, W, NWF, A, E = self.dims[:5]
        return _untrash(self.s, W, self.dims[12], E, A)


def _engine(device: torch.device, engine: str | None) -> str:
    """The batch simulator's engine on ``device``: the kernel on the card,
    the plain tick on the CPU, unless the caller names one."""
    engine = engine or ("kernel" if device.type == "cuda" else "plain")
    if engine not in ("kernel", "plain"):
        raise ValueError(f"engine {engine!r}: 'kernel' or 'plain'")
    return engine


def _new_chunk(co: dict, st: dict, device: torch.device, engine: str, opts: dict):
    if engine == "kernel":
        if opts:
            raise TypeError(f"the kernel runs a chunk in one launch: no {sorted(opts)}")
        return _KernelChunk(co, st, device)
    return _Chunk(co, st, device, **opts)


def _run_torch(co: dict, st: dict, device, engine: str | None = None, **opts) -> dict:
    """Advance every lane to completion on ``device``: the reference's
    ``_run_jax``, with the same state dict in and out (numpy in, device
    tensors out).  On the card the kernel runs it, unless ``engine="plain"``
    asks for the plain tick, whose ``opts`` (``block``, ``act_k``,
    ``graphs``) override the device's defaults; the results depend on
    neither."""
    dev = resolve_device(device)
    chunk = _new_chunk(co, st, dev, _engine(dev, engine), opts)
    while not chunk.done:
        chunk.launch()
        chunk.settle()
    return chunk.state()


def _run_chunks(chunks: list, device: torch.device, engine: str | None = None,
                **opts) -> list[tuple[dict, dict]]:
    """Run several chunks together, each on its own stream on the card: the
    kernel's launches (one a chunk), or every live chunk's next block of
    the plain tick (``engine="plain"``), are all enqueued before any is
    waited for.  Returns each chunk's final state (numpy) and run counters,
    in order."""
    engine = _engine(device, engine)
    runs = []
    for lanes in chunks:
        co, st = _build(lanes)
        runs.append(_new_chunk(co, st, device, engine, opts))
    t0 = time.perf_counter()
    live = list(runs)
    while live:
        for r in live:
            r.launch()
        for r in live:
            r.settle()
        live = [r for r in live if not r.done]
    wall = time.perf_counter() - t0
    capture = sum(r.stats["capture_s"] for r in runs)
    RUN_STATS["compile_s"] += capture
    RUN_STATS["run_s"] += wall - capture
    RUN_STATS["compiles"] += sum(r.stats["captures"] for r in runs)
    RUN_STATS["launches"] += len(runs)
    out = []
    for r in runs:
        state = {k: v.cpu().numpy() for k, v in r.state().items()}
        RUN_STATS["ticks"] += int(state["guard"])
        for key in ("blocks", "eager_blocks", "replays", "reruns"):
            BLOCK_STATS[key] += r.stats[key]
        out.append((state, r.stats))
    return out


# Launch accounting (the reference's keys): graph-capture wall on the card
# (0 on the CPU and on the kernel path) vs run wall, chunks launched (one
# kernel launch a chunk on the kernel path), captures, and ticks counted as
# the reference's `guard` counts them.
RUN_STATS = {"compile_s": 0.0, "run_s": 0.0,
             "compiles": 0, "launches": 0, "ticks": 0}

# Blocks run, of which eager (the first block of each chunk, every block on
# the CPU, and blocks run without a graph) and graph replays, and blocks
# rolled back and rerun because an activation bound overflowed.  The kernel
# path counts one block a chunk, none eager, replayed or rerun.
BLOCK_STATS = {"blocks": 0, "eager_blocks": 0, "replays": 0, "reruns": 0}


def reset_run_stats() -> dict:
    """Zero the capture/run accounting (returns the live dict)."""
    for stats in (RUN_STATS, BLOCK_STATS):
        for k, v in stats.items():
            stats[k] = type(v)(0)
    return RUN_STATS


def _results(lanes: Sequence[_Lane], out: dict) -> list:
    if out["alive"].any():
        raise RuntimeError("batch simulator wedged")
    return [_extract(ln, i, out) for i, ln in enumerate(lanes)]


def _extract(lane: _Lane, i: int, out: dict):
    cfg = lane.cfg
    if out["budget"][i]:
        return SimBudgetExceeded(cfg.design, lane.workload.name,
                                 cfg.max_cycles, int(out["cycle"][i]))
    bd = new_breakdown()
    for j, c in enumerate(CYCLE_CATEGORIES):
        bd[c] = int(out["bd"][i, j])
    res = SimResult(design=cfg.design, workload=lane.workload.name,
                    cycles=int(out["cycle"][i]),
                    instructions=int(out["wf"][i, :, F_IS].sum()),
                    resident_warps=lane.occupancy,
                    rfc_hits=int(out["ch"][i]),
                    rfc_accesses=int(out["ca"][i]),
                    mrf_accesses=int(out["cm"][i]),
                    prefetch_ops=int(out["cpo"][i]),
                    prefetch_cycles=int(out["cpc"][i]),
                    prefetch_stall_cycles=int(out["cps"][i]),
                    writeback_regs=int(out["cwb"][i]),
                    activations=int(out["cact"][i]),
                    cycle_breakdown=bd)
    check_breakdown(bd, res.cycles, cfg.design, lane.workload.name)
    return res


# --------------------------------------------------------------------------
# Public API
# --------------------------------------------------------------------------

# Lanes per sub-chunk within a shape group (see `_chunk_lanes`), per device
# type.  The CPU keeps the reference's 8: a tick's cost there grows with the
# lanes, so a length-sorted group retires its short lanes early in small
# chunks.  On the card the kernel runs each lane on its own warp, so a chunk
# takes its longest lane's time whatever its width, and each shape group
# runs as one wide chunk.
_SUB_LANES = {"cpu": 8, "cuda": 256}


def run_batch(jobs: Sequence[tuple[Workload, SimConfig]], *,
              fallback: bool = True, device="cuda") -> list:
    """Simulate many (workload, config) jobs; vectorized where supported.

    Returns one outcome per job, in order: a `SimResult`, or a
    `SimBudgetExceeded` *instance* (not raised) for lanes that blew their
    ``max_cycles`` watchdog — the sweep service records those as outcomes.
    Unsupported configs (see `batch_supported`) fall back to the scalar
    event-heap engine per job; pass ``fallback=False`` to get a
    `ValueError` instead.  The lockstep run goes on ``device`` (the CUDA
    card unless the caller passes ``device="cpu"``); its chunks run together.
    """
    dev = resolve_device(device)
    outcomes: list = [None] * len(jobs)
    lanes: list[_Lane] = []
    idxs: list[int] = []
    for i, (w, cfg) in enumerate(jobs):
        if batch_supported(cfg):
            parse_interval_strategy(cfg.interval_strategy)  # raise like engine
            code = _encode_plan(w, cfg)
            lanes.append(_Lane(w, cfg, code, _occupancy(w, cfg)))
            idxs.append(i)
        elif fallback:
            try:
                outcomes[i] = simulate(w, cfg)
            except SimBudgetExceeded as e:
                outcomes[i] = e
        else:
            raise ValueError(
                f"config not batch-supported (scheduler={cfg.scheduler!r}, "
                f"bank_model={cfg.bank_model!r}, trace={cfg.trace}, "
                f"num_sms={cfg.num_sms})")
    chunks = list(_chunk_lanes(lanes, idxs, _SUB_LANES.get(dev.type, 8)))
    runs = _run_chunks([c for c, _ in chunks], dev)
    for (chunk, chunk_idxs), (out, _) in zip(chunks, runs):
        for i, r in zip(chunk_idxs, _results(chunk, out)):
            outcomes[i] = r
    return outcomes


def _chunk_lanes(lanes: list[_Lane], idxs: list[int], sub_lanes: int = 8):
    """Partition lanes into compile-friendly, utilization-friendly chunks.

    Lanes are grouped by the shape dimensions that dominate per-tick cost —
    active-list width (8 for the cached designs vs. all-resident for
    BL/RFC/Ideal), warp count, and the shared-RFC entry table — so a chunk
    of LTRF lanes pays (K, 8) scheduler scans instead of inheriting (K, 64)
    from one BL bystander.  Within a group, lanes are ordered by a crude
    run-length estimate: the lockstep while-loop runs until the *slowest*
    lane finishes, so co-scheduling similar-length lanes keeps the rest of
    the chunk from idling (and finished lanes from being dead weight).

    Groups are then cut into sub-chunks of at most ``sub_lanes`` lanes.
    Per-tick cost is nearly linear in the lane count (the K-independent
    loop overhead is small), so a finished lane that stays resident until
    the chunk's slowest lane retires costs almost as much as a live one —
    on the tracked sweep the longest lane runs ~5x the mean, and one big
    chunk burns that whole imbalance as dead weight.  Length-sorted
    sub-chunks retire short lanes in cheap early launches and leave the
    stragglers in small tail chunks.  That holds on the CPU; on the card a
    tick costs about the same for 8 lanes or 256, so ``sub_lanes`` is set per
    device (`_SUB_LANES`)."""
    groups: dict[tuple, list[int]] = {}
    for j, ln in enumerate(lanes):
        cfg = ln.cfg
        sig = (_bucket(cfg.num_warps, 4), _bucket(_acap(ln), 2),
               cfg.rfc_entries if cfg.design == "RFC" else 0)
        groups.setdefault(sig, []).append(j)
    for sig, members in groups.items():
        members.sort(key=lambda j: _length_hint(lanes[j]))
        for lo in range(0, len(members), sub_lanes):
            part = members[lo: lo + sub_lanes]
            yield [lanes[j] for j in part], [idxs[j] for j in part]


def _length_hint(ln: _Lane) -> float:
    """Rough relative cycle count (ordering heuristic only)."""
    cfg = ln.cfg
    return (ln.code.n_pc * ln.occupancy
            * (cfg.mrf_cycles + cfg.mem_cycles * (1.0 - cfg.l1_hit_rate)))




def simulate_batch(jobs: Sequence[tuple[Workload, SimConfig]], *,
                   fallback: bool = True, device="cuda") -> list[SimResult]:
    """Like `run_batch` but raises the first `SimBudgetExceeded` (matching
    the scalar `simulate` contract)."""
    outcomes = run_batch(jobs, fallback=fallback, device=device)
    for r in outcomes:
        if isinstance(r, SimBudgetExceeded):
            raise r
    return outcomes


def simulate_one(workload: Workload, cfg: SimConfig, *, device="cuda") -> SimResult:
    """Single-job convenience wrapper over the batch path."""
    return simulate_batch([(workload, cfg)], device=device)[0]
