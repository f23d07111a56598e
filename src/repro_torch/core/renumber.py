"""Register renumbering — paper §4.2 phase 4.

Rewrites every register operand occurrence so each live-range lands in the
register bank chosen by the ICG coloring.  Non-conflicting live-ranges of the
same color may share one physical register (standard web allocation); a
live-range is always given a register of its color's bank, so the prefetch
unit touches each bank at most ``ceil(|working set| / num_banks)`` times.

Bank mapping schemes:
* ``interleaved`` (hardware default): bank(r) = r mod num_banks
* ``grouped`` (paper's Fig. 8 walk-through): bank(r) = r // regs_per_bank

Copy of ``repro.core.renumber`` for the PyTorch port: the same text, with its
imports of ``repro`` read as ``repro_torch``.
"""
from __future__ import annotations

import copy
from dataclasses import dataclass

from .coloring import Coloring, chaitin_color
from .icg import ICG, build_icg
from .intervals import IntervalAnalysis
from .ir import Program


def bank_of(reg: int, num_banks: int, scheme: str = "interleaved", regs_per_bank: int = 2) -> int:
    if scheme == "interleaved":
        return reg % num_banks
    if scheme == "grouped":
        return (reg // regs_per_bank) % num_banks
    raise ValueError(scheme)


def _bank_regs(bank: int, num_banks: int, scheme: str, regs_per_bank: int):
    """Infinite generator of register ids living in ``bank``."""
    m = 0
    while True:
        if scheme == "interleaved":
            yield bank + m * num_banks
        else:
            base = bank * regs_per_bank + m * num_banks * regs_per_bank
            for j in range(regs_per_bank):
                yield base + j
        m += 1


@dataclass
class RenumberResult:
    prog: Program
    analysis: IntervalAnalysis  # intervals recomputed over the renumbered prog
    icg: ICG
    coloring: Coloring
    lr_reg: dict[int, int]  # lr_id -> new register
    applied: bool = True  # False: pass found no improvement, kept original code


def _schedule_cost(analysis: IntervalAnalysis, num_banks: int, scheme: str,
                   regs_per_bank: int) -> tuple[int, int]:
    """(max conflicts, total serial bank rounds) — lower is better."""
    from .prefetch import prefetch_schedule

    ops = prefetch_schedule(analysis, num_banks=num_banks, scheme=scheme,
                            regs_per_bank=regs_per_bank)
    return (max((o.conflicts for o in ops), default=0),
            sum(o.serial_rounds for o in ops))


def renumber_registers(
    analysis: IntervalAnalysis,
    num_banks: int,
    scheme: str = "interleaved",
    regs_per_bank: int = 2,
    max_regs: int = 256,
    icg: ICG | None = None,
) -> RenumberResult:
    # The pipeline's ICG pass hands its (memoized) graph in; standalone
    # callers let the pass pair collapse into one call.
    if icg is None:
        icg = build_icg(analysis)
    coloring = chaitin_color(icg.adj, num_banks)

    # Assign physical registers per color-bank, reusing a register across
    # live-ranges only when they do not interfere.
    lr_reg: dict[int, int] = {}
    bank_alloc: dict[int, list[tuple[int, set[int]]]] = {}  # color -> [(reg, lr_ids)]
    order = sorted(icg.ranges, key=lambda lr: (min(lr.intervals or {1 << 30}), lr.lr_id))
    for lr in order:
        c = coloring.colors[lr.lr_id]
        slots = bank_alloc.setdefault(c, [])
        placed = False
        blocked = icg.adj[lr.lr_id] | icg.interfere[lr.lr_id]
        for reg, holders in slots:
            if not (blocked & holders):
                holders.add(lr.lr_id)
                lr_reg[lr.lr_id] = reg
                placed = True
                break
        if not placed:
            gen = _bank_regs(c, num_banks, scheme, regs_per_bank)
            used = {r for r, _ in slots}
            for reg in gen:
                if reg not in used:
                    break
                if reg > max_regs * 4:  # safety valve
                    break
            slots.append((reg, {lr.lr_id}))
            lr_reg[lr.lr_id] = reg

    new_prog = copy.deepcopy(analysis.prog)
    for label, i, ins in list(new_prog.instructions()):
        mapping: dict[tuple[str, int], int] = {}
        for k, _ in enumerate(ins.dsts):
            lr_id = icg.occ.get((label, i, "d", k))
            if lr_id is not None:
                mapping[("d", k)] = lr_reg[lr_id]
        for k, _ in enumerate(ins.srcs):
            lr_id = icg.occ.get((label, i, "s", k))
            if lr_id is not None:
                mapping[("s", k)] = lr_reg[lr_id]
        new_prog.blocks[label].instrs[i] = ins.with_regs(mapping)

    # Intervals are structurally identical; recompute working sets over the
    # renumbered registers by replaying membership.
    new_analysis = IntervalAnalysis(
        prog=new_prog,
        intervals=copy.deepcopy(analysis.intervals),
        block_interval=dict(analysis.block_interval),
        n_cap=analysis.n_cap,
    )
    for iv in new_analysis.intervals:
        ws: set[int] = set()
        for b in iv.blocks:
            ws |= new_prog.blocks[b].refs()
        iv.working_set = ws

    # The pass is advisory: keep the renumbered code only when it actually
    # reduces prefetch bank pressure (the coloring heuristic can lose on
    # over-constrained graphs, e.g. 16-register intervals over 4 banks).
    if _schedule_cost(new_analysis, num_banks, scheme, regs_per_bank) > \
       _schedule_cost(analysis, num_banks, scheme, regs_per_bank):
        ident = {lr.lr_id: lr.reg for lr in icg.ranges}
        return RenumberResult(prog=analysis.prog, analysis=analysis, icg=icg,
                              coloring=coloring, lr_reg=ident, applied=False)
    return RenumberResult(prog=new_prog, analysis=new_analysis, icg=icg,
                          coloring=coloring, lr_reg=lr_reg, applied=True)
