"""Liveness + register-live-range (web) analysis.

Implements the dataflow substrate the paper's §3 (LTRF+ dead-operand bits) and
§4 (register-live-ranges, the ICG nodes) require:

* classic backward liveness (block level and per-instruction points);
* reaching definitions (block level), used to build *webs*: maximal
  def-use chains of one architectural register — the paper's
  "register-live-range: a chain of common uses of a specific register";
* linearized ``[first, last]`` live intervals with loop extension — the
  substrate linear-scan register allocation needs (exposed to the frontend
  through the pipeline's ``live-intervals`` pass).

Copy of ``repro.core.liveness`` for the PyTorch port: the same text, with its
imports of ``repro`` read as ``repro_torch``.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from .ir import Instr, Program, back_edges


def block_liveness(prog: Program) -> tuple[dict[str, set[int]], dict[str, set[int]]]:
    """Backward may-liveness over general registers. Returns (live_in, live_out)."""
    uses: dict[str, set[int]] = {}
    defs: dict[str, set[int]] = {}
    for bb in prog:
        u, d = bb.uses_defs()
        uses[bb.label], defs[bb.label] = u, d
    live_in = {l: set() for l in prog.order}
    live_out = {l: set() for l in prog.order}
    changed = True
    while changed:
        changed = False
        for label in reversed(prog.order):
            bb = prog.blocks[label]
            out = set()
            for s in bb.succs:
                out |= live_in[s]
            inn = uses[label] | (out - defs[label])
            if out != live_out[label] or inn != live_in[label]:
                live_out[label], live_in[label] = out, inn
                changed = True
    return live_in, live_out


def instr_live_out(prog: Program) -> dict[tuple[str, int], set[int]]:
    """Per-instruction live-out sets (keyed by (block label, instr index))."""
    _, block_out = block_liveness(prog)
    points: dict[tuple[str, int], set[int]] = {}
    for bb in prog:
        live = set(block_out[bb.label])
        for i in range(len(bb.instrs) - 1, -1, -1):
            ins = bb.instrs[i]
            points[(bb.label, i)] = set(live)
            live -= set(ins.dsts)
            live |= set(ins.srcs)
    return points


def annotate_dead_operands(prog: Program) -> Program:
    """LTRF+ dead-operand bits: mark source operands whose register is dead
    immediately after the instruction (conservative static liveness)."""
    louts = instr_live_out(prog)
    for bb in prog:
        for i, ins in enumerate(bb.instrs):
            lo = louts[(bb.label, i)]
            dead = tuple(k for k, s in enumerate(ins.srcs) if s not in lo and s not in ins.dsts)
            bb.instrs[i] = Instr(
                op=ins.op, dsts=ins.dsts, srcs=ins.srcs, pdst=ins.pdst,
                psrcs=ins.psrcs, target=ins.target, dead_srcs=dead,
            )
    return prog


def linear_live_intervals(prog: Program) -> tuple[dict[int, int], dict[int, int]]:
    """[first, last] linear positions per register, extended over loops.

    A register whose first access inside a loop span is a *read* carries a
    value across the back edge, so its interval must cover the whole span.
    This is the liveness substrate for linear-scan allocation
    (`repro.frontend.regalloc`), reached via the pipeline's
    ``live-intervals`` pass.
    """
    first: dict[int, int] = {}
    last: dict[int, int] = {}
    block_span: dict[str, tuple[int, int]] = {}
    pos = 0
    flat: list[Instr] = []
    for label in prog.order:
        start = pos
        for ins in prog.blocks[label].instrs:
            for r in ins.regs:
                first.setdefault(r, pos)
                last[r] = pos
            flat.append(ins)
            pos += 1
        block_span[label] = (start, pos - 1)

    spans = []
    for (u, v) in back_edges(prog):
        s, e = block_span[v][0], block_span[u][1]
        if s <= e:
            spans.append((s, e))
    changed = True
    while changed:
        changed = False
        for (s, e) in spans:
            defined: set[int] = set()
            carried: set[int] = set()
            for ins in flat[s:e + 1]:
                for r in ins.srcs:
                    if r not in defined:
                        carried.add(r)
                defined.update(ins.dsts)
            for r in carried:
                nf, nl = min(first[r], s), max(last[r], e)
                if (nf, nl) != (first[r], last[r]):
                    first[r], last[r] = nf, nl
                    changed = True
    return first, last


# ---------------------------------------------------------------------------
# Reaching definitions + webs (register-live-ranges)
# ---------------------------------------------------------------------------

DefSite = tuple[str, int, int]  # (block, instr index, dst position)


def _def_sites(prog: Program) -> dict[int, list[DefSite]]:
    sites: dict[int, list[DefSite]] = {}
    for label, i, ins in prog.instructions():
        for k, r in enumerate(ins.dsts):
            sites.setdefault(r, []).append((label, i, k))
    return sites


def reaching_defs(prog: Program) -> dict[str, dict[int, set[DefSite]]]:
    """Block-entry reaching definitions, per register."""
    gen: dict[str, dict[int, DefSite]] = {}
    kill: dict[str, set[int]] = {}
    for bb in prog:
        g: dict[int, DefSite] = {}
        for i, ins in enumerate(bb.instrs):
            for k, r in enumerate(ins.dsts):
                g[r] = (bb.label, i, k)  # last def in block wins
        gen[bb.label] = g
        kill[bb.label] = set(g)
    rin: dict[str, dict[int, set[DefSite]]] = {l: {} for l in prog.order}
    changed = True
    while changed:
        changed = False
        for label in prog.order:
            bb = prog.blocks[label]
            # out[pred] = gen[pred] ∪ (in[pred] - kill[pred])
            new_in: dict[int, set[DefSite]] = {}
            for p in bb.preds:
                pin = rin[p]
                for r, ds in pin.items():
                    if r not in kill[p]:
                        new_in.setdefault(r, set()).update(ds)
                for r, d in gen[p].items():
                    new_in.setdefault(r, set()).add(d)
            if new_in != rin[label]:
                rin[label] = new_in
                changed = True
    return rin


@dataclass
class LiveRange:
    """A web: one allocatable entity. ``reg`` is the original register."""

    lr_id: int
    reg: int
    defs: frozenset[DefSite]
    use_sites: frozenset[tuple[str, int, int]] = frozenset()  # (block, instr, src pos)
    intervals: set[int] = field(default_factory=set)  # filled by icg.py


class _UF:
    def __init__(self) -> None:
        self.p: dict[DefSite, DefSite] = {}

    def find(self, x: DefSite) -> DefSite:
        self.p.setdefault(x, x)
        while self.p[x] != x:
            self.p[x] = self.p[self.p[x]]
            x = self.p[x]
        return x

    def union(self, a: DefSite, b: DefSite) -> None:
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.p[ra] = rb


def build_live_ranges(prog: Program) -> tuple[list[LiveRange], dict[tuple[str, int, str, int], int]]:
    """Build webs and an occurrence map.

    Returns (live_ranges, occ) where ``occ[(block, instr_idx, 'd'|'s', pos)]``
    is the lr_id of that operand occurrence.  Uses without a reaching def
    (kernel inputs) get a synthetic entry def at the program entry.
    """
    rdefs = reaching_defs(prog)
    uf = _UF()
    use_defs: dict[tuple[str, int, int], set[DefSite]] = {}

    for bb in prog:
        cur: dict[int, set[DefSite]] = {r: set(ds) for r, ds in rdefs[bb.label].items()}
        for i, ins in enumerate(bb.instrs):
            for k, r in enumerate(ins.srcs):
                ds = cur.get(r)
                if not ds:
                    synth: DefSite = ("__entry__", -1, r)  # undefined-before-use input
                    ds = {synth}
                    cur[r] = set(ds)
                use_defs[(bb.label, i, k)] = set(ds)
                first = next(iter(ds))
                for d in ds:
                    uf.union(first, d)
            for k, r in enumerate(ins.dsts):
                cur[r] = {(bb.label, i, k)}

    # Group def sites per (register, web root).
    def reg_of(d: DefSite) -> int:
        if d[0] == "__entry__":
            return d[2]
        return prog.blocks[d[0]].instrs[d[1]].dsts[d[2]]

    groups: dict[tuple[int, DefSite], set[DefSite]] = {}
    for label, i, ins in prog.instructions():
        for k, _ in enumerate(ins.dsts):
            d = (label, i, k)
            groups.setdefault((reg_of(d), uf.find(d)), set()).add(d)
    for ds in use_defs.values():
        for d in ds:
            groups.setdefault((reg_of(d), uf.find(d)), set()).add(d)

    ranges: list[LiveRange] = []
    root_to_lr: dict[tuple[int, DefSite], int] = {}
    for (reg, root), ds in sorted(groups.items(), key=lambda kv: (kv[0][0], str(kv[0][1]))):
        lr = LiveRange(lr_id=len(ranges), reg=reg, defs=frozenset(ds))
        root_to_lr[(reg, root)] = lr.lr_id
        ranges.append(lr)

    occ: dict[tuple[str, int, str, int], int] = {}
    uses_by_lr: dict[int, set[tuple[str, int, int]]] = {}
    for label, i, ins in prog.instructions():
        for k, r in enumerate(ins.dsts):
            occ[(label, i, "d", k)] = root_to_lr[(r, uf.find((label, i, k)))]
        for k, r in enumerate(ins.srcs):
            ds = use_defs[(label, i, k)]
            lr_id = root_to_lr[(r, uf.find(next(iter(ds))))]
            occ[(label, i, "s", k)] = lr_id
            uses_by_lr.setdefault(lr_id, set()).add((label, i, k))
    for lr in ranges:
        lr.use_sites = frozenset(uses_by_lr.get(lr.lr_id, set()))
    return ranges, occ
