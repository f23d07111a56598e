"""Interval Conflict Graph (ICG) construction — paper §4.2 phases 1-2.

Nodes are register-live-ranges.  Two relations are computed:

* ``adj`` — *bank-conflict* edges used for coloring: two live-ranges conflict
  when both belong to the *working set* (are fetched by the prefetch op) of a
  common register-interval.  This is what determines prefetch bank conflicts:
  only registers fetched together compete for MRF banks (live-through values
  stay in the MRF and are not part of the prefetch).  The paper's Fig. 9
  walk-through is only 4-colorable under this reading.
* ``interfere`` — classic liveness interference (co-live at some program
  point, block-granular): the *correctness* constraint for physical register
  reuse during renumbering.  Renumbering may give two live-ranges the same
  register only if they neither interfere nor bank-conflict.

Copy of ``repro.core.icg`` for the PyTorch port: the same text, with its
imports of ``repro`` read as ``repro_torch``.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from .intervals import IntervalAnalysis
from .liveness import LiveRange, block_liveness, build_live_ranges, reaching_defs


@dataclass
class ICG:
    ranges: list[LiveRange]
    occ: dict[tuple[str, int, str, int], int]  # operand occurrence -> lr_id
    adj: dict[int, set[int]] = field(default_factory=dict)        # bank conflicts
    interfere: dict[int, set[int]] = field(default_factory=dict)  # liveness
    interval_members: dict[int, set[int]] = field(default_factory=dict)  # iid -> fetched lr_ids

    def degree(self, n: int) -> int:
        return len(self.adj.get(n, ()))

    @property
    def num_edges(self) -> int:
        return sum(len(v) for v in self.adj.values()) // 2


def _clique(adj: dict[int, set[int]], nodes: set[int]) -> None:
    lst = sorted(nodes)
    for i, a in enumerate(lst):
        for b in lst[i + 1:]:
            adj[a].add(b)
            adj[b].add(a)


def _coalesce_same_reg(
    ranges: list[LiveRange],
    occ: dict[tuple[str, int, str, int], int],
    lr_intervals: dict[int, set[int]],
) -> tuple[list[LiveRange], dict[tuple[str, int, str, int], int], dict[int, set[int]]]:
    """Merge webs of the *same architectural register* that share an interval.

    The prefetch bit-vector has one bit per register number, so two webs of
    ``rK`` fetched in the same interval are physically one fetch; leaving them
    as separate ICG nodes would force them into different banks (and different
    register numbers), inflating the working set.  Same-register webs are
    never simultaneously live, so the merge is always safe.
    """
    parent = {lr.lr_id: lr.lr_id for lr in ranges}

    def find(x: int) -> int:
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    by_reg: dict[int, list[LiveRange]] = {}
    for lr in ranges:
        by_reg.setdefault(lr.reg, []).append(lr)
    changed = True
    ivs = {lr.lr_id: set(lr_intervals[lr.lr_id]) for lr in ranges}
    while changed:
        changed = False
        for _reg, lst in by_reg.items():
            roots: dict[int, int] = {}
            for lr in lst:
                r = find(lr.lr_id)
                roots.setdefault(r, r)
            rs = list(roots)
            for i, a in enumerate(rs):
                for b in rs[i + 1:]:
                    ra, rb = find(a), find(b)
                    if ra != rb and ivs[ra] & ivs[rb]:
                        parent[rb] = ra
                        ivs[ra] |= ivs[rb]
                        changed = True

    groups: dict[int, list[LiveRange]] = {}
    for lr in ranges:
        groups.setdefault(find(lr.lr_id), []).append(lr)
    new_ranges: list[LiveRange] = []
    old_to_new: dict[int, int] = {}
    new_intervals: dict[int, set[int]] = {}
    for root, lrs in sorted(groups.items()):
        nid = len(new_ranges)
        merged = LiveRange(
            lr_id=nid, reg=lrs[0].reg,
            defs=frozenset().union(*(lr.defs for lr in lrs)),
            use_sites=frozenset().union(*(lr.use_sites for lr in lrs)),
        )
        merged.intervals = set().union(*(lr_intervals[lr.lr_id] for lr in lrs))
        new_ranges.append(merged)
        new_intervals[nid] = merged.intervals
        for lr in lrs:
            old_to_new[lr.lr_id] = nid
    new_occ = {k: old_to_new[v] for k, v in occ.items()}
    return new_ranges, new_occ, new_intervals


def build_icg(analysis: IntervalAnalysis) -> ICG:
    prog = analysis.prog
    ranges, occ = build_live_ranges(prog)
    live_in, _ = block_liveness(prog)
    rdefs = reaching_defs(prog)

    lr_intervals: dict[int, set[int]] = {lr.lr_id: set() for lr in ranges}
    for (label, _i, _kind, _pos), lr_id in occ.items():
        lr_intervals[lr_id].add(analysis.block_interval[label])
    ranges, occ, lr_intervals = _coalesce_same_reg(ranges, occ, lr_intervals)

    icg = ICG(ranges=ranges, occ=occ,
              adj={lr.lr_id: set() for lr in ranges},
              interfere={lr.lr_id: set() for lr in ranges})

    # --- bank-conflict edges: co-membership in an interval's fetched set ---
    members: dict[int, set[int]] = {}
    for (label, _i, _kind, _pos), lr_id in occ.items():
        iid = analysis.block_interval[label]
        members.setdefault(iid, set()).add(lr_id)
    for lr in ranges:
        lr.intervals = lr_intervals[lr.lr_id]
    icg.interval_members = members
    for lrs in members.values():
        _clique(icg.adj, lrs)

    # --- interference edges: co-live within a block (conservative) ---
    defs_to_lr: dict[tuple, int] = {}
    input_lr: dict[int, int] = {}
    for lr in ranges:
        for d in lr.defs:
            defs_to_lr[d] = lr.lr_id
            if d[0] == "__entry__":
                input_lr[lr.reg] = lr.lr_id
    for bb in prog:
        live_here: set[int] = set()
        reach = rdefs[bb.label]
        for r in live_in[bb.label]:
            ds = reach.get(r)
            if ds:
                for d in ds:
                    lr_id = defs_to_lr.get(d)
                    if lr_id is not None:
                        live_here.add(lr_id)
            elif r in input_lr:
                live_here.add(input_lr[r])
        for i, _ins in enumerate(bb.instrs):
            for kind in ("d", "s"):
                k = 0
                while (bb.label, i, kind, k) in occ:
                    live_here.add(occ[(bb.label, i, kind, k)])
                    k += 1
        _clique(icg.interfere, live_here)
    return icg
