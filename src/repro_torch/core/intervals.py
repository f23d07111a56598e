"""Register-interval formation — Algorithms 1 & 2 of the paper.

A *register-interval* is a CFG subgraph with (1) a single control-flow entry
and (2) a register working-set of at most ``n_cap`` registers (the size of one
register-file-cache partition).  Pass 1 (Algorithm 1) grows intervals block by
block, splitting basic blocks whose own instruction stream overflows the cap
and at function calls.  Pass 2 (Algorithm 2) repeatedly merges
single-predecessor intervals whose union still fits, so whole (nested) loops
collapse into one interval — one prefetch per loop.

Deviation from the paper's pseudocode (documented in DESIGN.md): the
pseudocode bounds the *per-path* accumulated register list; we bound the
*whole interval's* working-set union.  The paper's §3.1 guarantee — every
access inside the interval is a register-cache hit after one entry prefetch —
only holds under the union reading, and Algorithm 2's merge condition already
uses the union, so we apply it uniformly.

``strand_mode=True`` instead builds Gebhart'11-style *strands* (§7.6):
prefetch regions additionally terminated at long-latency memory ops and never
merged across loop back edges (pass 2 disabled).
"""
from __future__ import annotations

from dataclasses import dataclass, field

from .ir import BasicBlock, Instr, Program


@dataclass
class Interval:
    iid: int
    header: str
    blocks: list[str] = field(default_factory=list)
    working_set: set[int] = field(default_factory=set)
    solo: bool = False  # function-call intervals: never merged

    @property
    def size(self) -> int:
        return len(self.working_set)


@dataclass
class IntervalAnalysis:
    prog: Program  # with any split blocks applied
    intervals: list[Interval]
    block_interval: dict[str, int]
    n_cap: int

    def interval_of(self, label: str) -> Interval:
        return self.intervals[self.block_interval[label]]

    def edges(self) -> set[tuple[int, int]]:
        out: set[tuple[int, int]] = set()
        for bb in self.prog:
            i = self.block_interval[bb.label]
            for s in bb.succs:
                j = self.block_interval[s]
                if i != j:
                    out.add((i, j))
        return out

    def validate(self) -> None:
        # Single entry: every inter-interval edge lands on the interval header.
        headers = {iv.iid: iv.header for iv in self.intervals}
        for bb in self.prog:
            i = self.block_interval[bb.label]
            for s in bb.succs:
                j = self.block_interval[s]
                if i != j:
                    assert s == headers[j], (
                        f"edge {bb.label}->{s} enters interval {j} not at header {headers[j]}"
                    )
        for iv in self.intervals:
            assert iv.blocks, f"empty interval {iv.iid}"
            # Working-set cap (single huge basic-block instructions excepted).
            if not iv.solo and len(iv.working_set) > self.n_cap:
                # only legal when some single instruction exceeds the cap
                worst = max(
                    (len(set(ins.regs)) for b in iv.blocks for ins in self.prog.blocks[b].instrs),
                    default=0,
                )
                assert worst > self.n_cap, (
                    f"interval {iv.iid} working set {len(iv.working_set)} > cap {self.n_cap}"
                )


def _split_block(prog: Program, label: str, at: int, salt: int) -> str:
    """Split ``label`` before instruction index ``at``; return new block label."""
    bb = prog.blocks[label]
    new_label = f"{label}.s{salt}"
    assert new_label not in prog.blocks
    tail = BasicBlock(label=new_label, instrs=bb.instrs[at:])
    bb.instrs = bb.instrs[:at]
    prog.blocks[new_label] = tail
    prog.order.insert(prog.order.index(label) + 1, new_label)
    # Edges: tail inherits bb's successors; bb falls through to tail.
    tail.succs = bb.succs
    bb.succs = [new_label]
    tail.preds = [label]
    for s in tail.succs:
        ps = prog.blocks[s].preds
        prog.blocks[s].preds = [new_label if p == label else p for p in ps]
    return new_label


def _presplit_calls(prog: Program) -> set[str]:
    """Isolate every call instruction into its own basic block.

    Returns labels of call-only blocks (they become solo intervals).
    """
    call_blocks: set[str] = set()
    salt = 0
    work = list(prog.order)
    while work:
        label = work.pop(0)
        bb = prog.blocks[label]
        for i, ins in enumerate(bb.instrs):
            if ins.is_call:
                if i > 0:
                    nl = _split_block(prog, label, i, salt)
                    salt += 1
                    work.insert(0, nl)
                    break
                if len(bb.instrs) > 1:
                    _split_block(prog, label, 1, salt)
                    salt += 1
                call_blocks.add(label)
                break
        else:
            continue
    return call_blocks


def _traverse(
    prog: Program,
    label: str,
    interval: Interval,
    n_cap: int,
    salt: list[int],
    strand_mode: bool,
) -> str | None:
    """Algorithm 1's TRAVERSE: fold ``label``'s instructions into the interval
    working set, splitting the block if the cap is exceeded (or, in strand
    mode, after a long-latency memory instruction).  Returns the label of the
    split-off tail block (a fresh interval header) if a split happened."""
    bb = prog.blocks[label]
    ws = interval.working_set
    for i, ins in enumerate(bb.instrs):
        regs = set(ins.regs)
        if not (regs <= ws):
            grown = ws | regs
            if len(grown) > n_cap and ws:
                # split before this instruction; tail starts a new interval
                tail = _split_block(prog, label, i, salt[0])
                salt[0] += 1
                return tail
            if len(grown) > n_cap and not ws and i > 0:
                tail = _split_block(prog, label, i, salt[0])
                salt[0] += 1
                return tail
            ws |= regs  # single instruction may exceed cap: must admit it
        if strand_mode and ins.is_mem and i + 1 < len(bb.instrs):
            # strands end at long-latency ops: split AFTER the memory op
            tail = _split_block(prog, label, i + 1, salt[0])
            salt[0] += 1
            return tail
    return None


def form_register_intervals(
    prog: Program,
    n_cap: int,
    strand_mode: bool = False,
    run_pass2: bool | None = None,
) -> IntervalAnalysis:
    """Run Algorithm 1 (+ Algorithm 2 unless strand_mode) on a copy of ``prog``."""
    import copy

    prog = copy.deepcopy(prog)
    call_blocks = _presplit_calls(prog)
    if run_pass2 is None:
        run_pass2 = not strand_mode

    intervals: list[Interval] = []
    block_interval: dict[str, int] = {}
    salt = [0]

    def new_interval(header: str, solo: bool = False) -> Interval:
        iv = Interval(iid=len(intervals), header=header, solo=solo)
        intervals.append(iv)
        return iv

    worklist: list[str] = [prog.entry]
    pending: set[str] = {prog.entry}
    new_interval(prog.entry, solo=prog.entry in call_blocks)
    block_interval[prog.entry] = 0

    def assigned(label: str) -> bool:
        return label in block_interval

    while worklist:
        label = worklist.pop(0)
        pending.discard(label)
        iv = intervals[block_interval[label]]
        iv.blocks.append(label)
        tail = _traverse(prog, label, iv, n_cap, salt, strand_mode)
        if tail is not None:
            t_iv = new_interval(tail, solo=tail in call_blocks)
            block_interval[tail] = t_iv.iid
            worklist.insert(0, tail)
            pending.add(tail)

        # Grow interval: admit blocks whose every predecessor is already in iv
        # and whose registers keep the union within the cap.
        if not iv.solo:
            changed = True
            while changed:
                changed = False
                for cand in prog.order:
                    if assigned(cand) or cand in pending:
                        continue
                    bb = prog.blocks[cand]
                    if not bb.preds:
                        continue
                    if not all(
                        assigned(p) and block_interval[p] == iv.iid and p in iv.blocks
                        for p in bb.preds
                    ):
                        continue
                    if prog.blocks[cand].instrs and strand_mode:
                        pass  # strands may still grow across forward edges
                    if len(iv.working_set | bb.refs()) > n_cap:
                        continue
                    if cand in call_blocks:
                        continue
                    block_interval[cand] = iv.iid
                    iv.blocks.append(cand)
                    t2 = _traverse(prog, cand, iv, n_cap, salt, strand_mode)
                    if t2 is not None:
                        t_iv = new_interval(t2, solo=t2 in call_blocks)
                        block_interval[t2] = t_iv.iid
                        worklist.insert(0, t2)
                        pending.add(t2)
                    changed = True
        # Successor blocks not yet assigned become new interval headers.
        for member in list(iv.blocks):
            for s in prog.blocks[member].succs:
                if not assigned(s) and s not in pending:
                    s_iv = new_interval(s, solo=s in call_blocks)
                    block_interval[s] = s_iv.iid
                    worklist.append(s)
                    pending.add(s)

    # Unreachable blocks: give each its own interval (keeps maps total).
    for label in prog.order:
        if label not in block_interval:
            iv = new_interval(label, solo=label in call_blocks)
            block_interval[label] = iv.iid
            iv.blocks.append(label)
            iv.working_set |= prog.blocks[label].refs()

    analysis = IntervalAnalysis(prog=prog, intervals=intervals,
                                block_interval=block_interval, n_cap=n_cap)
    if run_pass2:
        analysis = _reduce(analysis)
    analysis.validate()
    return analysis


def form_fixed_intervals(prog: Program, length: int) -> IntervalAnalysis:
    """Naive fixed-length interval formation (``interval_strategy="fixed:N"``).

    Splits every basic block into runs of at most ``length`` instructions and
    makes each resulting block its own interval (no growing, no merging).
    Single-entry holds trivially — every interval is one block, which is its
    own header — but the working set is *unbounded*: a run of N instructions
    touches whatever it touches.  That is the point: this is the strawman
    baseline the ablation figures compare the paper's algorithm against.
    """
    import copy

    if length < 1:
        raise ValueError(f"fixed interval length must be >= 1, got {length}")
    prog = copy.deepcopy(prog)
    salt = 0
    work = list(prog.order)
    while work:
        label = work.pop(0)
        if len(prog.blocks[label].instrs) > length:
            tail = _split_block(prog, label, length, salt)
            salt += 1
            work.insert(0, tail)

    intervals: list[Interval] = []
    block_interval: dict[str, int] = {}
    for label in prog.order:
        iv = Interval(iid=len(intervals), header=label, blocks=[label],
                      working_set=prog.blocks[label].refs())
        intervals.append(iv)
        block_interval[label] = iv.iid
    n_cap = max((iv.size for iv in intervals), default=1)
    analysis = IntervalAnalysis(prog=prog, intervals=intervals,
                                block_interval=block_interval,
                                n_cap=max(n_cap, 1))
    analysis.validate()
    return analysis


def _reduce(analysis: IntervalAnalysis) -> IntervalAnalysis:
    """Algorithm 2: merge single-predecessor intervals until fixpoint."""
    prog, n_cap = analysis.prog, analysis.n_cap
    parent = {iv.iid: iv.iid for iv in analysis.intervals}

    def find(x: int) -> int:
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    ws = {iv.iid: set(iv.working_set) for iv in analysis.intervals}
    solo = {iv.iid: iv.solo for iv in analysis.intervals}
    header = {iv.iid: iv.header for iv in analysis.intervals}

    def ipreds(iid: int) -> set[int]:
        out: set[int] = set()
        h = header[iid]
        for member_label in members[iid]:
            for p in prog.blocks[member_label].preds:
                pi = find(analysis.block_interval[p])
                if pi != iid and member_label == h:
                    out.add(pi)
        return out

    members = {iv.iid: list(iv.blocks) for iv in analysis.intervals}

    changed = True
    while changed:
        changed = False
        for iid in [iv.iid for iv in analysis.intervals]:
            cur = find(iid)
            if cur != iid:
                continue
            preds = ipreds(cur)
            if len(preds) != 1:
                continue
            (p,) = preds
            if p == cur or solo[p] or solo[cur]:
                continue
            if len(ws[p] | ws[cur]) > n_cap:
                continue
            # merge cur into p
            parent[cur] = p
            ws[p] |= ws[cur]
            members[p] += members[cur]
            changed = True

    # Rebuild compact interval list.
    roots = sorted({find(iv.iid) for iv in analysis.intervals})
    remap = {r: k for k, r in enumerate(roots)}
    new_intervals: list[Interval] = []
    for r in roots:
        blocks = sorted(members[r], key=prog.order.index)
        new_intervals.append(Interval(
            iid=remap[r], header=header[r], blocks=blocks,
            working_set=set(ws[r]), solo=solo[r],
        ))
    block_interval = {b: remap[find(i)] for b, i in analysis.block_interval.items()}
    return IntervalAnalysis(prog=prog, intervals=new_intervals,
                            block_interval=block_interval, n_cap=n_cap)
