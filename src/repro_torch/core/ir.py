"""PTX-like register IR + control-flow graph.

This is the front-end the paper's compiler passes operate on.  Programs are
lists of instructions over virtual/architectural registers ``r0..rK`` and
predicate registers ``p0..pK``; control flow is expressed with labels and
(predicated) branches, exactly enough to express the paper's Listing 1 and the
workload suite (loops, nested loops, if/else diamonds, function calls).

A tiny asm DSL keeps workloads and tests readable::

    mov   r0, A          ; immediate / symbol sources are ignored operands
    L1: ld r4, [r0]      ; loads are long-latency instructions
    set   p0, r4, r5
    @!p0 bra L2
    add   r0, r0, 4
    bra   L1
    L2: exit

Registers are integers (``r7`` -> 7); predicates live in a separate small
space (``p0`` -> 0) because the paper's bank-conflict machinery only concerns
general registers.
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field, replace
from typing import Iterable, Iterator, Sequence

# Instruction opcodes with a memory (long-latency) semantics.
MEM_OPS = frozenset({"ld", "st"})
# Opcodes that transfer control.
BRANCH_OPS = frozenset({"bra", "exit", "ret"})
CALL_OPS = frozenset({"call"})


@dataclass(frozen=True)
class Instr:
    """One IR instruction.

    ``dsts``/``srcs`` are general-register ids.  ``pdst``/``psrcs`` are
    predicate-register ids (``set`` writes a predicate, ``@p``/``@!p`` guards
    read one).  ``target`` is a label for branches/calls.
    """

    op: str
    dsts: tuple[int, ...] = ()
    srcs: tuple[int, ...] = ()
    pdst: int | None = None
    psrcs: tuple[int, ...] = ()
    target: str | None = None
    # Dead-operand bits (LTRF+): positions into ``srcs`` whose register dies
    # right after this instruction.  Filled in by liveness analysis.
    dead_srcs: tuple[int, ...] = ()

    @property
    def regs(self) -> tuple[int, ...]:
        return tuple(self.dsts) + tuple(self.srcs)

    @property
    def is_mem(self) -> bool:
        return self.op in MEM_OPS

    @property
    def is_branch(self) -> bool:
        return self.op in BRANCH_OPS

    @property
    def is_call(self) -> bool:
        return self.op in CALL_OPS

    def with_regs(self, mapping: dict[tuple[str, int], int]) -> "Instr":
        """Rewrite register operands.  ``mapping`` keys are ('d'|'s', position)."""
        dsts = tuple(mapping.get(("d", i), r) for i, r in enumerate(self.dsts))
        srcs = tuple(mapping.get(("s", i), r) for i, r in enumerate(self.srcs))
        return replace(self, dsts=dsts, srcs=srcs)

    def render(self) -> str:
        parts = [self.op]
        ops = [f"r{d}" for d in self.dsts]
        if self.pdst is not None:
            ops.append(f"p{self.pdst}")
        ops += [f"r{s}" for s in self.srcs]
        if self.target:
            ops.append(self.target)
        guard = "".join(f"@p{p} " for p in self.psrcs) if self.op != "set" else ""
        return guard + parts[0] + " " + ", ".join(ops)


@dataclass
class BasicBlock:
    label: str
    instrs: list[Instr] = field(default_factory=list)
    succs: list[str] = field(default_factory=list)
    preds: list[str] = field(default_factory=list)

    def refs(self) -> set[int]:
        """All general registers referenced (read or written) in the block."""
        out: set[int] = set()
        for ins in self.instrs:
            out.update(ins.regs)
        return out

    def uses_defs(self) -> tuple[set[int], set[int]]:
        """(upward-exposed uses, defs) over general registers."""
        uses: set[int] = set()
        defs: set[int] = set()
        for ins in self.instrs:
            uses.update(s for s in ins.srcs if s not in defs)
            defs.update(ins.dsts)
        return uses, defs


@dataclass
class Program:
    """A CFG: ordered blocks, entry first."""

    blocks: dict[str, BasicBlock]
    order: list[str]
    name: str = "kernel"

    @property
    def entry(self) -> str:
        return self.order[0]

    def __iter__(self) -> Iterator[BasicBlock]:
        for label in self.order:
            yield self.blocks[label]

    def instructions(self) -> Iterator[tuple[str, int, Instr]]:
        for label in self.order:
            for i, ins in enumerate(self.blocks[label].instrs):
                yield label, i, ins

    def registers(self) -> set[int]:
        out: set[int] = set()
        for bb in self:
            out.update(bb.refs())
        return out

    def num_instrs(self) -> int:
        return sum(len(bb.instrs) for bb in self)

    def recompute_edges(self) -> None:
        """(Re)build succ/pred lists from terminators + fallthrough order."""
        for bb in self.blocks.values():
            bb.succs, bb.preds = [], []
        for idx, label in enumerate(self.order):
            bb = self.blocks[label]
            nxt = self.order[idx + 1] if idx + 1 < len(self.order) else None
            term = bb.instrs[-1] if bb.instrs else None
            succs: list[str] = []
            if term is not None and term.op == "bra":
                assert term.target is not None
                succs.append(term.target)
                if term.psrcs and nxt is not None:  # predicated: may fall through
                    succs.append(nxt)
            elif term is not None and term.op in ("exit", "ret"):
                pass
            else:  # fallthrough (including calls: they return)
                if nxt is not None:
                    succs.append(nxt)
            bb.succs = list(dict.fromkeys(succs))
        for label in self.order:
            for s in self.blocks[label].succs:
                if label not in self.blocks[s].preds:
                    self.blocks[s].preds.append(label)

    def validate(self) -> None:
        assert self.order and self.order[0] in self.blocks
        for label in self.order:
            for s in self.blocks[label].succs:
                assert s in self.blocks, f"dangling edge {label}->{s}"

    def render(self) -> str:
        lines = []
        for bb in self:
            lines.append(f"{bb.label}:")
            lines += [f"  {ins.render()}" for ins in bb.instrs]
        return "\n".join(lines)


_LINE = re.compile(
    r"^\s*(?:(?P<label>[A-Za-z_]\w*)\s*:)?\s*(?P<guards>(?:@!?p\d+\s+)*)"
    r"(?P<op>[a-z.]+)?\s*(?P<ops>.*?)\s*(?:;.*)?$"
)
_REG = re.compile(r"^r(\d+)$")
_PREG = re.compile(r"^p(\d+)$")


def parse_asm(text: str, name: str = "kernel") -> Program:
    """Parse the asm DSL into a Program with block-level CFG."""
    raw: list[tuple[str | None, Instr | None]] = []
    for line in text.strip().splitlines():
        line = line.strip()
        if not line or line.startswith(";") or line.startswith("#"):
            continue
        m = _LINE.match(line)
        if not m:
            raise ValueError(f"bad asm line: {line!r}")
        label = m.group("label")
        op = m.group("op")
        if op is None:
            raw.append((label, None))
            continue
        op = op.split(".")[0]  # strip type suffixes like ld.local.u32
        guards = tuple(int(g) for g in re.findall(r"@!?p(\d+)", m.group("guards") or ""))
        toks = [t.strip() for t in m.group("ops").split(",") if t.strip()] if m.group("ops") else []
        dsts: list[int] = []
        srcs: list[int] = []
        pdst: int | None = None
        psrcs: list[int] = list(guards)
        target: str | None = None
        for i, tok in enumerate(toks):
            tok = tok.strip("[]")  # memory operands read an address register
            rm, pm = _REG.match(tok), _PREG.match(tok)
            if pm:
                if op == "set" and pdst is None:
                    pdst = int(pm.group(1))
                else:
                    psrcs.append(int(pm.group(1)))
            elif rm:
                r = int(rm.group(1))
                # first operand is the destination except for st/bra/call
                if i == 0 and op not in ("st", "bra", "call", "exit", "ret", "set"):
                    dsts.append(r)
                else:
                    srcs.append(r)
            elif op in ("bra", "call") and re.match(r"^[A-Za-z_]\w*$", tok):
                target = tok
            # anything else (immediates / symbols) is a non-register operand
        raw.append((label, Instr(op=op, dsts=tuple(dsts), srcs=tuple(srcs),
                                 pdst=pdst, psrcs=tuple(psrcs), target=target)))

    # Split into basic blocks: leaders are labeled lines and post-branch lines.
    blocks: dict[str, BasicBlock] = {}
    order: list[str] = []
    cur: BasicBlock | None = None
    anon = 0

    def new_block(label: str | None) -> BasicBlock:
        nonlocal anon
        if label is None:
            label = f".b{anon}"
            anon += 1
        bb = BasicBlock(label=label)
        blocks[label] = bb
        order.append(label)
        return bb

    prev_was_branch = True  # force a leader at program start
    for label, ins in raw:
        if label is not None or prev_was_branch or cur is None:
            cur = new_block(label)
            prev_was_branch = False
        if ins is None:
            continue
        cur.instrs.append(ins)
        if ins.is_branch:
            prev_was_branch = True
    prog = Program(blocks=blocks, order=order, name=name)
    prog.recompute_edges()
    prog.validate()
    return prog


def linearize(prog: Program) -> list[Instr]:
    return [ins for _, _, ins in prog.instructions()]


def reachable_blocks(prog: Program) -> set[str]:
    seen: set[str] = set()
    stack = [prog.entry]
    while stack:
        b = stack.pop()
        if b in seen:
            continue
        seen.add(b)
        stack.extend(prog.blocks[b].succs)
    return seen


def back_edges(prog: Program) -> set[tuple[str, str]]:
    """DFS back edges (loop edges) of the CFG."""
    color: dict[str, int] = {}
    out: set[tuple[str, str]] = set()

    def dfs(u: str) -> None:
        color[u] = 1
        for v in prog.blocks[u].succs:
            c = color.get(v, 0)
            if c == 0:
                dfs(v)
            elif c == 1:
                out.add((u, v))
        color[u] = 2

    import sys

    old = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old, 10000))
    try:
        dfs(prog.entry)
    finally:
        sys.setrecursionlimit(old)
    return out
