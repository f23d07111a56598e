"""Linear-scan register allocation for lifted programs.

The graph lifter emits over unlimited virtual registers; the simulator's
occupancy model needs a compiled ``regs_per_thread`` under a configurable
``maxregcount`` (the nvcc knob real kernels are tuned with).  This pass:

* computes live intervals over the linearized program through the core
  compiler pipeline's liveness passes (`repro_torch.core.pipeline.frontend_passes`
  -> `repro_torch.core.liveness.linear_live_intervals`), conservatively extending
  any register that is live across a loop back edge to the whole loop span
  (its value must survive every iteration);
* runs a classic linear scan, assigning dense architectural ids — dense ids
  keep the interleaved bank mapping (``reg % num_banks``) balanced;
* on pressure above ``maxregcount``, spills the farthest-ending live ranges
  to (shared) memory: every spilled use loads through a small set of reserved
  shuttle registers and every spilled def stores back, so the simulator
  naturally charges the long-latency spill traffic.

The output program re-validates and runs on both simulator engines; the
``regs_per_thread`` metadata feeds `Simulator._occupancy` exactly like the
synthetic suite's hand-assigned register demands.

Copy of ``repro.frontend.regalloc`` for the PyTorch port (the same text, its
imports of ``repro`` read as ``repro_torch``), behind the port's graph lifter
`repro_torch.frontend.fx_lift`.
"""
from __future__ import annotations

from dataclasses import dataclass
from heapq import heappop, heappush

from repro_torch.core.ir import BasicBlock, Instr, Program
from repro_torch.core.pipeline import CompileContext, PassManager, frontend_passes

# Reserved when spilling: 3 shuttle registers (mad reads up to 3 sources)
# plus the spill base address register.
_RESERVED = 4


@dataclass(frozen=True)
class AllocResult:
    prog: Program
    regs_per_thread: int
    vreg_map: dict[int, int]       # virtual -> architectural (unspilled only)
    spilled: frozenset[int]
    spill_loads: int
    spill_stores: int

    @property
    def spill_count(self) -> int:
        return len(self.spilled)


def _liveness_via_pipeline(prog: Program) -> tuple[dict[int, int], dict[int, int]]:
    """Run the core liveness pipeline; returns linear [first, last] intervals."""
    ctx = CompileContext(prog=prog, design="frontend")
    PassManager(frontend_passes()).run(ctx)
    return ctx.artifacts["linear_live_intervals"]


def _linear_scan(ivals: list[tuple[int, int, int]],
                 k: int) -> tuple[dict[int, int], set[int]]:
    """Classic linear scan over (start, end, reg); farthest-end spill victim."""
    assign: dict[int, int] = {}
    spilled: set[int] = set()
    active: list[tuple[int, int]] = []  # (end, reg)
    free: list[int] = list(range(k))
    for start, end, r in ivals:
        keep = []
        for (e, v) in active:
            if e < start:
                heappush(free, assign[v])
            else:
                keep.append((e, v))
        active = keep
        if free:
            assign[r] = heappop(free)
            active.append((end, r))
            continue
        far = max(active, key=lambda t: (t[0], t[1]), default=None)
        if far is not None and far[0] > end:
            far_e, far_v = far
            spilled.add(far_v)
            assign[r] = assign.pop(far_v)
            active.remove(far)
            active.append((end, r))
        else:
            spilled.add(r)
    return assign, spilled


def allocate_registers(prog: Program, maxregcount: int = 64) -> AllocResult:
    """Lower unlimited virtual registers to at most ``maxregcount`` ids."""
    if maxregcount < _RESERVED + 2:
        raise ValueError(f"maxregcount={maxregcount} below the reserved "
                         f"spill machinery ({_RESERVED + 2} registers)")
    first, last = _liveness_via_pipeline(prog)
    ivals = sorted((first[r], last[r], r) for r in first)

    assign, spilled = _linear_scan(ivals, maxregcount)
    shuttles: tuple[int, ...] = ()
    spill_base = -1
    if spilled:
        k = maxregcount - _RESERVED
        assign, spilled = _linear_scan(ivals, k)
        shuttles = (k, k + 1, k + 2)
        spill_base = k + 3

    loads = stores = 0
    blocks: dict[str, BasicBlock] = {}
    for bb in prog:
        out: list[Instr] = []
        if bb.label == prog.entry and spilled:
            out.append(Instr(op="mov", dsts=(spill_base,)))
        for ins in bb.instrs:
            mapping: dict[tuple[str, int], int] = {}
            pre: list[Instr] = []
            post: list[Instr] = []
            src_shuttle: dict[int, int] = {}
            for k2, s in enumerate(ins.srcs):
                if s in spilled:
                    t = src_shuttle.get(s)
                    if t is None:
                        t = shuttles[len(src_shuttle)]
                        src_shuttle[s] = t
                        pre.append(Instr(op="ld", dsts=(t,),
                                         srcs=(spill_base,)))
                        loads += 1
                    mapping[("s", k2)] = t
                else:
                    mapping[("s", k2)] = assign[s]
            for k2, d in enumerate(ins.dsts):
                if d in spilled:
                    t = shuttles[0]
                    mapping[("d", k2)] = t
                    post.append(Instr(op="st", srcs=(t, spill_base)))
                    stores += 1
                else:
                    mapping[("d", k2)] = assign[d]
            out.extend(pre)
            out.append(ins.with_regs(mapping))
            out.extend(post)
        blocks[bb.label] = BasicBlock(label=bb.label, instrs=out)

    new_prog = Program(blocks=blocks, order=list(prog.order), name=prog.name)
    new_prog.recompute_edges()
    new_prog.validate()
    return AllocResult(
        prog=new_prog,
        regs_per_thread=len(new_prog.registers()),
        vreg_map=dict(assign),
        spilled=frozenset(spilled),
        spill_loads=loads,
        spill_stores=stores,
    )
