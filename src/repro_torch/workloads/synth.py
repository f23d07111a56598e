"""Deterministic synthetic GPU-kernel generator.

Builds PTX-like programs (our asm DSL) with controllable register pressure,
loop nesting, memory intensity and branch structure — standing in for the
paper's CUDA-SDK / Rodinia / Parboil kernels.  Generation is fully seeded so
every run of the suite is identical.

Register usage is *phase-clustered*, as in real compiled kernels: each
structural region (prelude, each loop level, epilogue) works on its own small
register subset plus a few shared loop-carried values, so a ~30-instruction
window touches 8-16 distinct registers even when the whole kernel uses 40+.
This is exactly the locality Table 4 of the paper measures (real interval
length ~= 89% of optimal).

Copy of ``repro.workloads.synth`` for the PyTorch port: the same text, with its
imports of ``repro`` read as ``repro_torch``.
"""
from __future__ import annotations

import random
from dataclasses import dataclass

from repro_torch.core.ir import Program, parse_asm


@dataclass
class LoopInfo:
    label: str
    trips: int


@dataclass
class SynthSpec:
    name: str
    seed: int
    n_regs: int              # register pressure (distinct general registers)
    loop_depth: int = 1      # nesting depth
    body_len: int = 12       # instructions per loop body
    mem_ratio: float = 0.25  # fraction of body instructions that are loads
    diamonds: int = 0        # if/else diamonds inside the innermost body
    trips: tuple[int, ...] = (8,)  # per-depth trip counts (outer..inner)
    epilogue_len: int = 4
    phase_size: int = 8      # registers per structural region
    shared_regs: int = 3     # loop-carried registers shared across phases
    regs_per_thread: int = 0  # compiled register demand (0 -> n_regs)
    l1_hit: float = 0.85     # data-cache hit rate (insensitive suites: divergent, low)

    def __post_init__(self) -> None:
        if self.regs_per_thread == 0:
            self.regs_per_thread = self.n_regs
        if len(self.trips) < self.loop_depth:
            self.trips = tuple(list(self.trips) + [self.trips[-1]] * (self.loop_depth - len(self.trips)))


class _Builder:
    def __init__(self, spec: SynthSpec) -> None:
        self.spec = spec
        self.rng = random.Random(spec.seed)
        self.lines: list[str] = []
        self.loops: list[LoopInfo] = []
        self.next_pred = 0
        self.counters = list(range(spec.loop_depth))
        self.bounds = list(range(spec.loop_depth, 2 * spec.loop_depth))
        data0 = 2 * spec.loop_depth
        self.data_regs = data_regs = list(range(data0, max(spec.n_regs, data0 + 4)))
        self.shared = data_regs[: spec.shared_regs]
        pool = data_regs[spec.shared_regs:]
        k = max(spec.phase_size, 4)
        self.phases = [pool[i:i + k] for i in range(0, len(pool), k)] or [pool or data_regs]
        self.cur = 0  # current phase index
        self.recent: list[int] = []

    # -- register selection --------------------------------------------------
    def _phase(self) -> list[int]:
        return self.phases[self.cur % len(self.phases)] + self.shared

    def enter_phase(self, idx: int) -> None:
        self.cur = idx
        # on entering a region, only shared loop-carried values stay "recent"
        self.recent = [r for r in self.recent if r in self._phase()]

    def dst(self) -> int:
        r = self.rng.choice(self._phase())
        self.recent.append(r)
        if len(self.recent) > 10:
            self.recent.pop(0)
        return r

    def src(self) -> int:
        if self.recent and self.rng.random() < 0.45:
            return self.rng.choice(self.recent)
        return self.rng.choice(self._phase())

    def emit(self, line: str) -> None:
        self.lines.append(line)

    # -- code regions ---------------------------------------------------------
    def body(self, n: int, mem_ratio: float) -> None:
        for _ in range(n):
            if self.rng.random() < mem_ratio:
                # loads are compiler-hoisted: the destination is NOT put in the
                # recent-use window, so consumers appear several instructions
                # later (memory-level parallelism, as real compilers schedule)
                d = self.rng.choice(self._phase())
                a = self.src()
                self.emit(f"ld r{d}, [r{a}]")
            else:
                op = self.rng.choice(["add", "mul", "mad", "sub"])
                d, a, b = self.dst(), self.src(), self.src()
                if op == "mad":
                    self.emit(f"mad r{d}, r{a}, r{b}, r{self.src()}")
                else:
                    self.emit(f"{op} r{d}, r{a}, r{b}")

    def diamond(self, k: int) -> None:
        p = self.next_pred
        self.next_pred += 1
        a, b = self.src(), self.src()
        else_l, join_l = f"E{k}_{p}", f"J{k}_{p}"
        self.emit(f"set p{p}, r{a}, r{b}")
        self.emit(f"@!p{p} bra {else_l}")
        self.body(max(2, self.spec.body_len // 4), self.spec.mem_ratio)
        self.emit(f"bra {join_l}")
        self.emit(f"{else_l}: nop")
        self.body(max(2, self.spec.body_len // 4), self.spec.mem_ratio)
        self.emit(f"{join_l}: nop")

    def loop(self, depth: int) -> None:
        spec = self.spec
        idx = spec.loop_depth - depth  # 0 == outermost
        ctr, bound = self.counters[idx], self.bounds[idx]
        label = f"L{idx}"
        self.loops.append(LoopInfo(label=label, trips=spec.trips[idx]))
        self.emit(f"mov r{ctr}, 0")
        self.emit(f"{label}: nop")
        self.enter_phase(idx + 1)  # each loop level has its own register subset
        self.body(spec.body_len, spec.mem_ratio)
        if depth == 1:
            for k in range(spec.diamonds):
                self.diamond(k)
        else:
            self.loop(depth - 1)
            self.enter_phase(idx + 1)
        p = self.next_pred
        self.next_pred += 1
        self.emit(f"add r{ctr}, r{ctr}, 1")
        self.emit(f"set p{p}, r{ctr}, r{bound}")
        self.emit(f"@p{p} bra {label}")

    def build(self) -> tuple[Program, dict[str, int]]:
        spec = self.spec
        for b in self.bounds:
            self.emit(f"mov r{b}, 100")
        # Initialize every data register (kernel parameters / constants):
        # real compilers never emit reads of uninitialized registers.
        for r in self.data_regs:
            self.emit(f"mov r{r}, {r * 3 + 1}")
        self.enter_phase(0)
        self.body(max(2, spec.body_len // 3), 0.1)  # setup
        if spec.loop_depth > 0:
            self.loop(spec.loop_depth)
        self.enter_phase(len(self.phases) - 1)
        self.body(spec.epilogue_len, 0.0)
        self.emit("exit")
        prog = parse_asm("\n".join(self.lines), name=spec.name)
        trips = {li.label: li.trips for li in self.loops}
        return prog, trips


def synthesize(spec: SynthSpec) -> tuple[Program, dict[str, int]]:
    return _Builder(spec).build()
