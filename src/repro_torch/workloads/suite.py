"""The workload registry + the synthetic suite.

`WORKLOADS` is a *registry*: the 14 synthetic kernels (9 register-sensitive +
5 register-insensitive, mirroring the paper's CUDA-SDK / Rodinia / Parboil
mix, §6 Fig. 3) register eagerly at import, and further suites register
lazily via `register_suite` — the ``traced`` suite (the repo's own kernels
lifted through `repro.frontend`) only traces when first requested, so
jax-free consumers and the tracked benchmark job list are unaffected.
Also exports the paper's Listing-1 walk-through program.

Copy of ``repro.workloads.suite`` for the PyTorch port: the same text, with its
imports of ``repro`` read as ``repro_torch``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Iterable

from repro_torch.core.ir import Program, parse_asm

from .synth import SynthSpec, synthesize

LISTING1 = """
    mov r0, A
    mov r1, B
    mov r2, 0
    mov r3, 100
L1: ld r4, [r0]
    ld r5, [r1]
    set p0, r4, r5
    @!p0 bra L2
    add r0, r0, 4
    add r1, r1, 4
    add r2, r2, 1
    set p1, r2, r3
    @p1 bra L1
    mov r6, 1
    bra L3
L2: mov r6, 0
L3: exit
"""


def listing1_program() -> Program:
    return parse_asm(LISTING1, name="listing1")


@dataclass(frozen=True)
class Workload:
    name: str
    program: Program
    trips: dict[str, int]
    register_sensitive: bool
    regs_per_thread: int  # compiled (maxregcount) register demand
    suite: str
    l1_hit: float = 0.85  # data-cache hit rate

    @property
    def key(self) -> str:
        return self.name


def _mk(name: str, suite: str, sensitive: bool, **kw) -> Workload:
    spec = SynthSpec(name=name, **kw)
    prog, trips = synthesize(spec)
    return Workload(name=name, program=prog, trips=trips,
                    register_sensitive=sensitive,
                    regs_per_thread=spec.regs_per_thread, suite=suite,
                    l1_hit=spec.l1_hit)


def _build_suite() -> dict[str, Workload]:
    ws: list[Workload] = [
        # --- register-sensitive (occupancy-capped at 256KB) ---
        _mk("backprop", "rodinia", True, seed=11, n_regs=40, loop_depth=2,
            body_len=14, mem_ratio=0.3, trips=(6, 10), regs_per_thread=48),
        _mk("hotspot", "rodinia", True, seed=12, n_regs=44, loop_depth=2,
            body_len=18, mem_ratio=0.25, diamonds=1, trips=(5, 8), regs_per_thread=52),
        _mk("lud", "rodinia", True, seed=13, n_regs=36, loop_depth=3,
            body_len=10, mem_ratio=0.2, trips=(4, 4, 6), regs_per_thread=64),
        _mk("srad", "rodinia", True, seed=14, n_regs=48, loop_depth=2,
            body_len=20, mem_ratio=0.3, diamonds=2, trips=(5, 8), regs_per_thread=72),
        _mk("gaussian", "rodinia", True, seed=15, n_regs=34, loop_depth=2,
            body_len=12, mem_ratio=0.35, trips=(6, 8), regs_per_thread=56),
        _mk("sgemm", "parboil", True, seed=16, n_regs=52, loop_depth=2,
            body_len=24, mem_ratio=0.15, trips=(4, 12), regs_per_thread=60),
        _mk("mri-q", "parboil", True, seed=17, n_regs=42, loop_depth=1,
            body_len=30, mem_ratio=0.2, trips=(24,), regs_per_thread=80),
        _mk("stencil", "parboil", True, seed=18, n_regs=38, loop_depth=3,
            body_len=12, mem_ratio=0.3, trips=(3, 4, 8), regs_per_thread=54),
        _mk("dct8x8", "cudasdk", True, seed=19, n_regs=46, loop_depth=1,
            body_len=36, mem_ratio=0.18, diamonds=1, trips=(16,), regs_per_thread=62),
        # --- register-insensitive (fit 64 warps at 256KB) ---
        _mk("btree", "rodinia", False, seed=21, n_regs=16, loop_depth=1,
            body_len=10, mem_ratio=0.45, diamonds=2, trips=(12,), regs_per_thread=18, l1_hit=0.5),
        _mk("kmeans", "rodinia", False, seed=22, n_regs=18, loop_depth=2,
            body_len=8, mem_ratio=0.4, trips=(6, 8), regs_per_thread=20, l1_hit=0.6),
        _mk("bfs", "rodinia", False, seed=23, n_regs=14, loop_depth=1,
            body_len=8, mem_ratio=0.5, diamonds=1, trips=(14,), regs_per_thread=16, l1_hit=0.45),
        _mk("nw", "rodinia", False, seed=24, n_regs=20, loop_depth=2,
            body_len=9, mem_ratio=0.35, trips=(6, 6), regs_per_thread=24, l1_hit=0.65),
        _mk("pathfinder", "rodinia", False, seed=25, n_regs=17, loop_depth=1,
            body_len=11, mem_ratio=0.4, diamonds=1, trips=(16,), regs_per_thread=20, l1_hit=0.55),
    ]
    return {w.name: w for w in ws}


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

WORKLOADS: dict[str, Workload] = {}

# Suites whose loaders run only on first use (tracing real kernels needs jax).
_SUITE_LOADERS: dict[str, Callable[[], Iterable[Workload]]] = {}
_SUITE_NAMES: dict[str, tuple[str, ...]] = {}
_LOADED_SUITES: set[str] = set()

# The stable synthetic default: sweep/benchmark job lists are built from these
# suites unless a caller asks for more, so lazily-registered workloads can
# never silently change the tracked perf artifact.
SYNTH_SUITES = ("rodinia", "parboil", "cudasdk")


def register_workload(w: Workload, replace: bool = False) -> Workload:
    """Add a workload to the registry (errors on collisions unless asked)."""
    if not replace and w.name in WORKLOADS:
        raise ValueError(f"workload {w.name!r} already registered")
    WORKLOADS[w.name] = w
    return w


def register_suite(suite: str, loader: Callable[[], Iterable[Workload]],
                   names: Iterable[str]) -> None:
    """Declare a lazily-built suite.  ``names`` must be known up front so
    `get_workload` can resolve them without running the loader."""
    _SUITE_LOADERS[suite] = loader
    _SUITE_NAMES[suite] = tuple(names)


def load_suite(suite: str) -> dict[str, Workload]:
    """Run a lazy suite's loader (once) and return its workloads."""
    if suite not in _LOADED_SUITES:
        loader = _SUITE_LOADERS.get(suite)
        if loader is not None:
            for w in loader():
                register_workload(w, replace=True)
        _LOADED_SUITES.add(suite)
    return {n: w for n, w in WORKLOADS.items() if w.suite == suite}


def get_workload(name: str) -> Workload:
    w = WORKLOADS.get(name)
    if w is None:
        for suite, names in _SUITE_NAMES.items():
            if name in names:
                load_suite(suite)
                break
        w = WORKLOADS.get(name)
        if w is None:
            raise KeyError(name)
    return w


def workload_names(suite: str | None = None) -> tuple[str, ...]:
    """Workload names for a suite selector.

    ``None``/``"synth"`` -> the stable synthetic default; ``"all"`` -> every
    suite (loading lazy ones); otherwise that suite's names (loaded on
    demand).
    """
    if suite in (None, "synth"):
        return tuple(n for n, w in WORKLOADS.items() if w.suite in SYNTH_SUITES)
    if suite == "all":
        for s in list(_SUITE_LOADERS):
            load_suite(s)
        return tuple(WORKLOADS)
    if suite in _SUITE_LOADERS:
        load_suite(suite)
    names = tuple(n for n, w in WORKLOADS.items() if w.suite == suite)
    if not names:
        raise ValueError(f"unknown workload suite {suite!r}")
    return names


for _w in _build_suite().values():
    register_workload(_w)
REGISTER_SENSITIVE = [w for w in WORKLOADS.values() if w.register_sensitive]
REGISTER_INSENSITIVE = [w for w in WORKLOADS.values() if not w.register_sensitive]
