"""The paper's §6 comparison points, as ready-made simulator configurations.

* ``BL``     — conventional non-cached register file (gets the 16KB the other
               designs spend on the RFC added to its MRF, per §6).
* ``RFC``    — hardware register file cache (Gebhart'11 ISCA).
* ``SHRF``   — software-managed hierarchy with strand-bounded prefetch
               (Gebhart'11 MICRO), i.e. LTRF with strands instead of
               register-intervals and no pass-2 merging.
* ``LTRF``   — the paper's design (register-interval prefetch).
* ``LTRF_conf`` — LTRF + compile-time register renumbering (§4).
* ``Ideal``  — enlarged register file with no latency increase.

Table 2 design points used in the evaluation:
  #6 TFET-SRAM: 8x capacity, 5.3x latency   #7 DWM: 8x capacity, 6.3x latency

Copy of ``repro.sim.designs`` for the PyTorch port: the same text, with its
imports of ``repro`` read as ``repro_torch``.
"""
from __future__ import annotations

from .engine import SimConfig, SimResult, simulate
from repro_torch.workloads.suite import Workload

TABLE2 = {
    1: dict(cap_mult=1, lat_mult=1.0),    # HP-SRAM baseline
    2: dict(cap_mult=8, lat_mult=1.25),   # HP-SRAM, 8x banks size
    3: dict(cap_mult=8, lat_mult=1.5),    # HP-SRAM, 8x banks
    4: dict(cap_mult=8, lat_mult=1.6),    # LSTP
    5: dict(cap_mult=8, lat_mult=2.8),    # LSTP, 8x banks
    6: dict(cap_mult=8, lat_mult=5.3),    # TFET
    7: dict(cap_mult=8, lat_mult=6.3),    # DWM
}

BASE_RF_KB = 256

# The latency-multiplier grid `max_tolerable_latency` walks; callers that
# pre-simulate the grid (benchmarks.paper_figs) import this so the two can
# never drift apart.
TOLERANCE_MULTS = (1, 2, 3, 4, 5, 6, 7, 8, 10, 12, 16)


def design_config(
    design: str,
    table2_config: int = 7,
    num_warps: int = 64,
    active_slots: int = 8,
    interval_cap: int = 16,
    mrf_latency_mult: float | None = None,
    rf_size_kb: int | None = None,
    num_sms: int = 1,
    scheduler: str = "two_level",
    mem_partitions: int = 0,
    bank_model: str = "none",
    renumber: str = "icg",
    interval_strategy: str = "paper",
    max_cycles: int = 0,
) -> SimConfig:
    """One design point.  GPU-scale knobs: ``num_sms`` > 1 (run the config
    through `repro.sim.gpu.simulate_gpu`; ``num_warps`` is then the kernel's
    whole-GPU warp count), ``scheduler`` picks the warp-scheduler policy,
    ``mem_partitions`` sizes the shared DRAM-partition model (0 = one per
    SM, i.e. uncontended fair share).  Bank-level knobs:
    ``bank_model="arbitrated"`` turns on same-cycle bank arbitration for
    operand reads/writebacks, ``renumber="identity"`` makes LTRF_conf skip
    the ICG renumbering pass (the §4.3 ablation axis).  Compiler knob:
    ``interval_strategy`` picks the interval-formation strategy for the
    LTRF-family designs (``"paper"``/``"capacity"``/``"fixed:N"``).
    Robustness knob: ``max_cycles`` arms the cycle-budget watchdog — a run
    that passes it raises `repro.sim.SimBudgetExceeded` (0 = unlimited)."""
    t = TABLE2[table2_config]
    size = rf_size_kb if rf_size_kb is not None else BASE_RF_KB * t["cap_mult"]
    mult = mrf_latency_mult if mrf_latency_mult is not None else t["lat_mult"]
    if design == "Ideal":
        mult = 1.0
    return SimConfig(
        design=design,
        mrf_latency_mult=mult,
        rf_size_kb=size,
        add_rfc_to_main=design in ("BL", "Ideal"),
        num_warps=num_warps,
        active_slots=active_slots,
        interval_cap=interval_cap,
        num_sms=num_sms,
        scheduler=scheduler,
        mem_partitions=mem_partitions,
        bank_model=bank_model,
        renumber=renumber,
        interval_strategy=interval_strategy,
        max_cycles=max_cycles,
    )


def baseline_config(num_warps: int = 64, num_sms: int = 1,
                    mem_partitions: int = 0,
                    bank_model: str = "none",
                    max_cycles: int = 0) -> SimConfig:
    """§6 normalization point: config #1 + the 16KB RFC space, no cache, 1x.

    At GPU scale the baseline keeps the default ``two_level`` scheduler
    (identical to ``lrr`` for the uncached BL design)."""
    return SimConfig(design="BL", mrf_latency_mult=1.0, rf_size_kb=BASE_RF_KB,
                     add_rfc_to_main=True, num_warps=num_warps,
                     num_sms=num_sms, mem_partitions=mem_partitions,
                     bank_model=bank_model, max_cycles=max_cycles)


def run(workload: Workload, cfg: SimConfig) -> SimResult:
    return simulate(workload, cfg)


def normalized_ipc(workload: Workload, cfg: SimConfig,
                   base: SimConfig | None = None) -> float:
    base = base or baseline_config(num_warps=cfg.num_warps)
    return simulate(workload, cfg).ipc / simulate(workload, base).ipc


def max_tolerable_latency(
    workload: Workload,
    design: str,
    loss: float = 0.05,
    mults: tuple[float, ...] = TOLERANCE_MULTS,
    num_warps: int = 64,
    sim=simulate,
) -> float:
    """§7.2 metric: largest MRF latency multiplier with <= ``loss`` IPC drop
    relative to the same design at 1x (main RF size held constant).

    ``sim`` lets callers swap in a memoizing runner (benchmarks.orchestrator)
    without changing the metric."""
    ref = sim(workload, design_config(design, mrf_latency_mult=1.0,
                                      rf_size_kb=BASE_RF_KB,
                                      num_warps=num_warps)).ipc
    best = 1.0
    for m in mults:
        if m == 1:
            continue
        ipc = sim(workload, design_config(design, mrf_latency_mult=float(m),
                                          rf_size_kb=BASE_RF_KB,
                                          num_warps=num_warps)).ipc
        if ipc >= (1 - loss) * ref:
            best = float(m)
        else:
            break
    return best
