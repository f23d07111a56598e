"""Register-file power proxy (paper §5.3 / Table 2).

Energy is dominated by per-access costs; we charge every access class with a
relative energy (baseline HP-SRAM MRF access = 1.0) and add a static term.
Constants follow Table 2's power column and CACTI-style capacity scaling
(a 16KB cache access is ~5x cheaper than a 256KB bank access; the WCB is a
small SRAM table; DWM cells draw 0.65x dynamic and far less static power).

The paper's claims this reproduces:
  * §5.3  LTRF consumes ~23% less power than the baseline RF (same tech),
          despite the added WCB/arbiter/cache structures;
  * §1    DWM main RF + LTRF cuts register-file power ~46% while 8x capacity.

Copy of ``repro.sim.power`` for the PyTorch port: the same text, with its
imports of ``repro`` read as ``repro_torch``.
"""
from __future__ import annotations

from dataclasses import dataclass, replace

from .engine import SimResult

# relative per-access energies (baseline 256KB HP-SRAM bank access = 1.0)
E_MRF = {"hp-sram": 1.0, "lstp-sram": 0.4, "tfet": 0.13, "dwm": 0.5}
E_RFC = 0.3      # 16KB cache bank
E_WCB = 0.08     # register-cache address table lookup
# static power per cycle, as a fraction of one MRF access energy
P_STATIC = {"hp-sram": 0.40, "lstp-sram": 0.16, "tfet": 0.05, "dwm": 0.10}
STATIC_CAP_SCALE = {"1x": 1.0, "8x": 8.0}  # static scales with capacity
RFC_STATIC = 0.05
WCB_OVERHEAD = 0.08  # arbiter + allocation units, always-on


@dataclass(frozen=True)
class PowerReport:
    design: str
    tech: str
    dynamic: float
    static: float

    @property
    def total(self) -> float:
        return self.dynamic + self.static


def rf_power(res: SimResult, tech: str = "hp-sram", cap_mult: int = 1,
             has_cache: bool | None = None) -> PowerReport:
    """Average register-file power (arbitrary units ~ energy/cycle)."""
    cycles = max(res.cycles, 1)
    cached = has_cache if has_cache is not None else res.rfc_accesses > 0
    dyn = res.mrf_accesses * E_MRF[tech]
    if cached:
        dyn += res.rfc_accesses * E_RFC
        dyn += (res.rfc_accesses + res.prefetch_ops) * E_WCB
    static = P_STATIC[tech] * (8.0 if cap_mult == 8 else 1.0)
    if cached:
        static += RFC_STATIC + WCB_OVERHEAD
    return PowerReport(design=res.design, tech=tech,
                       dynamic=dyn / cycles, static=static)


def gpu_rf_power(res, tech: str = "hp-sram", cap_mult: int = 1,
                 has_cache: bool | None = None) -> PowerReport:
    """Whole-GPU register-file power for a `repro.sim.gpu.GpuResult`.

    Dynamic energy is the chip-wide access total spread over the GPU's
    wall-clock (`GpuResult` sums the counters and takes the slowest SM's
    cycles — all SMs burn energy concurrently, so `rf_power`'s per-cycle
    arithmetic applies unchanged); static power is the per-SM static term
    times ``num_sms`` (idle SMs still leak).
    """
    p = rf_power(res, tech, cap_mult=cap_mult, has_cache=has_cache)
    return replace(p, static=p.static * res.num_sms)


def power_comparison(workload, table2_config: int = 7, sim=None):
    """BL (HP-SRAM 1x) vs LTRF on the Table-2 design point's technology.

    ``sim`` lets callers swap in a memoizing runner (benchmarks.orchestrator).
    """
    from .designs import baseline_config, design_config
    from .engine import simulate

    if sim is None:
        sim = simulate
    tech = {6: "tfet", 7: "dwm"}[table2_config]
    bl = sim(workload, baseline_config())
    lt = sim(workload, design_config("LTRF", table2_config=table2_config))
    lt_same = sim(workload, design_config("LTRF", mrf_latency_mult=1.0,
                                          rf_size_kb=256))
    p_bl = rf_power(bl, "hp-sram", cap_mult=1)
    p_lt = rf_power(lt, tech, cap_mult=8)
    p_lt_same = rf_power(lt_same, "hp-sram", cap_mult=1)
    return {
        "workload": workload.name,
        "bl_power": p_bl.total,
        "ltrf_same_tech_power": p_lt_same.total,
        "ltrf_8x_power": p_lt.total,
        "same_tech_saving": 1 - p_lt_same.total / p_bl.total,
        "dwm_8x_saving": 1 - p_lt.total / p_bl.total,
    }
