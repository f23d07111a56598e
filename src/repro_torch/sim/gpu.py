"""Whole-GPU model: N SMs, a CTA dispatcher, and shared memory partitions.

The paper's headline numbers (34% speedup, Fig 20's warps-per-SM scaling)
are whole-GPU results; this module scales the single-SM discrete-event
engine (`engine.Simulator`) to a full chip without re-implementing it:

* a **CTA/thread-block dispatcher** splits the kernel's ``num_warps`` total
  warps into CTAs (``warps_per_cta`` warps each) and deals them round-robin
  across ``num_sms`` SMs, GPGPU-Sim style;
* each SM runs an independent per-SM `Simulator` with its warp share and a
  distinct deterministic seed (different CTAs see different data-dependent
  branches and memory jitter);
* the per-SM ``dram_interval`` hack becomes a **shared memory-partition
  model**: the chip has ``mem_partitions`` DRAM partitions (default: one
  per SM), each serving one line every ``dram_interval`` cycles, so the
  per-SM effective service interval is
  ``dram_interval * num_sms / mem_partitions`` — fewer partitions than SMs
  models global bandwidth contention, which is what caps the paper's
  register-insensitive workloads at GPU scale;
* per-SM `SimResult`s aggregate into a `GpuResult`: whole-GPU IPC (total
  instructions over the slowest SM's cycles — SMs run concurrently) and
  summed traffic counters; hand the `GpuResult` to `power.gpu_rf_power`
  for the whole-GPU §5.3 energy proxy (the benchmark harness records it
  per sweep config).

The invariant that makes this safe: ``num_sms=1`` with the ``two_level``
scheduler derives a per-SM config *equal* to the input config, so the GPU
model reproduces today's single-SM counters bit-identically
(tests/test_sim_golden.py pins this).

Warp-scheduler policies (``SimConfig.scheduler``)
-------------------------------------------------

==============  ============================================================
policy          description
==============  ============================================================
``two_level``   the paper's scheduler (Gebhart'11/Narasiman'11): only
                ``active_slots`` warps are schedulable; a warp stalling on
                an L1-miss value is swapped out for a ready warp, paying
                register-cache write-back + working-set re-prefetch in the
                cached designs.  Default, and the only policy the frozen
                golden engine implements.
``gto``         greedy-then-oldest: every resident warp is schedulable;
                issue sticks with the warp that issued last until it
                stalls, then falls back to the oldest (lowest-wid) ready
                warp.  No deactivation churn.
``lrr``         loose round-robin over all resident warps — the classic
                baseline scheduler.  No deactivation churn.
==============  ============================================================

For the non-cached designs (BL/RFC/Ideal) ``two_level`` and ``lrr`` issue
identically (there is no active-slot restriction without a register cache);
``gto`` differs on all designs.

Copy of ``repro.sim.gpu`` for the PyTorch port: the same text, with its
imports of ``repro`` read as ``repro_torch``.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace

from repro_torch.obs.attribution import merge_breakdowns
from repro_torch.workloads.suite import Workload

from .engine import SCHEDULERS, SimConfig, SimResult, simulate

__all__ = [
    "SCHEDULERS", "GpuResult", "dispatch_ctas", "per_sm_configs",
    "gpu_jobs", "simulate_gpu",
]

# Per-SM seed offset: distinct CTAs must see distinct branch/memory jitter
# streams, while SM 0 keeps the chip-level seed (num_sms=1 bit-identity).
SM_SEED_STRIDE = 7919


def dispatch_ctas(num_warps: int, num_sms: int,
                  warps_per_cta: int = 4) -> list[int]:
    """Round-robin CTA dispatch: per-SM warp counts.

    The kernel's ``num_warps`` warps form ``ceil(num_warps/warps_per_cta)``
    CTAs (the last one possibly partial); CTA *i* lands on SM ``i % num_sms``.
    """
    if num_warps < 0 or num_sms < 1 or warps_per_cta < 1:
        raise ValueError("need num_warps >= 0, num_sms >= 1, warps_per_cta >= 1")
    shares = [0] * num_sms
    cta = 0
    remaining = num_warps
    while remaining > 0:
        take = warps_per_cta if remaining >= warps_per_cta else remaining
        shares[cta % num_sms] += take
        cta += 1
        remaining -= take
    return shares


def _effective_dram_interval(cfg: SimConfig) -> int | float:
    """Per-SM DRAM service interval under the shared-partition model.

    ``mem_partitions`` partitions (0 -> one per SM) each serve one line per
    ``dram_interval`` cycles; an SM's fair share of that global bandwidth is
    one line every ``dram_interval * num_sms / mem_partitions`` cycles.
    Integral results stay ``int`` so the uncontended case keys sim caches
    identically to the raw config.
    """
    partitions = cfg.mem_partitions or cfg.num_sms
    eff = cfg.dram_interval * cfg.num_sms / partitions
    return int(eff) if eff == int(eff) else eff


def per_sm_configs(cfg: SimConfig, warps_per_cta: int = 4) -> list[SimConfig]:
    """Derive one single-SM `SimConfig` per SM that received work.

    With ``num_sms=1`` (and default ``mem_partitions``) the derived config
    equals ``cfg`` — the GPU model degenerates to today's single-SM engine,
    caches included.
    """
    eff = _effective_dram_interval(cfg)
    shares = dispatch_ctas(cfg.num_warps, cfg.num_sms, warps_per_cta)
    return [
        replace(cfg, num_sms=1, mem_partitions=0, num_warps=share,
                seed=cfg.seed + SM_SEED_STRIDE * sm, dram_interval=eff)
        for sm, share in enumerate(shares) if share > 0
    ]


def gpu_jobs(workload: str, cfg: SimConfig,
             warps_per_cta: int = 4) -> list[tuple[str, SimConfig]]:
    """The per-SM (workload, config) jobs one GPU simulation expands into —
    hand these to `benchmarks.orchestrator.SimRunner.prefill` to run a
    GPU-scale sweep across the process pool with cache reuse."""
    return [(workload, c) for c in per_sm_configs(cfg, warps_per_cta)]


@dataclass
class GpuResult:
    """Aggregated whole-GPU counters (sums; ``cycles`` is the slowest SM)."""
    design: str
    workload: str
    num_sms: int
    scheduler: str
    cycles: int
    instructions: int
    resident_warps: int
    rfc_hits: int = 0
    rfc_accesses: int = 0
    mrf_accesses: int = 0
    prefetch_ops: int = 0
    prefetch_cycles: int = 0
    prefetch_stall_cycles: int = 0
    writeback_regs: int = 0
    activations: int = 0
    bank_conflicts: int = 0
    bank_conflict_cycles: int = 0
    cycle_breakdown: dict[str, int] = field(default_factory=dict)
    # ^ per-category cycle attribution summed over SMs (repro.obs): the
    #   breakdown accounts for every SM-cycle simulated, so it sums to
    #   sum(per_sm cycles) — NOT to the chip-level `cycles` (slowest SM).
    per_sm: tuple[SimResult, ...] = ()

    @property
    def ipc(self) -> float:
        """Whole-GPU IPC: SMs run concurrently, so the chip retires the
        total instruction count in the slowest SM's cycle count."""
        return self.instructions / max(self.cycles, 1)

    @property
    def hit_rate(self) -> float:
        return self.rfc_hits / max(self.rfc_accesses, 1)

    @property
    def bank_conflict_rate(self) -> float:
        """Extra bank-serialization rounds per retired instruction (chip)."""
        return self.bank_conflicts / max(self.instructions, 1)

    @property
    def sm_imbalance(self) -> float:
        """Slowest-SM cycles over mean SM cycles (1.0 = perfectly balanced)."""
        if not self.per_sm:
            return 1.0
        mean = sum(r.cycles for r in self.per_sm) / len(self.per_sm)
        return self.cycles / max(mean, 1e-9)


def aggregate(cfg: SimConfig, results: list[SimResult],
              workload: str) -> GpuResult:
    """Fold per-SM `SimResult`s into one `GpuResult`."""
    return GpuResult(
        design=cfg.design, workload=workload, num_sms=cfg.num_sms,
        scheduler=cfg.scheduler,
        cycles=max((r.cycles for r in results), default=0),
        instructions=sum(r.instructions for r in results),
        resident_warps=sum(r.resident_warps for r in results),
        rfc_hits=sum(r.rfc_hits for r in results),
        rfc_accesses=sum(r.rfc_accesses for r in results),
        mrf_accesses=sum(r.mrf_accesses for r in results),
        prefetch_ops=sum(r.prefetch_ops for r in results),
        prefetch_cycles=sum(r.prefetch_cycles for r in results),
        prefetch_stall_cycles=sum(r.prefetch_stall_cycles for r in results),
        writeback_regs=sum(r.writeback_regs for r in results),
        activations=sum(r.activations for r in results),
        bank_conflicts=sum(r.bank_conflicts for r in results),
        bank_conflict_cycles=sum(r.bank_conflict_cycles for r in results),
        cycle_breakdown=merge_breakdowns(r.cycle_breakdown for r in results),
        per_sm=tuple(results),
    )


def simulate_gpu(workload: Workload, cfg: SimConfig,
                 sim=simulate, warps_per_cta: int = 4) -> GpuResult:
    """Simulate a whole GPU: dispatch CTAs, run every SM, aggregate.

    ``sim`` accepts any ``(workload, SimConfig) -> SimResult`` callable, so
    callers can swap in the memoizing orchestrator runner
    (`benchmarks.orchestrator.SimRunner.sim`) — the per-SM jobs then hit the
    compile cache, the in-process memo, and the on-disk sim cache.
    """
    results = [sim(workload, c) for c in per_sm_configs(cfg, warps_per_cta)]
    name = workload if isinstance(workload, str) else workload.name
    return aggregate(cfg, results, name)
