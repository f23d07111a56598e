"""The port's batch simulator held to the JAX package's scalar event engine
(``repro.sim.engine.simulate``) and golden oracle (``golden_simulate``), on
the CPU, part two: time skipping, mixed fallback positions, watchdog
parity, the Listing-1 pins and the batch fuzz of ``tests/test_sim_fuzz.py``
(part one, ``test_torch_sim_batch_golden.py``, holds the FMA pin and budget
outcomes).  Results are compared field by field (``asdict``), budget
outcomes by their arguments.
"""
from dataclasses import asdict, replace

import pytest

pytest.importorskip("torch")

import test_sim_fuzz as fuzz  # noqa: E402
from test_sim_golden import LISTING1_BREAKDOWN, LISTING1_GOLDEN  # noqa: E402

import repro.sim.engine as ref_engine  # noqa: E402
from repro.sim import design_config as ref_design_config  # noqa: E402
from repro.sim.golden import golden_simulate  # noqa: E402
from repro.workloads import WORKLOADS as REF_WORKLOADS  # noqa: E402
from repro.workloads.suite import Workload as RefWorkload, listing1_program as ref_listing1  # noqa: E402

from repro_torch.core.ir import parse_asm as port_parse_asm  # noqa: E402
from repro_torch.sim import (  # noqa: E402
    DESIGNS, SimBudgetExceeded, SimConfig, batch, batch_supported, design_config, run_batch,
    simulate_one,
)
from repro_torch.workloads import WORKLOADS  # noqa: E402
from repro_torch.workloads.suite import Workload, listing1_program  # noqa: E402


def _ref(cfg):
    """The same config in the JAX package's type."""
    return ref_engine.SimConfig(**asdict(cfg))


def _want(name, cfg):
    """The reference engine's result, held to golden, as a dict."""
    w = REF_WORKLOADS[name] if isinstance(name, str) else name
    got = asdict(ref_engine.simulate(w, _ref(cfg)))
    assert got == asdict(golden_simulate(w, _ref(cfg)))
    return got


def _ref_budget_args(name, cfg):
    with pytest.raises(ref_engine.SimBudgetExceeded) as exc:
        ref_engine.simulate(REF_WORKLOADS[name], _ref(cfg))
    return exc.value.args


def test_time_skip_finishes_under_cycle_count():
    w = WORKLOADS["kmeans"]
    cfg = design_config("LTRF", table2_config=7, num_warps=2)
    stats = batch.reset_run_stats()
    res = simulate_one(w, cfg, device="cpu")
    assert asdict(res) == _want("kmeans", cfg)
    assert 0 < stats["ticks"] < res.cycles, (stats["ticks"], res.cycles)


def test_mixed_supported_and_fallback_positions():
    w = WORKLOADS["kmeans"]
    base = design_config("LTRF", table2_config=7, num_warps=2)
    jobs = [
        (w, base),
        (w, replace(base, scheduler="gto")),
        (w, design_config("BL", table2_config=7, num_warps=2)),
        (w, replace(base, scheduler="lrr")),
        (w, replace(base, bank_model="arbitrated")),
    ]
    assert [batch_supported(c) for _, c in jobs] == [True, False, True, False, False]
    for (_, cfg), got in zip(jobs, run_batch(jobs, device="cpu")):
        want = asdict(ref_engine.simulate(REF_WORKLOADS["kmeans"], _ref(cfg)))
        assert asdict(got) == want, (cfg.design, cfg.scheduler, cfg.bank_model)


def test_watchdog_parity_across_budgets():
    """Budgets that land inside dead-time gaps trip at the reference's cycle."""
    w = WORKLOADS["kmeans"]
    cfg = design_config("LTRF", table2_config=7, num_warps=2)
    cycles = _want("kmeans", cfg)["cycles"]
    tights = [replace(cfg, max_cycles=max(1, int(cycles * frac))) for frac in (0.2, 0.5, 0.9)]
    for tight, got in zip(tights, run_batch([(w, t) for t in tights], device="cpu")):
        assert isinstance(got, SimBudgetExceeded), tight.max_cycles
        assert got.args == _ref_budget_args("kmeans", tight)


def test_listing1_pins_via_batch_engine():
    """All 7 designs of Listing 1 in one call: the golden pins, counters and
    cycle attribution, and the reference engine's full results."""
    w = Workload(name="listing1", program=listing1_program(), trips={"L1": 100},
                 register_sensitive=False, regs_per_thread=8, suite="paper")
    w_ref = RefWorkload(name="listing1", program=ref_listing1(), trips={"L1": 100},
                        register_sensitive=False, regs_per_thread=8, suite="paper")
    jobs = [(w, design_config(d, table2_config=7, num_warps=16)) for d in DESIGNS]
    for design, (_, cfg), r in zip(DESIGNS, jobs, run_batch(jobs, fallback=False, device="cpu")):
        assert (r.cycles, r.instructions, r.mrf_accesses, r.rfc_hits,
                r.rfc_accesses) == LISTING1_GOLDEN[design]
        assert tuple(r.cycle_breakdown.values()) == LISTING1_BREAKDOWN[design]
        assert asdict(r) == asdict(golden_simulate(w_ref, ref_design_config(
            design, table2_config=7, num_warps=16)))


SEEDS = [900 + s for s in range(8)]


def test_fuzz_batch_matches_golden(monkeypatch):
    """Eight random (program, config) pairs from `test_sim_fuzz`'s
    generators in one call, each equal to the reference engine and golden,
    field by field."""
    ref_jobs = [(fuzz.random_workload(s), fuzz.random_config(s)) for s in SEEDS]
    # the same generators, building the port's types
    monkeypatch.setattr(fuzz, "parse_asm", port_parse_asm)
    monkeypatch.setattr(fuzz, "Workload", Workload)
    monkeypatch.setattr(fuzz, "SimConfig", SimConfig)
    jobs = [(fuzz.random_workload(s), fuzz.random_config(s)) for s in SEEDS]
    assert all(batch_supported(c) for _, c in jobs)
    got = run_batch(jobs, fallback=False, device="cpu")
    for s, (w_ref, cfg_ref), r in zip(SEEDS, ref_jobs, got):
        want = asdict(ref_engine.simulate(w_ref, cfg_ref))
        assert want == asdict(golden_simulate(w_ref, cfg_ref)), s
        assert asdict(r) == want, (s, cfg_ref.design)
