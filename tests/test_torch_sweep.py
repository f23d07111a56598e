"""The port's sweep service (``repro_torch.serving.sweep``, ``faults``) and
the modules it drives (``sim/gpu.py``, ``sim/analytic.py``, ``sim/power.py``)
against the JAX package's, on the CPU.

* The service's batch path (``SimRunner(device="cpu", batch=True)``) and its
  process pool give the reference engine's results, field by field (the two
  packages' dataclasses differ, so ``asdict`` is compared).
* The reference's chaos suite (``tests/test_sweep_faults.py``) is replayed
  test for test on the port's copies: the same fault plans and the same
  expected reports, with every "equals ``simulate``" check held to the
  reference's engine.
* Store entries written by either package are disk hits for the other.
* A whole-batch failure of the batch engine raises out of ``prefill`` (the
  port's one change of behaviour on a failure; the reference absorbs it).
* 'auto' batch mode never batches on the CPU and batches at 8 misses on the
  card (the device faked here).

Jobs are small: eager PyTorch on the CPU costs a few milliseconds a tick, and
the paper's Listing 1 runs all 7 designs in 206 ticks.
"""
from __future__ import annotations

import ast
import inspect
import json
import pathlib
from dataclasses import asdict, replace

import pytest

torch = pytest.importorskip("torch")

import test_sweep_faults as ref_chaos  # noqa: E402
from benchmarks.sweep_subset import gpu_sweep_jobs, screening_jobs  # noqa: E402

import repro.serving.sweep as ref_sweep  # noqa: E402
import repro.sim.analytic as ref_analytic  # noqa: E402
import repro.sim.engine as ref_engine  # noqa: E402
import repro.sim.gpu as ref_gpu  # noqa: E402
import repro.sim.power as ref_power  # noqa: E402
import repro.workloads as ref_workloads  # noqa: E402

import repro_torch.serving as port_serving  # noqa: E402
import repro_torch.serving.faults as port_faults  # noqa: E402
import repro_torch.serving.sweep as port_sweep  # noqa: E402
import repro_torch.sim.analytic as port_analytic  # noqa: E402
import repro_torch.sim.batch as port_batch  # noqa: E402
import repro_torch.sim.designs as port_designs  # noqa: E402
import repro_torch.sim.engine as port_engine  # noqa: E402
import repro_torch.sim.gpu as port_gpu  # noqa: E402
import repro_torch.sim.power as port_power  # noqa: E402
import repro_torch.workloads as port_workloads  # noqa: E402

pytestmark = pytest.mark.filterwarnings(
    "ignore::DeprecationWarning")  # os.fork + threads (torch) in pool workers

ROOT = pathlib.Path(__file__).resolve().parents[1]
DESIGNS = ("BL", "RFC", "SHRF", "LTRF", "LTRF_conf", "LTRF_plus", "Ideal")
LISTING1 = "listing1_sweep_service"     # registered under a name of its own


def _port_cfg(cfg):
    return port_engine.SimConfig(**asdict(cfg))


def _ref_cfg(cfg):
    return ref_engine.SimConfig(**asdict(cfg))


def _ref_result(name, cfg) -> dict:
    """The reference's scalar engine on the same job, as a dict."""
    return asdict(ref_engine.simulate(ref_workloads.get_workload(name), _ref_cfg(cfg)))


def _runner(tmp, **kw):
    kw.setdefault("device", "cpu")
    kw.setdefault("processes", 1)
    return port_sweep.SimRunner(cache_dir=tmp, **kw)


@pytest.fixture
def listing1():
    """Listing 1 registered in both packages' workload registries (the
    service resolves jobs by name), removed afterwards."""
    for pkg in (ref_workloads, port_workloads):
        pkg.register_workload(pkg.Workload(
            name=LISTING1, program=pkg.listing1_program(), trips={"L1": 100},
            register_sensitive=False, regs_per_thread=8, suite="paper"))
    yield [(LISTING1, port_designs.design_config(d, table2_config=7, num_warps=16))
           for d in DESIGNS]
    for pkg in (ref_workloads, port_workloads):
        del pkg.WORKLOADS[LISTING1]


# ----------------------------------------------------------- batch and pool

def test_batch_prefill_gives_the_reference_engine(listing1, tmp_path):
    runner = _runner(tmp_path, batch=True)
    report = runner.prefill(listing1)
    assert report.ok and report.computed == len(listing1) == 7
    assert runner.stats["batched"] == 7
    for name, cfg in listing1:
        assert asdict(runner.sim(name, cfg)) == _ref_result(name, cfg), cfg.design


def test_pool_prefill_gives_the_reference_engine(tmp_path):
    jobs = [(n, port_engine.SimConfig(design=d, num_warps=4, seed=s))
            for n in ("kmeans", "bfs") for d in ("BL", "LTRF") for s in range(2)]
    runner = _runner(tmp_path, processes=2, batch=False)
    report = runner.prefill(jobs)
    assert report.ok and report.computed == len(jobs) and runner.stats["batched"] == 0
    for name, cfg in jobs:
        assert asdict(runner.sim(name, cfg)) == _ref_result(name, cfg)


def test_batch_budget_outcomes_recorded_not_retried(tmp_path):
    """A lane that blows the sweep's watchdog is a ``budget`` failure on the
    batch path too, charged one attempt, never retried."""
    runner = _runner(tmp_path, batch=True,
                     sweep=port_sweep.SweepConfig(watchdog_max_cycles=50))
    jobs = [("kmeans", port_engine.SimConfig(design="BL", num_warps=4, seed=s))
            for s in range(3)]
    report = runner.prefill(jobs)
    assert not report.ok and len(report.failed) == 3 and report.retried == {}
    assert runner.stats["batched"] == 0
    for rec in report.failed:
        assert rec.kind == "budget" and rec.attempts == 1
        assert "max_cycles=50" in rec.detail


# --------------------------------------------------- the planted failure

def _raise(*args, **kwargs):
    raise RuntimeError("planted whole-batch failure")


def test_whole_batch_failure_raises_out_of_prefill(listing1, tmp_path, monkeypatch):
    monkeypatch.setattr(port_batch, "run_batch", _raise)
    runner = _runner(tmp_path, processes=2, batch=True)
    with pytest.raises(RuntimeError, match="planted whole-batch failure"):
        runner.prefill(listing1)
    assert runner.stats["computed"] == 0
    assert not list(tmp_path.glob("*.json"))          # nothing finished elsewhere


def test_reference_absorbs_the_same_failure(listing1, tmp_path, monkeypatch):
    """The behaviour the port changes: the reference finishes the sweep on
    its classic backends and reports nothing of the failure."""
    import repro.sim.batch as ref_batch
    monkeypatch.setattr(ref_batch, "run_batch", _raise)
    jobs = [(n, _ref_cfg(c)) for n, c in listing1[:2]]
    runner = ref_sweep.SimRunner(processes=1, batch=True, cache_dir=tmp_path)
    report = runner.prefill(jobs)
    assert report.ok and report.computed == 2 and runner.stats["batched"] == 0


def test_prefill_batch_has_no_handler():
    tree = ast.parse((ROOT / "src/repro_torch/serving/sweep.py").read_text())
    runner = next(n for n in tree.body if isinstance(n, ast.ClassDef) and n.name == "SimRunner")
    fn = next(n for n in runner.body if getattr(n, "name", "") == "_prefill_batch")
    assert not [n for n in ast.walk(fn) if isinstance(n, ast.Try)]


# ------------------------------------------------------------- 'auto' mode

@pytest.mark.parametrize("misses", [8, 64])
def test_auto_mode_never_batches_on_the_cpu(tmp_path, monkeypatch, misses):
    monkeypatch.delenv("REPRO_SIM_BATCH", raising=False)
    monkeypatch.setattr(port_batch, "run_batch", _raise)
    runner = _runner(tmp_path)
    assert runner._batch_mode() == "auto"
    jobs = [("bfs", port_engine.SimConfig(design="LTRF", num_warps=1, seed=s))
            for s in range(misses)]
    report = runner.prefill(jobs)
    assert report.ok and report.computed == misses and runner.stats["batched"] == 0


@pytest.mark.parametrize("misses", [7, 8])
def test_auto_mode_batches_at_8_misses_on_the_card(tmp_path, monkeypatch, misses):
    """The card faked: the runner's device reads ``cuda`` and the engine
    records its calls and returns the scalar engine's results."""
    monkeypatch.delenv("REPRO_SIM_BATCH", raising=False)
    calls = []

    def fake(jobs, device):
        calls.append((len(jobs), device.type))
        return [port_engine.simulate(w, cfg) for w, cfg in jobs]

    monkeypatch.setattr(port_batch, "run_batch", fake)
    runner = _runner(tmp_path)
    runner.device = torch.device("cuda")
    jobs = [("bfs", port_engine.SimConfig(design="LTRF", num_warps=1, seed=s))
            for s in range(misses)]
    report = runner.prefill(jobs)
    assert report.ok and report.computed == misses
    assert calls == ([(8, "cuda")] if misses >= 8 else [])
    assert runner.stats["batched"] == (8 if misses >= 8 else 0)


# ------------------------------------------------------ the chaos suite

def _chaos_cases():
    for name, fn in vars(ref_chaos).items():
        if not (name.startswith("test_") and inspect.isfunction(fn)):
            continue
        marks = [m for m in getattr(fn, "pytestmark", []) if m.name == "parametrize"]
        if not marks:
            yield pytest.param(name, {}, id=name)
            continue
        (argname, values), = [m.args for m in marks]
        for v in values:
            yield pytest.param(name, {argname: v}, id=f"{name}[{v}]")


def _ref_simulate(workload, cfg):
    """The reference engine on a port job, its result as the port's type."""
    return port_engine.SimResult(**_ref_result(workload.name, cfg))


@pytest.fixture
def chaos_on_port(monkeypatch):
    """Point the reference chaos suite's names at the port's copies; its
    "== simulate(...)" checks then hold the port's service to the
    reference's engine."""
    def runner(*args, **kwargs):
        kwargs.setdefault("device", "cpu")
        return port_sweep.SimRunner(*args, **kwargs)

    names = {
        "faults": port_faults, "sweep_mod": port_sweep, "SimRunner": runner,
        "simulate": _ref_simulate, "WORKLOADS": port_workloads.WORKLOADS,
        "SimConfig": port_engine.SimConfig, "SimBudgetExceeded": port_engine.SimBudgetExceeded,
        "CFG": port_engine.SimConfig(**asdict(ref_chaos.CFG)),
        "FAST": port_sweep.SweepConfig(**asdict(ref_chaos.FAST)),
    }
    names.update({n: getattr(port_sweep, n) for n in (
        "FAILURE_KINDS", "FailureRecord", "ResultStore", "SweepConfig", "SweepReport",
        "job_label", "sim_key")})
    for name, value in names.items():
        monkeypatch.setattr(ref_chaos, name, value)
    # nothing of the JAX package is left in the suite's namespace
    for name, value in vars(ref_chaos).items():
        mod = getattr(value, "__module__", None) or getattr(value, "__name__", "")
        if name in names or not isinstance(mod, str) or value is ref_chaos:
            continue
        assert not (mod == "repro" or mod.startswith("repro.")), name


@pytest.mark.parametrize("name, params", list(_chaos_cases()))
def test_reference_chaos_suite_on_the_port(chaos_on_port, name, params, tmp_path,
                                           monkeypatch):
    fn = getattr(ref_chaos, name)
    fixtures = {"tmp_path": tmp_path, "monkeypatch": monkeypatch}
    fn(**{p: fixtures.get(p, params.get(p)) for p in inspect.signature(fn).parameters})


def test_chaos_suite_replays_the_reference_tests():
    names = {p.values[0] for p in _chaos_cases()}
    assert {"test_chaos_acceptance_sweep", "test_corrupt_entry_quarantined_not_silently_recomputed",
            "test_rev_bump_misses_disk_cache", "test_sim_key_includes_all_three_revs",
            "test_hybrid_degrades_to_engine_on_corrupt_calibration"} <= names
    assert len(list(_chaos_cases())) == 33


# ------------------------------------------------------- the store, both ways

def _store_jobs():
    return [(n, port_engine.SimConfig(design=d, num_warps=4, seed=s))
            for n in ("kmeans", "bfs") for d in ("BL", "LTRF") for s in range(2)]


def test_port_entries_read_by_the_reference(tmp_path):
    jobs = _store_jobs()
    writer = _runner(tmp_path, batch=False)
    assert writer.prefill(jobs).computed == len(jobs)
    est = writer.estimate(*jobs[0])
    reader = ref_sweep.SimRunner(processes=1, batch=False, cache_dir=tmp_path)
    report = reader.prefill([(n, _ref_cfg(c)) for n, c in jobs])
    assert report.cached == len(jobs) and report.computed == 0
    assert reader.stats["disk_hits"] == len(jobs) and reader.stats["quarantined"] == 0
    for name, cfg in jobs:
        assert asdict(reader.sim(name, _ref_cfg(cfg))) == asdict(writer.sim(name, cfg))
    assert asdict(reader.estimate(jobs[0][0], _ref_cfg(jobs[0][1]))) == asdict(est)
    assert reader.stats["analytic_disk_hits"] == 1


def test_reference_entries_read_by_the_port(tmp_path):
    jobs = _store_jobs()
    writer = ref_sweep.SimRunner(processes=1, batch=False, cache_dir=tmp_path)
    writer.prefill([(n, _ref_cfg(c)) for n, c in jobs])
    reader = _runner(tmp_path, batch=True)
    report = reader.prefill(jobs)
    assert report.cached == len(jobs) and report.computed == 0
    assert reader.stats["disk_hits"] == len(jobs) and reader.stats["batched"] == 0
    for name, cfg in jobs:
        assert asdict(reader.sim(name, cfg)) == asdict(writer.sim(name, _ref_cfg(cfg)))


def test_keys_and_run_ids_equal_across_packages():
    jobs = _store_jobs()
    ref_jobs = [(n, _ref_cfg(c)) for n, c in jobs]
    assert [port_sweep.sim_key(*j) for j in jobs] == [ref_sweep.sim_key(*j) for j in ref_jobs]
    assert port_sweep.sweep_run_id(jobs) == ref_sweep.sweep_run_id(ref_jobs)
    calib = port_analytic.DEFAULT_CALIBRATION
    assert asdict(calib) == asdict(ref_analytic.DEFAULT_CALIBRATION)
    assert [port_sweep.analytic_sim_key(*j, calib) for j in jobs] == \
        [ref_sweep.analytic_sim_key(*j, ref_analytic.DEFAULT_CALIBRATION) for j in ref_jobs]


# ---------------------------------------------------- the analytic tier

@pytest.mark.parametrize("workloads", [("pathfinder", "bfs"), ("kmeans", "srad")])
def test_analytic_estimates_equal(workloads):
    grid = [j for j in screening_jobs(workloads=workloads, rf_sizes_kb=(256,))]
    assert len(grid) == 268
    for name, cfg in grid:
        assert port_analytic.analytic_supported(_port_cfg(cfg)) == \
            ref_analytic.analytic_supported(cfg)
        got = port_analytic.estimate(port_workloads.get_workload(name), _port_cfg(cfg))
        want = ref_analytic.estimate(ref_workloads.get_workload(name), cfg)
        assert asdict(got) == asdict(want), (name, cfg)
    pts = [(float(i % 7), float((i * 5) % 11)) for i in range(60)]
    assert port_analytic.pareto_frontier(pts) == ref_analytic.pareto_frontier(pts)


def test_hybrid_tier_confirms_the_reference_frontier(tmp_path):
    """The hybrid tier picks the reference's confirmations, and the engine's
    results for them are the reference engine's."""
    grid = screening_jobs(workloads=("bfs",), rf_sizes_kb=(256,), mults=(1.0, 2.0))
    grid = [(n, replace(c, num_warps=4)) for n, c in grid]
    port_jobs = [(n, _port_cfg(c)) for n, c in grid]
    port = _runner(tmp_path / "port", tier="hybrid", batch=False)
    ref = ref_sweep.SimRunner(processes=1, batch=False, cache_dir=tmp_path / "ref",
                              tier="hybrid")
    got, want = port.prefill(port_jobs), ref.prefill(grid)
    assert got.ok and got.frontier_jobs == want.frontier_jobs
    assert got.frontier_confirmed == want.frontier_confirmed > 0
    confirmed = [j for j in port_jobs if port.store.path(port_sweep.sim_key(*j)).exists()]
    assert len(confirmed) == got.frontier_confirmed
    for name, cfg in confirmed:
        assert asdict(port.sim(name, cfg)) == _ref_result(name, cfg)


# ---------------------------------------------- the whole-GPU model and power

@pytest.mark.parametrize("scheduler", ["two_level", "gto", "lrr"])
def test_simulate_gpu_equal(scheduler):
    for name, cfg in gpu_sweep_jobs(warps_per_sm=2, schedulers=(scheduler,)):
        got = port_gpu.simulate_gpu(port_workloads.get_workload(name), _port_cfg(cfg))
        want = ref_gpu.simulate_gpu(ref_workloads.get_workload(name), cfg)
        assert asdict(got) == asdict(want), (name, cfg.design)
        assert (got.ipc, got.sm_imbalance) == (want.ipc, want.sm_imbalance)
        for tech in ref_power.E_MRF:
            for cap in (1, 8):
                assert asdict(port_power.gpu_rf_power(got, tech, cap_mult=cap)) == \
                    asdict(ref_power.gpu_rf_power(want, tech, cap_mult=cap))


def test_service_whole_gpu_batches_two_level_per_sm_jobs(listing1, tmp_path):
    """``prefill_gpu`` + ``sim_gpu``: the two_level per-SM jobs go to the
    batch engine, the others to the scalar engine, and each whole-GPU result
    is the reference model's."""
    jobs = [(LISTING1, replace(cfg, num_sms=2, scheduler=s))
            for _, cfg in listing1 if cfg.design in ("BL", "LTRF")
            for s in ("two_level", "gto", "lrr")]
    runner = _runner(tmp_path, batch=True)
    report = runner.prefill_gpu(jobs)
    assert report.ok and report.computed == 12 and runner.stats["batched"] == 4
    for name, cfg in jobs:
        want = ref_gpu.simulate_gpu(ref_workloads.get_workload(name), _ref_cfg(cfg))
        assert asdict(runner.sim_gpu(name, cfg)) == asdict(want), (cfg.design, cfg.scheduler)


@pytest.mark.parametrize("table2_config", [6, 7])
def test_power_comparison_equal(table2_config):
    got = port_power.power_comparison(port_workloads.get_workload("bfs"), table2_config)
    want = ref_power.power_comparison(ref_workloads.get_workload("bfs"), table2_config)
    assert got == want
    res = ref_engine.simulate(ref_workloads.get_workload("bfs"), ref_engine.SimConfig())
    port_res = port_engine.SimResult(**asdict(res))
    for tech in ref_power.E_MRF:
        assert asdict(port_power.rf_power(port_res, tech)) == asdict(ref_power.rf_power(res, tech))


# ------------------------------------------------------------- metrics

def test_metrics_snapshot_matches_the_reference_shape(tmp_path):
    jobs = _store_jobs()[:4]
    port = _runner(tmp_path / "port", batch=False)
    ref = ref_sweep.SimRunner(processes=1, batch=False, cache_dir=tmp_path / "ref")
    port.prefill(jobs)
    ref.prefill([(n, _ref_cfg(c)) for n, c in jobs])
    got, want = port.metrics_snapshot(), ref.metrics_snapshot()
    assert got["run_id"] == want["run_id"] and sorted(got) == sorted(want)
    counters = [k for k in want if k.startswith("sweep_") and not isinstance(want[k], dict)]
    assert counters and {k: got[k] for k in counters} == {k: want[k] for k in counters}
    assert json.loads(json.dumps(got)) == got
    names = [line.split()[2] for line in port.metrics.to_prometheus().splitlines()
             if line.startswith("# TYPE")]
    assert names == [line.split()[2] for line in ref.metrics.to_prometheus().splitlines()
                     if line.startswith("# TYPE")]
    assert port_serving.SimRunner is port_sweep.SimRunner
