"""The port's batch simulator held to the JAX package's scalar event engine
(``repro.sim.engine.simulate``) and golden oracle (``golden_simulate``), on
the CPU, part one: the FMA pin and budget outcomes of
``tests/test_sim_batch.py`` (the rest, and the batch fuzz of
``tests/test_sim_fuzz.py``, are in ``test_torch_sim_batch_fuzz.py``).  Results are compared field by field
(``asdict``: the packages' dataclasses differ), ``cycle_breakdown``
included; budget outcomes are compared by their arguments.
"""
from dataclasses import asdict, replace

import pytest

pytest.importorskip("torch")

import repro.sim.engine as ref_engine  # noqa: E402
from repro.sim.golden import golden_simulate  # noqa: E402
from repro.workloads import WORKLOADS as REF_WORKLOADS  # noqa: E402

from repro_torch.sim import (  # noqa: E402
    SimBudgetExceeded, design_config, run_batch, simulate_batch,
)
from repro_torch.workloads import WORKLOADS  # noqa: E402


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


@pytest.fixture(scope="module")
def kmeans_bl_16w():
    """kmeans BL at Table-2 #7, 16 warps, run once in full and once under a
    budget of half its cycles, in one `run_batch` call (shared by the FMA
    pin and the budget test: 8091 ticks)."""
    cfg = design_config("BL", table2_config=7, num_warps=16)
    want = _want("kmeans", cfg)
    tight = replace(cfg, max_cycles=max(1, want["cycles"] // 2))
    ok, tripped = run_batch([(WORKLOADS["kmeans"], cfg), (WORKLOADS["kmeans"], tight)],
                            device="cpu")
    return cfg, tight, want, ok, tripped


def test_fma_contraction_regression_pin(kmeans_bl_16w):
    """The case where XLA's FMA contraction once flipped a token-bucket
    compare: full-structure equality with the event engine and golden."""
    _, _, want, ok, _ = kmeans_bl_16w
    assert asdict(ok) == want


def test_budget_outcomes_returned_not_raised(kmeans_bl_16w):
    cfg, tight, want, ok, tripped = kmeans_bl_16w
    assert asdict(ok) == want
    assert isinstance(tripped, SimBudgetExceeded)
    assert tripped.args == _ref_budget_args("kmeans", tight)
    w = WORKLOADS["kmeans"]
    lst = design_config("LTRF", table2_config=7, num_warps=2)
    with pytest.raises(SimBudgetExceeded) as exc:
        simulate_batch([(w, replace(lst, max_cycles=300)), (w, replace(lst, max_cycles=100))],
                       device="cpu")
    assert exc.value.args == _ref_budget_args("kmeans", replace(lst, max_cycles=300))
