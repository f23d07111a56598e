"""The timed path broken underneath a run (the chip's look skipped, the rest
of the run driven on the CPU at smoke size): ``correct`` must come out false
for every fault a serving cell can have.  Each fault replaces the engine's
decode step, which the driver's window calls."""
import time

import pytest

from perfbench import harness
from perfbench.tests.conftest import SMOKE_SECONDS, smoke

CELLS = [w["name"] for w in harness.benchmark()["workloads"]]


def state_unchanged(engine, step, cache_len):
    """The step computes its tokens but leaves its caches as they were."""
    kept = {k: t.clone() for k, t in engine.cache.items()}
    out = step(cache_len)
    for k, t in engine.cache.items():
        t.copy_(kept[k])
    return out


def half_batch(engine, step, cache_len):
    """The second half of the slots is left out: its rows come back zero."""
    out = step(cache_len).clone()
    out[out.shape[0] // 2:] = 0
    return out


def token_altered(engine, step, cache_len):
    """One slot's token is changed where the step produces it."""
    out = step(cache_len).clone()
    out[0] = (out[0] + 1) % engine.cfg.vocab
    return out


FAULTS = {"state_unchanged": state_unchanged, "half_batch": half_batch,
          "token_altered": token_altered}


def run(workload):
    return harness.run_cell(workload, 2**31 + 29, SMOKE_SECONDS, False, "cpu",
                            time.perf_counter(), sizes=smoke(workload))[0]


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("workload", CELLS)
def test_fault_makes_the_run_incorrect(workload, fault, monkeypatch):
    from repro_torch.serving import ServingEngine
    sound = ServingEngine.decode
    monkeypatch.setattr(ServingEngine, "decode", lambda self, cache_len: FAULTS[fault](
        self, lambda n: sound(self, n), cache_len))
    result = run(workload)
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(workload):
    result = run(workload)
    assert result["correct"], result["checks"]
