"""Shared settings of the benchmark's CPU tests: smoke-size models and mixes
that a test run can hold, and the repository's paths."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

SMOKE_ARCH = {
    "granite-moe-3b-a800m": dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=64,
                                 vocab=2048, n_experts=8, top_k=2),
}
SMOKE_MIX = {
    "serve": dict(active_slots=4, max_len=64, total_pages=64, backlog=32, warmup_steps=2,
                  trace_steps=3,
                  prompt_len={"dist": "lognormal", "median": 16, "sigma": 0.5, "min": 4, "max": 64},
                  new_tokens={"dist": "lognormal", "median": 3, "sigma": 0.5, "min": 2, "max": 8}),
}
# a window of 0 seconds runs the driver's least number of steps
SMOKE_SECONDS = 0.0


def smoke(workload: str) -> dict:
    """run_cell's ``sizes`` that shrink ``workload`` to smoke size."""
    from perfbench import harness
    w = harness.cell(harness.benchmark(), workload)
    driver = harness.load_json(harness.HERE / "mixes" / f"{w['traffic']}.json")["driver"]
    return {"arch": SMOKE_ARCH[w["config"]], "mix": SMOKE_MIX[driver]}


@pytest.fixture
def root() -> Path:
    return ROOT
