"""A CPU rehearsal of the driver at smoke size: the backlog, one ``run()``
call a window, the step timestamps, the traced slice, the reference's
comparison and the result line.  Nothing here is a device number: these
runs take the plain path on the CPU."""
import math
import time

import pytest

from perfbench import harness
from perfbench.tests.conftest import SMOKE_SECONDS, smoke

CELLS = [w["name"] for w in harness.benchmark()["workloads"]]


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("workload", CELLS)
def test_cell_runs_on_cpu_at_smoke_size(workload, trace):
    result, rec = harness.run_cell(workload, 2**31 + 17, SMOKE_SECONDS, trace, "cpu",
                                   time.perf_counter(), sizes=smoke(workload))
    assert result["correct"], result["checks"]
    assert list(result)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(result)
    assert result["attempted"] > 0 and result["failed"] == 0
    want = {m["name"] for m in harness.metrics_of(harness.benchmark(), workload, trace)}
    got = set(result["metrics"])
    if not trace:
        assert got == want
    else:      # the device's readers find nothing to read on the CPU
        assert got <= want and "breakdown" in result
    for m in result["metrics"].values():
        assert math.isfinite(m["value"])
    assert rec["steps"] == len(rec["starts"]) == 4
    assert all(b > a for a, b in zip(rec["starts"], rec["starts"][1:]))
    assert rec["tokens"] == sum(rec["active"])
    # requests ended and their slots were refilled inside the window
    assert rec["attempted"] > rec["slots"]
    assert set(rec["gap_stats"]) >= {"mean_logit_gap", "slot_mean_logit_gap_max"}
