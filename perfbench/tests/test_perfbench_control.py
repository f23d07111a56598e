"""The control kept as a test at a size a test run holds: the plain
reference computed in float8 in the program's place reads at least three
times what the program's sound run reads on one of the cell's numbers (the
readings on the card at the cell's own size are in PERF.md)."""
import time

import pytest
import torch

from perfbench import calibrate, harness
from perfbench.tests.conftest import SMOKE_SECONDS, smoke

CELLS = [w["name"] for w in harness.benchmark()["workloads"]]


@pytest.mark.parametrize("workload", CELLS)
def test_control_reads_far_above_the_program(workload):
    sizes = smoke(workload)
    result, rec = harness.run_cell(workload, 2**31 + 41, SMOKE_SECONDS, False, "cpu",
                                   time.perf_counter(), sizes=sizes)
    w = harness.cell(harness.benchmark(), workload)
    mix = {**harness.load_json(harness.HERE / "mixes" / f"{w['traffic']}.json"), **sizes["mix"]}
    ctl = calibrate.control(mix, 2**31 + 41, rec, torch.device("cpu"))
    prog = {k: c["value"] for k, c in result["checks"].items()}
    separated = [k for k in prog if k in ctl and ctl[k] >= 3 * prog[k] and ctl[k] > 0]
    assert separated, (prog, ctl)
