"""The readings a serving cell's limits are set from, on the card, in one process.

    python perfbench/calibrate.py --workload <cell> --seeds <a,b,...> \
        [--control <k>] --seconds <s>

For each seed it runs the cell as ``run.py`` does (the same driver, window
and comparison) and prints the program's readings; for the first ``k``
seeds it also reads the control: the plain reference computed in float8 in
the program's place (on the tokens the program was fed, the gap of the
token float8 puts first).  One JSON line per reading goes to standard
output.  The benchmark's own runs never run this.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def control(mix: dict, seed: int, rec: dict, dev) -> dict:
    """The control's gap statistics for the run ``rec`` (a serving
    driver's record) made from ``seed``."""
    from perfbench import harness
    driver = harness.load_module(harness.HERE / "drivers" / f"{mix['driver']}.py")
    gaps = driver.replay(rec["arch"], seed, dev, rec["slots"], mix["max_len"], rec["feeds"],
                         rec["served"], rec["cache_lens"], "fp8")
    return driver.gap_stats(gaps, rec["active"])


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=30.0)
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    from perfbench import harness

    w = harness.cell(harness.benchmark(), args.workload)
    mix = harness.load_json(harness.HERE / "mixes" / f"{w['traffic']}.json")

    def emit(seed, kind, readings, **extra):
        print(json.dumps({"workload": args.workload, "seed": seed, "kind": kind,
                          "readings": readings, **extra}), flush=True)

    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        res, rec = harness.run_cell(args.workload, seed, args.seconds, False, "cuda", t)
        emit(seed, "program", {k: c["value"] for k, c in res["checks"].items()},
             stats=rec["gap_stats"], memory_peak_bytes=rec["memory_peak_bytes"],
             metrics={k: m["value"] for k, m in res["metrics"].items()},
             seconds=time.perf_counter() - t)
        if i < args.control:
            t = time.perf_counter()
            emit(seed, "control", control(mix, seed, rec, torch.device("cuda")),
                 seconds=time.perf_counter() - t)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
