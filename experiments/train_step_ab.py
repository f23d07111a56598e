"""Time tinyllama-1.1b's train step on the card, one tree of the port at a time.

    PYTHONPATH=<tree>/src python3 experiments/train_step_ab.py --label <name>

For an A/B comparison of two trees (a parent and a change) run it once per
tree, in turns (parent, change, change, parent) in one session on one card:
host times vary by a few per cent between machines and over minutes.  The
step is chip_smoke.py's train_tinyllama step: full width and depth, bf16,
remat as configured, B=8 x S=1024 from the data pipeline, the same AdamW
settings.  One warm-up step, then ``--steps`` steps timed on the host clock
(each ends in a synchronise), then one step under ``torch.profiler``: its
device-busy ms (kernels, copies and memsets) and the device ms of each
``ltrf_matmul`` kernel by name.  Prints one JSON line with the card's name
and power limit; the CUDA kernels build at first use under the tree.
"""
import argparse
import json
import os
import statistics
import subprocess
import tempfile
import time

os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.data import batch_for_step  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.optim import AdamWConfig  # noqa: E402
from repro_torch.runtime import build_train_step, make_train_state  # noqa: E402

ARCH, B, S = "tinyllama-1.1b", 8, 1024


def device_ms(prof) -> tuple[float, dict]:
    """Device-busy ms of the profiled window (kernels, copies and memsets in
    its Chrome trace) and ms by ltrf_matmul kernel."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    busy, matmul = 0.0, {}
    for e in events:
        if e.get("cat") not in ("kernel", "gpu_memcpy", "gpu_memset"):
            continue
        busy += e["dur"] / 1e3
        if "ltrf_matmul" in e["name"]:
            name = e["name"].replace("void (anonymous namespace)::", "").split("(")[0]
            matmul[name] = matmul.get(name, 0.0) + e["dur"] / 1e3
    return busy, matmul


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--label", required=True)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("train_step_ab: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build(["ltrf_matmul", "flash_attention", "flash_attention_bwd"])
    dev = torch.device("cuda", 0)
    cfg = get_arch(ARCH)
    state = make_train_state(cfg, torch.Generator(dev).manual_seed(args.seed), dev)
    step = build_train_step(cfg, AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=6))
    shape = ShapeConfig("ab_train", S, B, "train")
    batches = [batch_for_step(cfg, shape, s, args.seed + 1) for s in range(args.steps + 1)]
    state, _ = step(state, batches[0])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    walls = []
    for b in batches[1:]:
        t0 = time.perf_counter()
        state, _ = step(state, b)
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
    peak = torch.cuda.max_memory_allocated() / 1e9
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        state, _ = step(state, batches[1])
        torch.cuda.synchronize()
    busy, matmul = device_ms(prof)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(json.dumps({"label": args.label, "card": card.strip(), "step_ms": walls,
                      "median_step_ms": statistics.median(walls),
                      "device_busy_ms": busy, "ltrf_matmul_ms": matmul,
                      "peak_memory_gb": peak}), flush=True)


if __name__ == "__main__":
    main()
