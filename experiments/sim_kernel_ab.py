"""Time the batch simulator's kernel (``csrc/sim_batch.cu``) on the card, one
tree of the port at a time.

    python3 experiments/sim_kernel_ab.py --tree <tree> --label <name>

For an A/B comparison of two trees (a parent and a change) run it once per
tree, in turns (parent, change, change, parent), one after another on one card.
``--tree`` (default: this script's checkout) is the checkout whose port and
``chip_smoke.py`` run: the script imports that ``chip_smoke.py``, which puts
the tree's ``src`` first on the path.  The chunks are the tree's
``chip_smoke.py``'s: the tracked sweep's (``sim_sweep_jobs()``), the traced
sweep's (``sim_sweep_jobs(names=TRACED_NAMES)``) and ``sim_batch``'s 8-lane
chunks (``SIM_NARROW_WORKLOADS`` x ``SIM_DESIGNS`` at Table-2 #7), each cut
as ``run_batch`` cuts it on the card (``_chunk_lanes``).  Each chunk runs
alone, ``--reps`` times, one launch a run (CUDA events over the launch): µs
a tick over its longest lane's ticks; then each sweep's chunks run
together, each on its own stream, as the sweep service runs them (host
clock over the run with a sync).  Prints one JSON line: per chunk its
lanes, ticks, µs a tick, and where the tree's wrapper plans an image the
route, a lane's image bytes in shared memory, the CTAs an SM holds (the
occupancy calculator's) and the waves reckoned from it; the kernel's
registers and spills (``-Xptxas -v``); the card's name and power limit.
The kernel builds at first use under the tree.
"""
import argparse
import importlib
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path


def load_chip_smoke(tree: Path):
    """The tree's ``chip_smoke.py`` as a module (it puts the tree's ``src``
    first on the path, so the port imported after it is the tree's)."""
    sys.path.insert(0, str(tree.resolve()))
    return importlib.import_module("chip_smoke")


def lanes_of(cs, jobs) -> list:
    """``(workload name, config)`` jobs as the batch engine's lanes."""
    from repro_torch.sim import batch
    out = []
    for name, cfg in jobs:
        w = cs.sim_workload(name)
        out.append(batch._Lane(w, cfg, batch._encode_plan(w, cfg), batch._occupancy(w, cfg)))
    return out


def chunks_of(lanes, sub_lanes) -> list:
    from repro_torch.sim import batch
    return [c for c, _ in batch._chunk_lanes(lanes, list(range(len(lanes))), sub_lanes)]


def sweeps(cs) -> dict:
    """chip_smoke's chunks: the tracked sweep's, the traced sweep's and
    ``sim_batch``'s 8-lane ones."""
    from repro_torch.sim import batch
    sub = batch._SUB_LANES["cuda"]
    narrow = [(n, cs.design_config(d, table2_config=7)) for n in cs.SIM_NARROW_WORKLOADS
              for d in cs.SIM_DESIGNS]
    return {"tracked": chunks_of(lanes_of(cs, cs.sim_sweep_jobs()), sub),
            "traced": chunks_of(lanes_of(cs, cs.sim_sweep_jobs(names=cs.TRACED_NAMES)), sub),
            "narrow": chunks_of(lanes_of(cs, narrow), cs.SIM_NARROW_LANES)}


def registers() -> dict:
    """``-Xptxas -v``'s lines for the kernel: registers, shared memory, spills."""
    from repro_torch.kernels import _build
    log = (_build.BUILD_DIR / "sim_batch.log").read_text()
    return {"ptxas": [ln.strip() for ln in log.splitlines()
                      if re.search(r"registers|spill|Compiling entry", ln)]}


def residency(lanes) -> dict:
    """The route and image bytes ``plan`` gives the chunk, the CTAs an SM
    holds, and the waves the chunk's CTAs take alone on this card."""
    from repro_torch.kernels.sim_batch import ops
    from repro_torch.sim import batch
    if not hasattr(ops, "plan"):       # a tree before the image: no shared memory
        return {"route": None, "image_bytes": 0, "ctas_per_sm": None, "waves": None}
    co, st = batch._build(lanes)
    name, nbytes = ops.plan(ops.widths(co, batch._trash(st), batch._dims(co, st)))
    K = st["wf"].shape[0]
    return {"route": name, "image_bytes": nbytes, "ctas_per_sm": ops.ctas_per_sm(name, nbytes),
            "waves": ops.waves(name, nbytes, K)}


def time_chunk(lanes, reps) -> dict:
    """The chunk alone, ``reps`` launches: its ticks and µs a tick."""
    import torch
    from repro_torch.sim import batch
    us = []
    for _ in range(reps):
        co, st = batch._build(lanes)
        run = batch._KernelChunk(co, st, torch.device("cuda"))
        run.launch()
        run.settle()
        ticks = int(run.s["guard"].item())
        us.append(1e3 * run.stats["kernel_ms"] / ticks)
    return {"lanes": len(lanes), "K": batch._bucket(len(lanes), 2), "ticks": ticks,
            "us_per_tick": statistics.median(us), "us_per_tick_runs": us,
            **residency(lanes)}


def time_sweep(chunks, reps) -> list:
    """The sweep's chunks together, each on its own stream: host seconds."""
    import torch
    from repro_torch.sim import batch
    walls = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        batch._run_chunks(chunks, torch.device("cuda"))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return walls


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--label", required=True)
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--tree", type=Path, default=Path(__file__).resolve().parents[1])
    args = ap.parse_args()
    cs = load_chip_smoke(args.tree)
    import torch
    from repro_torch.kernels import _build
    if not torch.cuda.is_available():
        raise SystemExit("sim_kernel_ab: needs a CUDA card")
    _build.build(["sim_batch"])
    out = {"label": args.label, "tree": str(args.tree), "chunks": {}, "sweep_engine_s": {}}
    for name, chunks in sweeps(cs).items():
        time_sweep(chunks, 1)              # the build and first launch, untimed
        out["sweep_engine_s"][name] = time_sweep(chunks, args.reps)
        out["chunks"][name] = [time_chunk(lanes, args.reps) for lanes in chunks]
    for name, rows in out["chunks"].items():
        ctas = [r["ctas_per_sm"] for r in rows]
        if None not in ctas:
            sms = torch.cuda.get_device_properties(0).multi_processor_count
            out.setdefault("sweep_waves", {})[name] = math.ceil(
                sum(r["K"] / c for r, c in zip(rows, ctas)) / sms)
    out.update(registers())
    out["card"] = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                  "--format=csv,noheader"], capture_output=True,
                                 text=True).stdout.strip()
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
