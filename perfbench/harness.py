"""The harness: finds a cell's files by name, runs its driver, reads its metrics.

Everything that belongs to one configuration, traffic mix, cell or metric
lies in a file of its own, found by the name ``BENCHMARK.json`` gives:

- ``configs/<config>.json``: the model as it is run (``arch``: the fields
  of the program's ``ArchConfig``, which the plain reference reads too);
- ``mixes/<traffic>.json``: the traffic's parameters and its ``driver``;
- ``drivers/<driver>.py``: ``run(ctx) -> record``;
- ``limits/<cell>.json``: the limit of every number the cell compares;
- ``metrics/<metric>.py``: ``read(record) -> number or None``.

``run_cell`` runs one cell once and returns the result line's object.
"""
from __future__ import annotations

import importlib.util
import json
import math
from pathlib import Path
from types import SimpleNamespace

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def load_module(path: Path):
    """A module from a file whose name may hold dots (``mfu.decode.py``)."""
    name = "perfbench_file_" + "".join(c if c.isalnum() else "_" for c in
                                       str(path.relative_to(HERE)))
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell(bench: dict, workload: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == workload:
            return w
    raise KeyError(f"no workload {workload!r} in BENCHMARK.json; have "
                   f"{[w['name'] for w in bench['workloads']]}")


def metrics_of(bench: dict, workload: str, trace: bool) -> list:
    """The cell's end-to-end metrics (``trace`` off) or per-layer ones (on):
    those whose ``workloads`` list it (an end-to-end metric without the
    list is every cell's; every per-layer metric lists its cells)."""
    if not trace:
        return [m for m in bench["end_to_end"] if workload in m.get("workloads", [workload])]
    return [m for m in bench["per_layer"] if workload in m["workloads"]]


def forbidden_modules(modules) -> list:
    """Loaded modules whose top-level name is one the benchmark must not
    load (compared whole: ``repro_torch`` is allowed, ``repro`` is not)."""
    return sorted(m for m in modules if m.split(".")[0] in FORBIDDEN)


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device, t_start: float,
             sizes: dict | None = None):
    """Run ``workload`` once: (the result line's object, the driver's
    record).  ``sizes`` serves the tests alone: ``{"arch": {...}, "mix":
    {...}}`` overrides the configuration's and the mix's numbers, so that a
    smoke-size model and mix run on the CPU."""
    import torch

    bench = benchmark()
    w = cell(bench, workload)
    conf = load_json(HERE / "configs" / f"{w['config']}.json")
    sizes = sizes or {}
    mix = {**load_json(HERE / "mixes" / f"{w['traffic']}.json"), **sizes.get("mix", {})}
    limits = load_json(HERE / "limits" / f"{workload}.json")
    driver = load_module(HERE / "drivers" / f"{mix['driver']}.py")
    ctx = SimpleNamespace(arch={**conf["arch"], **sizes.get("arch", {})}, mix=mix, seed=seed,
                          seconds=seconds, trace=trace, device=torch.device(device),
                          t_start=t_start)
    rec = driver.run(ctx)

    out = {}
    for m in metrics_of(bench, workload, trace):
        value = load_module(HERE / "metrics" / f"{m['name']}.py").read(rec)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    readings = rec["readings"]
    if set(readings) != set(limits):
        raise RuntimeError(f"readings {sorted(readings)} and limits {sorted(limits)} differ")
    checks = {k: {"value": readings[k], "limit": limits[k]} for k in sorted(readings)}
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    attempted, failed = rec["attempted"], rec["failed"]
    dev = ctx.device
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
              "count": w["chips"], "memory_peak_bytes": rec["memory_peak_bytes"]}
    result = {"correct": correct and failed == 0, "attempted": attempted, "failed": failed,
              "metrics": out, "device": device}
    if trace and "trace" in rec:
        device["busy_s"] = rec["trace"]["busy_s"]
        device["window_s"] = rec["trace"]["window_s"]
        result["breakdown"] = {"device_ops": rec["trace"]["device_ops"],
                               "idle_gaps": rec["trace"]["idle_gaps"]}
    result["checks"] = checks
    return result, rec
