"""Serving driver: continuous batching with paged KV on one device.

``python -m repro_torch.launch.serve --arch granite-moe-3b-a800m --full``
(``--arch`` takes every id of ``repro_torch.configs.ARCH_IDS``)

Wraps the ServingEngine (two-level request scheduler + the paper's Address
Allocation Unit for KV pages) with a synthetic request generator and random
weights made from ``--seed``, and reports throughput and fairness stats.
Runs on the CUDA card unless ``--device cpu`` is given.  On the card the
engine captures its decode step as a CUDA graph before the timed window
(``capture_s``, printed beside ``ms_per_step`` and ``tok_per_s``, which are
then the replayed steady state); ``serve(..., graphs=False)`` runs the step
eagerly.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from .. import resolve_device
from ..configs import ARCH_IDS, get_arch, get_smoke
from ..serving import ServeConfig, ServingEngine


def serve(arch_id: str, smoke: bool = True, n_requests: int = 16,
          max_new: int = 12, seed: int = 0, active_slots: int = 4,
          total_pages: int = 32, max_len: int = 128, device="cuda",
          graphs: bool = True, params=None) -> dict:
    """Serve ``n_requests`` synthetic requests made from ``seed`` to completion.
    ``params``: the weights (default: random, from ``seed``); ``graphs``: the
    engine's (a CUDA graph of the step on the card, else eager).  The stats
    include each request's greedy tokens (``generated``)."""
    cfg = get_smoke(arch_id) if smoke else get_arch(arch_id)
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    engine = ServingEngine(cfg, params=params, sc=ServeConfig(
        max_len=max_len, active_slots=active_slots, total_pages=total_pages),
        generator=torch.Generator(dev).manual_seed(seed), device=dev, graphs=graphs)
    for _ in range(n_requests):
        prompt = rng.integers(0, cfg.vocab, rng.integers(1, 8)).tolist()
        engine.submit(prompt, max_new_tokens=int(rng.integers(2, max_new + 1)))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    out = engine.run()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    tokens = sum(len(v) for v in out.values())
    engine.aau.check_invariants()
    return {
        "requests": n_requests,
        "completed": len(engine.sched.finished),
        "tokens": tokens,
        "steps": engine.steps,
        "tok_per_s": tokens / max(dt, 1e-9),
        "ms_per_step": 1e3 * dt / max(engine.steps, 1),
        "preemptions": engine.sched.preemptions,
        "pages_leaked": engine.aau.used_count,
        "wall_s": dt,
        "capture_s": engine.capture_s,
        "graphs": engine.graph is not None,
        "device": str(dev),
        "generated": out,
    }


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b", choices=ARCH_IDS)
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    stats = serve(args.arch, smoke=not args.full, n_requests=args.requests,
                  seed=args.seed, device=args.device)
    print(", ".join(f"{k}={v if not isinstance(v, float) else round(v, 2)}"
                    for k, v in stats.items() if k != "generated"))


if __name__ == "__main__":
    main()
