"""Serving driver: a closed loop over the program's ``ServingEngine``.

Set-up makes the weights from the seed, builds the engine (on the card it
captures its decode step as a CUDA graph), runs the loop a few steps on
warm-up requests to time a step, then puts the engine back to its fresh
state (empty scheduler and page pool, zeroed caches and slot tokens) and
submits the mix's whole backlog, so ``waiting`` never empties in the
window; each slot's first input is the first token of its first request's
prompt (the engine feeds a slot its previous token and does not prefill).  The window is one ``engine.run(max_steps=n)`` call, n sized from
the warm-up's step time.  A thin wrapper on the engine's ``decode``
attribute records, at each entry, the time, the tokens fed to every slot,
the position and which request holds each slot; successive entries are one
whole step apart (replay, the host read of the tokens, the scheduler).

The check, once the window has closed and the program's state is freed:
the plain reference starts from zeroed caches, is fed the same tokens at
the same positions step by step, and at every step and slot gives the gap
by which the logit of the token the program served lies below its best.
Every token served in the window is compared; the number held to its limit
is the mean gap, and beside it the widest of the slots' own mean gaps, so
that a fault in one slot shows (the widest gap, its 99.9th percentile and
the share of tokens that are not the reference's first choice are printed).
"""
from __future__ import annotations

import gc
import sys
import time

import numpy as np
import torch

from perfbench import traffic, weights
from perfbench.reference import model as ref
from perfbench.trace import Slice


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _log(ctx, msg: str) -> None:
    print(f"[{time.perf_counter() - ctx.t_start:7.2f} s] {msg}", file=sys.stderr, flush=True)


def _reset(engine) -> None:
    """The engine as its constructor leaves it: no requests, every page
    free, caches and slot tokens zero (the caches zeroed in place: the
    captured step holds their addresses)."""
    from repro_torch.serving.allocator import AddressAllocationUnit
    from repro_torch.serving.scheduler import TwoLevelScheduler
    engine.aau = AddressAllocationUnit(engine.sc.total_pages)
    engine.sched = TwoLevelScheduler(engine.aau, active_slots=engine.sc.active_slots)
    engine.generated = {}
    engine.tokens[:] = 0
    engine.steps = 0
    for t in engine.cache.values():
        t.zero_()


def run(ctx) -> dict:
    from repro_torch.configs.base import ArchConfig
    from repro_torch.kernels import counts
    from repro_torch.serving import ServeConfig, ServingEngine

    a, mix, dev = ctx.arch, ctx.mix, ctx.device
    params = weights.make(a, ctx.seed, dev)
    sc = ServeConfig(max_len=mix["max_len"], active_slots=mix["active_slots"],
                     total_pages=mix["total_pages"])
    engine = ServingEngine(ArchConfig(**a), params=params, sc=sc, device=dev)
    slots = sc.active_slots
    _log(ctx, f"engine built (capture {engine.capture_s:.2f} s)")
    for prompt, _ in traffic.requests(mix, ctx.seed + 1, a["vocab"], slots):
        engine.submit(prompt, max_new_tokens=mix["warmup_steps"] * 4)
    engine.run(max_steps=2)
    _sync(dev)
    t = time.perf_counter()
    engine.run(max_steps=mix["warmup_steps"])
    _sync(dev)
    step_s = (time.perf_counter() - t) / mix["warmup_steps"]
    _log(ctx, f"warm-up: {1e3 * step_s:.2f} ms a step")
    _reset(engine)
    n = max(4, round(ctx.seconds / step_s))
    backlog = traffic.requests(mix, ctx.seed, a["vocab"])
    for prompt, new in backlog:
        engine.submit(prompt, max_new_tokens=new)
    # the engine does not prefill: each slot's first input is the first token
    # of the prompt that takes it, so no two slots run the same sequence
    engine.tokens[:len(backlog[:slots]), 0] = [p[0] for p, _ in backlog[:slots]]

    starts, feeds, lens, holders = [], [], [], []
    prof = Slice() if ctx.trace else None
    k0 = n // 2
    k1 = min(n - 1, k0 + mix["trace_steps"])
    inner = engine.decode

    def decode(cache_len):
        k = len(starts)
        if prof is not None and k in (k0, k1):
            prof.start() if k == k0 else prof.stop()
        starts.append(time.perf_counter())
        feeds.append(engine.tokens[:, 0].copy())
        lens.append(cache_len)
        holders.append([r.rid for r in engine.sched.active])
        return inner(cache_len)

    engine.decode = decode
    if prof is not None:
        prof.warm()
    before = counts.read()
    _sync(dev)
    t0 = time.perf_counter()
    engine.run(max_steps=n)
    _sync(dev)
    t1 = time.perf_counter()
    if prof is not None and prof.prof is not None and len(starts) <= k1:
        prof.stop()                     # the loop ended inside the slice
    launched = counts.since(before)
    rec = {
        "kind": "serve", "arch": a, "setup_s": t0 - ctx.t_start, "window_s": t1 - t0,
        "steps": len(starts), "slots": slots, "starts": starts, "cache_lens": lens,
        "active": [len(h) for h in holders],
        "tokens": sum(len(v) for v in engine.generated.values()),
        "traced": (k0, k1) if prof is not None else None,
        "launches": {fn.__name__: v for (fn, name), v in launched.items() if name == "launches"},
        "memory_peak_bytes": torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0,
        "pages_leaked": engine.aau.used_count - sum(len(r.pages) for r in engine.sched.active),
    }
    # every request that held a slot got exactly one token for each step it held one
    held: dict = {}
    for rids in holders:
        for rid in rids:
            held[rid] = held.get(rid, 0) + 1
    rec["attempted"] = len(held)
    rec["failed"] = sum(len(engine.generated.get(rid, ())) != n for rid, n in held.items())
    if prof is not None:
        rec["trace"] = prof.read()
    rec["feeds"] = feeds = np.stack(feeds)
    rec["served"] = served = np.concatenate([feeds[1:], engine.tokens[:, 0].copy()[None]])
    del engine, params, inner
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    t = time.perf_counter()
    gaps = replay(a, ctx.seed, dev, slots, mix["max_len"], feeds, served, lens, "fp32")
    print(f"reference: {len(starts)} steps replayed in {time.perf_counter() - t:.1f} s",
          file=sys.stderr)
    stats = gap_stats(gaps, rec["active"])
    print("served tokens: " + ", ".join(f"{k} {v:.6g}" for k, v in stats.items()), file=sys.stderr)
    rec["gap_stats"] = stats
    rec["readings"] = {"mean_logit_gap": stats["mean_logit_gap"],
                       "pages_leaked": float(rec["pages_leaked"])}
    return rec


def gap_stats(gaps: np.ndarray, active) -> dict:
    """Over every served token (slot i of step k for i below that step's
    active count): the mean gap, the widest of the slots' mean gaps, the
    widest gap, the 99.9th percentile, and the share of tokens that are not
    the reference's first choice, in %."""
    served = np.arange(gaps.shape[1])[None, :] < np.asarray(active)[:, None]
    g = gaps[served]
    per_slot = (gaps * served).sum(0)[served.any(0)] / served.sum(0)[served.any(0)]
    return {"mean_logit_gap": float(g.mean()), "slot_mean_logit_gap_max": float(per_slot.max()),
            "max_logit_gap": float(g.max()),
            "p999_logit_gap": float(np.quantile(g, 0.999)),
            "not_first_pct": float(100.0 * np.mean(g > 0))}


def replay(a: dict, seed: int, dev, slots: int, max_len: int, feeds, served, lens,
           precision: str) -> np.ndarray:
    """Gaps (steps, slots): at each step, how far the logit of the token
    ``served`` lies below the best logit of the float32 reference, fed
    ``feeds`` at positions ``lens`` from zeroed caches.  With ``precision``
    "fp8", the served token is the one the float8 reference puts first (the
    control), and both run side by side."""
    ref.no_tf32()
    w = weights.make(a, seed, dev)
    p32 = weights.as_f32(w)
    del w
    judge = ref.Decoder(a, p32, slots, max_len, ref.Precision("fp32"))
    other = (ref.Decoder(a, p32, slots, max_len, ref.Precision(precision))
             if precision != "fp32" else None)
    feeds_t = torch.from_numpy(feeds).to(dev)
    served_t = torch.from_numpy(served).to(dev)
    out = torch.empty(feeds.shape, dtype=torch.float32, device=dev)
    for k in range(feeds.shape[0]):
        lg = judge.step(feeds_t[k], int(lens[k]))
        pick = served_t[k] if other is None else other.step(feeds_t[k], int(lens[k])).argmax(-1)
        out[k] = lg.max(-1).values - lg.gather(1, pick[:, None].long())[:, 0]
    return out.cpu().numpy()
