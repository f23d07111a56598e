#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py [--seed 0]

Phases, each printing one JSON line with its wall time (any failure raises and
exits non-zero; no phase's error is caught):

1. device  -- ``nvidia-smi`` name and power limit.
2. build   -- both Hopper kernels from ``src/repro_torch/csrc`` (nvcc, in
   parallel) into ``build/kernels/``.
3. kernel_checks -- each kernel against its plain PyTorch version on the
   card, at the main path's shapes: error, the per-CTA plan, and the median
   time of the kernel, the plain version and one PyTorch library call for
   the same function (``library_ms``; the port never calls it), beside its
   bound.
4. prefill -- full-width tinyllama-1.1b ``loss_fn`` on B=2 x S=1024 tokens
   from the seed, on the kernel path; logits and loss held against the plain
   path on the card, and each layer's ``flash_attention`` call against its
   plain version at that layer's inputs.  Planted attention faults show what
   each limit catches.
5. serve   -- full-width ``serve()`` (8 active slots, max_len 256, 16
   requests, up to 12 new tokens each) on the kernel path; all requests
   complete, no page leaks; the first 4 decode steps' logits held against
   the plain path.
6. profile -- four full-width decode steps as the engine runs them, under
   ``torch.profiler``: the device-busy share of a step and the kernels by
   device time (Chrome trace in chiprun_out/decode_trace.json).
7. a ``{"kernels": [...]}`` line: launches on the main path (phases 4 and 5,
   each counted from 0), error, times and bounds per kernel.
8. the last line: ``{"ok": true, "device": {...}}``.

Weights are random (seeded); the port imports neither jax nor the JAX package.
Bounds use the H100 SXM data-sheet figures: 3.35 TB/s HBM, 989 TFLOP/s dense
bf16 tensor, 67 TFLOP/s fp32.  Full results also go to chiprun_out/chip_smoke.json.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import attention_ref, flash_attention  # noqa: E402
from repro_torch.kernels.ltrf_matmul import ltrf_matmul, matmul_plan, matmul_ref  # noqa: E402
from repro_torch.launch.serve import serve  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models.lm import (  # noqa: E402
    decode_step, init_decode_cache, init_params, logits_fn, loss_fn,
)

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
ARCH = "tinyllama-1.1b"
# tolerances.  ltrf_matmul vs its plain version: the _tol table of the kernel
# tests (its outputs here are about N(0, 1)).  flash_attention vs its plain
# version: both compute in fp32 and round once to bf16, so they differ by at
# most one bf16 ulp (< 8e-3 of the value); its outputs average hundreds of
# keys and are ~0.05 in size, so the matmul's atol of 8e-2 would pass a
# dropped KV tile.  The flash limits are elementwise (rtol, atol) and a
# relative L2 over the whole output; a planted fault (one KV tile zeroed) must
# fail them.  A full-width bf16 model, kernel path vs plain path: relative L2
# of the logits and relative loss difference (bf16 rounds at ~4e-3 and the two
# paths round at different points in each of 22 layers).  On an H100 sound
# runs read a logits relative L2 of 0.018-0.021; the two planted attention
# faults read 0.047 (one KV tile zeroed) and 0.47 (not causal), and must fail.
TOL = {torch.bfloat16: dict(rtol=3e-2, atol=8e-2), torch.float32: dict(rtol=2e-4, atol=1e-4)}
FLASH_TOL = dict(rtol=1e-2, atol=1e-3)
FLASH_REL_L2 = 1e-2
MODEL_LOGITS_REL_L2 = 3.5e-2
MODEL_LOSS_REL = 1e-2
ZEROED_KV = slice(512, 576)        # the planted fault's KV tile (rows of S)
L2_BYTES = 50 * 2 ** 20


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def time_ms(fns, reps: int = 5, min_iters: int = 10) -> tuple[float, float]:
    """(device ms, eager ms) per call, each the median over ``reps``.

    ``fns`` are calls on distinct operand copies, cycled so that the weights
    come from HBM and not from the 50 MB L2, as in a decode step.  Device
    time replays the calls captured in one CUDA graph, so host launch cost is
    left out; eager time times the same calls launched from Python, back to
    back, which is what the main path pays.  Both use CUDA events.
    """
    iters = max(min_iters, len(fns))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):          # warm-up: builds, plans, workspaces
        for f in fns[:3]:
            f()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fns[i % len(fns)]()

    def median(run) -> float:
        samples = []
        for _ in range(reps):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            run()
            end.record()
            end.synchronize()
            samples.append(start.elapsed_time(end) / iters)
        return statistics.median(samples)

    device = median(graph.replay)
    eager = median(lambda: [fns[i % len(fns)]() for i in range(iters)])
    del graph
    return device, eager


def bound(nbytes: float, flops: float, dtype) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def compare(got, want, dtype) -> dict:
    got, want = got.float(), want.float()
    err = (got - want).abs()
    return {"max_abs_err": float(err.max()),
            "max_rel_err": float(err.max() / want.abs().max().clamp_min(1e-30)),
            "within_tol": bool(torch.allclose(got, want, **TOL[dtype]))}


def compare_flash(got, want) -> dict:
    got, want = got.float(), want.float()
    rec = {"max_abs_err": float((got - want).abs().max()),
           "mean_abs_out": float(want.abs().mean()), "rel_l2": rel_l2(got, want)}
    rec["within_tol"] = bool(torch.allclose(got, want, **FLASH_TOL)
                             and rec["rel_l2"] <= FLASH_REL_L2)
    return rec


def zero_kv_tile(k, v, seq_dim: int):
    """The planted fault: K and V of one KV tile set to 0 (a dropped tile)."""
    k, v = k.clone(), v.clone()
    k.narrow(seq_dim, ZEROED_KV.start, ZEROED_KV.stop - ZEROED_KV.start).zero_()
    v.narrow(seq_dim, ZEROED_KV.start, ZEROED_KV.stop - ZEROED_KV.start).zero_()
    return k, v


def rel_l2(a, b) -> float:
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


# the slice's projections (K, N) and how often one forward launches each
def slice_matmuls(cfg):
    D, F_, L = cfg.d_model, cfg.d_ff, cfg.n_layers
    QD, KVD = cfg.n_heads * cfg.hd, cfg.n_kv_heads * cfg.hd
    return [((D, QD), L), ((D, KVD), 2 * L), ((QD, D), L),   # wq; wk, wv; wo
            ((D, F_), 2 * L), ((F_, D), L),                  # w_gate, w_up; w_down
            ((D, cfg.vocab), 1)]                             # lm_head


def phase_device() -> dict:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()
    print(out[0], flush=True)
    return {"nvidia_smi": out[0], "torch": torch.__version__, "cuda": torch.version.cuda,
            "name": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}


def phase_build() -> dict:
    logs = _build.build(["ltrf_matmul", "flash_attention"])
    summary = {}
    for name in ("ltrf_matmul", "flash_attention"):
        log = logs.get(name) or (_build.BUILD_DIR / f"{name}.log").read_text()
        summary[name] = [ln.strip() for ln in log.splitlines()
                         if "registers" in ln or "spill" in ln.lower()][:24]
    return {"ptxas": summary}


def phase_kernel_checks(cfg, dev) -> dict:
    gen = torch.Generator(dev).manual_seed(123)
    res = {"ltrf_matmul": [], "flash_attention": []}
    shapes = sorted({kn for kn, _ in slice_matmuls(cfg)})
    cases = [(M, K, N, torch.bfloat16) for M in (8, 2048) for K, N in shapes]
    cases += [(300, 500, 200, torch.float32), (64, 1024, 96, torch.float32)]
    for M, K, N, dt in cases:
        x = torch.randn(M, K, device=dev, generator=gen).to(dt)
        w = (torch.randn(K, N, device=dev, generator=gen) / math.sqrt(K)).to(dt)
        got = ltrf_matmul(x, w)
        torch.cuda.synchronize()
        rec = {"M": M, "K": K, "N": N, "dtype": str(dt).split(".")[-1],
               **compare(got, matmul_ref(x, w), dt)}
        plan, blocks = matmul_plan(M, K, N, x.element_size())
        rec["plan"] = {"blocks_mkn": blocks, "intervals": plan.num_intervals,
                       "slots": plan.num_slots, "max_bytes_per_round": plan.max_interval_bytes(),
                       "smem_per_cta": plan.vmem_budget}
        copies = [w] + [w.clone() for _ in range(max(0, math.ceil(2 * L2_BYTES / w.nbytes) - 1))]
        rec["ms"], rec["eager_ms"] = time_ms([lambda w=c: ltrf_matmul(x, w) for c in copies])
        rec["plain_ms"], _ = time_ms([lambda w=c: matmul_ref(x, w) for c in copies])
        rec["library_ms"], rec["library_eager_ms"] = time_ms(
            [lambda w=c: torch.matmul(x, w) for c in copies])
        rec["bound_ms"], rec["bound_by"] = bound(
            (M * K + K * N + M * N) * x.element_size(), 2 * M * K * N, dt)
        del copies
        emit({"check": "ltrf_matmul", **rec})
        check(rec["within_tol"], f"ltrf_matmul {M}x{K}x{N} {dt} disagrees with plain: {rec}")
        res["ltrf_matmul"].append(rec)

    for B, H, KV, S, d in [(2, cfg.n_heads, cfg.n_kv_heads, 1024, cfg.hd),
                           (2, cfg.n_heads, cfg.n_kv_heads, 1000, cfg.hd),
                           (2, 8, 1, 1024, cfg.hd)]:
        dt = torch.bfloat16
        q = torch.randn(B, H, S, d, device=dev, generator=gen).to(dt)
        k = torch.randn(B, KV, S, d, device=dev, generator=gen).to(dt)
        v = torch.randn(B, KV, S, d, device=dev, generator=gen).to(dt)
        got = flash_attention(q, k, v)
        torch.cuda.synchronize()
        want = attention_ref(q, k, v)
        rec = {"B": B, "H": H, "KV": KV, "S": S, "d": d, "dtype": "bfloat16",
               **compare_flash(got, want)}
        planted = compare_flash(attention_ref(q, *zero_kv_tile(k, v, 2)), want)
        rec["planted_fault"] = planted
        check(not planted["within_tol"], f"flash check passes a zeroed KV tile: {planted}")
        rec["ms"], rec["eager_ms"] = time_ms([lambda: flash_attention(q, k, v)])
        rec["plain_ms"], _ = time_ms([lambda: attention_ref(q, k, v)], min_iters=3)
        rec["library_ms"], _ = time_ms([lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True)])
        pairs = B * H * S * (S + 1) / 2          # causal (q, k) pairs this run needs
        rec["bound_ms"], rec["bound_by"] = bound(
            (2 * q.numel() + k.numel() + v.numel()) * q.element_size(), 4 * d * pairs, dt)
        emit({"check": "flash_attention", **rec})
        check(rec["within_tol"], f"flash_attention {rec} disagrees with plain")
        res["flash_attention"].append(rec)
    return res


def reset_counts() -> None:
    ltrf_matmul.launches = 0
    flash_attention.launches = 0


def read_counts() -> dict:
    return {"ltrf_matmul": ltrf_matmul.launches, "flash_attention": flash_attention.launches}


plain_attention = layers.causal_attention


@contextlib.contextmanager
def recording_flash():
    """Record (q, k, v, out) of each flash_attention call the layers make."""
    calls = []

    def record(q, k, v):
        o = flash_attention(q, k, v)
        calls.append((q, k, v, o))
        return o

    layers.flash_attention = record
    try:
        yield calls
    finally:
        layers.flash_attention = flash_attention


def phase_prefill(cfg, params, dev, seed) -> dict:
    toks = torch.randint(0, cfg.vocab, (2, 1024), device=dev,
                         generator=torch.Generator(dev).manual_seed(seed + 1))
    batch = {"tokens": toks, "labels": toks}
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    loss, _ = loss_fn(params, batch, cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()                        # the main path's launches
    check(bool(torch.isfinite(loss)), f"prefill loss not finite: {loss}")
    check(counts["ltrf_matmul"] == 7 * cfg.n_layers + 1
          and counts["flash_attention"] == cfg.n_layers, f"prefill launches {counts}")
    # held against the plain path (these launches are not counted); the kernel
    # path's run also records each layer's flash_attention call
    with recording_flash() as calls:
        logits_k, _ = logits_fn(params, batch, cfg)
    logits_p, _ = logits_fn(params, batch, cfg, kernels=False)
    loss_p, _ = loss_fn(params, batch, cfg, kernels=False)
    out = {"loss": float(loss), "loss_plain": float(loss_p),
           "loss_rel_diff": abs(float(loss) - float(loss_p)) / abs(float(loss_p)),
           "logits_rel_l2": rel_l2(logits_k, logits_p),
           "logits_max_abs_err": float((logits_k.float() - logits_p.float()).abs().max()),
           "logits_shape": list(logits_k.shape), "first_call_s": wall, "launches": counts}
    del logits_k
    # flash_attention at each layer's own inputs, against its plain version
    per_layer = [compare_flash(o, attention_ref(q, k, v)) for q, k, v, o in calls]
    q, k, v, _ = calls[0]
    planted = compare_flash(attention_ref(q, *zero_kv_tile(k, v, 2)), attention_ref(q, k, v))
    out["flash_per_layer"] = {
        "layers": len(per_layer), "max_abs_err": max(r["max_abs_err"] for r in per_layer),
        "max_rel_l2": max(r["rel_l2"] for r in per_layer),
        "within_tol": all(r["within_tol"] for r in per_layer), "planted_fault_layer0": planted}
    del calls, q, k, v
    check(len(per_layer) == cfg.n_layers and out["flash_per_layer"]["within_tol"],
          f"flash_attention vs plain at the model's inputs: {out['flash_per_layer']}")
    check(not planted["within_tol"], f"flash check passes a zeroed KV tile: {planted}")
    # what the model-level limit reads for planted attention faults on the
    # plain path: attention that is not causal, and one KV tile zeroed
    faults = {"not_causal": lambda q, k, v, q_block=512, q_offset=None: plain_attention(
                  q, k, v, q_block=q_block, q_offset=k.shape[1] - 1),
              "kv_tile_zeroed": lambda q, k, v, q_block=512, q_offset=None: plain_attention(
                  q, *zero_kv_tile(k, v, 1), q_block=q_block, q_offset=q_offset)}
    out["planted_model_faults"] = {}
    for name, fault in faults.items():
        layers.causal_attention = fault
        try:
            logits_f, _ = logits_fn(params, batch, cfg, kernels=False)
        finally:
            layers.causal_attention = plain_attention
        out["planted_model_faults"][name] = {"logits_rel_l2": rel_l2(logits_f, logits_p)}
        del logits_f
    del logits_p
    for name, kern in (("kernel", True), ("plain", False)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss_fn(params, batch, cfg, kernels=kern)
        torch.cuda.synchronize()
        out[f"{name}_loss_fn_ms"] = 1e3 * (time.perf_counter() - t0)
    check(out["logits_rel_l2"] <= MODEL_LOGITS_REL_L2, f"prefill logits vs plain: {out}")
    for name, fault in out["planted_model_faults"].items():
        check(fault["logits_rel_l2"] > MODEL_LOGITS_REL_L2,
              f"the model-level limit passes a planted attention fault ({name}): {out}")
    check(out["loss_rel_diff"] <= MODEL_LOSS_REL, f"prefill loss vs plain: {out}")
    return out


def phase_serve(cfg, params, dev, seed) -> dict:
    torch.cuda.synchronize()
    reset_counts()
    stats = serve(ARCH, smoke=False, n_requests=16, max_new=12, seed=seed,
                  active_slots=8, total_pages=64, max_len=256, device=dev)
    counts = read_counts()                        # the main path's launches
    check(stats["completed"] == 16, f"serve completed {stats['completed']}/16")
    check(stats["pages_leaked"] == 0, f"serve leaked {stats['pages_leaked']} pages")
    check(counts["ltrf_matmul"] == stats["steps"] * (7 * cfg.n_layers + 1),
          f"serve launches {counts} over {stats['steps']} steps")
    # the engine's first 4 steps (zeros in, shared cache_len 0..3) on both paths
    ck = init_decode_cache(cfg, 8, 256, dev)
    cp = init_decode_cache(cfg, 8, 256, dev)
    toks = torch.zeros((8, 1), dtype=torch.long, device=dev)
    steps = []
    for step in range(4):
        lk, ck = decode_step(params, ck, toks, step, cfg)
        lp, cp = decode_step(params, cp, toks, step, cfg, kernels=False)
        steps.append({"step": step, "logits_rel_l2": rel_l2(lk, lp),
                      "logits_max_abs_err": float((lk.float() - lp.float()).abs().max()),
                      "argmax_agree": float((lk[:, -1].argmax(-1) == lp[:, -1].argmax(-1))
                                            .float().mean())})
        toks = lk[:, -1].argmax(-1, keepdim=True)
    check(all(s["logits_rel_l2"] <= MODEL_LOGITS_REL_L2 for s in steps),
          f"decode logits vs plain: {steps}")
    return {**stats, "launches": counts, "decode_vs_plain": steps}


def phase_profile(cfg, params, dev) -> dict:
    """Device-busy share of decode steps run as the engine runs them (8 slots,
    argmax fetched to the host every step), from the profiler's kernel spans."""
    from torch.profiler import ProfilerActivity, profile

    cache = init_decode_cache(cfg, 8, 256, dev)
    toks = torch.zeros((8, 1), dtype=torch.long, device=dev)

    def step(n):
        nonlocal cache
        logits, cache = decode_step(params, cache, toks, n, cfg)
        toks.copy_(torch.from_numpy(logits[:, -1].argmax(-1, keepdim=True).cpu().numpy()))

    for n in range(2):
        step(n)
    torch.cuda.synchronize()
    n_steps = 4
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for n in range(2, 2 + n_steps):
            step(n)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    trace = out_dir / "decode_trace.json"
    prof.export_chrome_trace(str(trace))
    events = json.loads(trace.read_text())["traceEvents"]
    spans = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    by_name: dict = {}
    for e in spans:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"]
    busy_ms = sum(by_name.values()) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"steps": n_steps, "wall_ms_per_step": 1e3 * wall / n_steps,
            "device_busy_ms_per_step": busy_ms / n_steps,
            "device_busy_share": busy_ms / (1e3 * wall),
            "device_ops_per_step": len(spans) / n_steps,
            "top_kernels_ms_per_step": [(name[:80], d / 1e3 / n_steps) for name, d in top]}


def kernels_line(cfg, checks, prefill, served) -> dict:
    launches = {n: prefill["launches"][n] + served["launches"][n]
                for n in ("ltrf_matmul", "flash_attention")}
    mm = {(r["M"], r["K"], r["N"]): r for r in checks["ltrf_matmul"] if r["dtype"] == "bfloat16"}

    def mix(M, key):
        return sum(n * mm[(M, K, N)][key] for (K, N), n in slice_matmuls(cfg))

    def mix_bound(M):
        nbytes = sum(n * (M * K + K * N + M * N) * 2 for (K, N), n in slice_matmuls(cfg))
        flops = sum(n * 2 * M * K * N for (K, N), n in slice_matmuls(cfg))
        return bound(nbytes, flops, torch.bfloat16)

    dec_bound, dec_by = mix_bound(8)
    pre_bound, pre_by = mix_bound(2048)
    fa = checks["flash_attention"][0]
    per_step = 7 * cfg.n_layers + 1
    return {"kernels": [
        {"name": "ltrf_matmul", "route": "cuda",
         "source": "src/repro_torch/csrc/ltrf_matmul.cu",
         "replaces": "src/repro/kernels/ltrf_matmul/kernel.py:48",
         "launches": launches["ltrf_matmul"],
         "max_abs_err": max(r["max_abs_err"] for r in mm.values()),
         "ms": mix(8, "ms"), "plain_ms": mix(8, "plain_ms"), "bound_ms": dec_bound,
         "bound_by": dec_by, "library_ms": mix(8, "library_ms"),
         "unit": f"one decode step's matmuls: {per_step} launches at M=8, bf16",
         "prefill_ms": mix(2048, "ms"), "prefill_plain_ms": mix(2048, "plain_ms"),
         "prefill_library_ms": mix(2048, "library_ms"), "prefill_bound_ms": pre_bound,
         "prefill_bound_by": pre_by,
         "launches_prefill": prefill["launches"]["ltrf_matmul"],
         "launches_serve": served["launches"]["ltrf_matmul"]},
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention/kernel.py:64",
         "launches": launches["flash_attention"],
         "max_abs_err": max(r["max_abs_err"] for r in checks["flash_attention"]),
         "ms": fa["ms"], "plain_ms": fa["plain_ms"], "bound_ms": fa["bound_ms"],
         "bound_by": fa["bound_by"], "library_ms": fa["library_ms"],
         "unit": (f"one launch at B={fa['B']}, H={fa['H']}, KV={fa['KV']}, S={fa['S']}, "
                  f"d={fa['d']}, bf16, causal ({cfg.n_layers} per prefill forward)"),
         "launches_prefill": prefill["launches"]["flash_attention"],
         "launches_serve": served["launches"]["flash_attention"]},
    ]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card available; nothing to run", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    cfg = get_arch(ARCH)
    results: dict = {}

    def run(name, fn, *a):
        t0 = time.perf_counter()
        results[name] = fn(*a)
        emit({"phase": name, "wall_s": time.perf_counter() - t0,
              **{k: v for k, v in results[name].items()
                 if k not in ("ltrf_matmul", "flash_attention")}})

    t_start = time.perf_counter()
    run("device", phase_device)
    run("build", phase_build)
    run("kernel_checks", phase_kernel_checks, cfg, dev)
    params = init_params(cfg, torch.Generator(dev).manual_seed(args.seed), dev)
    run("prefill", phase_prefill, cfg, params, dev, args.seed)
    run("serve", phase_serve, cfg, params, dev, args.seed)
    run("profile", phase_profile, cfg, params, dev)
    line = kernels_line(cfg, results["kernel_checks"], results["prefill"], results["serve"])
    for k in line["kernels"]:
        check(k["launches"] > 0, f"{k['name']} never launched on the main path")
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(
        {**results, **line, "total_s": time.perf_counter() - t_start}, indent=1))
    emit(line)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
