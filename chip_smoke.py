#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one CUDA card and check them.

    python3 chip_smoke.py [--seed 0]

Phases, each printing one JSON line with its wall time (any failure raises and
exits non-zero; no phase's error is caught):

1. device  -- ``nvidia-smi`` name and power limit.
2. build   -- the three Hopper kernels, the two backward kernels
   (``flash_attention_bwd.cu``, ``ssd_scan_bwd.cu``) and the batch
   simulator's run loop (``sim_batch.cu``, with ``-fmad=false``) from
   ``src/repro_torch/csrc`` (nvcc, in parallel) into ``build/kernels/``,
   started here and each finished at its first use, so the compiles overlap
   the first kernel checks; ``build_logs``, after the checks, records each
   kernel's registers and spills (and fails if flash's bf16 kernels spill).
3. kernel_checks -- each kernel against its plain PyTorch version on the
   card, at the main paths' shapes (flash at tinyllama-1.1b's and
   zamba2-1.2b's): error, the per-CTA plan, and the median time of the
   kernel, the plain version and one PyTorch library call for the same
   function where there is one (``library_ms``; the port never calls it),
   beside its bound.  Planted faults show what the flash and ssd limits
   catch.  Each flash check also holds the V pre-pass alone to its plain
   version, bit for bit, and times it; at llava-next-34b's shape one KV
   head's V is scaled by 2^20 and another's by 2^-20, each query head held
   to the flash limits alone (atol times its V's scale), and the output
   with each head's 2^e left off must fail them.  Each matmul check also
   records the decode route's K split (and cluster size), or the forward
   wgmma route's schedule (tiles, data-parallel waves, split tiles and their
   k-slices, the busiest CTA's k-blocks), and requires two launches to give
   the same bits; at tinyllama-1.1b's wk/wv (M = 2048) the output with one
   partial of a split tile left out of its fixup must fail the limit; each
   ssd check also gives
   ``bound_tc_ms``, its work as the kernel does it (3 bf16 products each).
   The backward kernels: flash's at tinyllama-1.1b's train shape and at
   each head dim with a ragged S, causal and not (bf16 held to SDPA's fp32
   backward, fp32 to ``flash_bwd_ref``; planted faults: a non-causal
   backward, the GQA group sum dropped, D dropped), ssd_scan's at
   mamba2-1.3b's and zamba2-1.2b's train shapes (held to
   ``ssd_chunk_bwd_ref`` in float64, at the generator's inputs and four
   seeds more, dA to a limit of its own; a dropped in_decay gradient must
   fail); each gives the same
   bits twice and is timed beside its plain
   version, its bound and (flash) SDPA's backward alone and its forward +
   backward; ssd's also beside ``bound_tc_ms``, its work as the kernel does
   it (3 bf16 tensor-core products each).
4. prefill -- full-width tinyllama-1.1b ``loss_fn`` on B=2 x S=1024 tokens
   from the seed, on the kernel path; logits and loss held against the plain
   path on the card, and each layer's ``flash_attention`` call against its
   plain version at that layer's inputs.  Planted attention faults show what
   each limit catches.  Every prefill phase checks that each of its bf16
   M=2048 matmuls and flash calls took the kernels' ``wgmma`` route.
5. serve   -- full-width tinyllama ``serve()`` (8 active slots, max_len 256,
   16 requests, up to 12 new tokens each) on the kernel path, its engine
   running the decode step as one captured CUDA graph (``capture_s``
   reported beside the steady-state ``ms_per_step``); all requests
   complete, no page leaks, every matmul launch (counted through the
   replays) on the ``decode`` route; the same requests on the eager engine
   (``graphs=False``) must give the same tokens, bit for bit, and a planted
   stale ``cache_len`` scalar (never written after capture) must not; the
   first 4 decode steps' logits held against the plain path.
6. profile -- four full-width tinyllama decode steps as the eager engine runs
   them and four replays of the compiled engine's step, under
   ``torch.profiler``: wall and device-busy ms of a step, busy share, device
   ops a step and the kernels by device time (Chrome traces in
   chiprun_out/decode_trace.json and decode_trace_graph.json).
7. prefill_mamba2 -- full-width mamba2-1.3b ``loss_fn`` at B=2 x S=1024 on
   the kernel path (97 ``ltrf_matmul`` and 48 ``ssd_scan`` launches), held
   against the plain path; each layer's ``ssd_scan`` chunk kernel held
   against ``ssd_chunk_ref`` at that layer's inputs; two planted SSM faults
   (inter-chunk carry dropped, lower-triangle mask dropped) must fail the
   model-level limit.
8. serve_mamba2 -- the serve of phase 5 for mamba2-1.3b (compiled against
   eager), its first 4 decode steps held against the plain path, and decode
   steps profiled as in phase 6.
9. prefill_zamba2 -- full-width zamba2-1.2b ``loss_fn`` at B=2 x S=1024 (119
   ``ltrf_matmul``, 6 ``flash_attention``, 38 ``ssd_scan`` launches), held
   against the plain path, each layer's flash and ssd call held against its
   plain version, and 4 decode steps (6 per-call-site KV caches) held against
   the plain path; then serve_zamba2, the serve of phase 5 for zamba2-1.2b
   (compiled against eager; the SSM caches and the shared block's KV caches
   in one captured step), its steps profiled as in phase 6.
10. prefill_granite_moe -- full-width, full-depth granite-moe-3b-a800m
    ``loss_fn`` at B=2 x S=1024 (129 ``ltrf_matmul``, 32 ``flash_attention``
    launches), held against the plain path in bf16 and in fp32, with the
    number of tokens whose top-8 expert set differs between the paths per
    layer, each layer's flash call against its plain version, planted MoE
    faults (gate renormalisation dropped, inverse permutation dropped) and
    attention faults, and the expert products (``torch.bmm``) timed.
11. serve_granite_moe -- the serve of phase 5 for granite-moe (compiled
    against eager), its first 4
    decode steps held against the plain path in bf16 and fp32 (a planted
    "capacity ignored" fault must fail the fp32 limit), steps profiled as in
    phase 6, and
    the expert products timed at the decode capacity.
12. prefill_musicgen, serve_musicgen -- the same for musicgen-large (audio:
    4 codebooks summed in, a 4 x 2048-wide head; 337 ``ltrf_matmul`` and 48
    flash launches a prefill).
13. prefill_llava -- llava-next-34b at full width, depth cut to 12 of 60
    layers, on 576 seeded patch embeddings and 448 tokens.
14. prefill_dbrx -- dbrx-132b at full width, depth cut to 2 of 40 layers.
15. prefill_dense_wide -- phi3-medium-14b and granite-20b at full width,
    depth cut to 4 layers each.
    Every new prefill phase holds the model against the plain path in bf16
    and in fp32 under limits a planted fault must fail, and records its depth
    cut (``depth``).
16. train_tinyllama -- full-width, full-depth tinyllama-1.1b trained for 6
    steps (bf16, ``cfg.remat`` "full", B=8 x S=1024 from the data pipeline)
    through ``runtime.train_step.build_train_step``: ms a step, tokens/s, the
    device-busy share of one step, 6 N tokens / step time against 989
    TFLOP/s, peak memory beside the state's bytes; every ``ltrf_matmul``
    launch (forward, remat recompute, both backward products) and every
    flash launch on ``wgmma``; the loss of the first batch lower after the
    steps; two steps from one state give the same bits under
    ``torch.use_deterministic_algorithms``; one flash backward launch a
    layer and step, on its ``wgmma`` route; the matmul backward's launches
    one ``nt`` (dX) and one ``tn`` (dW) for each forward product.  Also the
    backward's pieces timed at the step's shapes: ``matmul_vjp`` (two kernel
    products, their operands read in place) per projection against cuBLAS
    and against the parent design (transposes copied into the forward's
    layout), with each product's layout, split and output tiles; the flash
    forward there held against ``attention_ref`` and timed (its backward is
    kernel_checks' first flash backward case).
17. train_replay -- the same model, depth cut to 2 layers, trained 12 steps
    through ``launch.train.train`` twice (checkpoints every 5 steps to the
    temporary directory), once uninterrupted and once with failures
    injected at steps 7 and 9, under deterministic algorithms: the final
    parameters must be bit-identical; the checkpoints' seconds reported.
18. train_grads -- tinyllama-1.1b and mamba2-1.3b at full width, depth cut
    to 2, B=2 x S=1024: kernel-path gradients against plain-path gradients
    leaf by leaf (relative L2), in fp32 under a sharp limit and in bf16,
    each backward kernel launched once a layer; planted faults in the
    backward (a zeroed dW, a non-causal flash backward, a dropped
    ``in_decay`` gradient) must fail the fp32 limit; ``ssd_scan``'s backward
    kernel timed.
19. sweep_service -- the simulator's sweep service
    (``repro_torch.serving.SimRunner(device="cuda", batch=True)``) driving the
    batch simulator on the card, whose every chunk is one launch of the
    ``sim_batch`` kernel (no CUDA graph: each call's launches must equal its
    chunks, each chunk printed with its lanes, ticks, the kernel's µs a
    tick, the route of a lane's image in shared memory, its bytes, the CTAs
    an SM holds and the waves), each simulated result held field by field,
    ``cycle_breakdown`` included, to the port's scalar ``engine.simulate`` (or
    ``simulate_gpu`` over it) run meanwhile on the host in worker processes:
    (a) the tracked sweep (``benchmarks/sweep_subset.py::sweep_jobs``, 14
    workloads x (the baseline + 7 designs) x Table-2 configs 6 and 7: 196
    unique sims, rebuilt from ``repro_torch.sim`` and ``repro_torch.workloads``)
    through ``prefill``, all 196 batched on the card: the service's wall beside
    the batch engine's, simulated instructions per second against the scalar
    engine's on one host core; (b) its replay by a fresh runner on the same
    store, all cache hits, and the same sweep on the service's host pool
    (``batch=False``, 6 spawned workers), for the card's wall to be read
    against, run on a host thread while the card runs (a), once the scalar
    engine's references are done; (c) the whole-GPU mini-sweep
    (``gpu_sweep_jobs``: 2 SMs x 16 warps, srad and bfs, BL and LTRF, three
    schedulers) through ``prefill_gpu`` and ``sim_gpu``: the ``two_level``
    per-SM jobs batched on the card, the others on the service's process
    pool; (d) the analytic tier over the screening grid (``screening_jobs``:
    3752 points), then the hybrid tier's confirmations (all ``gto`` points,
    on the pool; on the host thread too, after the host-pool sweep), and the
    same over the grid's ``two_level`` half for the 4
    workloads of the 8-lane comparison (536 points), whose confirmations run
    on the card; (e) a
    planted whole-batch failure of the engine must raise out of ``prefill``
    with no job completed elsewhere; (f) the service's sweep metrics.
20. sim_batch -- the batch simulator (``repro_torch.sim.batch``) driven
    directly on the card: ``run_batch(..., fallback=False, device="cuda")`` at
    8 lanes per launch on all 7 designs x 4 workloads at Table-2 #7 (the
    kernel, one launch a chunk), each result held to the scalar engine;
    the same chunks' final state from the kernel held plane by plane, bit
    for bit, to the plain PyTorch tick run on the card (``engine="plain"``,
    its blocks replayed as CUDA graphs); lanes per launch, launches, ticks,
    the card's wall, the kernel's µs a tick, registers and spills, a lane's
    image route and bytes, CTAs an SM and waves, and the
    plain tick's ms a tick for eager blocks and for graph replay and the
    device-busy share of a block (profiler), for that chunk and for the
    tracked sweep's widest; a planted fault (the DRAM queue's interval one
    cycle longer) must make some job differ.
21. traced_sweep -- the traced suite: the port's own kernels' plain versions
    and layers lifted through ``torch.fx`` (``repro_torch.frontend``) into the
    simulator's register IR.  (a) The six lifts in a fresh host process
    (which must not start CUDA) and in this one: seconds, static
    instructions, registers, loops and LTRF cycles at Table-2 #7 beside the
    JAX package's lift (constants); (b) the traced sweep
    (``benchmarks/sweep_subset.py::sweep_jobs(suite="traced")`` rebuilt from
    the port: 84 unique sims) through ``SimRunner(device="cuda",
    batch=True).prefill``, every job batched on the card and held field by
    field to the port's scalar engine run meanwhile in host worker
    processes: the service's and the engine's walls, chunks with their
    lanes and ticks, simulated instructions per second beside the scalar
    engine's on one host core; (c) ``traced_matmul`` on all 7 designs at
    #7, 16 warps, through ``run_batch`` on the card, must give
    ``TRACED_MATMUL_GOLDEN``; (d) a planted lift fault (the dot loop's trip
    count one higher) must break (c) on every design.
22. mesh -- the mesh layer (``repro_torch.distributed``, ``launch.mesh``,
    ``launch.dryrun``): (a) tinyllama-1.1b at full width and depth on
    ``make_host_mesh()`` (a one-rank NCCL group) with ``default_rules``
    ("2d"): the state placed by ``reshard_state``, 2 steps through
    ``build_train_step(..., rules=rules)`` under deterministic algorithms,
    bit-identical (loss, grad norm, every parameter and moment) to the same 2
    steps without rules, ms a step with and without, one flash backward
    launch a layer and step; (b) zamba2-1.2b cut to
    its first 6 layers (one shared attention block) and granite-moe-3b-a800m
    cut to 2, ``loss_fn`` (the prefill step) at B=2 x S=1024 under the rules,
    bit-identical to without (``ssd_scan``, flash and the MoE dispatch
    through their DTensor call sites); (c) ``pipeline_forward`` over a
    one-rank stage mesh, tinyllama's dense block as the stage, 4
    microbatches of 2 x 1024, bit-identical to ``sequential_reference``;
    every launch of (a)-(c) on ``wgmma``; (d) the dry-run (one architecture
    per family x train_4k and decode_32k on the 16x16 production mesh, and
    tinyllama train_4k on 2x16x16), run by ``python -m
    repro_torch.launch.dryrun`` in three host processes that see no card,
    started after the build and read here: each cell's seconds, per-device
    argument and peak GiB, per-rank FLOPs and collectives by kind, and the
    tracked sweep's card wall beside its wall before the dry-run ran beside
    the card; granite-moe's two cells printed beside their counts when the
    MoE site gathered the experts' d_ff split, and failed if either's FLOPs
    a rank is above an eighth of those; mamba2-1.3b's and zamba2-1.2b's
    train_4k cells printed with the all-gather GiB charged to
    ``mamba2._split_proj``, and failed above 40 % of those when it gathered
    once a slice.
23. a ``{"kernels": [...]}`` line: launches on the main paths (phases 4, 5,
    7-17 and 22, each counted from 0; ``sim_batch``'s on phases 19-21) in
    all and per route, error, times and
    bounds per kernel, and each kernel's training launches and backward
    (flash's and ssd_scan's: the backward kernel's source, its launches on
    phases 16-18 and 22, each of which must launch one, and its time beside
    its bound, its plain version and the library call).
24. the phases' walls and the script's total on one line, then the last
    line: ``{"ok": true, "device": {...}}``.

Weights are random (seeded); the port imports neither jax nor the JAX package.
Each model's weights are freed before the next model is made.  Bounds use the
H100 SXM data-sheet figures: 3.35 TB/s HBM, 989 TFLOP/s dense bf16 tensor,
67 TFLOP/s fp32.  Full results also go to chiprun_out/chip_smoke.json.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import dataclasses
import gc
import json
import math
import multiprocessing
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
# cuBLAS repeats its sums bit for bit only with a fixed workspace, set before
# CUDA starts (train_tinyllama's and train_replay's deterministic steps)
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402
import torch.nn.functional as F  # noqa: E402
from torch.distributed.device_mesh import init_device_mesh  # noqa: E402
from torch.nn.attention import SDPBackend, sdpa_kernel  # noqa: E402

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import attention_ref, flash_attention  # noqa: E402
from repro_torch.kernels.flash_attention.ref import flash_bwd_ref, v_to_f16_ref  # noqa: E402
from repro_torch.kernels.ltrf_matmul import (  # noqa: E402
    ltrf_matmul, matmul_plan, matmul_ref, split_k,
)
from repro_torch.kernels.ltrf_matmul.ops import DECODE_MAX_CLUSTER  # noqa: E402
from repro_torch.kernels.ssd_scan import ops as ssd_ops  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_chunk, ssd_chunk_ref, ssd_scan  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import ssd_chunk_bwd_ref  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.frontend.workloads import TRACED_NAMES, build_traced_workload  # noqa: E402
from repro_torch.data import batch_for_step  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.kernels.ltrf_matmul import ops as mm_ops  # noqa: E402
from repro_torch.kernels.sim_batch import ops as sim_ops  # noqa: E402
from repro_torch.distributed import (  # noqa: E402
    default_rules, pipeline_forward, reshard_state, sequential_reference,
)
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.launch.serve import serve  # noqa: E402
from repro_torch.launch.train import train  # noqa: E402
from repro_torch.optim import AdamWConfig  # noqa: E402
from repro_torch.runtime import (  # noqa: E402
    build_eval_step, build_prefill_step, build_train_step, grads_of, make_train_state,
    to_device,
)
from repro_torch.runtime.train_step import train_state_axes, train_state_shapes  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402
from repro_torch.models import layers, mamba2, moe  # noqa: E402
from repro_torch.models import lm as lm_module  # noqa: E402
from repro_torch.models.lm import (  # noqa: E402
    ATTN_FAMILIES, decode_step, head_width, held_width, init_decode_cache, init_params,
    logits_fn, loss_fn, param_axes, param_shapes,
)
from repro_torch.serving import ServeConfig, ServingEngine, SimRunner, sim_key  # noqa: E402
from repro_torch.sim import TOLERANCE_MULTS, baseline_config, design_config  # noqa: E402
from repro_torch.sim import simulate_gpu  # noqa: E402
from repro_torch.sim.gpu import per_sm_configs  # noqa: E402
from repro_torch.sim import batch as sim_batch  # noqa: E402
from repro_torch.sim import engine as sim_engine  # noqa: E402
from repro_torch.sim.batch import run_batch as sim_run_batch  # noqa: E402
from repro_torch.workloads import Workload, get_workload, listing1_program  # noqa: E402
from repro_torch.workloads import workload_names as sim_workload_names  # noqa: E402

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
ARCH = "tinyllama-1.1b"
SSM_ARCH = "mamba2-1.3b"
HYBRID_ARCH = "zamba2-1.2b"
MOE_ARCH = "granite-moe-3b-a800m"
AUDIO_ARCH = "musicgen-large"
# prefilled at full width with their depth cut: llava's 60 layers are 68.8 GB
# of bf16 weights (no room for the fp32 copy of the check), dbrx's 40 are
# ~264 GB; phi3-medium-14b and granite-20b are cut to 4 to keep the run short
DEPTH_CUTS = {"llava-next-34b": 12, "dbrx-132b": 2, "phi3-medium-14b": 4, "granite-20b": 4}
KERNELS = ("ltrf_matmul", "flash_attention", "ssd_scan")
# the backward kernels' sources, built beside KERNELS (no TPU kernel of their
# own: the kernels line lists them under their forward kernel's training entry)
BWD_SOURCES = {"flash_attention": "flash_attention_bwd", "ssd_scan": "ssd_scan_bwd"}
# tolerances.  ltrf_matmul vs its plain version: the _tol table of the kernel
# tests (its outputs here are about N(0, 1)).  flash_attention vs its plain
# version: the bf16 kernel computes S = Q K^T in fp32 (products of bf16
# values are exact, so only the sum order differs), rounds P to fp16 (11
# bits) against V scaled to fp16 by a power of two per KV head, exact in
# fp16's normal range, and scales each row back by 2^e -- or, in training's
# forward (FlashAttentionFn), splits P into bf16 hi + lo (~16 bits) against
# the bf16 V -- and accumulates P V in fp32 (a single bf16 P, as
# FA2/FA3 round it, moves single outputs by up to ~2e-3 relative: emulated
# on the CPU at these shapes, experiments/numerics/flash_p_emulation.py, it
# reads a relative L2 of 2e-3 but 1.46-1.85x the elementwise limit; fp16 P
# reads 0.65-0.71 of it, the split 0.36-0.55); the plain version computes
# in fp32.  Both round once to bf16,
# so they differ by about one bf16 ulp (< 8e-3 of the value) where the two
# fp32 values straddle a rounding point.  Its outputs average hundreds of
# keys and are ~0.05 in size, so the matmul's atol of 8e-2 would pass a
# dropped KV tile.  The flash limits are elementwise (rtol, atol) and a
# relative L2 over the whole output; a planted fault (one KV tile zeroed) must
# fail them.  Where V's KV heads are scaled (the scaled-V check), each query
# head is held to them alone, its atol times its V's scale; leaving a head's
# 2^e off must fail.  A full-width bf16 model, kernel path vs plain path: relative L2
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
# ssd_scan vs ssd_chunk_ref: fp32 in and out; the kernel's products are
# bf16x3 on the tensor cores (each operand split into bf16 high and low
# parts, ~16 bits kept; emulated on the CPU at mamba2's widths this alone
# reads a relative L2 of 5e-6, where single TF32 products read 3.3e-4),
# summed in fp32 in another order than torch's fp32 matmuls, and cum summed
# by another scan.  The sharp limit is a relative L2 per output: on an H100
# sound reads were 2e-6 to 1.7e-5 with the earlier all-fp32 kernel
# (kernel-check shapes and every layer's inputs of both models), and a
# planted fault (one 64-row block of x zeroed in one chunk) reads 0.17-0.31
# on y_intra and must fail.  Elementwise, the
# fp32 _tol row (rtol 2e-4, atol 1e-4 times the output's RMS) is 10x too
# tight for single terms: each decay is exp(cum_i - cum_j) of two fp32
# cumulative sums that reach |Q dt A| ~ 1e3-1e4 at Q = 256, whose ulp is
# 1e-4 to 1e-3, so two summation orders move single terms by up to ~4e-3
# relative where a sum cancels (read on an H100: up to 3.9x of rtol 1e-3 /
# atol 1e-4 x RMS at the model's inputs).  The elementwise limit is that row
# times 50 / 10, a bound on gross local faults.
SSD_RTOL = 1e-2
SSD_ATOL = 1e-3                    # times the output's RMS
SSD_REL_L2 = 1e-4
SSD_OUTPUTS = ("y_intra", "states", "in_decay", "chunk_decay")
# model-level limits for the Mamba2 families, kernel path vs plain path, as a
# relative L2 of the logits.  In bf16 the two paths' rounding flips grow over
# 48 (38) layers and 1024 positions: on an H100 sound reads are 0.16-0.19 at
# prefill and 0.03-0.12 over 4 decode steps, and the plain path against
# itself with only its products rounded another way reads 0.18-0.21.  A
# dropped inter-chunk carry reads 0.20 there, so the bf16 limit only bounds
# gross faults.  The sharp limit runs the same weights and tokens in fp32,
# where the paths differ by fp32 sum order only: sound reads 2.7e-4-3.6e-4 at
# prefill and 7e-6-3.4e-5 at decode; the dropped carry reads 0.18 and the
# dropped mask 1.35, and both must read above it.
SSM_BF16_REL_L2 = 0.35
SSM_FP32_REL_L2 = 3e-3
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


def compare_ssd(got, want) -> dict:
    """The four chunk outputs, each against the SSD limits."""
    rec = {}
    for name, g, w in zip(SSD_OUTPUTS, got, want):
        rms = float(w.square().mean().sqrt())
        err = (g - w).abs()
        rec[name] = {"max_abs_err": float(err.max()), "rms": rms, "rel_l2": rel_l2(g, w),
                     "max_excess": float((err / (SSD_ATOL * rms + SSD_RTOL * w.abs())).max())}
        rec[name]["within_tol"] = (rec[name]["max_excess"] <= 1.0
                                   and rec[name]["rel_l2"] <= SSD_REL_L2)
    rec["within_tol"] = all(rec[n]["within_tol"] for n in SSD_OUTPUTS)
    rec["max_abs_err"] = max(rec[n]["max_abs_err"] for n in SSD_OUTPUTS)
    return rec


def zero_kv_tile(k, v, seq_dim: int):
    """The planted fault: K and V of one KV tile set to 0 (a dropped tile)."""
    k, v = k.clone(), v.clone()
    k.narrow(seq_dim, ZEROED_KV.start, ZEROED_KV.stop - ZEROED_KV.start).zero_()
    v.narrow(seq_dim, ZEROED_KV.start, ZEROED_KV.stop - ZEROED_KV.start).zero_()
    return k, v


def zero_x_block(x, chunk: int):
    """The planted ssd fault: one 64-row j-block of x (B, S, H, P) zeroed in
    the second chunk (its rows 64..127, cut at the chunk's end; the whole
    chunk when it has 64 rows or fewer)."""
    lo = chunk + 64 if chunk > 64 else chunk
    x = x.clone()
    x[:, lo:min(lo + 64, 2 * chunk)] = 0
    return x


def rel_l2(a, b) -> float:
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def row_rel_l2(a, b) -> float:
    """The largest relative L2 of one position's logits (last dim)."""
    a, b = a.float(), b.float()
    return float(((a - b).norm(dim=-1) / b.norm(dim=-1).clamp_min(1e-30)).max())


def free_memory() -> None:
    gc.collect()
    torch.cuda.empty_cache()


# the slice's projections (K, N) and how often one forward (or one decode
# step) launches each
def slice_matmuls(cfg):
    D, F_, L = cfg.d_model, cfg.d_ff, cfg.n_layers
    QD, KVD = cfg.n_heads * cfg.hd, cfg.n_kv_heads * cfg.hd
    dense = [((D, QD), 1), ((D, KVD), 2), ((QD, D), 1),   # wq; wk, wv; wo
             ((D, F_), 2), ((F_, D), 1)]                  # w_gate, w_up; w_down
    head = ((D, held_width(head_width(cfg))), 1)          # lm_head as held (padded)
    if cfg.family == "moe":                               # experts are torch.bmm
        return [(kn, n * L) for kn, n in dense[:3]] + [head]
    if cfg.family in ATTN_FAMILIES:
        return [(kn, n * L) for kn, n in dense] + [head]
    d_inner = cfg.ssm_expand * D
    d_in_proj = 2 * d_inner + 2 * cfg.ssm_state + d_inner // cfg.ssm_headdim
    mixer = [((D, d_in_proj), L), ((d_inner, D), L)]      # in_proj, out_proj
    shared = L // cfg.attn_every if cfg.family == "hybrid" else 0
    return mixer + [(kn, n * shared) for kn, n in dense if shared] + [head]


def forward_launches(cfg) -> dict:
    """Kernel launches of one prefill forward on the kernel path."""
    shared = cfg.n_layers // cfg.attn_every if cfg.family == "hybrid" else 0
    return {"ltrf_matmul": sum(n for _, n in slice_matmuls(cfg)),
            "flash_attention": cfg.n_layers if cfg.family in ATTN_FAMILIES else shared,
            "ssd_scan": cfg.n_layers if cfg.family in ("ssm", "hybrid") else 0}


def chunk_rows(S, Q) -> tuple[int, int, float]:
    """(chunks, rows inside S, (query, key) pairs of the chunks' lower
    triangles)."""
    rows = [min(Q, S - c * Q) for c in range(-(-S // Q))]
    return len(rows), sum(rows), sum(q * (q + 1) / 2 for q in rows)


def ssd_work(B, S, H, P, N, Q) -> tuple[float, float]:
    """(bytes, flops).  Bytes: each input read once, each output written
    once.  Operations: the lower triangle of C B^T once per (b, chunk), and
    per head the lower triangle of (C B^T o L)(x dt) and the state product,
    over the rows of each chunk that lie inside S."""
    nc, rows, tri = chunk_rows(S, Q)
    flops = B * (2 * N * tri + H * (2 * P * tri + 2 * P * N * rows))
    nbytes = 4 * (B * S * H * P + B * S * H + H + 2 * B * S * N
                  + B * nc * H * (Q * P + P * N + Q + 1))
    return nbytes, flops


def ssd_bound(B, S, H, P, N, Q) -> tuple[float, str]:
    """The work at the fp32 CUDA-core rate (67 TFLOP/s): the FFMA kernel's bound."""
    return bound(*ssd_work(B, S, H, P, N, Q), torch.float32)


def ssd_bound_tc(B, S, H, P, N, Q) -> float:
    """The same work as the kernel does it: each fp32 product as three bf16
    tensor-core products (bf16x3) at 989 TFLOP/s, or the bytes if they take
    longer."""
    nbytes, flops = ssd_work(B, S, H, P, N, Q)
    return 1e3 * max(nbytes / HBM_BYTES_PER_S, 3 * flops / PEAK_FLOPS[torch.bfloat16])


def phase_device() -> dict:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()
    print(out[0], flush=True)
    return {"nvidia_smi": out[0], "torch": torch.__version__, "cuda": torch.version.cuda,
            "name": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}


def ptxas_summary(log: str) -> dict:
    """``-Xptxas -v`` per kernel instantiation: {"name<int template args>":
    "Used N registers, S bytes spill stores, L bytes spill loads"}."""
    out, key, spills = {}, None, ""
    for ln in log.splitlines():
        entry = re.search(r"Compiling entry function '\w*?_cu_[0-9a-f]{8}(\d+)(\w+)'", ln)
        if entry:
            n = int(entry.group(1))
            name, rest = entry.group(2)[:n], entry.group(2)[n:]
            key = f"{name}<{','.join(re.findall(r'L[ib](\d+)', rest.split('Ev')[0]))}>"
        elif key and "spill stores" in ln:
            spills = ln.split(",", 1)[1].strip()
        elif key and "Used" in ln and "registers" in ln:
            out[key] = ln.split(":", 1)[1].split(",")[0].strip() + ", " + spills
    return out


SIM_SOURCE = "sim_batch"     # the batch simulator's run loop: no TPU kernel
BUILT = (*KERNELS, *BWD_SOURCES.values(), SIM_SOURCE)


def phase_build() -> dict:
    """Start every source's nvcc at once and return: each library is put in
    place at its first use (the kernel checks), so the compiles overlap the
    checks that do not need them yet."""
    _build.build(BUILT, wait=False)
    return {"started": list(BUILT)}


def phase_build_logs() -> dict:
    """The compiles' ``-Xptxas -v`` summaries, once all are done; fails if
    the bf16 flash forward (the V pre-pass or any head dim's attention
    kernel, in either form of P) spills."""
    _build.build(BUILT)
    out = {"ptxas": {name: ptxas_summary((_build.BUILD_DIR / f"{name}.log").read_text())
                     for name in BUILT}}
    flash = {k: v for k, v in out["ptxas"]["flash_attention"].items()
             if k.startswith(("flash_attention_wgmma", "flash_v_to_f16"))}
    check(len(flash) == 2 * len(flash_ops.HEAD_DIMS) + 1
          and all("0 bytes spill stores" in v for v in flash.values()),
          f"flash_attention's bf16 kernels spill (or are missing): {flash}")
    return out


# the planted split fault's shape (at M = 2048): tinyllama-1.1b's wk/wv,
# whose 32 tiles are each cut into k-slices
DROPPED_PARTIAL_KN = (2048, 256)


def forward_schedule(M, K, N) -> dict:
    """The forward wgmma route's schedule of (M, K, N): tile width, output
    tiles, data-parallel waves (whole tiles, one a CTA), the tiles split and
    the k-slices each is cut into, and the k-blocks of the busiest CTA."""
    s = mm_ops.schedule(M, K, N)
    return {"bn": s.bn, "tiles": s.tiles,
            "dp_waves": (s.tiles - s.split_tiles) // mm_ops.NUM_SMS,
            "split_tiles": s.split_tiles, "split": s.split, "grid": s.grid,
            "longest_blocks": s.longest()}


def drop_a_partial(got, x, w):
    """The planted fault: the kernel's output with the second k-slice of the
    first split tile left out of its fixup, as a fixup that dropped that
    partial would have rounded it."""
    M, K = x.shape
    s = mm_ops.schedule(M, K, w.shape[1])
    check(s.split > 1, f"ltrf_matmul {M}x{K}x{w.shape[1]}: no tile split to plant a fault in")
    tile, kb0, kb1 = s.unit(s.slices(0)[1])
    rows = slice((tile % s.m_tiles) * 128, (tile % s.m_tiles) * 128 + 128)
    cols = slice((tile // s.m_tiles) * s.bn, (tile // s.m_tiles) * s.bn + s.bn)
    ks = slice(64 * kb0, 64 * kb1)
    out = got.float()
    out[rows, cols] -= x[rows, ks].float() @ w[ks, cols].float()
    return out.to(got.dtype)


def check_matmuls(cfgs, dev, gen) -> list:
    shapes = sorted({kn for cfg in cfgs for kn, _ in slice_matmuls(cfg)})
    cases = [(M, K, N, torch.bfloat16) for M in (8, 2048) for K, N in shapes]
    # a probe, on no main path: tinyllama's head widened by 8 columns, so its
    # weight rows are an odd multiple of 16 bytes long, as mamba2-1.3b's
    # 50280-wide head's are (against 2048 x 32000, whose rows are 128-aligned)
    cases += [(2048, 2048, 32008, torch.bfloat16)]
    cases += [(300, 500, 200, torch.float32), (64, 1024, 96, torch.float32)]
    res = []
    for M, K, N, dt in cases:
        x = torch.randn(M, K, device=dev, generator=gen).to(dt)
        w = (torch.randn(K, N, device=dev, generator=gen) / math.sqrt(K)).to(dt)
        got = ltrf_matmul(x, w)
        again = ltrf_matmul(x, w)
        torch.cuda.synchronize()
        rec = {"M": M, "K": K, "N": N, "dtype": str(dt).split(".")[-1],
               **compare(got, matmul_ref(x, w), dt),
               "same_bits_twice": bool(torch.equal(got, again))}
        del again
        plan, blocks = matmul_plan(M, K, N, x.element_size())
        split = split_k(M, K, N, x.element_size())
        rec["plan"] = {"blocks_mkn": blocks, "split_k": split,
                       "ctas": -(-N // blocks[2]) * split if split > 1 else None,
                       "cluster": split if 1 < split <= DECODE_MAX_CLUSTER else None,
                       "intervals": plan.num_intervals, "slots": plan.num_slots,
                       "max_bytes_per_round": plan.max_interval_bytes(),
                       "smem_per_cta": plan.vmem_budget}
        if mm_ops.route(M, x.element_size()) == "wgmma":
            rec["schedule"] = forward_schedule(M, K, N)
            if (K, N) == DROPPED_PARTIAL_KN:
                rec["dropped_partial"] = compare(drop_a_partial(got, x, w), matmul_ref(x, w), dt)
        copies = [w] + [w.clone() for _ in range(max(0, math.ceil(2 * L2_BYTES / w.nbytes) - 1))]
        rec["ms"], rec["eager_ms"] = time_ms([lambda w=c: ltrf_matmul(x, w) for c in copies])
        # the plain version in fp32 runs ~20x the kernel's time: at the large
        # shapes 3 calls a sample, not 10
        rec["plain_ms"], _ = time_ms([lambda w=c: matmul_ref(x, w) for c in copies],
                                     min_iters=3 if 2 * M * K * N > 1e11 else 10)
        rec["library_ms"], rec["library_eager_ms"] = time_ms(
            [lambda w=c: torch.matmul(x, w) for c in copies])
        rec["bound_ms"], rec["bound_by"] = bound(
            (M * K + K * N + M * N) * x.element_size(), 2 * M * K * N, dt)
        del copies
        emit({"check": "ltrf_matmul", **rec})
        check(rec["within_tol"], f"ltrf_matmul {M}x{K}x{N} {dt} disagrees with plain: {rec}")
        check("dropped_partial" not in rec or not rec["dropped_partial"]["within_tol"],
              f"ltrf_matmul {M}x{K}x{N}: the check passes a fixup that drops a partial")
        # the decode route's split-K sums its slices in a fixed order: serving
        # compares greedy tokens, so two launches must give the same bits
        check(rec["same_bits_twice"], f"ltrf_matmul {M}x{K}x{N} {dt}: two launches differ")
        res.append(rec)
    return res


def check_flash(cfg, hybrid, others, dev, gen) -> list:
    """tinyllama's shape (and ragged, and MQA), zamba2's, then one at each
    of ``others``' (H, KV, d), each tagged with its arch."""
    res = []
    shapes = [(2, cfg.n_heads, cfg.n_kv_heads, 1024, cfg.hd),
              (2, cfg.n_heads, cfg.n_kv_heads, 1000, cfg.hd),
              (2, 8, 1, 1024, cfg.hd),
              (2, hybrid.n_heads, hybrid.n_kv_heads, 1024, hybrid.hd)]
    shapes += [(2, c.n_heads, c.n_kv_heads, 1024, c.hd) for c in others]
    archs = [cfg.name] * 3 + [hybrid.name] + [c.name for c in others]
    for (B, H, KV, S, d), arch in zip(shapes, archs):
        dt = torch.bfloat16
        q = torch.randn(B, H, S, d, device=dev, generator=gen).to(dt)
        k = torch.randn(B, KV, S, d, device=dev, generator=gen).to(dt)
        v = torch.randn(B, KV, S, d, device=dev, generator=gen).to(dt)
        got = flash_attention(q, k, v)
        split = flash_ops._attend(q, k, v, True, False, split_p=True)[0]   # training's form
        torch.cuda.synchronize()
        want = attention_ref(q, k, v)
        rec = {"arch": arch, "B": B, "H": H, "KV": KV, "S": S, "d": d, "dtype": "bfloat16",
               **compare_flash(got, want), "split_p": compare_flash(split, want)}
        del split
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
        rec["prepass_ms"] = prepass_ms(q, k, v)
        emit({"check": "flash_attention", **rec})
        check(rec["within_tol"], f"flash_attention {rec} disagrees with plain")
        check(rec["split_p"]["within_tol"],
              f"flash_attention's split-P forward {rec} disagrees with plain")
        res.append(rec)
    return res


def prepass_ms(q, k, v, calls: int = 5):
    """The V pre-pass's device ms a bf16 call (no LSE), from the profiler's
    spans of ``calls`` calls (None if it saw none)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            flash_attention(q, k, v)
        torch.cuda.synchronize()
    us = [t for name, t in device_spans(prof)[0].items() if "flash_v_to_f16" in name]
    return sum(us) / calls / 1e3 if us else None


def per_head_flash(got, want, head_scales) -> dict:
    """Each query head against the flash limits alone, its atol times its
    V's scale: the worst head's excess over the elementwise limit and its
    relative L2."""
    got, want = got.float(), want.float()
    excess, l2 = [], []
    for h, sc in enumerate(head_scales):
        g, w = got[:, h], want[:, h]
        excess.append(float(((g - w).abs() / (FLASH_TOL["atol"] * sc
                                              + FLASH_TOL["rtol"] * w.abs())).max()))
        l2.append(rel_l2(g, w))
    return {"max_excess": max(excess), "max_rel_l2": max(l2),
            "within_tol": max(excess) <= 1.0 and max(l2) <= FLASH_REL_L2}


def check_flash_scaled_v(cfg, dev, gen) -> dict:
    """``cfg``'s (llava's) head dim and heads, with KV head 0's V times 2^20
    and head 1's times 2^-20: the pre-pass scales each to fp16 by a power of
    two of its own, and each query head must stay within the flash limits
    alone (atol times its V's scale).  Planted fault: the kernel's output
    with each head's 2^e left off (divided out again), which must fail."""
    B, H, KV, S, d = 2, cfg.n_heads, cfg.n_kv_heads, 1024, cfg.hd
    q, k, v = (torch.randn(B, n, S, d, device=dev, generator=gen) for n in (H, KV, KV))
    scales = torch.ones(KV, device=dev)
    scales[0], scales[1] = 2.0 ** 20, 2.0 ** -20
    q, k, v = q.bfloat16(), k.bfloat16(), (v * scales[None, :, None, None]).bfloat16()
    head_scales = scales.repeat_interleave(H // KV).tolist()
    got = flash_attention(q, k, v)
    torch.cuda.synchronize()
    want = attention_ref(q, k, v)
    _, e = v_to_f16_ref(v.cpu())
    off = torch.exp2(-e.float()).repeat_interleave(H // KV, 1)[..., None, None].to(dev)
    rec = {"arch": cfg.name, "B": B, "H": H, "KV": KV, "S": S, "d": d,
           "v_scales": [2.0 ** 20, 2.0 ** -20, 1.0], "exponents": e[0, :3].tolist(),
           **per_head_flash(got, want, head_scales),
           "planted_fault": per_head_flash(got.float() * off, want, head_scales)}
    emit({"check": "flash_attention_scaled_v", **rec})
    check(rec["within_tol"], f"flash_attention with scaled V heads disagrees with plain: {rec}")
    check(not rec["planted_fault"]["within_tol"],
          f"flash scaled-V check passes the output with 2^e left off: {rec}")
    return rec


def ssd_inputs(B, S, H, P, N, dev, gen):
    """Inputs at the scales the Mamba2 block gives the scan: x and B/C after
    the conv's silu, dt a softplus, A = -linspace(1, 16) over the heads."""
    x = F.silu(torch.randn(B, S, H, P, device=dev, generator=gen))
    dt = F.softplus(torch.randn(B, S, H, device=dev, generator=gen))
    A = -torch.exp(torch.log(torch.linspace(1.0, 16.0, H, device=dev)))
    Bm = F.silu(torch.randn(B, S, N, device=dev, generator=gen))
    Cm = F.silu(torch.randn(B, S, N, device=dev, generator=gen))
    return x, dt, A, Bm, Cm


def check_ssd(dev, gen) -> list:
    res = []
    # mamba2-1.3b prefill; the same with a ragged S; zamba2-1.2b prefill (N 64);
    # Q = 96 with P = N = 16 (and S ragged against it)
    for B, S, H, P, N, Q in [(2, 1024, 64, 64, 128, 256), (2, 1000, 64, 64, 128, 256),
                             (2, 1024, 64, 64, 64, 256), (2, 1000, 16, 16, 16, 96)]:
        ins = ssd_inputs(B, S, H, P, N, dev, gen)
        got = ssd_chunk(*ins, Q)
        torch.cuda.synchronize()
        want = ssd_chunk_ref(*ins, Q)
        rec = {"B": B, "S": S, "H": H, "P": P, "N": N, "Q": Q, "dtype": "float32",
               **compare_ssd(got, want)}
        x_bad = zero_x_block(ins[0], Q)
        planted = compare_ssd(got, ssd_chunk_ref(x_bad, *ins[1:], Q))
        rec["planted_fault"] = {n: planted[n]["rel_l2"] for n in SSD_OUTPUTS}
        rec["planted_fault"]["within_tol"] = planted["within_tol"]
        del got, want, x_bad
        rec["ms"], rec["eager_ms"] = time_ms([lambda: ssd_chunk(*ins, Q)])
        rec["plain_ms"], _ = time_ms([lambda: ssd_chunk_ref(*ins, Q)], min_iters=3)
        rec["library_ms"] = None                 # no PyTorch call computes it
        rec["bound_ms"], rec["bound_by"] = ssd_bound(B, S, H, P, N, Q)
        rec["bound_tc_ms"] = ssd_bound_tc(B, S, H, P, N, Q)
        emit({"check": "ssd_scan", **rec})
        check(not planted["within_tol"], f"ssd check passes a zeroed x block: {rec}")
        check(rec["within_tol"], f"ssd_scan {rec} disagrees with ssd_chunk_ref")
        res.append(rec)
        del ins
        free_memory()
    return res


def flash_bwd_inputs(B, H, KV, S, d, causal, dtype, dev, gen):
    """q, k, v, the kernel forward's O and LSE (as ``FlashAttentionFn``
    runs it), and dO."""
    q = torch.randn(B, H, S, d, device=dev, generator=gen).to(dtype)
    k, v = (torch.randn(B, KV, S, d, device=dev, generator=gen).to(dtype) for _ in range(2))
    do = torch.randn(B, H, S, d, device=dev, generator=gen).to(dtype)
    return (q, k, v, *flash_ops._attend(q, k, v, causal, with_lse=True, split_p=True), do)


def sdpa_grads(q, k, v, do, causal):
    """SDPA's fp32 backward on the same inputs, K and V repeated over each group."""
    rep = q.shape[1] // k.shape[1]
    q32, k32, v32 = (t.float().requires_grad_() for t in (q, k, v))
    out = F.scaled_dot_product_attention(q32, k32.repeat_interleave(rep, 1),
                                         v32.repeat_interleave(rep, 1), is_causal=causal)
    return torch.autograd.grad(out, (q32, k32, v32), do.float())


def grad_errs(grads, want) -> dict:
    return {n: rel_l2(g, r) for n, g, r in zip(("dq", "dk", "dv"), grads, want)}


def flash_bwd_faults(q, k, v, o, lse, do) -> dict:
    """The planted faults of the flash backward, each run on the kernel: a
    non-causal backward (of the non-causal forward), the GQA group sum
    dropped (dK, dV of the group's first head times the group), D dropped
    (O read as zeros)."""
    rep = q.shape[1] // k.shape[1]
    dq, dke, dve = flash_ops.flash_bwd(q, *(t.repeat_interleave(rep, 1) for t in (k, v)), o, lse,
                                       do, True)
    return {"not_causal": flash_ops.flash_bwd(q, k, v, *flash_ops._attend(q, k, v, False, True),
                                              do, False),
            "group_sum_dropped": (dq, dke[:, ::rep] * rep, dve[:, ::rep] * rep),
            "delta_dropped": flash_ops.flash_bwd(q, k, v, torch.zeros_like(o), lse, do, True)}


def flash_bwd_bound(B, H, KV, S, d, causal, dtype) -> tuple[float, str]:
    """Five products (S again, dV, dP, dQ, dK) over the (query, key) pairs
    this run needs, reading q, k, v, O, dO (and the LSE) and writing dq, dk, dv."""
    pairs = B * H * (S * (S + 1) / 2 if causal else S * S)
    size = torch.finfo(dtype).bits // 8
    # q, O, dO read and dq written; k, v read and dk, dv written; the LSE
    nbytes = 4 * (B * H + B * KV) * S * d * size + 4 * B * H * S
    return bound(nbytes, 10 * d * pairs, dtype)


SDPA_REPS = 10       # eager calls a median takes, for the backward and its yardstick


def sdpa_backward_ms(q, k, v, do) -> tuple[float, str]:
    """SDPA's backward alone, the first PyTorch call that computes
    ``flash_bwd``'s function: ``torch.autograd.grad`` of one causal forward,
    eager, under the FLASH_ATTENTION backend (K and V repeated over the group
    before the timed window if that backend refuses ``enable_gqa``); (median
    ms, what ran)."""
    qg = q.detach().requires_grad_()
    with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
        try:
            kg, vg = (t.detach().requires_grad_() for t in (k, v))
            out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True, enable_gqa=True)
            how = "FLASH_ATTENTION backend, enable_gqa"
        except RuntimeError:
            rep = q.shape[1] // k.shape[1]
            kg, vg = (t.repeat_interleave(rep, 1).detach().requires_grad_() for t in (k, v))
            out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
            how = "FLASH_ATTENTION backend, K and V repeated over the group outside the timing"
        ms = eager_ms(lambda: torch.autograd.grad(out, (qg, kg, vg), do, retain_graph=True),
                      reps=SDPA_REPS)
    return ms, f"scaled_dot_product_attention backward alone, bf16, eager ({how})"


def check_flash_bwd(cfg, dev, gen) -> list:
    """flash's backward kernel (``flash_bwd``) at tinyllama's train shape and
    at each head dim with a ragged S, causal and not, in bf16 (held to
    SDPA's fp32 backward) and fp32 (held to ``flash_bwd_ref``); two launches
    give the same bits; at the train shape the planted faults must fail, and
    the kernel, the plain version, SDPA's backward alone (``library_ms``) and
    SDPA's forward + backward are timed."""
    res = []
    cases = [(TRAIN_B, cfg.n_heads, cfg.n_kv_heads, TRAIN_S, cfg.hd, True, torch.bfloat16)]
    cases += [(2, 8, 2, 1000, d, causal, dt) for d in flash_ops.HEAD_DIMS
              for causal in (True, False) for dt in (torch.bfloat16, torch.float32)]
    for i, (B, H, KV, S, d, causal, dt) in enumerate(cases):
        q, k, v, o, lse, do = ins = flash_bwd_inputs(B, H, KV, S, d, causal, dt, dev, gen)
        before = flash_ops.flash_bwd.launches
        got = flash_ops.flash_bwd(*ins, causal)
        again = flash_ops.flash_bwd(*ins, causal)
        torch.cuda.synchronize()
        launched = flash_ops.flash_bwd.launches - before
        if dt == torch.bfloat16:
            want, limit = sdpa_grads(q, k, v, do, causal), FLASH_GRAD_REL_L2
        else:
            want, limit = flash_bwd_ref(*ins, causal), FLASH_BWD_F32_REL_L2
        rec = {"B": B, "H": H, "KV": KV, "S": S, "d": d, "causal": causal,
               "dtype": str(dt).split(".")[-1], "rel_l2": grad_errs(got, want), "limit": limit,
               "max_abs_err": max(float((g.float() - w.float()).abs().max())
                                  for g, w in zip(got, want)),
               "same_bits_twice": all(torch.equal(a, b) for a, b in zip(got, again))}
        del got, again
        rec["ms"], rec["eager_ms"] = time_ms([lambda: flash_ops.flash_bwd(*ins, causal)])
        rec["bound_ms"], rec["bound_by"] = flash_bwd_bound(B, H, KV, S, d, causal, dt)
        if i == 0:
            rec["planted_faults"] = {n: grad_errs(g, want)
                                     for n, g in flash_bwd_faults(*ins).items()}
            free_memory()
            rec["plain_ms"] = eager_ms(lambda: flash_bwd_ref(*ins, causal))
            qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))

            def sdpa():
                out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True, enable_gqa=True)
                torch.autograd.grad(out, (qg, kg, vg), do)

            rec["library_fwd_bwd_ms"] = eager_ms(sdpa)
            rec["library_ms"], rec["library"] = sdpa_backward_ms(q, k, v, do)
            # the kernel timed the same way: one eager call between CUDA events
            rec["kernel_eager_call_ms"] = eager_ms(lambda: flash_ops.flash_bwd(*ins, causal),
                                                   reps=SDPA_REPS)
        del want, ins, q, k, v, o, lse, do
        free_memory()
        emit({"check": "flash_attention_bwd", **rec})
        check(launched == 2, f"flash backward launches {launched}: {rec}")
        check(rec["same_bits_twice"], f"flash backward: two launches differ: {rec}")
        check(max(rec["rel_l2"].values()) <= limit, f"flash backward disagrees: {rec}")
        for name, errs in rec.get("planted_faults", {}).items():
            check(max(errs.values()) > limit, f"flash backward check passes {name}: {rec}")
        res.append(rec)
    return res


def ssd_bwd_bound(B, S, H, P, N, Q) -> tuple[float, str]:
    """The backward reads the inputs and the outputs' gradients and writes
    the inputs' gradients.  Its products, counted as ``ssd_work`` counts the
    forward's, at the fp32 rate: per (b, chunk) C B^T again, dG B and dG^T C
    over the lower triangle; per head dM = dy xdt^T and M^T dy over the
    lower triangle, B dS^T and (xdt o decay_end)^T dS over the rows."""
    nbytes = ssd_work(B, S, H, P, N, Q)[0]
    in_bytes = 4 * (B * S * H * P + B * S * H + H + 2 * B * S * N)
    _, rows, tri = chunk_rows(S, Q)
    flops = B * (3 * 2 * N * tri + H * (2 * 2 * P * tri + 2 * 2 * P * N * rows))
    return bound(nbytes + in_bytes, flops, torch.float32)


def ssd_bwd_bound_tc(B, S, H, P, N, Q) -> float:
    """The backward's work as the kernel does it: each of its products (the
    ones ``ssd_bwd_bound`` counts) as three bf16 tensor-core products
    (bf16x3) at 989 TFLOP/s, or the bytes if they take longer."""
    nbytes = ssd_work(B, S, H, P, N, Q)[0] + 4 * (B * S * H * P + B * S * H + H + 2 * B * S * N)
    _, rows, tri = chunk_rows(S, Q)
    flops = B * (3 * 2 * N * tri + H * (2 * 2 * P * tri + 2 * 2 * P * N * rows))
    return 1e3 * max(nbytes / HBM_BYTES_PER_S, 3 * flops / PEAK_FLOPS[torch.bfloat16])


SSD_GRADS = ("dx", "ddt", "dA", "dB", "dC")


def ssd_bwd_limits() -> dict:
    return {n: SSD_BWD_DA_REL_L2 if n == "dA" else SSD_BWD_REL_L2 for n in SSD_GRADS}


def within(errs: dict, limits: dict) -> bool:
    return all(errs[n] <= limits[n] for n in errs)


def ssd_bwd_readings(B, S, H, P, N, Q, dev, gen) -> tuple:
    """(inputs, output gradients, the kernel's gradients, the float64 plain
    version's, and each gradient's relative L2 for the kernel and for the
    fp32 plain version against the float64 one)."""
    ins = ssd_inputs(B, S, H, P, N, dev, gen)
    grads = tuple(torch.randn(o.shape, device=dev, generator=gen) for o in ssd_chunk(*ins, Q))
    got = ssd_ops.ssd_chunk_bwd(ins, Q, grads)
    want = ssd_chunk_bwd_ref(*(t.double() for t in ins), Q, tuple(g.double() for g in grads))
    errs = ({n: rel_l2(g, w) for n, g, w in zip(SSD_GRADS, got, want)},
            {n: rel_l2(g, w) for n, g, w in zip(SSD_GRADS, ssd_chunk_bwd_ref(*ins, Q, grads),
                                                 want)})
    return ins, grads, got, want, errs


def check_ssd_bwd(dev, gen) -> list:
    """ssd_scan's backward kernel (``ssd_chunk_bwd``) at mamba2-1.3b's and
    zamba2-1.2b's train shapes, per gradient against ``ssd_chunk_bwd_ref``
    run in float64 (its fp32 run's own distance beside it), on the inputs of
    ``gen`` and of SSD_BWD_SEEDS more seeds; two launches give the same bits;
    a dropped in_decay gradient must fail; the kernel and the fp32 plain
    version timed."""
    res = []
    for arch in (SSM_ARCH, HYBRID_ARCH):
        c = get_arch(arch)
        B, S, H = GRAD_B, TRAIN_S, c.ssm_expand * c.d_model // c.ssm_headdim
        P, N, Q = c.ssm_headdim, c.ssm_state, c.ssm_chunk
        before = ssd_ops.ssd_chunk_bwd.launches
        ins, grads, got, want, (errs, plain_errs) = ssd_bwd_readings(B, S, H, P, N, Q, dev, gen)
        again = ssd_ops.ssd_chunk_bwd(ins, Q, grads)
        torch.cuda.synchronize()
        launched = ssd_ops.ssd_chunk_bwd.launches - before
        planted = ssd_ops.ssd_chunk_bwd(ins, Q, (grads[0], grads[1], None, grads[3]))
        rec = {"arch": arch, "B": B, "S": S, "H": H, "P": P, "N": N, "Q": Q, "dtype": "float32",
               "rel_l2": errs, "plain_fp32_rel_l2": plain_errs,
               "planted_in_decay_dropped": {n: rel_l2(g, w) for n, g, w in
                                            zip(SSD_GRADS, planted, want)},
               "limit": ssd_bwd_limits(),
               "max_abs_err": max(float((g.double() - w).abs().max()) for g, w in zip(got, want)),
               "same_bits_twice": all(torch.equal(a, b) for a, b in zip(got, again))}
        del got, again, want, planted
        free_memory()
        rec["seeds"] = []
        for seed in range(SSD_BWD_SEEDS):
            more = ssd_bwd_readings(B, S, H, P, N, Q, dev,
                                    torch.Generator(dev).manual_seed(1000 + seed))[-1]
            rec["seeds"].append({"seed": 1000 + seed, "rel_l2": more[0],
                                 "plain_fp32_rel_l2": more[1]})
            del more
            free_memory()
        rec["ms"], rec["eager_ms"] = time_ms([lambda: ssd_ops.ssd_chunk_bwd(ins, Q, grads)])
        rec["plain_ms"] = eager_ms(lambda: ssd_chunk_bwd_ref(*ins, Q, grads))
        rec["library_ms"] = None                 # no PyTorch call computes it
        rec["bound_ms"], rec["bound_by"] = ssd_bwd_bound(B, S, H, P, N, Q)
        rec["bound_tc_ms"] = ssd_bwd_bound_tc(B, S, H, P, N, Q)
        emit({"check": "ssd_scan_bwd", **rec})
        check(launched == 2, f"ssd backward launches {launched}: {rec}")
        check(rec["same_bits_twice"], f"ssd backward: two launches differ: {rec}")
        for e in [rec["rel_l2"]] + [r["rel_l2"] for r in rec["seeds"]]:
            check(within(e, rec["limit"]), f"ssd backward disagrees: {rec}")
        check(not within(rec["planted_in_decay_dropped"], rec["limit"]),
              f"ssd backward check passes a dropped in_decay gradient: {rec}")
        res.append(rec)
        del ins, grads
        free_memory()
    return res


def phase_kernel_checks(cfgs, dev) -> dict:
    gen = torch.Generator(dev).manual_seed(123)
    return {"ltrf_matmul": check_matmuls(cfgs, dev, gen),
            "flash_attention": check_flash(cfgs[0], cfgs[2], cfgs[3:], dev, gen),
            "flash_attention_scaled_v": check_flash_scaled_v(cfgs[5], dev, gen),
            "ssd_scan": check_ssd(dev, gen),
            "flash_attention_bwd": check_flash_bwd(cfgs[0], dev, gen),
            "ssd_scan_bwd": check_ssd_bwd(dev, gen)}


def reset_counts() -> None:
    for kern in (ltrf_matmul, flash_attention, ssd_scan, flash_ops.flash_bwd,
                 ssd_ops.ssd_chunk_bwd):
        kern.launches = 0
    for kern in (ltrf_matmul, flash_attention, flash_ops.flash_bwd):
        kern.launches_by_route = dict.fromkeys(kern.launches_by_route, 0)
    ltrf_matmul.launches_by_layout = dict.fromkeys(ltrf_matmul.launches_by_layout, 0)


def read_counts() -> dict:
    return {"ltrf_matmul": ltrf_matmul.launches, "flash_attention": flash_attention.launches,
            "ssd_scan": ssd_scan.launches}


def read_backward() -> dict:
    """The backward kernels' launches, under their forward kernel's name, and
    ``ltrf_matmul``'s launches by layout (nn forward, nt dX, tn dW)."""
    return {"flash_attention": flash_ops.flash_bwd.launches,
            "ssd_scan": ssd_ops.ssd_chunk_bwd.launches,
            "flash_attention_by_route": dict(flash_ops.flash_bwd.launches_by_route),
            "ltrf_matmul_by_layout": dict(ltrf_matmul.launches_by_layout)}


def read_routes() -> dict:
    return {"ltrf_matmul": dict(ltrf_matmul.launches_by_route),
            "flash_attention": dict(flash_attention.launches_by_route)}


plain_attention = layers.causal_attention
plain_carry = mamba2.chunk_carry
plain_mask = mamba2._causal_mask
plain_moe_block = lm_module.moe_block

# planted attention faults (replacements of the plain path's causal_attention)
ATTN_FAULTS = {
    "not_causal": lambda q, k, v, q_block=512, q_offset=None: plain_attention(
        q, k, v, q_block=q_block, q_offset=k.shape[1] - 1),
    "kv_tile_zeroed": lambda q, k, v, q_block=512, q_offset=None: plain_attention(
        q, *zero_kv_tile(k, v, 1), q_block=q_block, q_offset=q_offset),
}


@contextlib.contextmanager
def patched(module, attr, replacement):
    orig = getattr(module, attr)
    setattr(module, attr, replacement)
    try:
        yield
    finally:
        setattr(module, attr, orig)


def planted_logits(cfg, params, batch, logits_p, faults) -> dict:
    """What the model-level limit reads for each planted fault, name ->
    (module, attribute, replacement), on the plain path."""
    out = {}
    for name, fault in faults.items():
        with patched(*fault):
            logits_f, _ = logits_fn(params, batch, cfg, kernels=False)
        out[name] = {"logits_rel_l2": rel_l2(logits_f, logits_p),
                     "logits_row_rel_l2": row_rel_l2(logits_f, logits_p)}
        del logits_f
    return out


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


@contextlib.contextmanager
def checking_ssd():
    """Hold each ssd_chunk call the layers make against ssd_chunk_ref at its
    inputs; keep the first call's inputs for a planted fault."""
    recs, first = [], []

    def record(x, dt, A, Bm, Cm, chunk):
        out = ssd_chunk(x, dt, A, Bm, Cm, chunk)
        recs.append(compare_ssd(out, ssd_chunk_ref(x, dt, A, Bm, Cm, chunk)))
        if not first:
            first.append(((x, dt, A, Bm, Cm, chunk), out))
        return out

    ssd_ops.ssd_chunk = record
    try:
        yield recs, first
    finally:
        ssd_ops.ssd_chunk = ssd_chunk


def main_path_prefill(cfg, params, batch) -> tuple[torch.Tensor, dict, dict, float]:
    """One kernel-path ``loss_fn`` with the counts set to 0 just before it;
    every bf16 matmul (M = 2048) and flash call must take the wgmma route."""
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    loss, _ = loss_fn(params, batch, cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, routes = read_counts(), read_routes()
    want = forward_launches(cfg)
    check(bool(torch.isfinite(loss)), f"{cfg.name} prefill loss not finite: {loss}")
    check(counts == want, f"{cfg.name} prefill launches {counts}, want {want}")
    for name in routes:
        check(routes[name]["wgmma"] == want[name],
              f"{cfg.name} prefill {name} routes {routes[name]}, want {want[name]} on wgmma")
    return loss, counts, routes, wall


def prefill_batch(cfg, dev, seed) -> dict:
    """B=2 x S=1024 positions from the seed, as the data pipeline lays them
    out: audio codes (2, K, 1024); vlm n_patches patch embeddings (N(0,
    0.02^2)) ahead of 1024 - n_patches tokens, labels 0 at the patches."""
    gen = torch.Generator(dev).manual_seed(seed + 1)
    if cfg.family == "audio":
        codes = torch.randint(0, cfg.vocab, (2, cfg.n_codebooks, 1024), device=dev, generator=gen)
        return {"codes": codes, "labels": codes}
    if cfg.family == "vlm":
        toks = torch.randint(0, cfg.vocab, (2, 1024 - cfg.n_patches), device=dev, generator=gen)
        patches = 0.02 * torch.randn(2, cfg.n_patches, cfg.d_model, device=dev, generator=gen)
        labels = torch.cat([toks.new_zeros((2, cfg.n_patches)), toks], dim=1)
        return {"tokens": toks, "patches": patches, "labels": labels}
    toks = torch.randint(0, cfg.vocab, (2, 1024), device=dev, generator=gen)
    return {"tokens": toks, "labels": toks}


def loss_fn_ms(cfg, params, batch, reps: int = 5) -> dict:
    """Host-clock ms of one ``loss_fn`` (ending in a synchronise) on each
    path, the median of ``reps`` calls and their spread (min, max): single
    calls vary by up to 1.8x between calls of the same code, as the host's
    share of a prefill does.  Also the device-busy ms of one more call,
    from the profiler's kernel spans, which the host's speed does not move."""
    from torch.profiler import ProfilerActivity, profile

    out = {}
    for name, kern in (("kernel", True), ("plain", False)):
        samples = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss_fn(params, batch, cfg, kernels=kern)
            torch.cuda.synchronize()
            samples.append(1e3 * (time.perf_counter() - t0))
        out[f"{name}_loss_fn_ms"] = statistics.median(samples)
        out[f"{name}_loss_fn_ms_range"] = [min(samples), max(samples)]
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            loss_fn(params, batch, cfg, kernels=kern)
            torch.cuda.synchronize()
        out[f"{name}_loss_fn_device_busy_ms"] = sum(device_spans(prof)[0].values()) / 1e3
    return out


def device_spans(prof, trace_name: str | None = None) -> tuple[dict, int]:
    """Device time in microseconds by kernel (and copy, and memset) name, and
    the number of such spans, from a finished profiler's Chrome trace (kept
    under chiprun_out/ as ``trace_name`` when one is given)."""
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    trace = out_dir / (trace_name or "last_trace.json")
    prof.export_chrome_trace(str(trace))
    events = json.loads(trace.read_text())["traceEvents"]
    if trace_name is None:
        trace.unlink()
    spans = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    by_name: dict = {}
    for e in spans:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"]
    return by_name, len(spans)


def flash_per_layer(calls, n_expected) -> dict:
    per_layer = [compare_flash(o, attention_ref(q, k, v)) for q, k, v, o in calls]
    q, k, v, _ = calls[0]
    planted = compare_flash(attention_ref(q, *zero_kv_tile(k, v, 2)), attention_ref(q, k, v))
    rec = {"layers": len(per_layer), "max_abs_err": max(r["max_abs_err"] for r in per_layer),
           "max_rel_l2": max(r["rel_l2"] for r in per_layer),
           "within_tol": all(r["within_tol"] for r in per_layer), "planted_fault_layer0": planted}
    check(len(per_layer) == n_expected and rec["within_tol"],
          f"flash_attention vs plain at the model's inputs: {rec}")
    check(not planted["within_tol"], f"flash check passes a zeroed KV tile: {planted}")
    return rec


def ssd_per_layer(recs, first, n_expected) -> dict:
    (x, dt, A, Bm, Cm, chunk), out = first[0]
    planted = compare_ssd(out, ssd_chunk_ref(zero_x_block(x, chunk), dt, A, Bm, Cm, chunk))
    rec = {"layers": len(recs), "max_abs_err": max(r["max_abs_err"] for r in recs),
           "max_rel_l2": {n: max(r[n]["rel_l2"] for r in recs) for n in SSD_OUTPUTS},
           "max_excess": {n: max(r[n]["max_excess"] for r in recs) for n in SSD_OUTPUTS},
           "within_tol": all(r["within_tol"] for r in recs),
           "planted_fault_layer0": {"rel_l2": {n: planted[n]["rel_l2"] for n in SSD_OUTPUTS},
                                    "within_tol": planted["within_tol"]}}
    check(len(recs) == n_expected and rec["within_tol"],
          f"ssd_scan vs ssd_chunk_ref at the model's inputs: {rec}")
    check(not planted["within_tol"], f"ssd check passes a zeroed x block: {rec}")
    return rec


def phase_prefill(cfg, params, dev, seed) -> dict:
    batch = prefill_batch(cfg, dev, seed)
    loss, counts, routes, wall = main_path_prefill(cfg, params, batch)
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
           "logits_shape": list(logits_k.shape), "first_call_s": wall, "launches": counts,
           "launches_by_route": routes}
    del logits_k
    # flash_attention at each layer's own inputs, against its plain version
    out["flash_per_layer"] = flash_per_layer(calls, cfg.n_layers)
    del calls
    # what the model-level limit reads for planted attention faults on the
    # plain path: attention that is not causal, and one KV tile zeroed
    out["planted_model_faults"] = planted_logits(cfg, params, batch, logits_p, model_faults(cfg))
    del logits_p
    out.update(loss_fn_ms(cfg, params, batch))
    check(out["logits_rel_l2"] <= MODEL_LOGITS_REL_L2, f"prefill logits vs plain: {out}")
    for name, fault in out["planted_model_faults"].items():
        check(fault["logits_rel_l2"] > MODEL_LOGITS_REL_L2,
              f"the model-level limit passes a planted attention fault ({name}): {out}")
    check(out["loss_rel_diff"] <= MODEL_LOSS_REL, f"prefill loss vs plain: {out}")
    return out


# planted SSM faults on the plain path: the state entering each chunk zeroed
# (the inter-chunk carry dropped), and no causal mask inside a chunk
SSM_FAULTS = {
    "carry_dropped": ("chunk_carry",
                      lambda st, dec: (plain_carry(st, dec)[0], torch.zeros_like(st))),
    "mask_dropped": ("_causal_mask",
                     lambda Q, device: torch.ones((Q, Q), dtype=torch.bool, device=device)),
}


def fp32_copy(tree):
    """The same weights in fp32 (every bf16 value is exact in fp32)."""
    return tree_map(lambda t: t.float(), tree)


plain_matmul = layers.matmul


@contextlib.contextmanager
def plain_matmuls_rounded_once():
    """The plain path's products as ``matmul_ref`` (fp32 sums rounded once,
    as the kernel rounds) in place of cuBLAS's bf16 GEMM."""
    def mm(x, w, kernels=True):
        return plain_matmul(x, w, kernels) if kernels else matmul_ref(x, w)

    mods = (layers, mamba2, lm_module)
    for mod in mods:
        mod.matmul = mm
    try:
        yield
    finally:
        for mod in mods:
            mod.matmul = plain_matmul


def planted_ssm_faults(cfg, params, batch, logits_p) -> dict:
    """What the model-level limit reads for each planted SSM fault."""
    return planted_logits(cfg, params, batch, logits_p,
                          {n: (mamba2, a, f) for n, (a, f) in SSM_FAULTS.items()})


def ssm_prefill(cfg, params, dev, seed, faults: bool) -> dict:
    """Kernel-path prefill of a Mamba2-family model, held against the plain
    path in the model's dtype and in fp32, with each layer's flash and ssd
    calls held against their plain versions."""
    batch = prefill_batch(cfg, dev, seed)
    loss, counts, routes, wall = main_path_prefill(cfg, params, batch)
    with recording_flash() as calls, checking_ssd() as (ssd_recs, ssd_first):
        logits_k, _ = logits_fn(params, batch, cfg)
    logits_p, _ = logits_fn(params, batch, cfg, kernels=False)
    loss_p, _ = loss_fn(params, batch, cfg, kernels=False)
    out = {"loss": float(loss), "loss_plain": float(loss_p),
           "loss_rel_diff": abs(float(loss) - float(loss_p)) / abs(float(loss_p)),
           "logits_rel_l2": rel_l2(logits_k, logits_p),
           "logits_row_rel_l2": row_rel_l2(logits_k, logits_p),
           "logits_max_abs_err": float((logits_k.float() - logits_p.float()).abs().max()),
           "logits_shape": list(logits_k.shape), "first_call_s": wall, "launches": counts,
           "launches_by_route": routes}
    del logits_k
    out["ssd_per_layer"] = ssd_per_layer(ssd_recs, ssd_first, cfg.n_layers)
    del ssd_recs, ssd_first
    if calls:
        out["flash_per_layer"] = flash_per_layer(calls, forward_launches(cfg)["flash_attention"])
    del calls
    # what bf16 rounding alone does over this depth: the plain path with its
    # products rounded once from fp32 sums, against the plain path
    with plain_matmuls_rounded_once():
        logits_r, _ = logits_fn(params, batch, cfg, kernels=False)
    out["plain_rounding_rel_l2"] = rel_l2(logits_r, logits_p)
    del logits_r
    if faults:
        out["planted_model_faults"] = planted_ssm_faults(cfg, params, batch, logits_p)
    del logits_p
    free_memory()
    # the same weights and tokens in fp32: kernel path vs plain path, and the
    # planted faults there
    cfg32, params32 = dataclasses.replace(cfg, dtype="float32"), fp32_copy(params)
    lk, _ = logits_fn(params32, batch, cfg32)
    lp, _ = logits_fn(params32, batch, cfg32, kernels=False)
    out["fp32"] = {"logits_rel_l2": rel_l2(lk, lp), "logits_row_rel_l2": row_rel_l2(lk, lp)}
    del lk
    if faults:
        out["fp32"]["planted_model_faults"] = planted_ssm_faults(cfg32, params32, batch, lp)
    del lp, params32
    free_memory()
    out.update(loss_fn_ms(cfg, params, batch))
    check(out["fp32"]["logits_rel_l2"] <= SSM_FP32_REL_L2,
          f"{cfg.name} fp32 prefill logits vs plain: {out}")
    for name, fault in out["fp32"].get("planted_model_faults", {}).items():
        check(fault["logits_rel_l2"] > SSM_FP32_REL_L2,
              f"the fp32 model-level limit passes a planted SSM fault ({name}): {out}")
    check(out["logits_rel_l2"] <= SSM_BF16_REL_L2, f"{cfg.name} prefill logits vs plain: {out}")
    check(out["loss_rel_diff"] <= MODEL_LOSS_REL, f"{cfg.name} prefill loss vs plain: {out}")
    return out


def first_tokens(cfg, dev) -> torch.Tensor:
    """The engine's first tokens for 8 slots: zeros, (8, 1) or (8, K, 1)."""
    shape = (8, cfg.n_codebooks, 1) if cfg.family == "audio" else (8, 1)
    return torch.zeros(shape, dtype=torch.long, device=dev)


def engine_tokens(cfg, greedy) -> torch.Tensor:
    """The next step's tokens from a step's argmax, as the engine feeds them:
    (8, 1), or for audio codebook 0's token on every codebook, (8, K, 1)."""
    if cfg.family == "audio":
        return greedy[:, :1, None].expand(-1, cfg.n_codebooks, 1)
    return greedy[:, None]


def decode_pairs(cfg, params, dev, steps: int = 4, plain_fault=None) -> list:
    """The engine's first ``steps`` decode steps (zeros in, shared cache_len
    0, 1, ...) on both paths, 8 slots, max_len 256, each fed the kernel
    path's greedy tokens; ``plain_fault`` (module, attribute, replacement)
    is planted in the plain path's steps."""
    ck = init_decode_cache(cfg, 8, 256, dev)
    cp = init_decode_cache(cfg, 8, 256, dev)
    toks = first_tokens(cfg, dev)
    out = []
    for step in range(steps):
        lk, ck = decode_step(params, ck, toks, step, cfg)
        with patched(*plain_fault) if plain_fault else contextlib.nullcontext():
            lp, cp = decode_step(params, cp, toks, step, cfg, kernels=False)
        out.append({"step": step, "logits_rel_l2": rel_l2(lk, lp),
                    "logits_max_abs_err": float((lk.float() - lp.float()).abs().max()),
                    "argmax_agree": float((lk[:, -1].argmax(-1) == lp[:, -1].argmax(-1))
                                          .float().mean())})
        toks = engine_tokens(cfg, lk[:, -1].argmax(-1))
    del ck, cp
    return out


def decode_vs_plain(cfg, params, dev, limit, steps: int = 4) -> list:
    out = decode_pairs(cfg, params, dev, steps)
    check(all(s["logits_rel_l2"] <= limit for s in out),
          f"{cfg.name} ({cfg.dtype}) decode vs plain: {out}")
    return out


def ssm_decode_vs_plain(cfg, params, dev) -> dict:
    """Decode steps against the plain path in the model's dtype and in fp32."""
    out = {"bf16": decode_vs_plain(cfg, params, dev, SSM_BF16_REL_L2)}
    free_memory()
    params32 = fp32_copy(params)
    out["fp32"] = decode_vs_plain(dataclasses.replace(cfg, dtype="float32"), params32, dev,
                                  SSM_FP32_REL_L2)
    del params32
    free_memory()
    return out


SERVE_KW = dict(smoke=False, n_requests=16, max_new=12, active_slots=8, total_pages=64,
                max_len=256)
REAL_CAPTURE = ServingEngine._capture


def stale_cache_len_capture(engine) -> None:
    """The planted fault: capture as the engine does, then point the steps'
    writes at a scalar the graph does not read, so every replay keeps the
    captured cache_len (0), as a Python int baked into a trace would."""
    REAL_CAPTURE(engine)
    engine._len = torch.zeros_like(engine._len)


def main_path_serve(arch, cfg, params, dev, seed, planted=False) -> dict:
    """``serve()`` on the compiled engine (the main path: the decode step
    captured once as a CUDA graph and replayed, its launches counted through
    the replays), then on the eager engine (``graphs=False``) with the same
    weights and requests: the two engines' tokens must agree bit for bit
    (the same kernels in the same order).  ``planted``: a compiled run whose
    cache_len scalar is never written must fail that check.  ``params`` are
    ``init_params`` from the seed, the weights ``serve()`` would make."""
    kw = dict(SERVE_KW, seed=seed, device=dev, params=params)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    stats = serve(arch, **kw)
    counts, routes = read_counts(), read_routes()  # the main path's launches
    seconds = {"compiled": time.perf_counter() - t0}
    check(stats["graphs"], f"{arch} serve ran eagerly on the card")
    check(stats["completed"] == 16, f"{arch} serve completed {stats['completed']}/16")
    check(stats["pages_leaked"] == 0, f"{arch} serve leaked {stats['pages_leaked']} pages")
    per_step = forward_launches(cfg)["ltrf_matmul"]
    check(counts == {"ltrf_matmul": stats["steps"] * per_step, "flash_attention": 0,
                     "ssd_scan": 0}, f"{arch} serve launches {counts} over {stats['steps']} steps")
    check(routes["ltrf_matmul"]["decode"] == counts["ltrf_matmul"],
          f"{arch} serve matmul routes {routes['ltrf_matmul']}: every step is M = 8")
    t0 = time.perf_counter()
    eager = serve(arch, graphs=False, **kw)
    seconds["eager"] = time.perf_counter() - t0
    check(not eager["graphs"] and eager["generated"] == stats["generated"],
          f"{arch}: the compiled engine's tokens {stats['generated']} differ from the "
          f"eager engine's {eager['generated']}")
    out = {k: v for k, v in stats.items() if k != "generated"}
    out["eager"] = {k: eager[k] for k in ("steps", "ms_per_step", "tok_per_s", "wall_s")}
    out["tokens_equal_eager"] = True
    if planted:
        t0 = time.perf_counter()
        with patched(ServingEngine, "_capture", stale_cache_len_capture):
            stale = serve(arch, **kw)
        seconds["planted"] = time.perf_counter() - t0
        differ = sum(a != b for a, b in zip(stale["generated"].values(),
                                            stats["generated"].values()))
        check(differ > 0, f"{arch}: the token check passes a planted stale cache_len scalar")
        out["planted_stale_cache_len"] = {"requests_whose_tokens_differ": differ}
    return {**out, "serve_s": seconds, "launches": counts, "launches_by_route": routes}


def phase_serve(cfg, params, dev, seed) -> dict:
    stats = main_path_serve(ARCH, cfg, params, dev, seed, planted=True)
    return {**stats, "decode_vs_plain": decode_vs_plain(cfg, params, dev, MODEL_LOGITS_REL_L2)}


def profile_engine(engine, trace_name) -> dict:
    """Device-busy share of decode steps as the engine runs them (8 slots,
    greedy tokens fetched to the host every step), from the profiler's
    kernel spans."""
    from torch.profiler import ProfilerActivity, profile

    def step(n):
        engine.tokens[:, 0] = engine.decode(n).cpu().numpy()

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
    by_name, n_spans = device_spans(prof, trace_name)
    busy_ms = sum(by_name.values()) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"steps": n_steps, "wall_ms_per_step": 1e3 * wall / n_steps,
            "device_busy_ms_per_step": busy_ms / n_steps,
            "device_busy_share": busy_ms / (1e3 * wall),
            "device_ops_per_step": n_spans / n_steps,
            "top_kernels_ms_per_step": [(name[:80], d / 1e3 / n_steps) for name, d in top]}


def phase_profile(cfg, params, dev, trace_name="decode_trace.json") -> dict:
    """Four decode steps of the eager engine (``graphs=False``) and four of
    the compiled one (replays of its captured step; trace
    ``decode_trace_graph*.json``), each profiled as ``profile_engine`` does,
    beside the step's HBM bound."""
    sc = ServeConfig(max_len=256, active_slots=8, total_pages=64)
    engine = ServingEngine(cfg, params, sc, device=dev, graphs=False)
    out = profile_engine(engine, trace_name)
    # a step reads every weight but the embedding table (of which it gathers
    # 8 rows), reads and writes the SSM state and conv window, and reads the
    # KV caches (whole, as plain decode attention does)
    nbytes = {"weights": sum(t.numel() * t.element_size() for k, v in params.items()
                             if k != "embed" for t in tree_leaves(v)),
              "ssm_state": sum(t.numel() * t.element_size() for k, t in engine.cache.items()
                               if k in ("ssm", "conv")),
              "kv_cache": sum(t.numel() * t.element_size() for k, t in engine.cache.items()
                              if k in ("k", "v"))}
    del engine
    free_memory()
    engine = ServingEngine(cfg, params, sc, device=dev)
    check(engine.graph is not None, f"{cfg.name}: the profiled engine did not capture its step")
    out["replayed"] = {**profile_engine(engine, trace_name.replace("decode_trace",
                                                                   "decode_trace_graph")),
                       "capture_s": engine.capture_s}
    del engine
    free_memory()
    out["replayed_over_eager"] = {
        k: out["replayed"][k] / out[k]
        for k in ("wall_ms_per_step", "device_busy_ms_per_step", "device_ops_per_step")}
    return {**out, "bytes_per_step": nbytes,
            "hbm_bound_ms_per_step": 1e3 * (nbytes["weights"] + 2 * nbytes["ssm_state"]
                                            + nbytes["kv_cache"]) / HBM_BYTES_PER_S}


def phase_prefill_mamba2(cfg, params, dev, seed) -> dict:
    return ssm_prefill(cfg, params, dev, seed, faults=True)


def phase_serve_mamba2(cfg, params, dev, seed) -> dict:
    stats = main_path_serve(SSM_ARCH, cfg, params, dev, seed)
    free_memory()
    return {**stats, "decode_vs_plain": ssm_decode_vs_plain(cfg, params, dev),
            "profile": phase_profile(cfg, params, dev, f"decode_trace_{SSM_ARCH}.json")}


def phase_prefill_zamba2(cfg, params, dev, seed) -> dict:
    out = ssm_prefill(cfg, params, dev, seed, faults=False)
    out["decode_vs_plain"] = ssm_decode_vs_plain(cfg, params, dev)
    return out


def phase_serve_zamba2(cfg, params, dev, seed) -> dict:
    """The serve of phase 5 for zamba2-1.2b (the SSM caches and the shared
    block's KV caches in one captured step), and 4 steps profiled each way."""
    stats = main_path_serve(HYBRID_ARCH, cfg, params, dev, seed)
    free_memory()
    return {**stats, "profile": phase_profile(cfg, params, dev,
                                              f"decode_trace_{HYBRID_ARCH}.json")}


# --- the moe, audio, vlm and wide dense families ----------------------------
#
# model-level limits of these families, kernel path vs plain path, as a
# relative L2 of the logits: (bf16, fp32, the planted faults left to the fp32
# limit).  Every planted fault must read above the fp32 limit, and every one
# not listed above the bf16 limit.  Read on an H100 80GB HBM3 at 700 W (PERF.md):
# - fp32: 3e-3 for the models without experts, where sound reads are 3e-6 to
#   1.1e-5 and the weakest planted fault (one KV tile zeroed) 0.0185 to 0.143;
#   1e-2 for the MoE models, where a few top-k choices flip between the paths
#   even in fp32 and a flipped token's MoE output changes outright
#   (granite-moe: 6 of 2048 x 32 choices, sound 1.0e-3; dbrx 1.5e-6), and the
#   weakest fault reads 0.029.  The same limits hold the first 4 decode steps
#   (sound 2e-6 to 4e-6; granite-moe with its capacity ignored reads 0.41).
# - bf16: the dense limit where bf16 rounding alone stays under it (musicgen
#   0.027 over 48 layers, llava 0.016 over 12; decode up to 0.031), tighter
#   where the depth cut leaves the paths closer (phi3 and granite-20b 0.0071
#   at 4 layers: 1.5e-2, which a zeroed KV tile, 0.020, fails; dbrx 0.010 at
#   2: 2e-2, zeroed tile 0.030), and a gross 0.15 for granite-moe, where
#   rounding alone flips 3 to 737 of the 2048 tokens' routes a layer and reads
#   0.075 (decode up to 0.072; the dropped renormalisation reads 0.33, the
#   dropped inverse permutation 0.82, a zeroed KV tile 0.095).
FAMILY_LIMITS = {
    MOE_ARCH: (0.15, 1e-2, ("kv_tile_zeroed",)),
    AUDIO_ARCH: (MODEL_LOGITS_REL_L2, 3e-3, ()),
    "llava-next-34b": (MODEL_LOGITS_REL_L2, 3e-3, ()),
    "dbrx-132b": (2e-2, 1e-2, ()),
    "phi3-medium-14b": (1.5e-2, 3e-3, ()),
    "granite-20b": (1.5e-2, 3e-3, ()),
}

# planted MoE faults (replacements in repro_torch.models.moe): the top-k
# gates not renormalised, the expert outputs not permuted back to their
# tokens, and (at decode) no capacity limit
MOE_FAULTS = {
    "renorm_dropped": ("top_k_gates", lambda probs, top_k: tuple(
        t[:, :top_k] for t in torch.sort(probs, dim=-1, descending=True, stable=True))),
    "inverse_dropped": ("inverse_permutation",
                        lambda order: torch.arange(order.numel(), device=order.device)),
}
CAPACITY_IGNORED = (moe, "capacity", lambda n_assign, n_experts, capacity_factor: n_assign)


def model_faults(cfg) -> dict:
    """name -> (module, attribute, replacement) of the planted faults."""
    out = {n: (layers, "causal_attention", f) for n, f in ATTN_FAULTS.items()}
    if cfg.family == "moe":
        out.update({n: (moe, a, f) for n, (a, f) in MOE_FAULTS.items()})
    return out


@contextlib.contextmanager
def recording_routes():
    """Record each MoE layer's top-k expert set per token (sorted ids, (T, k))."""
    sets = []

    def record(params, x, *, top_k, capacity_factor=1.25, groups=1):
        probs = torch.softmax(torch.matmul(x.reshape(-1, x.shape[-1]).float(),
                                           params["router"]), dim=-1)
        sets.append(moe.top_k_gates(probs, top_k)[1].sort(dim=-1).values)
        return plain_moe_block(params, x, top_k=top_k, capacity_factor=capacity_factor,
                               groups=groups)

    with patched(lm_module, "moe_block", record):
        yield sets


def route_flips(sets_a, sets_b) -> list:
    """Per layer, the tokens whose top-k expert sets differ between two runs."""
    return [int((a != b).any(-1).sum()) for a, b in zip(sets_a, sets_b)]


def time_experts(cfg, params, slots: int, dev) -> dict:
    """The expert products (``moe.expert_ffn``: three ``torch.bmm`` and the
    SwiGLU) of every layer at ``slots`` capacity slots an expert, timed as
    CUDA-graph replays cycling over the layers' own weights (so they come
    from HBM, as in a forward), beside their bound: the weights and the
    (E, C, D) input and output moved once, 2 x 3 x E x C x D x F operations."""
    E, D, F_, L = cfg.n_experts, cfg.d_model, cfg.d_ff, cfg.n_layers
    gen = torch.Generator(dev).manual_seed(7)
    xe = torch.randn(E, slots, D, device=dev, generator=gen).to(cfg.torch_dtype)
    fns = [lambda p=p["moe"]: moe.expert_ffn(p, xe) for p in params["layers"]]
    ms, eager_ms = time_ms(fns, reps=5, min_iters=len(fns))
    nbytes = (3 * E * D * F_ + 2 * E * slots * D) * xe.element_size()
    bound_ms, bound_by = bound(nbytes, 2 * 3 * E * slots * D * F_, cfg.torch_dtype)
    return {"slots": slots, "layers": L, "ms_per_layer": ms, "eager_ms_per_layer": eager_ms,
            "ms": L * ms, "bound_ms_per_layer": bound_ms, "bound_ms": L * bound_ms,
            "bound_by": bound_by, "weight_bytes_per_layer": 3 * E * D * F_ * xe.element_size()}


def depth(cfg) -> dict:
    full = get_arch(cfg.name).n_layers
    return {"n_layers": cfg.n_layers, "of": full, "cut": cfg.n_layers < full}


def family_prefill(cfg, params, dev, seed) -> dict:
    """Kernel-path prefill of a dense, moe, vlm or audio model, held against
    the plain path in bf16 and in fp32 (with planted faults on the plain
    path in both), each layer's flash call against its plain version, and
    for MoE models the routing flips between the paths per layer and the
    expert products' time."""
    batch = prefill_batch(cfg, dev, seed)
    loss, counts, routes, wall = main_path_prefill(cfg, params, batch)
    faults = model_faults(cfg)
    is_moe = cfg.family == "moe"
    with recording_flash() as calls, recording_routes() as sets_k:
        logits_k, _ = logits_fn(params, batch, cfg)
    with recording_routes() as sets_p:
        logits_p, _ = logits_fn(params, batch, cfg, kernels=False)
    loss_p, _ = loss_fn(params, batch, cfg, kernels=False)
    out = {"depth": depth(cfg), "loss": float(loss), "loss_plain": float(loss_p),
           "loss_rel_diff": abs(float(loss) - float(loss_p)) / abs(float(loss_p)),
           "logits_rel_l2": rel_l2(logits_k, logits_p),
           "logits_row_rel_l2": row_rel_l2(logits_k, logits_p),
           "logits_max_abs_err": float((logits_k.float() - logits_p.float()).abs().max()),
           "logits_shape": list(logits_k.shape), "first_call_s": wall, "launches": counts,
           "launches_by_route": routes}
    if is_moe:
        out["route_flips_per_layer"] = route_flips(sets_k, sets_p)
        out["route_flips_tokens"] = sets_k[0].shape[0]
    del logits_k, sets_k, sets_p
    out["flash_per_layer"] = flash_per_layer(calls, cfg.n_layers)
    del calls
    # what bf16 rounding alone does over this depth: the plain path with its
    # products rounded once from fp32 sums, against the plain path
    with plain_matmuls_rounded_once():
        logits_r, _ = logits_fn(params, batch, cfg, kernels=False)
    out["plain_rounding_rel_l2"] = rel_l2(logits_r, logits_p)
    del logits_r
    out["planted_model_faults"] = planted_logits(cfg, params, batch, logits_p, faults)
    del logits_p
    free_memory()
    # the same weights and inputs in fp32: kernel path vs plain path, and the
    # planted faults there
    cfg32, params32 = dataclasses.replace(cfg, dtype="float32"), fp32_copy(params)
    with recording_routes() as sets_k:
        lk, _ = logits_fn(params32, batch, cfg32)
    with recording_routes() as sets_p:
        lp, _ = logits_fn(params32, batch, cfg32, kernels=False)
    out["fp32"] = {"logits_rel_l2": rel_l2(lk, lp), "logits_row_rel_l2": row_rel_l2(lk, lp)}
    if is_moe:
        out["fp32"]["route_flips_per_layer"] = route_flips(sets_k, sets_p)
    del lk, sets_k, sets_p
    out["fp32"]["planted_model_faults"] = planted_logits(cfg32, params32, batch, lp, faults)
    del lp, params32
    free_memory()
    out.update(loss_fn_ms(cfg, params, batch))
    if is_moe:
        out["expert_products"] = time_experts(
            cfg, params, moe.capacity(2048 * cfg.top_k, cfg.n_experts, cfg.capacity_factor), dev)
    bf16_limit, fp32_limit, fp32_only = FAMILY_LIMITS[cfg.name]
    check(out["fp32"]["logits_rel_l2"] <= fp32_limit,
          f"{cfg.name} fp32 prefill logits vs plain: {out}")
    for name, fault in out["fp32"]["planted_model_faults"].items():
        check(fault["logits_rel_l2"] > fp32_limit,
              f"{cfg.name}: the fp32 limit passes a planted fault ({name}): {out}")
    check(out["logits_rel_l2"] <= bf16_limit, f"{cfg.name} prefill logits vs plain: {out}")
    for name, fault in out["planted_model_faults"].items():
        check(name in fp32_only or fault["logits_rel_l2"] > bf16_limit,
              f"{cfg.name}: the bf16 limit passes a planted fault ({name}): {out}")
    check(out["loss_rel_diff"] <= MODEL_LOSS_REL, f"{cfg.name} prefill loss vs plain: {out}")
    return out


def family_serve(cfg, params, dev, seed) -> dict:
    """The serve of phase 5 for a full config, its first 4 decode steps held
    against the plain path in bf16 and fp32 (for MoE, a planted "capacity
    ignored" fault must fail the fp32 limit), and 4 steps profiled."""
    arch = cfg.name
    bf16_limit, fp32_limit, _ = FAMILY_LIMITS[arch]
    stats = main_path_serve(arch, cfg, params, dev, seed)
    free_memory()
    out = {**stats, "decode_vs_plain": {"bf16": decode_vs_plain(cfg, params, dev, bf16_limit)}}
    free_memory()
    cfg32, params32 = dataclasses.replace(cfg, dtype="float32"), fp32_copy(params)
    out["decode_vs_plain"]["fp32"] = decode_vs_plain(cfg32, params32, dev, fp32_limit)
    if cfg.family == "moe":
        planted = decode_pairs(cfg32, params32, dev, plain_fault=CAPACITY_IGNORED)
        out["decode_vs_plain"]["fp32_planted_capacity_ignored"] = planted
        check(max(s["logits_rel_l2"] for s in planted) > fp32_limit,
              f"{arch}: the fp32 decode limit passes a planted fault (capacity ignored): {out}")
    del params32
    free_memory()
    out["profile"] = phase_profile(cfg, params, dev, f"decode_trace_{arch}.json")
    if cfg.family == "moe":
        ex = time_experts(cfg, params, moe.capacity(8 * cfg.top_k, cfg.n_experts,
                                                   cfg.capacity_factor), dev)
        ex["share_of_device_busy"] = ex["ms"] / out["profile"]["device_busy_ms_per_step"]
        ex["share_of_wall"] = ex["ms"] / out["profile"]["wall_ms_per_step"]
        out["expert_products_decode"] = ex
    return out


def phase_prefill_dense_wide(cfgs, dev, seed) -> dict:
    """phi3-medium-14b and granite-20b, each at full width with its depth cut
    to 4; each model's weights freed before the next is made.  The phase's
    launches are the two prefills' together."""
    out = {}
    for cfg in cfgs:
        params = init_params(cfg, torch.Generator(dev).manual_seed(seed), dev)
        out[cfg.name] = family_prefill(cfg, params, dev, seed)
        del params
        free_memory()
    runs = list(out.values())
    out["launches"] = {n: sum(r["launches"][n] for r in runs) for n in KERNELS}
    out["launches_by_route"] = {n: {r: sum(x["launches_by_route"][n][r] for x in runs)
                                    for r in runs[0]["launches_by_route"][n]}
                                for n in runs[0]["launches_by_route"]}
    return out


# --- training ---------------------------------------------------------------
#
# train_tinyllama: B x S tokens a step from the data pipeline, the optimizer
# of launch.train (lr 1e-3, 10 warm-up steps); train_replay: 12 steps of the
# same model cut to 2 layers, failures at steps 7 and 9 (as
# tests/test_runtime.py:119-136); train_grads: 2 layers, B=2 x S=1024.
TRAIN_B, TRAIN_S, TRAIN_STEPS = 8, 1024, 6
TRAIN_OPT = AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=TRAIN_STEPS)
REPLAY_LAYERS, REPLAY_STEPS, REPLAY_EVERY, REPLAY_FAILURES = 2, 12, 5, {7: 1, 9: 1}
GRAD_LAYERS, GRAD_B = 2, 2
# kernel path against plain path, per gradient leaf, as a relative L2 (the
# largest over the leaves), per model and dtype.  In fp32 the paths differ
# by sum order only: on an H100 80GB HBM3 at 700 W sound reads were 3.9e-6
# (tinyllama) and 1.2e-4 (mamba2, at A_log, whose gradient sums the
# ssd_scan outputs' small bf16x3 rounding over every position), and the
# planted faults a zeroed dW 1.0, a non-causal flash recompute 0.91 and a
# dropped in_decay gradient 0.048: each fp32 limit sits >= 16x above its
# sound value and >= 24x under the weakest fault.  In bf16 the paths round
# at other points in every layer (sound 7.9e-3 and 1.03e-2): the limits
# there bound gross faults only.
TRAIN_GRAD_REL_L2 = {ARCH: {"float32": 1e-4, "bfloat16": 3e-2},
                     SSM_ARCH: {"float32": 2e-3, "bfloat16": 4e-2}}
# flash's backward (bf16 gradients) against SDPA's fp32 backward on the
# same bf16 inputs, at the train shape, per gradient as a relative L2: on an
# H100 80GB HBM3 at 700 W the plain recompute read 1.7e-3-2.4e-3 (the
# gradients' bf16 rounding, dk and dv summed over each group in bf16) and a
# non-causal recompute 0.88-0.91; the backward kernel also rounds P and dS
# once to bf16 before its products (2.4e-3 emulated on the CPU).  The train shape's
# matmul products (forward, dX, dW at M = 8192) are held to TOL's bf16 row
# at unit RMS: sound reads used <= 16 % of it, a planted tile >= 19x.
FLASH_GRAD_REL_L2 = 1e-2
# flash's fp32 backward kernel (CUDA cores) against flash_bwd_ref on the
# card, per gradient: fp32 sum order only
FLASH_BWD_F32_REL_L2 = 1e-5
# ssd_scan's backward kernel (fp32 FFMA) against ssd_chunk_bwd_ref run in
# float64, per gradient as a relative L2, at the inputs of the kernel
# checks' generator and of SSD_BWD_SEEDS more seeds.  On an H100 80GB HBM3
# at 700 W at mamba2-1.3b's train shape, over five inputs, dx, dB, dC read
# <= 2.0e-7 and ddt <= 3.2e-6 (the fp32 plain version's own <= 3.5e-6 and
# 2.6e-5).  dA sums a reverse cumsum whose terms cancel, so in fp32 it reads
# 4.3e-5-1.07e-4 (the fp32 plain version's own 4.4e-5-1.24e-4, 1.17x the
# kernel's at most): it has a limit of its own.  A dropped in_decay gradient
# reads 1.6e-3 on ddt and 2.1e-3 on dA, and must read above a limit.
SSD_BWD_REL_L2 = 1e-4
SSD_BWD_DA_REL_L2 = 3e-4
SSD_BWD_SEEDS = 4

real_matmul_vjp = mm_ops.matmul_vjp
real_flash_bwd = flash_ops.flash_bwd
real_ssd_bwd = ssd_ops.ssd_chunk_bwd


def _dw_zeroed(x, w, dy, needs):
    dx, dw = real_matmul_vjp(x, w, dy, needs)
    return dx, None if dw is None else torch.zeros_like(dw)


# planted faults in the kernels' backward: name -> (module, attribute, replacement)
GRAD_FAULTS = {
    "matmul_dw_zeroed": (mm_ops, "matmul_vjp", _dw_zeroed),
    "flash_not_causal": (flash_ops, "flash_bwd", lambda q, k, v, o, lse, do, causal:
                         real_flash_bwd(q, k, v, *flash_ops._attend(q, k, v, False, True), do,
                                        False)),
    "ssd_in_decay_dropped": (ssd_ops, "ssd_chunk_bwd", lambda ins, chunk, g: real_ssd_bwd(
        ins, chunk, (g[0], g[1], None, g[3]))),
}
ARCH_GRAD_FAULTS = {ARCH: ("matmul_dw_zeroed", "flash_not_causal"),
                    SSM_ARCH: ("matmul_dw_zeroed", "ssd_in_decay_dropped")}


def train_step_launches(cfg) -> dict:
    """Kernel launches of one train step's gradient: the forward, the
    blocks' recompute under remat (every launch but the head's product) and
    two backward products for each forward product."""
    fwd = forward_launches(cfg)
    again = 1 if cfg.remat != "none" else 0
    mm = fwd["ltrf_matmul"]
    return {"ltrf_matmul": mm + again * (mm - 1) + 2 * mm,
            "flash_attention": (1 + again) * fwd["flash_attention"],
            "ssd_scan": (1 + again) * fwd["ssd_scan"]}


def train_step_layouts(cfg, steps: int) -> dict:
    """``ltrf_matmul``'s launches of ``steps`` train steps by layout: the
    forward and the recompute in nn, one nt (dX) and one tn (dW) for each
    forward product."""
    mm = forward_launches(cfg)["ltrf_matmul"]
    return {"nn": steps * (train_step_launches(cfg)["ltrf_matmul"] - 2 * mm),
            "nt": steps * mm, "tn": steps * mm}


def eager_ms(fn, reps: int = 3) -> float:
    """Median device ms of ``fn`` launched from Python, between CUDA events
    (for calls too large or too dynamic to capture in a graph)."""
    fn()
    samples = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end))
    return statistics.median(samples)


def named_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from named_leaves(v, f"{prefix}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from named_leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def compare_train_product(got, want) -> dict:
    """One product of the train step against its plain version: the bf16
    row of TOL with both sides divided by the plain output's RMS (TOL's
    limits are for outputs of about unit size; the train products' are not:
    dX is ~1/sqrt(K), the head's dW ~sqrt(M/N))."""
    got, want = got.float(), want.float()
    rms = float(want.square().mean().sqrt().clamp_min(1e-30))
    err = (got - want).abs()
    limit = TOL[torch.bfloat16]["atol"] * rms + TOL[torch.bfloat16]["rtol"] * want.abs()
    return {"max_abs_err": float(err.max()), "rms": rms, "rel_l2": rel_l2(got, want),
            "max_excess": float((err / limit).max()), "within_tol": bool((err <= limit).all())}


def planted_tile(t, transpose: bool):
    """The planted matmul faults: one 128 x 128 output tile zeroed, or
    transposed (a tile written from the wrong operand layout)."""
    t, n = t.clone(), min(128, *t.shape)
    tile = t[:n, :n]
    tile.copy_(tile.t().clone() if transpose else torch.zeros_like(tile))
    return t


def backward_plan(M, K, N) -> dict:
    """The kernel's plan of ``matmul_vjp``'s two products for x (M, K) and
    w (K, N): each product's (M', K', N'), layout, tile width, K split and
    output tiles."""
    out = {}
    for name, (m, k, n, layout) in (("dX", (M, N, K, "nt")), ("dW", (K, M, N, "tn"))):
        bm, _, bn, stages = mm_ops.pick_blocks(m, k, n, 2, layout)
        tiles = -(-m // bm) * -(-n // bn)
        split = mm_ops.split_k(m, k, n, 2, layout)
        out[name] = {"gemm": [m, k, n], "layout": layout, "bn": bn, "stages": stages,
                     "split": split, "tiles": tiles, "ctas": min(tiles * split, mm_ops.NUM_SMS)}
    return out


def copied_vjp(x, w, dy):
    """The parent design of ``matmul_vjp``, timed beside it: each transpose
    copied, both products in the forward's layout."""
    return mm_ops._product(dy, w.t().contiguous()), mm_ops._product(x.t().contiguous(), dy)


def check_train_matmuls(cfg, dev) -> dict:
    """Every ``ltrf_matmul`` product of one train step at its shape, M = B x S
    rows: the forward x @ w and ``matmul_vjp``'s dX = dY w^T (layout nt) and
    dW = x^T dY (layout tn), each held against ``matmul_ref`` on the same
    inputs (a planted zeroed or transposed tile must fail each check) and
    launched twice for the same bits; then ``matmul_vjp`` (its operands read
    in place) timed against the same two products in cuBLAS, against the
    parent design (``copied_vjp``) and against their bound, summed over a
    step's launches, each product also alone with its layout, split and
    tiles; and the forward product, kernel and cuBLAS, the same way."""
    M, gen = TRAIN_B * TRAIN_S, torch.Generator(dev).manual_seed(11)
    per_shape, tot = [], {"ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0, "copied_ms": 0.0,
                          "dX_ms": 0.0, "dW_ms": 0.0, "launches": 0,
                          "forward_ms": 0.0, "forward_library_ms": 0.0, "forward_bound_ms": 0.0}
    for (K, N), n in slice_matmuls(cfg):
        x = torch.randn(M, K, device=dev, generator=gen).bfloat16()
        w = (torch.randn(K, N, device=dev, generator=gen) / math.sqrt(K)).bfloat16()
        dy = (torch.randn(M, N, device=dev, generator=gen) / math.sqrt(N)).bfloat16()
        dx, dw = mm_ops.matmul_vjp(x, w, dy, (True, True))
        again = mm_ops.matmul_vjp(x, w, dy, (True, True))
        fwd = ltrf_matmul(x, w)
        products = {"forward": (fwd, lambda: matmul_ref(x, w), False),
                    "dX": (dx, lambda: matmul_ref(dy, w.t()), True),
                    "dW": (dw, lambda: matmul_ref(x.t(), dy), False)}
        rec = {"K": K, "N": N, "per_step": n, **backward_plan(M, K, N),
               "forward_schedule": forward_schedule(M, K, N),
               "same_bits_twice": bool(torch.equal(dx, again[0]) and torch.equal(dw, again[1])),
               "forward_same_bits_twice": bool(torch.equal(fwd, ltrf_matmul(x, w)))}
        check(rec["same_bits_twice"], f"train matmul backward at K={K}, N={N}: two launches differ")
        check(rec["forward_same_bits_twice"], f"train matmul forward at K={K}, N={N}: "
                                              "two launches differ")
        del again
        for name, (got, plain, transpose) in products.items():
            want = plain()
            fault = "tile_transposed" if transpose else "tile_zeroed"
            rec.setdefault(name, {}).update({
                **compare_train_product(got, want),
                fault: compare_train_product(planted_tile(got, transpose), want)})
            check(rec[name]["within_tol"],
                  f"train matmul {name} at M={M}, K={K}, N={N} disagrees with plain: {rec}")
            check(not rec[name][fault]["within_tol"],
                  f"train matmul {name} check at K={K}, N={N} passes a planted {fault}")
            del want
        del dx, dw, fwd, products
        ms, _ = time_ms([lambda: mm_ops.matmul_vjp(x, w, dy, (True, True))], min_iters=5)
        lib, _ = time_ms([lambda: (torch.matmul(dy, w.t()), torch.matmul(x.t(), dy))],
                         min_iters=5)
        copied, _ = time_ms([lambda: copied_vjp(x, w, dy)], min_iters=5)
        rec["dX"]["ms"], _ = time_ms([lambda: mm_ops._product(dy, w, "nt")], min_iters=5)
        rec["dW"]["ms"], _ = time_ms([lambda: mm_ops._product(x, dy, "tn")], min_iters=5)
        fwd, _ = time_ms([lambda: ltrf_matmul(x, w)], min_iters=5)
        fwd_lib, _ = time_ms([lambda: torch.matmul(x, w)], min_iters=5)
        b, by = bound(2 * (2 * M * K + 2 * K * N + 2 * M * N), 4 * M * K * N, torch.bfloat16)
        rec.update({"ms": ms, "library_ms": lib, "copied_ms": copied, "bound_ms": b,
                    "bound_by": by, "forward_ms": fwd, "forward_library_ms": fwd_lib})
        emit({"check": "ltrf_matmul_train", "M": M, **rec})
        per_shape.append(rec)
        tot["ms"] += n * ms
        tot["library_ms"] += n * lib
        tot["copied_ms"] += n * copied
        tot["dX_ms"] += n * rec["dX"]["ms"]
        tot["dW_ms"] += n * rec["dW"]["ms"]
        tot["bound_ms"] += n * b
        tot["launches"] += 2 * n
        # the forward x @ w of a step's launches at this shape
        tot["forward_ms"] += n * fwd
        tot["forward_library_ms"] += n * fwd_lib
        tot["forward_bound_ms"] += n * bound(2 * (M * K + K * N + M * N), 2 * M * K * N,
                                             torch.bfloat16)[0]
        del x, w, dy
    free_memory()
    return {**tot, "unit": f"the backward products of one {cfg.name} train step, "
                           f"M = {M}, bf16 (copied_ms: the parent design, transposes "
                           "copied)", "shapes": per_shape}


def check_train_flash(cfg, dev) -> dict:
    """flash_attention's forward at one layer's train shape, as
    ``FlashAttentionFn`` runs it (P split): the kernel held against
    attention_ref (a zeroed KV tile must fail), its output's bits unchanged
    by writing the LSE, and its time.  The backward kernel at this shape is
    held and timed by ``check_flash_bwd`` (its first case)."""
    gen = torch.Generator(dev).manual_seed(12)
    B, H, KV, S, d = TRAIN_B, cfg.n_heads, cfg.n_kv_heads, TRAIN_S, cfg.hd
    q, k, v, o, lse, do = flash_bwd_inputs(B, H, KV, S, d, True, torch.bfloat16, dev, gen)
    want = attention_ref(q, k, v)
    def train_forward(with_lse):
        return flash_ops._attend(q, k, v, True, with_lse, split_p=True)[0]

    rec = {"forward": {**compare_flash(o, want),
                       "planted_fault": compare_flash(
                           attention_ref(q, *zero_kv_tile(k, v, 2)), want)},
           "lse_leaves_the_output_bits": bool(torch.equal(o, train_forward(False)))}
    del want
    free_memory()
    emit({"check": "flash_attention_train", **rec})
    check(rec["forward"]["within_tol"], f"flash at the train shape disagrees with plain: {rec}")
    check(not rec["forward"]["planted_fault"]["within_tol"],
          f"flash check at the train shape passes a zeroed KV tile: {rec}")
    check(rec["lse_leaves_the_output_bits"], "flash: writing the LSE changed the output")
    fwd = eager_ms(lambda: train_forward(True))
    lib_fwd = eager_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                              enable_gqa=True))
    # the forward's bound from the shapes: its two products over the causal
    # (q, k) pairs
    pairs = B * H * S * (S + 1) / 2
    fwd_bound = bound((2 * q.numel() + k.numel() + v.numel()) * 2, 4 * d * pairs,
                      torch.bfloat16)
    del q, k, v, o, lse, do
    free_memory()
    return {"unit": f"one layer at B={B}, H={H}, KV={KV}, S={S}, d={d}, bf16, causal",
            **rec, "kernel_forward_ms": fwd, "library_forward_ms": lib_fwd,
            "library_forward": "scaled_dot_product_attention forward, bf16, eager",
            "bound_ms": fwd_bound[0],
            "bound_by": fwd_bound[1], "layers_per_step": cfg.n_layers}


def phase_train_tinyllama(cfg, dev, seed) -> dict:
    state = make_train_state(cfg, torch.Generator(dev).manual_seed(seed), dev)
    step = build_train_step(cfg, TRAIN_OPT)
    shape = ShapeConfig("chip_train", TRAIN_S, TRAIN_B, "train")
    batches = [batch_for_step(cfg, shape, s, seed + 1) for s in range(TRAIN_STEPS)]
    evaluate = build_eval_step(cfg)
    loss_before = float(evaluate(state["params"], batches[0])["loss"])
    state_bytes = {"params": nbytes(state["params"]), "grads": nbytes(state["params"]),
                   "mu": nbytes(state["opt"]["mu"]), "nu": nbytes(state["opt"]["nu"])}
    free_memory()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    walls, metrics = [], []
    for b in batches:
        t0 = time.perf_counter()
        state, m = step(state, b)
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
        metrics.append({k: float(v) for k, v in m.items()})
    counts, routes = read_counts(), read_routes()     # the main path's launches
    backward = read_backward()
    peak = torch.cuda.max_memory_allocated()
    want = {k: TRAIN_STEPS * v for k, v in train_step_launches(cfg).items()}
    loss_after = float(evaluate(state["params"], batches[0])["loss"])
    step_ms = statistics.median(walls[1:])
    tokens = TRAIN_B * TRAIN_S
    out = {"steps": TRAIN_STEPS, "batch": TRAIN_B, "seq": TRAIN_S, "remat": cfg.remat,
           "dtype": cfg.dtype, "params": cfg.param_count(), "step_ms": walls,
           "median_step_ms": step_ms, "first_step_ms": walls[0],
           "tokens_per_s": tokens / (step_ms / 1e3),
           "model_flops_share": 6 * cfg.param_count() * tokens / (step_ms / 1e3)
           / PEAK_FLOPS[torch.bfloat16],
           "losses": [m["loss"] for m in metrics], "grad_norms": [m["grad_norm"] for m in metrics],
           "lrs": [m["lr"] for m in metrics], "loss_first_batch_before": loss_before,
           "loss_first_batch_after": loss_after, "launches": counts, "launches_by_route": routes,
           "backward_launches": backward,
           "launches_per_step": train_step_launches(cfg), "state_gb":
           {k: v / 1e9 for k, v in state_bytes.items()},
           "peak_memory_gb": peak / 1e9,
           "activations_gb": (peak - sum(state_bytes.values())) / 1e9}
    # one more step under the profiler: the device-busy share
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, _ = step(state, batches[0])
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    by_name, n_spans = device_spans(prof)        # a step's trace is too large to keep
    busy = sum(by_name.values()) / 1e3
    out["profile"] = {"wall_ms": wall, "device_busy_ms": busy, "device_busy_share": busy / wall,
                      "device_ops": n_spans, "top_kernels_ms": [
                          (n[:100], d / 1e3) for n, d in sorted(by_name.items(),
                                                                 key=lambda kv: -kv[1])[:20]]}
    # two steps from the same state and batch, deterministic algorithms on
    torch.use_deterministic_algorithms(True)
    try:
        twin = tree_map(torch.clone, state)
        a, _ = step(twin, batches[1])
        b, _ = step(state, batches[1])
        out["same_bits_twice"] = all(torch.equal(x, y)
                                     for x, y in zip(tree_leaves(a), tree_leaves(b)))
    finally:
        torch.use_deterministic_algorithms(False)
    del state, twin, a, b
    free_memory()
    out["matmul_backward"] = check_train_matmuls(cfg, dev)
    out["flash_train_shape"] = check_train_flash(cfg, dev)
    check(counts == want, f"train launches {counts}, want {want}")
    for name in routes:
        check(routes[name]["wgmma"] == counts[name],
              f"train {name} routes {routes[name]}: every launch on wgmma")
    check(backward["flash_attention"] == TRAIN_STEPS * cfg.n_layers
          == backward["flash_attention_by_route"]["wgmma"],
          f"train flash backward launches {backward}: one a layer and step, on wgmma")
    check(backward["ltrf_matmul_by_layout"] == train_step_layouts(cfg, TRAIN_STEPS),
          f"train matmul launches by layout {backward['ltrf_matmul_by_layout']}, want "
          f"{train_step_layouts(cfg, TRAIN_STEPS)}: one nt and one tn a forward product")
    check(all(math.isfinite(x) for x in out["losses"] + out["grad_norms"]),
          f"train losses or grad norms not finite: {out}")
    check(loss_after < loss_before, f"the first batch's loss did not fall: {out}")
    check(out["same_bits_twice"], "two train steps from one state differ")
    return out


def phase_train_replay(dev, seed) -> dict:
    """``train`` twice from one seed, the second with failures injected:
    bit-identical final parameters (deterministic algorithms on)."""
    kw = dict(smoke=False, steps=REPLAY_STEPS, batch=TRAIN_B, seq=TRAIN_S,
              ckpt_every=REPLAY_EVERY, seed=seed, device=dev, layers=REPLAY_LAYERS)
    torch.use_deterministic_algorithms(True)
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_ckpt_"))
    try:
        reset_counts()
        a = train(ARCH, ckpt_dir=str(tmp / "a"), **kw)
        ckpt_bytes = sum(f.stat().st_size for f in (tmp / "a" / f"step_{REPLAY_STEPS:09d}")
                         .iterdir())
        shutil.rmtree(tmp / "a")
        b = train(ARCH, ckpt_dir=str(tmp / "b"), inject_failures=REPLAY_FAILURES, **kw)
        counts, routes, backward = read_counts(), read_routes(), read_backward()
    finally:
        torch.use_deterministic_algorithms(False)
        shutil.rmtree(tmp, ignore_errors=True)
    same = all(torch.equal(x, y) for x, y in zip(tree_leaves(a["state"]["params"]),
                                                 tree_leaves(b["state"]["params"])))
    out = {"layers": REPLAY_LAYERS, "steps": REPLAY_STEPS, "ckpt_every": REPLAY_EVERY,
           "inject_failures": {str(k): v for k, v in REPLAY_FAILURES.items()},
           "restarts": b["restarts"], "final_step": [a["final_step"], b["final_step"]],
           "bit_identical_params": same, "checkpoint_gb": ckpt_bytes / 1e9,
           "uninterrupted": {"wall_s": a["wall_s"], "ckpt": a["ckpt_timings"],
                             "losses": a["losses"]},
           "with_failures": {"wall_s": b["wall_s"], "ckpt": b["ckpt_timings"],
                             "losses": b["losses"]},
           "launches": counts, "launches_by_route": routes, "backward_launches": backward}
    del a, b
    free_memory()
    check(out["restarts"] == len(REPLAY_FAILURES), f"replay restarts: {out}")
    check(out["final_step"] == [REPLAY_STEPS] * 2, f"replay steps: {out}")
    check(same, f"replayed training gave other parameters: {out}")
    check(backward["flash_attention"] > 0, f"replay: no flash backward launch: {backward}")
    for name in routes:
        check(routes[name]["wgmma"] == counts[name],
              f"replay {name} routes {routes[name]}: every launch on wgmma")
    return out


def grad_rel_l2(gk, gp) -> dict:
    return {n: rel_l2(a, b) for (n, a), (_, b) in zip(named_leaves(gk), named_leaves(gp))}


def grads_vs_plain(cfg, params, batch, faults) -> dict:
    reset_counts()
    lk, _, gk = grads_of(cfg, params, batch)
    backward = read_backward()
    lp, _, gp = grads_of(cfg, params, batch, kernels=False)
    errs = grad_rel_l2(gk, gp)
    del gk
    worst = sorted(errs.items(), key=lambda kv: -kv[1])
    out = {"loss": float(lk), "loss_plain": float(lp), "max_rel_l2": worst[0][1],
           "worst_leaves": worst[:5], "leaves": len(errs), "backward_launches": backward}
    planted = {}
    for name in faults:
        with patched(*GRAD_FAULTS[name]):
            _, _, gf = grads_of(cfg, params, batch)
        planted[name] = max(grad_rel_l2(gf, gp).values())
        del gf
    if planted:
        out["planted_faults"] = planted
    del gp
    free_memory()
    return out


def time_ssd_backward(cfg, dev) -> dict:
    """ssd_scan's backward kernel (``ssd_chunk_bwd``) at one layer's shape in
    train_grads, beside the kernel forward."""
    H = cfg.ssm_expand * cfg.d_model // cfg.ssm_headdim
    gen = torch.Generator(dev).manual_seed(13)
    ins = ssd_inputs(GRAD_B, TRAIN_S, H, cfg.ssm_headdim, cfg.ssm_state, dev, gen)
    outs = ssd_chunk(*ins, cfg.ssm_chunk)
    grads = tuple(torch.randn_like(o) for o in outs)
    bwd = eager_ms(lambda: ssd_ops.ssd_chunk_bwd(ins, cfg.ssm_chunk, grads))
    fwd = eager_ms(lambda: ssd_chunk(*ins, cfg.ssm_chunk))
    del ins, outs, grads
    free_memory()
    shape = (GRAD_B, TRAIN_S, H, cfg.ssm_headdim, cfg.ssm_state, cfg.ssm_chunk)
    fwd_bound, bwd_bound = ssd_bound(*shape), ssd_bwd_bound(*shape)
    return {"unit": (f"one layer at B={GRAD_B}, S={TRAIN_S}, H={H}, P={cfg.ssm_headdim}, "
                     f"N={cfg.ssm_state}, Q={cfg.ssm_chunk}, fp32"),
            "backward_ms": bwd, "kernel_forward_ms": fwd,
            "bound_ms": fwd_bound[0], "bound_by": fwd_bound[1],
            "backward_bound_ms": bwd_bound[0], "backward_bound_by": bwd_bound[1],
            "backward_bound_tc_ms": ssd_bwd_bound_tc(*shape)}


def phase_train_grads(dev, seed) -> dict:
    out = {}
    shape = ShapeConfig("chip_grads", TRAIN_S, GRAD_B, "train")
    for arch in (ARCH, SSM_ARCH):
        cfg = dataclasses.replace(get_arch(arch), n_layers=GRAD_LAYERS)
        params = init_params(cfg, torch.Generator(dev).manual_seed(seed), dev)
        batch = to_device(batch_for_step(cfg, shape, 0, seed + 1), dev)
        rec = {"depth": depth(cfg), "batch": GRAD_B, "seq": TRAIN_S, "remat": cfg.remat}
        rec["bfloat16"] = grads_vs_plain(cfg, params, batch, ())
        cfg32, params32 = dataclasses.replace(cfg, dtype="float32"), fp32_copy(params)
        del params
        free_memory()
        rec["float32"] = grads_vs_plain(cfg32, params32, batch, ARCH_GRAD_FAULTS[arch])
        del params32
        free_memory()
        out[arch] = rec
    out["ssd_backward"] = time_ssd_backward(get_arch(SSM_ARCH), dev)
    # the sound kernel-path gradients' backward launches, one a layer
    runs = [out[a][dt]["backward_launches"] for a in (ARCH, SSM_ARCH)
            for dt in ("bfloat16", "float32")]
    out["backward_launches"] = {
        "flash_attention": sum(r["flash_attention"] for r in runs),
        "ssd_scan": sum(r["ssd_scan"] for r in runs),
        "flash_attention_by_route": {k: sum(r["flash_attention_by_route"][k] for r in runs)
                                     for k in flash_ops.BWD_ROUTES.values()},
        "ltrf_matmul_by_layout": {k: sum(r["ltrf_matmul_by_layout"][k] for r in runs)
                                  for k in mm_ops.LAYOUTS}}
    for arch, name in ((ARCH, "flash_attention"), (SSM_ARCH, "ssd_scan")):
        for dt in ("bfloat16", "float32"):
            got = out[arch][dt]["backward_launches"][name]
            check(got == GRAD_LAYERS, f"{arch} {dt} gradients: {got} {name} backward launches")
    for arch, limits in TRAIN_GRAD_REL_L2.items():
        out[arch]["limits"] = limits
        for dtype, limit in limits.items():
            check(out[arch][dtype]["max_rel_l2"] <= limit,
                  f"{arch} {dtype} gradients, kernel vs plain path: {out[arch][dtype]}")
        for name, err in out[arch]["float32"]["planted_faults"].items():
            check(err > limits["float32"],
                  f"{arch}: the fp32 gradient limit passes a planted fault ({name}): {err}")
    return out


# ------------------------------------------------------------ the simulator

SIM_DESIGNS = ("BL", "RFC", "SHRF", "LTRF", "LTRF_conf", "LTRF_plus", "Ideal")
SIM_TABLE2 = (6, 7)
SIM_SCALAR_WORKERS = 6             # host processes for the scalar engine
SIM_NARROW_LANES = 8               # the reference's lanes per launch (XLA on the CPU)
# the 8-lane comparison: all 7 designs at Table-2 #7 on the 4 workloads of
# the sweep with the fewest ticks, so that it fits the phase's time
SIM_NARROW_WORKLOADS = ("pathfinder", "bfs", "btree", "kmeans")


def sim_sweep_jobs(table2_configs=SIM_TABLE2, names=None) -> list:
    """``benchmarks/sweep_subset.py::sweep_jobs`` (:116-126) rebuilt from the
    port: the workloads (the 14 of the default suite unless ``names`` gives a
    suite's) x (the §6 baseline + 7 designs) x Table-2 configs, the unique
    (workload, config) pairs in order."""
    jobs, seen = [], set()
    for tc in table2_configs:
        for name in names or sim_workload_names():
            for cfg in [baseline_config()] + [design_config(d, table2_config=tc)
                                              for d in SIM_DESIGNS]:
                if (name, cfg) not in seen:
                    seen.add((name, cfg))
                    jobs.append((name, cfg))
    return jobs


def sim_workload(name: str):
    """A workload of the suite, or the paper's Listing 1 (the planted fault's:
    its pins are tests/test_sim_golden.py's)."""
    if name == "listing1":
        return Workload(name="listing1", program=listing1_program(), trips={"L1": 100},
                        register_sensitive=False, regs_per_thread=8, suite="paper")
    return get_workload(name)


def sim_scalar(job):
    """The port's scalar event engine on one job (a host worker's task):
    the result as a dict and its seconds on one core."""
    name, cfg = job
    if name in TRACED_NAMES:           # a traced workload's lift is timed apart
        sim_workload(name)
    t0 = time.perf_counter()
    res = sim_engine.simulate(sim_workload(name), cfg)
    return dataclasses.asdict(res), time.perf_counter() - t0


def sim_chunks(jobs, sub_lanes) -> list:
    lanes = []
    for name, cfg in jobs:
        w = sim_workload(name)
        lanes.append(sim_batch._Lane(w, cfg, sim_batch._encode_plan(w, cfg),
                                     sim_batch._occupancy(w, cfg)))
    return [c for c, _ in sim_batch._chunk_lanes(lanes, list(range(len(lanes))), sub_lanes)]


def sim_card_run(jobs, sub_lanes) -> dict:
    """``run_batch`` on the card with ``sub_lanes`` lanes per launch at most:
    results, wall seconds and the run's counters."""
    lanes_per_launch = [len(c) for c in sim_chunks(jobs, sub_lanes)]
    with patched(sim_batch, "_SUB_LANES", {**sim_batch._SUB_LANES, "cuda": sub_lanes}):
        sim_batch.reset_run_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = sim_run_batch([(sim_workload(n), c) for n, c in jobs], fallback=False,
                            device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    stats = {**sim_batch.RUN_STATS, **sim_batch.BLOCK_STATS}
    check(stats["compiles"] == 0 and stats["replays"] == 0,
          f"run_batch on the card captured {stats['compiles']} graphs; the kernel needs none")
    instr = sum(r.instructions for r in res)
    return {"results": [dataclasses.asdict(r) for r in res], "jobs": len(jobs),
            "lanes_per_launch": lanes_per_launch, "launches": stats["launches"],
            "ticks": stats["ticks"], "graph_captures": stats["compiles"],
            "capture_s": stats["compile_s"], "blocks": stats["blocks"],
            "eager_blocks": stats["eager_blocks"], "replays": stats["replays"],
            "reruns": stats["reruns"], "wall_s": wall, "sim_instructions": instr,
            "sim_instr_per_s": instr / wall}


def sim_tick_times(lanes, blocks: int = 10) -> dict:
    """ms a tick of one chunk alone, its blocks run eagerly and then replayed
    from its graph (each after its first, exact block), and the device-busy
    share of graph blocks (kernel time over the window's wall, profiler)."""
    co, st = sim_batch._build(lanes)
    run = sim_batch._Chunk(co, st, torch.device("cuda"))
    run.launch()
    run.settle()
    T = run.block

    def timed(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            run.launch()
            run.settle()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / (n * T)

    run.graphs = False
    eager = timed(3)
    run.graphs = True
    run.launch()                     # the capture, then its first replay
    run.settle()
    graph = timed(blocks)
    # a block's device time (CUDA events on the chunk's stream) and the host
    # time of its launch, medians of 5
    dev_ms, launch_ms = [], []
    for _ in range(5):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        with torch.cuda.stream(run.stream):
            e0.record()
            t0 = time.perf_counter()
            run.launch()
            launch_ms.append((time.perf_counter() - t0) * 1e3)
            e1.record()
        run.settle()
        dev_ms.append(e0.elapsed_time(e1))
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(3):
            run.launch()
            run.settle()
        torch.cuda.synchronize()
        window_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    top = {}
    for e in kernels:
        top[e.name] = top.get(e.name, 0.0) + e.time_range.elapsed_us() / (3 * T)
    return {"lanes": len(lanes), "K": run.dims[0], "W": run.dims[1], "A": run.dims[3],
            "E": run.dims[4], "ticks_a_block": T, "eager_ms_per_tick": eager,
            "graph_ms_per_tick": graph, "device_ms_per_tick": statistics.median(dev_ms) / T,
            "launch_ms_per_block": statistics.median(launch_ms),
            "kernels_per_tick": len(kernels) / (3 * T),
            "device_busy_share": busy_us / window_us, "busy_us_per_tick": busy_us / (3 * T),
            "top_device_us_per_tick": dict(sorted(top.items(), key=lambda kv: -kv[1])[:8]),
            "reruns": run.stats["reruns"]}


def sim_chunk_line(lanes, state, stats) -> dict:
    """One chunk's kernel run: lanes, ticks (its longest lane's), launches,
    the launch's time on the card and the kernel's µs a tick; its route and
    a lane's image in shared memory, and two values derived, not measured:
    the CTAs (lanes) an SM holds (the CUDA occupancy calculator's) and the
    waves its CTAs would take alone on the card."""
    ticks = int(state["guard"])
    ms = stats.get("kernel_ms")
    line = {"lanes": len(lanes), "ticks": ticks, "launches": stats["blocks"],
            "graph_captures": stats["captures"], "kernel_ms": ms,
            "us_per_tick": None if ms is None or not ticks else 1e3 * ms / ticks}
    route, nbytes = stats.get("route"), stats.get("image_bytes")
    if route is not None:
        K = sim_batch._bucket(len(lanes), 2)
        line.update(route=route, image_bytes=nbytes,
                    ctas_per_sm=sim_ops.ctas_per_sm(route, nbytes),
                    waves=sim_ops.waves(route, nbytes, K))
    return line


def sim_kernel_tick(lanes) -> dict:
    """One chunk run alone by the kernel: its launch's time, ticks, µs a
    tick, and its bound: the planes read once and the state written once
    over the launch (bytes; a chain of dependent ticks has no useful
    roofline)."""
    co, st = sim_batch._build(lanes)
    run = sim_batch._KernelChunk(co, st, torch.device("cuda"))
    run.launch()
    run.settle()
    line = sim_chunk_line(lanes, {"guard": run.s["guard"].item()}, run.stats)
    nbytes = (sum(t.numel() * t.element_size() for t in run.co.values())
              + 2 * sum(t.numel() * t.element_size() for t in run.s.values()))
    return {**line, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "plane_bytes": nbytes}


def sim_kernel_vs_plain(jobs, sub_lanes) -> dict:
    """The kernel's final state against the plain tick's on the card, chunk
    by chunk and plane by plane, bit for bit (``sub_lanes`` lanes a chunk):
    planes that differ, the largest absolute difference, both walls."""
    chunks = sim_chunks(jobs, sub_lanes)
    cuda = torch.device("cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    kernel = sim_batch._run_chunks(chunks, cuda)
    kernel_wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    plain = sim_batch._run_chunks(chunks, cuda, engine="plain")
    plain_wall = time.perf_counter() - t0
    differ, max_abs = [], 0.0
    for i, ((got, _), (want, _)) in enumerate(zip(kernel, plain)):
        check(sorted(got) == sorted(want), f"sim_batch: chunk {i}'s kernel state has keys "
                                           f"{sorted(got)}, the plain tick's {sorted(want)}")
        for key in want:
            a, b = got[key], want[key]
            if a.dtype != b.dtype or a.shape != b.shape:
                differ.append(f"chunk {i} {key}: {a.dtype}{a.shape} vs {b.dtype}{b.shape}")
                continue
            if not np.array_equal(a, b):
                differ.append(f"chunk {i} {key}")
            if a.size:
                max_abs = max(max_abs, float(np.abs(a.astype(np.float64)
                                                    - b.astype(np.float64)).max()))
    check(not differ, f"sim_batch: the kernel's final state differs from the plain tick's "
                      f"on the card: {differ[:8]}")
    return {"chunks": len(chunks), "lanes": [len(c) for c in chunks],
            "ticks": [int(st["guard"]) for st, _ in kernel], "planes": len(plain[0][0]),
            "differ": differ, "max_abs_err": max_abs, "kernel_wall_s": kernel_wall,
            "plain_wall_s": plain_wall,
            "kernel_ms": [stats["kernel_ms"] for _, stats in kernel]}


def sim_mismatches(card: list, scalar: list) -> list:
    return [i for i, (a, b) in enumerate(zip(card, scalar)) if a != b]


SIM_GPU_SCHEDULERS = ("two_level", "gto", "lrr")


def sim_gpu_sweep_jobs(num_sms: int = 2, warps_per_sm: int = 16,
                       workloads=("srad", "bfs"), designs=("BL", "LTRF")) -> list:
    """``benchmarks/sweep_subset.py::gpu_sweep_jobs`` (:66-79) rebuilt from the
    port: whole-GPU configs at Table-2 #7, one per (workload, design,
    scheduler)."""
    return [(name, design_config(d, table2_config=7, num_warps=warps_per_sm * num_sms,
                                 num_sms=num_sms, scheduler=s))
            for name in workloads for d in designs for s in SIM_GPU_SCHEDULERS]


def sim_screening_jobs(workloads=None, schedulers=("two_level", "gto")) -> list:
    """``benchmarks/sweep_subset.py::screening_jobs`` (:129-152) rebuilt from
    the port: the designs x workloads x tolerated latency x RF size x
    scheduler grid of the analytic tier, unique points in order."""
    names = list(workloads) if workloads else sim_workload_names()
    return list(dict.fromkeys(
        (name, design_config(d, table2_config=7, rf_size_kb=kb, mrf_latency_mult=float(m),
                             scheduler=s))
        for kb in (256, 2048) for name in names for d in SIM_DESIGNS
        for m in TOLERANCE_MULTS for s in schedulers))


def sim_scalar_gpu(job) -> dict:
    """The port's whole-GPU model over its scalar engine (a host worker's
    task)."""
    name, cfg = job
    return dataclasses.asdict(simulate_gpu(sim_workload(name), cfg))


def sim_routes_since(mark: dict) -> dict:
    """The ``sim_batch`` kernel's launches on each image route since
    ``mark`` (an earlier ``dict(sim_ops.sim_batch.launches_by_route)``)."""
    return {r: n - mark.get(r, 0) for r, n in sim_ops.sim_batch.launches_by_route.items()}


def sim_routes_sum(parts) -> dict:
    """Launches by route summed over ``parts`` (dicts route -> launches)."""
    out = dict.fromkeys(sim_ops.ROUTES, 0)
    for part in parts:
        for r, n in part.items():
            out[r] += n
    return out


@contextlib.contextmanager
def engine_calls():
    """Record each lockstep run of the batch engine (``_run_chunks``, once a
    ``run_batch`` call, after its lanes are encoded) made on the thread that
    entered this: its jobs, wall seconds, chunks (launches) with their lanes
    and ticks (the longest lane's, as the reference's ``guard`` counts
    them), the kernel's launches (and by route), and ticks summed.  Another
    thread's recorder may nest inside."""
    calls, owner = [], threading.get_ident()
    inner = sim_batch._run_chunks

    def timed(lane_chunks, device, **opts):
        t0 = time.perf_counter()
        launched = sim_ops.sim_batch.launches
        mark = dict(sim_ops.sim_batch.launches_by_route)
        out = inner(lane_chunks, device, **opts)
        if threading.get_ident() != owner:
            return out
        chunks = [sim_chunk_line(c, state, stats) for c, (state, stats) in zip(lane_chunks, out)]
        kernel_launches = sim_ops.sim_batch.launches - launched
        check(kernel_launches == len(chunks) and not any(c["graph_captures"] for c in chunks),
              f"batch engine on the card: {kernel_launches} kernel launches and "
              f"{sum(c['graph_captures'] for c in chunks)} graph captures for {len(chunks)} "
              "chunks; one launch a chunk and no graph expected")
        calls.append({"jobs": sum(c["lanes"] for c in chunks), "device": str(device),
                      "wall_s": time.perf_counter() - t0, "launches": len(chunks),
                      "kernel_launches": kernel_launches,
                      "kernel_launches_by_route": sim_routes_since(mark),
                      "ticks": sum(c["ticks"] for c in chunks), "chunks": chunks})
        return out

    with patched(sim_batch, "_run_chunks", timed):
        yield calls


def sweep_runner(cache_dir, batch=True) -> SimRunner:
    return SimRunner(device="cuda", batch=batch, processes=SIM_SCALAR_WORKERS,
                     cache_dir=cache_dir)


def report_line(report) -> dict:
    keys = ("total", "cached", "computed", "completed", "pool_recycles", "wall_s", "tier",
            "analytic_points", "frontier_confirmed")
    return {**{k: getattr(report, k) for k in keys}, "ok": report.ok,
            "failed": report.failed_jobs(), "quarantined": len(report.quarantined)}


def stored_jobs(runner, jobs) -> list:
    """The jobs whose engine result is in ``runner``'s store."""
    return [j for j in jobs if runner.store.path(sim_key(*j)).exists()]


def fork_warnings() -> list:
    """What starting a worker by ``fork`` warns in this process, where CUDA
    has started: the reason the service spawns its pool's workers here."""
    with warnings.catch_warnings(record=True) as warned:
        warnings.simplefilter("always")
        fork = multiprocessing.get_context("fork")
        with concurrent.futures.ProcessPoolExecutor(1, mp_context=fork) as pool:
            pool.submit(os.getpid).result()
    return [f"{w.category.__name__}: {w.message}" for w in warned]


def service_whole_gpu(cache_dir, jobs, scalar) -> dict:
    """(c): whole-GPU jobs through ``prefill_gpu`` and ``sim_gpu``; each
    ``GpuResult`` held to ``scalar`` (``simulate_gpu`` over the scalar
    engine).  The per-SM jobs of the batch engine's scheduler go to the card,
    the others to the service's process pool, started after CUDA; any
    warning raised while it starts is recorded."""
    runner = sweep_runner(cache_dir)
    per_sm = [(n, c) for n, cfg in jobs for c in per_sm_configs(cfg)]
    on_card = [j for j in per_sm if sim_batch.batch_supported(j[1])]
    with engine_calls() as calls, warnings.catch_warnings(record=True) as warned:
        warnings.simplefilter("always")
        t0 = time.perf_counter()
        report = runner.prefill_gpu(jobs)
        wall = time.perf_counter() - t0
    check(report.ok and report.computed == len(per_sm),
          f"sweep_service whole-GPU: {report_line(report)}")
    check(runner.stats["batched"] == len(on_card) and calls and calls[0]["jobs"] == len(on_card),
          f"sweep_service whole-GPU: {runner.stats['batched']} per-SM jobs batched, "
          f"{len(on_card)} expected")
    got = [dataclasses.asdict(runner.sim_gpu(n, c)) for n, c in jobs]
    bad = sim_mismatches(got, scalar)
    check(not bad, f"sweep_service whole-GPU: {len(bad)} of {len(jobs)} GpuResults differ "
                   f"from the scalar engine")
    return {"jobs": len(jobs), "per_sm_jobs": len(per_sm), "identical": len(jobs) - len(bad),
            "batched_on_card": runner.stats["batched"],
            "on_pool": report.computed - runner.stats["batched"], "wall_s": wall,
            "engine_calls": calls, "report": report_line(report),
            "warnings": [f"{w.category.__name__}: {w.message}" for w in warned],
            "fork_warnings": fork_warnings()}


def service_hybrid(cache_dir, grid) -> dict:
    """(d): the analytic tier over ``grid`` (estimates on the host), then
    the hybrid tier: the engine confirms each workload's frontier.  Returns
    the walls, the confirmed jobs and what ran where."""
    runner = sweep_runner(cache_dir)
    t0 = time.perf_counter()
    screened = runner.prefill(grid, tier="analytic")
    estimate_wall = time.perf_counter() - t0
    check(screened.ok and screened.analytic_points == len(grid),
          f"sweep_service hybrid screening: {report_line(screened)}")
    with engine_calls() as calls:
        t0 = time.perf_counter()
        report = runner.prefill(grid, tier="hybrid")
        confirm_wall = time.perf_counter() - t0
    confirmed = stored_jobs(runner, grid)
    check(report.ok and report.frontier_confirmed == len(confirmed) > 0,
          f"sweep_service hybrid: {report_line(report)}")
    on_card = sum(sim_batch.batch_supported(c) for _, c in confirmed)
    check(runner.stats["batched"] == on_card,
          f"sweep_service hybrid: {runner.stats['batched']} batched, {on_card} expected")
    return {"runner": runner, "confirmed": confirmed, "points": len(grid),
            "estimate_wall_s": estimate_wall, "confirm_wall_s": confirm_wall,
            "frontier_confirmed": report.frontier_confirmed, "batched_on_card": on_card,
            "on_pool": len(confirmed) - on_card,
            "card_wall_s": sum(c["wall_s"] for c in calls), "engine_calls": calls,
            "report": report_line(report)}


def service_planted_failure(cache_dir, jobs) -> dict:
    """(e): the batch engine fails as a whole; ``prefill`` must raise, and
    no job may be finished on the process pool instead."""
    runner = sweep_runner(cache_dir)

    def broken(jobs, **kw):
        raise RuntimeError("planted whole-batch failure")

    raised = ""
    with patched(sim_batch, "run_batch", broken):
        try:
            runner.prefill(jobs)
        except RuntimeError as e:
            raised = str(e)
    check(raised == "planted whole-batch failure",
          "sweep_service: a planted whole-batch failure did not raise out of prefill")
    check(runner.stats["computed"] == 0 and not stored_jobs(runner, jobs),
          "sweep_service: jobs were completed after a planted whole-batch failure")
    return {"jobs": len(jobs), "raised": raised, "computed": runner.stats["computed"]}


def service_host_pool(host_dir, jobs) -> dict:
    """The tracked sweep on the service's host pool (the scalar engine), for
    the card's wall to be read against: its results, wall and counters."""
    host = sweep_runner(host_dir, batch=False)
    t0 = time.perf_counter()
    report = host.prefill(jobs)
    wall = time.perf_counter() - t0
    check(report.ok and report.computed == len(jobs) and host.stats["batched"] == 0,
          f"sweep_service host pool: {report_line(report)}")
    return {"results": [dataclasses.asdict(host.sim(n, c)) for n, c in jobs], "wall_s": wall}


def service_tracked(cache_dir, jobs, scalar_f, meanwhile, out) -> tuple:
    """(a) the tracked sweep through ``prefill``, every job batched on the
    card and held to ``scalar_f`` (the scalar engine's futures), while
    ``meanwhile`` (host work that never runs the batch engine) runs on a
    host thread; (b) its replay by a fresh runner on the same store.  Fills
    ``out``; returns the runner of (a), its results and what ``meanwhile``
    returned."""
    with engine_calls() as calls, concurrent.futures.ThreadPoolExecutor(1) as lane:
        on_host = lane.submit(meanwhile)
        # (a) the tracked sweep, every job batched on the card
        runner = sweep_runner(cache_dir)
        t0 = time.perf_counter()
        report = runner.prefill(jobs)
        wall = time.perf_counter() - t0
        on_host = on_host.result()
    check(report.ok and report.computed == len(jobs)
          and runner.stats["batched"] == len(jobs),
          f"sweep_service: {report_line(report)}, batched {runner.stats['batched']}")
    got = [dataclasses.asdict(runner.sim(n, c)) for n, c in jobs]
    scalar = [f.result() for f in scalar_f]
    scalar_res = [r for r, _ in scalar]
    bad = sim_mismatches(got, scalar_res)
    first = [jobs[i][0] + "/" + jobs[i][1].design for i in bad[:5]]
    check(not bad, f"sweep_service: {len(bad)} of {len(jobs)} jobs differ from the "
                   f"scalar engine (first {first})")
    scalar_s = sum(s for _, s in scalar)
    instr = sum(r["instructions"] for r in scalar_res)
    out["tracked"] = {
        "jobs": len(jobs), "identical": len(jobs) - len(bad),
        "batched": runner.stats["batched"], "service_wall_s": wall,
        "kernel_chunks": [ch for c in calls for ch in c["chunks"]],
        "longest_lane_ticks": max(ch["ticks"] for c in calls for ch in c["chunks"]),
        "engine_wall_s": sum(c["wall_s"] for c in calls),
        "service_overhead_s": wall - sum(c["wall_s"] for c in calls),
        "sim_instructions": instr, "sim_instr_per_s": instr / wall,
        "scalar_cpu_s": scalar_s, "scalar_instr_per_s": instr / scalar_s,
        "engine_calls": calls, "report": report_line(report)}
    # (b) the replay: a fresh runner on the same store
    replay = sweep_runner(cache_dir)
    t0 = time.perf_counter()
    report_b = replay.prefill(jobs)
    wall_b = time.perf_counter() - t0
    check(report_b.ok and report_b.cached == len(jobs) and report_b.computed == 0,
          f"sweep_service replay: {report_line(report_b)}")
    bad_b = sim_mismatches([dataclasses.asdict(replay.sim(n, c)) for n, c in jobs], got)
    check(not bad_b, f"sweep_service replay: {len(bad_b)} results differ")
    out["replay"] = {"jobs": len(jobs), "cached": report_b.cached,
                     "disk_hits": replay.stats["disk_hits"], "wall_s": wall_b}
    return runner, got, on_host


def phase_sweep_service(dev, seed) -> dict:
    """The sweep service (``repro_torch.serving.SimRunner``) driving the batch
    simulator on the card: (a) the tracked sweep, (b) its replay from the
    store, (c) the whole-GPU mini-sweep, (d) the hybrid tier, (e) a planted
    whole-batch failure, (f) the service's metrics.  Every simulated result
    is held field by field to the port's scalar engine, run meanwhile in
    host worker processes."""
    del dev, seed                      # the sweeps are fixed; no weights
    jobs = sim_sweep_jobs()
    gpu_jobs = sim_gpu_sweep_jobs()
    grid = sim_screening_jobs()
    # the grid's confirmations are all gto points (the batch engine's
    # domain is two_level); its two_level half, cut to the 4 workloads with
    # the fewest ticks to fit the script's time, gives the card its own
    grid_two_level = sim_screening_jobs(SIM_NARROW_WORKLOADS, schedulers=("two_level",))
    cache = Path(tempfile.mkdtemp(prefix="sweep_service_"))
    ctx = multiprocessing.get_context("spawn")
    out: dict = {}
    try:
        with concurrent.futures.ProcessPoolExecutor(SIM_SCALAR_WORKERS, mp_context=ctx) as pool:
            scalar_f = [pool.submit(sim_scalar, j) for j in jobs]
            gpu_f = [pool.submit(sim_scalar_gpu, j) for j in gpu_jobs]

            def on_host():
                # the host's share, on a thread while the card runs (a), once
                # the scalar engine's references are done: the same sweep on
                # the service's host pool, then (d)'s screening grid, whose
                # confirmations all run on the pool
                concurrent.futures.wait(scalar_f + gpu_f)
                host = service_host_pool(cache / "host_pool", jobs)
                grid_h = service_hybrid(cache / "hybrid", grid)
                check(grid_h["batched_on_card"] == 0,
                      "sweep_service hybrid (grid): a confirmation would share the card")
                return host, grid_h

            runner, got, (host, grid_h) = service_tracked(cache / "tracked", jobs, scalar_f,
                                                          on_host, out)
            bad_h = sim_mismatches(host["results"], got)
            check(not bad_h, f"sweep_service host pool: {len(bad_h)} results differ")
            instr = out["tracked"]["sim_instructions"]
            out["host_pool"] = {"jobs": len(jobs), "workers": SIM_SCALAR_WORKERS,
                                "wall_s": host["wall_s"], "sim_instr_per_s": instr / host["wall_s"],
                                "during_card_sweep": True}
            # (c) the whole-GPU mini-sweep
            out["whole_gpu"] = service_whole_gpu(cache / "gpu", gpu_jobs,
                                                 [f.result() for f in gpu_f])
            # (d) the hybrid tier: the screening grid (above), then its
            # two_level half on the card
            hybrid = out["hybrid"] = {
                "grid": {**grid_h, "during_card_sweep": True},
                "two_level": service_hybrid(cache / "hybrid_two_level", grid_two_level)}
            conf_f = {k: [pool.submit(sim_scalar, j) for j in h["confirmed"]]
                      for k, h in hybrid.items()}
            # (e) a planted whole-batch failure
            out["planted_failure"] = service_planted_failure(cache / "planted", jobs[:16])
            for k, h in hybrid.items():
                r = h.pop("runner")
                confirmed = h.pop("confirmed")
                bad_d = sim_mismatches([dataclasses.asdict(r.sim(*j)) for j in confirmed],
                                       [f.result()[0] for f in conf_f[k]])
                check(not bad_d, f"sweep_service hybrid ({k}): {len(bad_d)} of "
                                 f"{len(confirmed)} confirmations differ from the scalar engine")
                h["identical"] = len(confirmed) - len(bad_d)
        # the main path's launches: (a), (c) and (d)'s runs ((e) launches none)
        main_calls = [c for part in (out["tracked"], out["whole_gpu"], *hybrid.values())
                      for c in part["engine_calls"]]
        out["kernel_launches"] = sum(c["kernel_launches"] for c in main_calls)
        out["kernel_launches_by_route"] = sim_routes_sum(
            c["kernel_launches_by_route"] for c in main_calls)
        # (f) the service's metrics
        snap = runner.metrics_snapshot()
        out["metrics"] = {k: v for k, v in snap.items()
                          if k.startswith("sweep_") or k in ("run_id", "runner_stats")}
    finally:
        shutil.rmtree(cache, ignore_errors=True)
    return out


def phase_sim_batch(dev, seed) -> dict:
    """The batch simulator on the card, driven directly: 8 lanes a launch,
    held job for job to the scalar engine on the host (run in worker
    processes meanwhile), a planted fault, and the tick's times (the tracked
    sweep runs through the sweep service, in phase ``sweep_service``)."""
    del dev, seed                      # the sweep is fixed; no weights
    jobs = sim_sweep_jobs()
    narrow = [(n, design_config(d, table2_config=7)) for n in SIM_NARROW_WORKLOADS
              for d in SIM_DESIGNS]
    fault_jobs = [("listing1", design_config(d, table2_config=7, num_warps=16))
                  for d in SIM_DESIGNS]
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(SIM_SCALAR_WORKERS, mp_context=ctx) as pool:
        scalar_f = [pool.submit(sim_scalar, j) for j in narrow]
        fault_f = [pool.submit(sim_scalar, j) for j in fault_jobs]
        launched = sim_ops.sim_batch.launches
        mark = dict(sim_ops.sim_batch.launches_by_route)
        at8 = sim_card_run(narrow, SIM_NARROW_LANES)
        main_launches = sim_ops.sim_batch.launches - launched
        main_routes = sim_routes_since(mark)
        # the kernel's final state against the plain tick's, on the card
        versus = sim_kernel_vs_plain(narrow, SIM_NARROW_LANES)
        # a planted fault: the DRAM queue's interval one cycle longer
        # (reference :855), a single float64 site
        build = sim_batch._build

        def late_dram(lanes):
            co, st = build(lanes)
            co["drint"] = co["drint"] + 1.0
            return co, st

        with patched(sim_batch, "_build", late_dram):
            faulty = sim_card_run(fault_jobs, sim_batch._SUB_LANES["cuda"])
        scalar = [f.result() for f in scalar_f]
        fault_scalar = [f.result()[0] for f in fault_f]
    # each job equal to the scalar engine, field by field
    bad8 = sim_mismatches(at8["results"], [r for r, _ in scalar])
    check(not bad8, f"sim_batch at {SIM_NARROW_LANES} lanes: {len(bad8)} jobs differ")
    fault_bad = sim_mismatches(faulty["results"], fault_scalar)
    check(len(fault_bad) > 0, "sim_batch: the planted DRAM-interval fault passed the check")
    # the kernel's µs a tick, and the plain tick's ms a tick eagerly and
    # replayed and its busy share, for the widest chunk of the tracked sweep
    # and for an 8-lane chunk of the comparison
    widest = max(sim_chunks(jobs, sim_batch._SUB_LANES["cuda"]), key=len)
    narrow8 = max(sim_chunks(narrow, SIM_NARROW_LANES), key=len)
    log = (_build.BUILD_DIR / f"{SIM_SOURCE}.log").read_text()
    kernel_t = {"widest": sim_kernel_tick(widest), "narrow": sim_kernel_tick(narrow8)}
    times = {"widest": sim_tick_times(widest), "narrow": sim_tick_times(narrow8)}
    for run in (at8, faulty):
        del run["results"]
    widest_t, narrow_t = times["widest"], times["narrow"]
    return {
        "kernel_launches": main_launches, "kernel_launches_by_route": main_routes,
        "kernel": {"widest": kernel_t["widest"], "narrow": kernel_t["narrow"],
                   "ptxas": ptxas_summary(log),
                   "ptxas_lines": [ln.strip() for ln in log.splitlines()
                                   if "registers" in ln or "spill" in ln]},
        "kernel_vs_plain": versus,
        "widest_lanes": len(widest),
        "plain_tick": "the figures below are the plain PyTorch tick's (engine='plain')",
        "eager_ms_per_tick": widest_t["eager_ms_per_tick"],
        "graph_ms_per_tick": widest_t["graph_ms_per_tick"],
        "device_ms_per_tick": widest_t["device_ms_per_tick"],
        "device_busy_share": widest_t["device_busy_share"],
        "at_8_lanes": {"jobs": len(narrow), "identical": len(narrow) - len(bad8),
                       "workloads": list(SIM_NARROW_WORKLOADS),
                       **{k: at8[k] for k in ("launches", "ticks", "graph_captures", "wall_s",
                                              "sim_instr_per_s")},
                       "kernel_us_per_tick": kernel_t["narrow"]["us_per_tick"],
                       "plain_tick": {k: narrow_t[k] for k in (
                           "eager_ms_per_tick", "graph_ms_per_tick", "device_ms_per_tick",
                           "device_busy_share")}},
        "planted_fault": {"fault": "DRAM-queue interval one cycle longer (reference :855)",
                          "jobs": len(fault_jobs), "mismatched": len(fault_bad)},
        "narrow_run": at8, "tick_times": times,
    }


# ------------------------------------------------------------ the traced suite

# The JAX package's lift of each traced workload (``repro.frontend``, jax 0.9,
# constants here, not an import): static instructions, regs_per_thread at
# maxregcount 64, loops, and LTRF at Table-2 #7, 16 warps, on the scalar
# engine: cycles and instructions.
TRACED_JAX_LIFT = {
    "traced_matmul": (69, 29, 1, 7180, 5584),
    "traced_attention": (171, 30, 4, 12233, 9456),
    "traced_ssd": (84, 23, 3, 27449, 17568),
    "traced_rmsnorm": (22, 8, 1, 1316, 1024),
    "traced_mlp": (153, 31, 3, 12776, 10640),
    "traced_attn_layer": (187, 36, 5, 24384, 19104),
}
# The lifted matmul's (cycles, instructions, mrf_accesses, rfc_hits,
# rfc_accesses) at Table-2 #7, 16 warps (tests/test_sim_golden.py:154-162):
# the port's lift of traced_matmul is the JAX lift's program.
TRACED_MATMUL_GOLDEN = {
    "BL": (7857, 5584, 16000, 0, 0),
    "RFC": (5878, 5584, 7803, 8197, 16000),
    "SHRF": (10557, 5584, 13416, 16000, 16000),
    "LTRF": (7180, 5584, 11552, 16000, 16000),
    "LTRF_conf": (6719, 5584, 11552, 16000, 16000),
    "LTRF_plus": (5468, 5584, 2512, 16000, 16000),
    "Ideal": (5381, 5584, 0, 0, 0),
}


def traced_lifts() -> dict:
    """(a), in a fresh host process: each traced workload lifted from the
    port's PyTorch functions (``build_traced_workload``: trace, lift,
    allocate registers), its seconds and shape, LTRF at Table-2 #7 with 16
    warps on the scalar engine, and whether lifting started CUDA."""
    out = {}
    for name in TRACED_NAMES:
        t0 = time.perf_counter()
        w = build_traced_workload(name)
        lift_s = time.perf_counter() - t0
        r = sim_engine.simulate(w, design_config("LTRF", table2_config=7, num_warps=16))
        static, regs, loops, cycles, instr = TRACED_JAX_LIFT[name]
        out[name] = {"lift_s": lift_s, "instructions_static": w.program.num_instrs(),
                     "regs_per_thread": w.regs_per_thread, "loops": len(w.trips),
                     "ltrf7_cycles": r.cycles, "ltrf7_instructions": r.instructions,
                     "jax_lift": {"instructions_static": static, "regs_per_thread": regs,
                                  "loops": loops, "ltrf7_cycles": cycles,
                                  "ltrf7_instructions": instr}}
    return {"workloads": out, "cuda_initialized": torch.cuda.is_initialized()}


def sim_counters(r) -> tuple:
    return (r.cycles, r.instructions, r.mrf_accesses, r.rfc_hits, r.rfc_accesses)


def phase_traced_sweep(dev, seed) -> dict:
    """The traced suite (``repro_torch.frontend``: the port's own kernels'
    plain versions and layers lifted through ``torch.fx``) on the card: (a)
    the six lifts, in a fresh host process (no CUDA) and in this one; (b) the
    traced sweep (``sweep_jobs(suite="traced")`` rebuilt from the port: 84
    unique sims) through the sweep service, every job batched on the card and
    held field by field to the port's scalar engine, run meanwhile in host
    worker processes; (c) ``traced_matmul`` on all 7 designs through
    ``run_batch`` on the card against ``TRACED_MATMUL_GOLDEN``; (d) a planted
    lift fault (the dot loop's trip count one higher) must break (c)."""
    del dev, seed                      # the sweep is fixed; no weights
    jobs = sim_sweep_jobs(names=TRACED_NAMES)
    cache = Path(tempfile.mkdtemp(prefix="traced_sweep_"))
    ctx = multiprocessing.get_context("spawn")
    out: dict = {}
    try:
        with concurrent.futures.ProcessPoolExecutor(SIM_SCALAR_WORKERS, mp_context=ctx) as pool:
            lifts_f = pool.submit(traced_lifts)
            scalar_f = [pool.submit(sim_scalar, j) for j in jobs]
            # (a) the lifts in this process, where CUDA has started
            t0 = time.perf_counter()
            for name in TRACED_NAMES:
                build_traced_workload(name)
            main_lift_s = time.perf_counter() - t0
            # (b) the traced sweep through the service, all on the card, while
            # the fresh process lifts
            runner = sweep_runner(cache / "traced")
            with engine_calls() as calls:
                t0 = time.perf_counter()
                report = runner.prefill(jobs)
                wall = time.perf_counter() - t0
            lifts = lifts_f.result()
            check(not lifts["cuda_initialized"], "traced_sweep: lifting started CUDA")
            out["lifts"] = {**lifts, "this_process_s": main_lift_s,
                            "fresh_process_s": sum(v["lift_s"]
                                                   for v in lifts["workloads"].values())}
            check(report.ok and report.computed == len(jobs)
                  and runner.stats["batched"] == len(jobs),
                  f"traced_sweep: {report_line(report)}, batched {runner.stats['batched']}")
            got = [dataclasses.asdict(runner.sim(n, c)) for n, c in jobs]
            scalar = [f.result() for f in scalar_f]
        scalar_res = [r for r, _ in scalar]
        bad = sim_mismatches(got, scalar_res)
        first = [jobs[i][0] + "/" + jobs[i][1].design for i in bad[:5]]
        check(not bad, f"traced_sweep: {len(bad)} of {len(jobs)} jobs differ from the "
                       f"scalar engine (first {first})")
        scalar_s = sum(s for _, s in scalar)
        instr = sum(r["instructions"] for r in scalar_res)
        engine_s = sum(c["wall_s"] for c in calls)
        out["sweep"] = {
            "jobs": len(jobs), "identical": len(jobs) - len(bad),
            "batched": runner.stats["batched"], "service_wall_s": wall,
            "engine_wall_s": engine_s, "service_overhead_s": wall - engine_s,
            "chunks": [ch for c in calls for ch in c["chunks"]],
            "launches": sum(c["launches"] for c in calls),
            "ticks": sum(c["ticks"] for c in calls),
            "longest_lane_ticks": max(ch["ticks"] for c in calls for ch in c["chunks"]),
            "sim_instructions": instr, "sim_instr_per_s": instr / wall,
            "scalar_cpu_s": scalar_s, "scalar_instr_per_s": instr / scalar_s,
            "report": report_line(report)}
    finally:
        shutil.rmtree(cache, ignore_errors=True)
    # (c) traced_matmul's pins through run_batch on the card (the main path's
    # last run), then (d) in a call of its own a planted lift fault: the dot
    # loop's trip count one higher
    w = get_workload("traced_matmul")
    (loop, trips), = w.trips.items()
    planted = dataclasses.replace(w, trips={loop: trips + 1})
    cfgs = [design_config(d, table2_config=7, num_warps=16) for d in SIM_DESIGNS]
    launched = sim_ops.sim_batch.launches
    mark = dict(sim_ops.sim_batch.launches_by_route)
    t0 = time.perf_counter()
    res = sim_run_batch([(w, c) for c in cfgs], fallback=False, device="cuda")
    pins_wall = time.perf_counter() - t0
    pins_launches = sim_ops.sim_batch.launches - launched
    pins_routes = sim_routes_since(mark)
    pins = [sim_counters(r) for r in res]
    faulty = [sim_counters(r) for r in sim_run_batch([(planted, c) for c in cfgs],
                                                     fallback=False, device="cuda")]
    wrong = [d for d, got in zip(SIM_DESIGNS, pins) if got != TRACED_MATMUL_GOLDEN[d]]
    check(not wrong, f"traced_sweep: traced_matmul differs from TRACED_MATMUL_GOLDEN on {wrong}")
    caught = [d for d, got in zip(SIM_DESIGNS, faulty) if got != TRACED_MATMUL_GOLDEN[d]]
    check(len(caught) == len(SIM_DESIGNS),
          f"traced_sweep: the planted trip-count fault passed on "
          f"{sorted(set(SIM_DESIGNS) - set(caught))}")
    out["matmul_pins"] = {"designs": len(SIM_DESIGNS), "identical": len(SIM_DESIGNS),
                          "wall_s": pins_wall, "kernel_launches": pins_launches,
                          "planted_fault": {"fault": f"trip count of {loop} {trips} -> {trips + 1}",
                                            "designs_caught": len(caught)}}
    # the main path's launches: (b)'s runs and (c)'s, not (d)'s
    out["kernel_launches"] = sum(c["kernel_launches"] for c in calls) + pins_launches
    out["kernel_launches_by_route"] = sim_routes_sum(
        [*(c["kernel_launches_by_route"] for c in calls), pins_routes])
    return out


# --- the mesh layer ----------------------------------------------------------
#
# mesh: (a) tinyllama-1.1b at full width and depth, 2 train steps on a
# one-rank NCCL mesh through the sharding rules, against the same 2 steps
# without rules; (b) zamba2-1.2b cut to its first 6 layers (one shared
# attention block) and granite-moe-3b-a800m cut to 2, loss_fn at B=2 x
# S=1024; (c) the GPipe schedule over a one-rank stage mesh; (d) the dry-run
# cells, run in host processes from the start of the script.
MESH_STEPS = 2
MESH_CUTS = {HYBRID_ARCH: 6, MOE_ARCH: 2}
MESH_MICRO, MESH_MB = 4, 2
DRYRUN_ARCHS = (ARCH, MOE_ARCH, "llava-next-34b", AUDIO_ARCH, SSM_ARCH, HYBRID_ARCH)
DRYRUN_SHAPES = ("train_4k", "decode_32k")
# the tracked sweep's card wall on an H100 80GB HBM3 at 700 W before the
# dry-run ran beside it (PERF.md §5): its cost shows against this
TRACKED_WALL_BEFORE_S = 392.4
# granite-moe's dry-run cells on 16x16 when the MoE site still gathered the
# experts' d_ff split (on the card's host, torch 2.11; PERF.md §6): FLOPs a
# rank and all-gather GiB.  Keeping the split cuts the FLOPs ~10x; a cell
# above an eighth of these has lost it.
MOE_GATHERED = {"train_4k": {"flops_per_rank": 6.60e15, "all_gather_gib": 510.8},
                "decode_32k": {"flops_per_rank": 1.98e11}}
# the Mamba2 models' train_4k cells on 16x16 when mamba2._split_proj sliced
# the column-split in_proj output three times, each slice gathering the whole
# tensor (on the card's host, torch 2.11; PERF.md §6): the all-gather GiB
# charged to _split_proj.  Gathered once, they are a third; a cell above 40 %
# of these gathers more than once.
SPLIT_PROJ_GATHERED_GIB = {SSM_ARCH: 3 * 99.75, HYBRID_ARCH: 3 * 77.78}


def dryrun_start(out_dir: Path) -> list:
    """(d): the dry-run's cells (``python -m repro_torch.launch.dryrun``) in
    three host processes that may not start CUDA (no card visible to them):
    the single-pod cells in two, tinyllama's multi-pod cell in the third, at
    a lower scheduling priority than this process, whose host thread feeds
    the card."""
    out_dir.mkdir(parents=True, exist_ok=True)
    for stale in out_dir.glob("*.json"):         # an earlier run's cells
        stale.unlink()
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": "", "OMP_NUM_THREADS": "1",
           "PYTHONPATH": os.pathsep.join([str(ROOT / "src"), os.environ.get("PYTHONPATH", "")])}
    half = len(DRYRUN_ARCHS) // 2
    argvs = [["--arch", *DRYRUN_ARCHS[:half], "--shape", *DRYRUN_SHAPES],
             ["--arch", *DRYRUN_ARCHS[half:], "--shape", *DRYRUN_SHAPES],
             ["--arch", ARCH, "--shape", "train_4k", "--multi-pod"]]
    procs = []
    for i, argv in enumerate(argvs):
        log = open(out_dir / f"dryrun_{i}.log", "w")
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", *argv, "--out-dir", str(out_dir)],
            stdout=log, stderr=subprocess.STDOUT, env=env, cwd=ROOT))
        log.close()
        os.setpriority(os.PRIO_PROCESS, procs[-1].pid, 10)
    return procs


def all_gathers_of(by_source: dict, top: int = 4) -> dict:
    """A dry-run cell's all-gather GiB of weights and of activations, and
    its ``top`` largest sources."""
    out: dict = {"weight": 0.0, "activation": 0.0}
    rows = []
    for key, v in by_source.items():
        kind, of, where = key.split(" ", 2)
        if kind == "all-gather":
            out[of] += v["bytes"] / 2 ** 30
            rows.append((v["bytes"] / 2 ** 30, f"{of} {where}"))
    out["top"] = {k: gib for gib, k in sorted(rows, reverse=True)[:top]}
    return out


def dryrun_read(procs, out_dir: Path, started: float, card: str) -> dict:
    """(d)'s cells, once their processes end: each cell's record, in short,
    and when the last cell was written (seconds after ``started``, a
    ``time.time()``); granite-moe's cells printed beside ``MOE_GATHERED``
    with ``card`` (``nvidia-smi``'s name and power limit), and held to an
    eighth of its FLOPs."""
    for i, proc in enumerate(procs):
        check(proc.wait() == 0, f"mesh: the dry-run exited {proc.returncode}: "
                                f"{(out_dir / f'dryrun_{i}.log').read_text()[-2000:]}")
    done = max(p.stat().st_mtime for p in out_dir.glob("*.json")) - started
    cells = {}
    for mesh_name, archs, shapes in [("pod16x16", DRYRUN_ARCHS, DRYRUN_SHAPES),
                                     ("pod2x16x16", (ARCH,), ("train_4k",))]:
        for a in archs:
            for shp in shapes:
                rec = json.loads((out_dir / f"{a}_{shp}_{mesh_name}.json").read_text())
                check(rec["ok"] and not rec["cuda_initialized"],
                      f"mesh: dry-run cell {a} {shp} {mesh_name}: {rec.get('error', rec)}")
                mem, coll = rec["memory"], rec["collectives"]
                cells[f"{a}/{shp}/{mesh_name}"] = {
                    "ok": rec["ok"], "trace_s": rec["trace_s"], "n_micro": rec.get("n_micro"),
                    "argument_gib": mem["argument_size_in_bytes"] / 2 ** 30,
                    "peak_gib": mem["peak_bytes"] / 2 ** 30,
                    "head_padding_bytes": mem["head_padding_bytes"],
                    "flops_per_rank": rec["cost"]["flops"],
                    "collectives": {k: v for k, v in coll.items()
                                    if isinstance(v, dict) and v["count"]},
                    "all_gather_gib_of": all_gathers_of(rec["collectives_by_source"]),
                    "split_proj_all_gather_gib": sum(
                        v["bytes"] for k, v in rec["collectives_by_source"].items()
                        if k.startswith("all-gather ") and k.endswith(" _split_proj")) / 2 ** 30,
                    "cuda_initialized": rec["cuda_initialized"]}
    moe = {}
    for shp, gathered in MOE_GATHERED.items():
        cell = cells[f"{MOE_ARCH}/{shp}/pod16x16"]
        coll = cell["collectives"]
        moe[shp] = {"flops_per_rank": cell["flops_per_rank"],
                    "all_gather_gib": coll.get("all-gather", {"bytes": 0})["bytes"] / 2 ** 30,
                    "collective_gib": sum(v["bytes"] for v in coll.values()) / 2 ** 30,
                    "gathered_split": gathered}
        print(f"mesh dry-run {MOE_ARCH} {shp} 16x16 ({card}; counts, no device): "
              f"FLOPs a rank {moe[shp]['flops_per_rank']:.4g} "
              f"(split gathered: {gathered['flops_per_rank']:.3g}), "
              f"all-gather {moe[shp]['all_gather_gib']:.2f} GiB"
              + (f" ({gathered['all_gather_gib']})" if "all_gather_gib" in gathered else "")
              + f", collectives {moe[shp]['collective_gib']:.2f} GiB", flush=True)
        check(moe[shp]["flops_per_rank"] <= gathered["flops_per_rank"] / 8,
              f"mesh: {MOE_ARCH} {shp} runs {moe[shp]['flops_per_rank']:.4g} FLOPs a rank, "
              f"above an eighth of {gathered['flops_per_rank']:.3g}: the experts' d_ff "
              f"split is gathered")
    split = {}
    for arch, gathered in SPLIT_PROJ_GATHERED_GIB.items():
        cell = cells[f"{arch}/train_4k/pod16x16"]
        split[arch] = {"split_proj_all_gather_gib": cell["split_proj_all_gather_gib"],
                       "all_gather_gib": cell["collectives"].get(
                           "all-gather", {"bytes": 0})["bytes"] / 2 ** 30,
                       "gathered_per_slice_gib": gathered}
        print(f"mesh dry-run {arch} train_4k 16x16 ({card}; counts, no device): all-gather "
              f"{split[arch]['all_gather_gib']:.2f} GiB, of it _split_proj "
              f"{split[arch]['split_proj_all_gather_gib']:.2f} GiB (gathered per slice: "
              f"{gathered:.2f})", flush=True)
        check(split[arch]["split_proj_all_gather_gib"] <= 0.4 * gathered,
              f"mesh: {arch} train_4k gathers {split[arch]['split_proj_all_gather_gib']:.2f} GiB "
              f"in _split_proj, above 40 % of {gathered:.2f}: the in_proj output is gathered "
              "more than once")
    return {"cells": cells, "done_after_s": done, "moe_ffn_split": moe,
            "split_proj_gathers": split}


def counted(fn, *a):
    """``fn(*a)`` with every launch count set to 0 first: (result, counts,
    routes) of that run alone."""
    torch.cuda.synchronize()
    reset_counts()
    out = fn(*a)
    torch.cuda.synchronize()
    return out, read_counts(), read_routes()


def timed_steps(step, state, batches) -> tuple:
    walls, metrics = [], []
    for b in batches:
        t0 = time.perf_counter()
        state, m = step(state, b)
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
        metrics.append({k: float(v) for k, v in m.items()})
    return state, metrics, walls


def mesh_train(cfg, dev, seed, rules) -> tuple:
    """(a): 2 steps from one state with the rules (the state placed by
    ``reshard_state``) and without; bit-identical under deterministic
    algorithms."""
    shape = ShapeConfig("chip_mesh", TRAIN_S, TRAIN_B, "train")
    batches = [batch_for_step(cfg, shape, s, seed + 1) for s in range(MESH_STEPS)]
    state = make_train_state(cfg, torch.Generator(dev).manual_seed(seed), dev)
    plain = tree_map(torch.clone, state)
    torch.use_deterministic_algorithms(True)
    try:
        plain, plain_m, plain_walls = timed_steps(build_train_step(cfg, TRAIN_OPT), plain, batches)
        placed, _ = reshard_state(state, train_state_axes(cfg), rules.mesh,
                                  shapes_tree=train_state_shapes(cfg))
        del state
        (placed, mesh_m, mesh_walls), counts, routes = counted(
            timed_steps, build_train_step(cfg, TRAIN_OPT, rules=rules), placed, batches)
        backward = read_backward()
    finally:
        torch.use_deterministic_algorithms(False)
    same = all(torch.equal(a, b.to_local())
               for a, b in zip(tree_leaves(plain), tree_leaves(placed)))
    out = {"steps": MESH_STEPS, "batch": TRAIN_B, "seq": TRAIN_S,
           "placements": sorted({str(tuple(t.placements)) for t in tree_leaves(placed)}),
           "losses": [m["loss"] for m in mesh_m], "grad_norms": [m["grad_norm"] for m in mesh_m],
           "step_ms_mesh": mesh_walls, "step_ms_plain": plain_walls,
           "bit_identical_state": same,
           "bit_identical_metrics": mesh_m == plain_m,
           "launches": counts, "launches_by_route": routes, "backward_launches": backward}
    del plain, placed
    free_memory()
    want = {k: MESH_STEPS * v for k, v in train_step_launches(cfg).items()}
    check(counts == want, f"mesh train launches {counts}, want {want}")
    check(backward["flash_attention"] == MESH_STEPS * cfg.n_layers,
          f"mesh train flash backward launches {backward}: one a layer and step")
    check(backward["ltrf_matmul_by_layout"] == train_step_layouts(cfg, MESH_STEPS),
          f"mesh train matmul launches by layout {backward['ltrf_matmul_by_layout']}")
    check(same and out["bit_identical_metrics"],
          f"mesh: the train steps under the rules differ from the steps without: {out}")
    return out, counts, routes


def mesh_loss(cfg, dev, seed, rules) -> tuple:
    """(b): ``loss_fn`` (the prefill step) at B=2 x S=1024 with the rules and
    without, from the same weights: the same bits."""
    params = init_params(cfg, torch.Generator(dev).manual_seed(seed), dev)
    batch = prefill_batch(cfg, dev, seed)
    plain = build_prefill_step(cfg)(params, batch)
    placed, _ = reshard_state(params, param_axes(cfg), rules.mesh, shapes_tree=param_shapes(cfg))
    got, counts, routes = counted(build_prefill_step(cfg, rules=rules), placed, batch)
    out = {"layers": cfg.n_layers, "loss": float(got["loss"]), "aux_loss": float(got["aux_loss"]),
           "bit_identical": all(torch.equal(got[k], plain[k]) for k in plain),
           "launches": counts, "launches_by_route": routes}
    del params, placed
    free_memory()
    check(counts == forward_launches(cfg), f"mesh {cfg.name} launches {counts}")
    check(out["bit_identical"], f"mesh: {cfg.name}'s loss under the rules differs: {out}")
    return out, counts, routes


def mesh_pipeline(cfg, dev, seed) -> tuple:
    """(c): the GPipe schedule over a one-rank stage mesh, tinyllama's dense
    block as the stage, against ``sequential_reference``: the same bits."""
    one = dataclasses.replace(cfg, n_layers=1)
    layer = init_params(one, torch.Generator(dev).manual_seed(seed), dev)["layers"][0]
    stacked = tree_map(lambda t: t[None], layer)
    gen = torch.Generator(dev).manual_seed(seed + 2)
    x = torch.randn(MESH_MICRO, MESH_MB, TRAIN_S, cfg.d_model, device=dev, generator=gen,
                    dtype=cfg.torch_dtype)
    positions = torch.arange(TRAIN_S, dtype=torch.int32, device=dev).expand(MESH_MB, TRAIN_S)

    def stage(p, h):
        return lm_module._dense_block(cfg, p, h, positions, True)[0]

    stage_mesh = init_device_mesh("cuda", (1,), mesh_dim_names=("stage",))
    with torch.no_grad():
        want = sequential_reference(stage, stacked, x)
        got, counts, routes = counted(pipeline_forward, stage, stacked, x, stage_mesh)
    out = {"microbatches": MESH_MICRO, "microbatch": [MESH_MB, TRAIN_S], "stages": 1,
           "bit_identical": bool(torch.equal(got, want)), "launches": counts,
           "launches_by_route": routes}
    check(out["bit_identical"], "mesh: the GPipe schedule differs from sequential_reference")
    return out, counts, routes


def phase_mesh(cfgs, dev, seed, dryrun, tracked_wall_s, card) -> dict:
    """The mesh layer on the card: (a)-(c) on a one-rank NCCL mesh
    (``make_host_mesh``) with ``default_rules``, every kernel launch on its
    route; (d) the dry-run's cells, read from their host processes, and the
    tracked sweep's card wall (``tracked_wall_s``) beside its wall before
    the dry-run ran beside the card; ``card``: ``nvidia-smi``'s name and
    power limit."""
    own = not dist.is_initialized()
    mesh = make_host_mesh(device=dev)
    rules = default_rules(mesh)
    out: dict = {"mesh": {"shape": list(mesh.mesh.shape), "backend": dist.get_backend()}}
    runs = []
    try:
        out["train"], *r = mesh_train(cfgs[0], dev, seed, rules)
        runs.append(r)
        for name, n in MESH_CUTS.items():
            cfg = dataclasses.replace(get_arch(name), n_layers=n)
            out[f"loss_{name}"], *r = mesh_loss(cfg, dev, seed, rules)
            runs.append(r)
        out["pipeline"], *r = mesh_pipeline(cfgs[0], dev, seed)
        runs.append(r)
    finally:
        if own:
            dist.destroy_process_group()
    out["launches"] = {n: sum(c[n] for c, _ in runs) for n in KERNELS}
    out["backward_launches"] = out["train"]["backward_launches"]
    out["launches_by_route"] = {n: {k: sum(rt[n][k] for _, rt in runs) for k in rs}
                                for n, rs in runs[0][1].items()}
    for name, by_route in out["launches_by_route"].items():
        check(by_route["wgmma"] == out["launches"][name],
              f"mesh {name} routes {by_route}: every launch on wgmma")
    out["dryrun"] = dryrun_read(*dryrun, card)
    out["tracked_sweep_wall_s"] = {"this_run": tracked_wall_s,
                                   "before_the_dryrun": TRACKED_WALL_BEFORE_S}
    return out


def sim_kernel_entry(sim, sim_paths, sim_routes) -> dict:
    """The kernels line's entry of the batch simulator's kernel: ``sim`` is
    phase sim_batch's result, ``sim_paths`` the kernel's launches on each
    simulator phase's main path, ``sim_routes`` the same launches by the
    route of a lane's image."""
    w, n = sim["kernel"]["widest"], sim["kernel"]["narrow"]
    per_tick = 1.0 / w["ticks"]
    return {
        "name": "sim_batch", "route": "cuda", "source": f"src/repro_torch/csrc/{SIM_SOURCE}.cu",
        "replaces": "src/repro/sim/batch.py:1102",
        "replaces_note": ("not a TPU kernel: the counterpart of _run_jax's lax.while_loop "
                          "(src/repro/sim/batch.py:629-1102)"),
        "launches": sum(sim_paths.values()), "launches_by_path": sim_paths,
        "max_abs_err": sim["kernel_vs_plain"]["max_abs_err"],
        "ms": w["kernel_ms"] * per_tick, "plain_ms": sim["graph_ms_per_tick"],
        "bound_ms": w["bound_ms"] * per_tick, "bound_by": w["bound_by"], "library_ms": None,
        "library_note": "no PyTorch call simulates the tick",
        "unit": (f"one tick of the tracked sweep's widest chunk ({w['lanes']} lanes, "
                 f"{w['ticks']} ticks in one launch); plain_ms: the plain tick's replayed "
                 "graph block, per tick; bound_ms: the chunk's planes read once and its state "
                 "written once over the launch, per tick (a chain of dependent ticks has no "
                 "useful roofline)"),
        "narrow": {"lanes": n["lanes"], "ticks": n["ticks"], "us_per_tick": n["us_per_tick"],
                   "plain_ms": sim["at_8_lanes"]["plain_tick"]["graph_ms_per_tick"]},
        "launches_by_route": sim_routes,
        "ptxas": sim["kernel"]["ptxas"]}


def kernels_line(cfgs, checks, paths, routes, trained, grads, bwd_paths, sim_entry,
                 ptxas) -> dict:
    """``paths``: each main path's launch counts, by phase; ``routes``: the
    same per route, for the kernels that have routes; ``trained`` and
    ``grads``: the train_tinyllama and train_grads results (each kernel's
    training launches and its backward's time); ``bwd_paths``: each training
    phase's backward kernel launches; ``sim_entry``: the batch simulator's
    kernel's entry; ``ptxas``: each source's ``-Xptxas -v`` summary."""
    launches = {n: sum(p[n] for p in paths.values()) for n in KERNELS}
    bwd_launches = {n: sum(p[n] for p in bwd_paths.values()) for n in BWD_SOURCES}
    fb, sb = checks["flash_attention_bwd"][0], checks["ssd_scan_bwd"][0]

    def backward(name, rec, unit, extra) -> dict:
        return {"source": f"src/repro_torch/csrc/{BWD_SOURCES[name]}.cu", "route": "cuda",
                "launches": bwd_launches[name],
                "launches_by_path": {k: p[name] for k, p in bwd_paths.items()},
                **{k: rec[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                       "library_ms")}, "unit": unit, **extra}

    by_route = {n: {r: sum(p[n][r] for p in routes.values()) for r in rs}
                for n, rs in next(iter(routes.values())).items()}
    mm = {(r["M"], r["K"], r["N"]): r for r in checks["ltrf_matmul"] if r["dtype"] == "bfloat16"}

    def mix(cfg, M):
        shapes = slice_matmuls(cfg)
        rec = {key: sum(n * mm[(M, K, N)][key] for (K, N), n in shapes)
               for key in ("ms", "plain_ms", "library_ms")}
        nbytes = sum(n * (M * K + K * N + M * N) * 2 for (K, N), n in shapes)
        flops = sum(n * 2 * M * K * N for (K, N), n in shapes)
        rec["bound_ms"], rec["bound_by"] = bound(nbytes, flops, torch.bfloat16)
        rec["launches"] = sum(n for _, n in shapes)
        return rec

    mixes = {cfg.name: {"decode_m8": mix(cfg, 8), "prefill_m2048": mix(cfg, 2048)}
             for cfg in cfgs}
    tiny = mixes[ARCH]
    fa, fa_hybrid = checks["flash_attention"][0], checks["flash_attention"][3]
    ssd, ssd_hybrid = checks["ssd_scan"][0], checks["ssd_scan"][2]
    return {"kernels": [
        {"name": "ltrf_matmul", "route": "cuda",
         "source": "src/repro_torch/csrc/ltrf_matmul.cu",
         "replaces": "src/repro/kernels/ltrf_matmul/kernel.py:48",
         "launches": launches["ltrf_matmul"], "launches_by_route": by_route["ltrf_matmul"],
         "launches_by_layout": {k: sum(p["ltrf_matmul_by_layout"][k] for p in bwd_paths.values())
                                for k in mm_ops.LAYOUTS},
         "launches_by_layout_over": (f"the training paths {sorted(bwd_paths)}; every prefill "
                                     "and serve launch is nn"),
         "max_abs_err": max(r["max_abs_err"] for r in mm.values()),
         "ms": tiny["decode_m8"]["ms"], "plain_ms": tiny["decode_m8"]["plain_ms"],
         "bound_ms": tiny["decode_m8"]["bound_ms"], "bound_by": tiny["decode_m8"]["bound_by"],
         "library_ms": tiny["decode_m8"]["library_ms"],
         "unit": (f"one {ARCH} decode step's matmuls: {tiny['decode_m8']['launches']} "
                  "launches at M=8, bf16; per-arch decode and prefill mixes in 'mixes'"),
         "prefill_ms": tiny["prefill_m2048"]["ms"],
         "prefill_plain_ms": tiny["prefill_m2048"]["plain_ms"],
         "prefill_library_ms": tiny["prefill_m2048"]["library_ms"],
         "prefill_bound_ms": tiny["prefill_m2048"]["bound_ms"],
         "prefill_bound_by": tiny["prefill_m2048"]["bound_by"],
         "mixes": mixes, "launches_by_path": {k: p["ltrf_matmul"] for k, p in paths.items()},
         "training": {"launches_per_step": trained["launches_per_step"]["ltrf_matmul"],
                      "launches_by_route": trained["launches_by_route"]["ltrf_matmul"],
                      "backward": ("two kernel products (matmul_vjp): dX in layout nt, dW "
                                   "in tn, operands read in place"),
                      "backward_per_step": {k: v for k, v in trained["matmul_backward"].items()
                                            if k != "shapes"}}},
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention/kernel.py:64",
         "launches": launches["flash_attention"],
         "launches_by_route": by_route["flash_attention"],
         "max_abs_err": max(r["max_abs_err"] for r in checks["flash_attention"]),
         "ms": fa["ms"], "plain_ms": fa["plain_ms"], "bound_ms": fa["bound_ms"],
         "bound_by": fa["bound_by"], "library_ms": fa["library_ms"],
         "unit": (f"one call (the V pre-pass, then the attention kernel; training's "
                  f"forward splits P and skips the pre-pass) at B={fa['B']}, "
                  f"H={fa['H']}, KV={fa['KV']}, S={fa['S']}, d={fa['d']}, bf16, causal (22 per "
                  f"{ARCH} prefill forward, 6 per {HYBRID_ARCH})"),
         "prepass_ms": fa["prepass_ms"],
         "scaled_v_check": checks["flash_attention_scaled_v"],
         "ptxas": ptxas["flash_attention"],
         HYBRID_ARCH: {"unit": (f"one launch at B={fa_hybrid['B']}, H={fa_hybrid['H']}, "
                                f"KV={fa_hybrid['KV']}, S={fa_hybrid['S']}, d={fa_hybrid['d']}, "
                                "bf16, causal"),
                       **{k: fa_hybrid[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                    "library_ms", "max_abs_err", "prepass_ms")}},
         "by_arch": {r["arch"]: {k: r[k] for k in ("H", "KV", "d", "ms", "plain_ms", "bound_ms",
                                                   "bound_by", "library_ms", "max_abs_err",
                                                   "prepass_ms")}
                     for r in checks["flash_attention"][4:]},
         "launches_by_path": {k: p["flash_attention"] for k, p in paths.items()},
         "training": {"launches_per_step": trained["launches_per_step"]["flash_attention"],
                      "launches_by_route": trained["launches_by_route"]["flash_attention"],
                      "backward": backward(
                          "flash_attention", fb,
                          f"one call (three launches) at B={fb['B']}, H={fb['H']}, KV={fb['KV']}, "
                          f"S={fb['S']}, d={fb['d']}, bf16, causal; library: {fb['library']}",
                          {"launches_by_route": {
                              r: sum(p["flash_attention_by_route"][r] for p in bwd_paths.values())
                              for r in flash_ops.BWD_ROUTES.values()},
                           **{k: fb[k] for k in ("eager_ms", "kernel_eager_call_ms",
                                                 "library_fwd_bwd_ms")}}),
                      "train_shape_check": trained["flash_train_shape"],
                      "backward_ms_per_step": (trained["flash_train_shape"]["layers_per_step"]
                                               * fb["eager_ms"])}},
        {"name": "ssd_scan", "route": "cuda",
         "source": "src/repro_torch/csrc/ssd_scan.cu",
         "replaces": "src/repro/kernels/ssd_scan/kernel.py:61",
         "launches": launches["ssd_scan"],
         "max_abs_err": max(r["max_abs_err"] for r in checks["ssd_scan"]),
         "ms": ssd["ms"], "plain_ms": ssd["plain_ms"], "bound_ms": ssd["bound_ms"],
         "bound_by": ssd["bound_by"], "bound_tc_ms": ssd["bound_tc_ms"], "library_ms": None,
         "library_note": "no single PyTorch call computes the chunked SSD",
         "unit": (f"one launch at B={ssd['B']}, S={ssd['S']}, H={ssd['H']}, P={ssd['P']}, "
                  f"N={ssd['N']}, Q={ssd['Q']}, fp32 (48 per {SSM_ARCH} prefill forward, "
                  f"38 per {HYBRID_ARCH}); bound_ms at the fp32 FFMA rate, bound_tc_ms "
                  "at 3 bf16 tensor-core products each"),
         HYBRID_ARCH: {"unit": f"one launch at N={ssd_hybrid['N']}, otherwise as above",
                       **{k: ssd_hybrid[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                     "bound_tc_ms", "max_abs_err")}},
         "launches_by_path": {k: p["ssd_scan"] for k, p in paths.items()},
         "training": {"backward": backward(
             "ssd_scan", sb, f"one call (two launches) at B={sb['B']}, S={sb['S']}, H={sb['H']}, "
             f"P={sb['P']}, "
             f"N={sb['N']}, Q={sb['Q']}, fp32 ({SSM_ARCH}'s train shape); bound_ms at the "
             "fp32 FFMA rate, bound_tc_ms at 3 bf16 tensor-core products each",
             {"library_note": "no single PyTorch call computes it",
              "bound_tc_ms": sb["bound_tc_ms"]}),
             "train_grads_timing": grads["ssd_backward"]}},
        sim_entry,
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
    cfgs = [get_arch(a) for a in (ARCH, SSM_ARCH, HYBRID_ARCH, MOE_ARCH, AUDIO_ARCH)]
    cfgs += [dataclasses.replace(get_arch(a), n_layers=n) for a, n in DEPTH_CUTS.items()]
    results: dict = {}

    phase_s: dict = {}

    def run(name, fn, *a):
        t0 = time.perf_counter()
        results[name] = fn(*a)
        phase_s[name] = time.perf_counter() - t0
        # phase_s last: a serve phase's stats have a wall_s of their own
        emit({"phase": name, "wall_s": phase_s[name],
              **{k: v for k, v in results[name].items() if k not in KERNELS},
              "phase_s": phase_s[name]})

    t_start = time.perf_counter()
    run("device", phase_device)
    run("build", phase_build)
    # the mesh phase's dry-run (d) runs on the host from here on, beside the
    # card; its processes are stopped whatever happens
    dry_dir = ROOT / "chiprun_out" / "dryrun_torch"
    dry_procs = dryrun_start(dry_dir)
    dryrun = (dry_procs, dry_dir, time.time())
    try:
        run("kernel_checks", phase_kernel_checks, cfgs, dev)
        run("build_logs", phase_build_logs)
        paths, routes = {}, {}
        for cfg, phases in [
                (cfgs[0], [("prefill", phase_prefill), ("serve", phase_serve)]),
                (cfgs[1], [("prefill_mamba2", phase_prefill_mamba2),
                           ("serve_mamba2", phase_serve_mamba2)]),
                (cfgs[2], [("prefill_zamba2", phase_prefill_zamba2),
                           ("serve_zamba2", phase_serve_zamba2)]),
                (cfgs[3], [("prefill_granite_moe", family_prefill),
                           ("serve_granite_moe", family_serve)]),
                (cfgs[4], [("prefill_musicgen", family_prefill), ("serve_musicgen", family_serve)]),
                (cfgs[5], [("prefill_llava", family_prefill)]),
                (cfgs[6], [("prefill_dbrx", family_prefill)])]:
            params = init_params(cfg, torch.Generator(dev).manual_seed(args.seed), dev)
            for name, fn in phases:
                run(name, fn, cfg, params, dev, args.seed)
                paths[name] = results[name]["launches"]
                routes[name] = results[name]["launches_by_route"]
            if cfg.name == ARCH:
                run("profile", phase_profile, cfg, params, dev)
            del params
            free_memory()
        run("prefill_dense_wide", phase_prefill_dense_wide, cfgs[7:], dev, args.seed)
        run("train_tinyllama", phase_train_tinyllama, cfgs[0], dev, args.seed)
        run("train_replay", phase_train_replay, dev, args.seed)
        for name in ("prefill_dense_wide", "train_tinyllama", "train_replay"):
            paths[name] = results[name]["launches"]
            routes[name] = results[name]["launches_by_route"]
        run("train_grads", phase_train_grads, dev, args.seed)
        # the simulator's phases, the kernel's launch count set to 0 before
        # each; each phase reports its main path's launches alone (its state
        # comparison, timing and planted-fault runs do not count)
        sim_paths, sim_routes = {}, []
        for name, fn in (("sweep_service", phase_sweep_service), ("sim_batch", phase_sim_batch),
                         ("traced_sweep", phase_traced_sweep)):
            sim_ops.sim_batch.launches = 0
            run(name, fn, dev, args.seed)
            sim_paths[name] = results[name]["kernel_launches"]
            sim_routes.append(results[name]["kernel_launches_by_route"])
            check(sim_paths[name] > 0, f"{name} never launched the sim_batch kernel")
        sim_routes = sim_routes_sum(sim_routes)
        check(sum(sim_routes.values()) == sum(sim_paths.values()),
              f"sim_batch launches by route {sim_routes}, by path {sim_paths}")
        run("mesh", phase_mesh, cfgs, dev, args.seed, dryrun,
            results["sweep_service"]["tracked"]["service_wall_s"],
            results["device"]["nvidia_smi"])
        paths["mesh"] = results["mesh"]["launches"]
        routes["mesh"] = results["mesh"]["launches_by_route"]
        bwd_paths = {name: results[name]["backward_launches"] for name in
                     ("train_tinyllama", "train_replay", "train_grads", "mesh")}
        for name, got in bwd_paths.items():
            check(got["flash_attention"] + got["ssd_scan"] > 0,
                  f"{name} launched no backward kernel: {got}")
        line = kernels_line(cfgs, results["kernel_checks"], paths, routes,
                            results["train_tinyllama"], results["train_grads"], bwd_paths,
                            sim_kernel_entry(results["sim_batch"], sim_paths, sim_routes),
                            results["build_logs"]["ptxas"])
        for k in line["kernels"]:
            check(k["launches"] > 0, f"{k['name']} never launched on the main path")
            if k["name"] in BWD_SOURCES:
                check(k["training"]["backward"]["launches"] > 0,
                      f"{k['name']}'s backward never launched on the training paths")
        out_dir = ROOT / "chiprun_out"
        out_dir.mkdir(exist_ok=True)
        total_s = time.perf_counter() - t_start
        (out_dir / "chip_smoke.json").write_text(json.dumps(
            {**results, **line, "phase_s": phase_s, "total_s": total_s}, indent=1))
        emit({"phase_walls_s": phase_s, "total_s": total_s})
        emit(line)
        emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                     "count": torch.cuda.device_count()}})
        return 0
    finally:
        for proc in dry_procs:
            proc.kill()


if __name__ == "__main__":
    sys.exit(main())
