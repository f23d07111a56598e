"""Where a tick of the batch simulator's kernel spends its cycles, on the card.

    PYTHONPATH=src python3 experiments/sim_kernel_phases.py

Writes an instrumented copy of ``csrc/sim_batch.cu`` (``PATCHES``: ``clock64``
laps around each part of the tick, and the ticks and issues, summed over a
chunk's lanes into a ``__device__`` array that ``sim_batch_phases`` reads and
zeroes) to ``build/kernels/sim_batch_phases-<hash>.cu``, builds it with the
kernel's own flags, runs chip_smoke's chunks (the tracked sweep's widest and
its RFC chunk, and an 8-lane chunk of ``sim_batch``'s comparison, as
``experiments/sim_kernel_ab.py`` builds them) once each, and prints one JSON
line: per chunk the cycles a tick in each phase (a lane's average), issues
a tick, and the instrumented launch's µs a tick; the cycles of each kind of
dependent step the kernel chains (``experiments/sim_step_latency.cu``: a
shared-memory load, a ``redux.sync``, a shuffle, a ballot, a ``match.any``,
a ``__syncwarp``, a float64 add and division, a float64 to int64 round trip,
``clock64``); a latency floor worked out from the code (``latency_floor``);
the SM clock; the card's name and power limit.  The timers add their own
cycles; the shares, not the sum, are the reading.  Each patch's anchor must
occur once in the source, so a kernel that moves on fails here, not quietly.
"""
import ctypes
import hashlib
import json
import subprocess
from pathlib import Path

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.sim_batch import ops
from repro_torch.sim import batch

import sim_kernel_ab as ab

PHASES = ("wake", "activation", "issue_slots", "issue_rfc_lookup", "issue_collector",
          "issue_counters_lru", "issue_tail", "issue_edge_prefetch", "issue_refresh_cf",
          "retire_admit", "classify_next_event")
PRELUDE = """enum { PH_WAKE, PH_ACT, PH_SLOTS, PH_RFC, PH_COL, PH_LRU, PH_TAIL, PH_EDGE, PH_CF,
       PH_POST, PH_CLASS, PH_TICKS, PH_ISSUES, NPH };
__device__ unsigned long long sb_phases[NPH];
#define SB_LAP(L, p) do { const long long now_ = clock64(); \\
  (L).ph[p] += now_ - (L).lap; (L).lap = now_; } while (0)
"""
LAP = "  SB_LAP(L, {});\n"
# (anchor, text put before it, text put after it): each anchor occurs once
PATCHES = (
    ("// ---------------------------------------------------------------- the image\n",
     PRELUDE, ""),
    ("  int64_t ch, ca, cm, cpo, cpc, cps, cwb, cact;\n", "",
     "  long long ph[NPH] = {};\n  long long lap = 0;\n"),
    ("  const int64_t n_hit = popc(found), n_miss = popc(valid & ~found);\n", "",
     LAP.format("PH_RFC")),
    ("  sfail = opnd && !ok;\n", "", LAP.format("PH_COL")),
    ("  const double read_lat = (L.rfc && n_miss > 0) ? L.mrfc : L.rl0;\n",
     LAP.format("PH_LRU"), ""),
    ("  const int64_t npce = ext ? pcs : npc;\n", "", LAP.format("PH_TAIL")),
    ("  // the warp-family row (:924-942) and its readiness row\n", LAP.format("PH_EDGE"), ""),
    ("  if (happened) refresh_cf(L, D, wsel, mn(npce, static_cast<int64_t>(D.P)));\n", "",
     LAP.format("PH_CF") + "  L.ph[PH_ISSUES] += 1;\n"),
    ("    issue_one(L, D, L.act[a], cycf, h, sf);\n", "  " + LAP.format("PH_SLOTS"), ""),
    ("  // deferred DONE marks (:1006-1008), then", LAP.format("PH_SLOTS"), ""),
    ("  L.ptr += nadm;\n  sync();\n", "", LAP.format("PH_POST")),
    ("  // wake: WAIT->READY, PREFETCH->ACTIVE", "  L.lap = clock64();\n  L.ph[PH_TICKS] += 1;\n",
     ""),
    ("  activation(L, D, cand);\n", LAP.format("PH_WAKE"), LAP.format("PH_ACT")),
    ("  activation(L, D, ready_warps(L, D));\n", "", LAP.format("PH_ACT")),
    ("  L.cycle += delta;\n  sync();\n", "", LAP.format("PH_CLASS")),
    ("    *plane<uint8_t>(a, PL_budget, k) = L.budget;\n", "",
     "    for (int p = 0; p < NPH; ++p)\n"
     "      atomicAdd(&sb_phases[p], static_cast<unsigned long long>(L.ph[p]));\n"),
)
READER = """
#if defined(__CUDACC__)
// The phase sums since the last call: NPH values.
extern "C" int sim_batch_phases(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, sb_phases, sizeof(sb_phases));
  if (err != cudaSuccess) return err;
  const unsigned long long zero[NPH] = {};
  return cudaMemcpyToSymbol(sb_phases, zero, sizeof(zero));
}
#endif
"""


def instrumented(text: str) -> str:
    """The kernel's source with ``PATCHES`` applied and ``READER`` appended."""
    for anchor, before, after in PATCHES:
        if text.count(anchor) != 1:
            raise RuntimeError(f"sim_kernel_phases: anchor found {text.count(anchor)} times, "
                               f"not once: {anchor!r}")
        text = text.replace(anchor, before + anchor + after)
    return text + READER


def library() -> ctypes.CDLL:
    text = instrumented((_build.CSRC / "sim_batch.cu").read_text())
    flags = _build.flags("sim_batch")
    tag = hashlib.sha256(" ".join(flags).encode() + text.encode()).hexdigest()[:12]
    src = _build.BUILD_DIR / f"sim_batch_phases-{tag}.cu"
    out = src.with_suffix(".so")
    if not out.exists():
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        src.write_text(text)
        subprocess.run([_build._nvcc(), *flags, "-o", str(out), str(src)], check=True,
                       capture_output=True)
    lib = ctypes.CDLL(str(out))
    lib.sim_batch_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.sim_batch_phases.argtypes = [ctypes.c_void_p]
    return lib


STEPS = ("lds64", "redux", "shfl", "ballot", "match_any", "syncwarp", "dadd", "ddiv_dadd",
         "d2l_dmul_dadd_l2d", "clock64")


def step_latency() -> dict:
    """Cycles a dependent step of each kind takes (sim_step_latency.cu)."""
    src = _build.CSRC.parents[2] / "experiments" / "sim_step_latency.cu"
    out = _build.BUILD_DIR / "sim_step_latency.so"
    subprocess.run([_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-O3",
                    "-shared", "-Xcompiler", "-fPIC", "-o", str(out), str(src)], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(str(out))
    vals = (ctypes.c_double * len(STEPS))()
    assert lib.step_latency(vals) == 0
    return dict(zip(STEPS, vals))


# The dependent steps on a tick's critical path, counted by hand off
# csrc/sim_batch.cu for a tick with no activation and no edge prefetch (the
# common one): loads whose address needs the previous load, warp
# reductions whose input needs the previous one, and the syncs between a
# step's reads and its writes.  Per tick: the wake (the warp rows, one
# ballot, a sync), the slot set-up (the active list, then the positions'
# rows), one `redux` an issue slot, the retirement (a sync, the ballots,
# one `redux` for the write-backs, a sync), the second activation's rows
# and ballot, the next event (the rows, one `redux`, a sync).  Per issue:
# the active list's entry, the warp's row, its meta row, the collectors and
# their argmin (two `redux`, a sync), the loop counters' row, a sync before
# the row's writes, the readiness row's two dependent loads, the position's
# reload.  Per issue on an RFC lane: the key index's entry of each operand,
# one ballot; per miss: the operand's key (a shuffle), the index again, the
# victim's argmin (two `redux`), the evicted entry's key, a sync.
FLOOR_TICK = {"lds64": 2 + 2 + 1 + 1, "ballot": 1 + 1 + 1, "redux": 1 + 1, "syncwarp": 4}
FLOOR_ISSUE = {"lds64": 1 + 1 + 1 + 1 + 1 + 2 + 1, "redux": 2, "syncwarp": 2}
FLOOR_RFC_ISSUE = {"lds64": 1, "ballot": 1}
FLOOR_RFC_MISS = {"shfl": 1, "lds64": 2, "redux": 2, "syncwarp": 1}


def latency_floor(step_cycles, issue_width, issues_a_tick, rfc, misses_an_issue) -> dict:
    """A floor on a tick's cycles worked out from the code: the critical
    path's dependent steps (above) times each step's measured latency."""
    def cycles(steps):
        return sum(n * step_cycles[k] for k, n in steps.items())
    tick = cycles(FLOOR_TICK) + issue_width * step_cycles["redux"]
    issue = cycles(FLOOR_ISSUE) + (cycles(FLOOR_RFC_ISSUE)
                                   + misses_an_issue * cycles(FLOOR_RFC_MISS) if rfc else 0.0)
    return {"cycles_a_tick": tick + issues_a_tick * issue}


def phases(lib, lanes) -> dict:
    dev = torch.device("cuda")
    co, st = batch._build(lanes)
    c, s = batch._place(co, dev), batch._place(batch._trash(st), dev)
    args = ops.kernel_args(c, s, batch._dims(co, st))
    sums = (ctypes.c_ulonglong * (len(PHASES) + 2))()
    lib.sim_batch_phases(sums)                     # zero them
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    err = lib.sim_batch_launch(ctypes.addressof(args), torch.cuda.current_stream().cuda_stream)
    e1.record()
    torch.cuda.synchronize()
    assert err == 0, err
    assert lib.sim_batch_phases(sums) == 0
    ticks, issues = sums[len(PHASES)], sums[len(PHASES) + 1]
    guard = int(s["guard"].item())
    n = len(lanes)
    rfc = bool(co["rfc"][:n].any())
    misses = float(s["cm"][:n].sum().item()) if rfc else 0.0
    return {"lanes": len(lanes), "ticks_all_lanes": ticks, "longest_lane_ticks": guard,
            "issues_a_tick": issues / ticks, "issue_width": int(co["slots"].shape[0]),
            "rfc": rfc, "misses_an_issue": misses / issues,
            "cycles_a_tick": {p: sums[i] / ticks for i, p in enumerate(PHASES)},
            "instrumented_us_a_tick": 1e3 * e0.elapsed_time(e1) / guard}


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("sim_kernel_phases: needs a CUDA card")
    lib = library()
    sweeps = ab.sweeps(ab.load_chip_smoke(Path(__file__).resolve().parents[1]))
    tracked = sweeps["tracked"]
    chunks = {"widest": max(tracked, key=len),
              "rfc": next(c for c in tracked if c[0].cfg.design == "RFC"),
              "narrow8": sweeps["narrow"][0]}
    out = {name: phases(lib, lanes) for name, lanes in chunks.items()}
    out["step_cycles"] = step_cycles = step_latency()
    out["sm_clock_mhz"] = clock = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    mhz = float(clock.split(",")[0].split()[0])
    for name in chunks:
        r = out[name]
        floor = latency_floor(step_cycles, r["issue_width"], r["issues_a_tick"], r["rfc"],
                              r["misses_an_issue"])
        r["latency_floor"] = {**floor, "us_a_tick": floor["cycles_a_tick"] / mhz,
                              "ms_longest_lane": floor["cycles_a_tick"] / mhz
                              * r["longest_lane_ticks"] / 1e3}
    out["card"] = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                  "--format=csv,noheader"], capture_output=True,
                                 text=True).stdout.strip()
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
