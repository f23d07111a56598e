"""Time ltrf_matmul's bf16 forward on the card, one tree of the port at a
time, at every forward shape of ``chip_smoke.py``'s paths.

    python3 experiments/matmul_ab.py --tree <tree> --label <name> [--study]

For an A/B comparison of two trees (a parent and a change) run it once per
tree, in turns (parent, change, change, parent), one after another on one
card.  ``--tree`` (default: this script's checkout) is the checkout whose
port and ``chip_smoke.py`` run: the script imports that ``chip_smoke.py``,
which puts the tree's ``src`` first on the path, and times with its
``time_ms`` (the calls replayed from one CUDA graph, CUDA events), the
weights rotated over copies past the 50 MB L2 as ``kernel_checks`` does.
Rows: each model's projections and head as the tree's ``slice_matmuls``
holds them (the nine models ``chip_smoke.py`` prefills, M = 2048 rows), the
2048 x 32008 probe of ``kernel_checks``, and tinyllama-1.1b's train step
(M = 8192).  A row is keyed by its model and role, so a head the two trees
hold at different widths is one row.  Each row: M, K, N, the kernel's device
ms, ``torch.matmul``'s (cuBLAS) on the same inputs, the bound (bytes or
operations, ``chip_smoke.bound``), the kernel's largest error against
``matmul_ref`` and, where the tree has it, the forward's schedule (tile
width, tiles, data-parallel waves, streamed tiles and CTAs, the busiest
CTA's k-blocks).  Then the train step's backward products (layouts nt, dX =
dY w^T, and tn, dW = x^T dY, at M = 8192), which must not move: the
kernel's device ms and cuBLAS's.

``--study`` (a tree with ``ops.candidates``) also times every candidate
schedule of each forward row, each launched directly with that schedule,
beside the one the cost model picks and its predicted cost, and the ragged wave
split into slices shallower than the candidates' (the data the cost
model's constants come from).  Prints one JSON line.
The kernel builds at first use under the tree.
"""
import argparse
import importlib
import json
import math
import subprocess
import sys
from pathlib import Path

ARCHS = ("tinyllama-1.1b", "mamba2-1.3b", "zamba2-1.2b", "granite-moe-3b-a800m",
         "musicgen-large", "llava-next-34b", "dbrx-132b", "phi3-medium-14b", "granite-20b")
PREFILL_M, TRAIN_M = 2048, 8192
PROBE = ("probe 2048x32008", PREFILL_M, 2048, 32008)
ROLES = {0: "wq", 1: "wk/wv", 2: "wo", 3: "w_gate/w_up", 4: "w_down"}


def load_chip_smoke(tree: Path):
    """The tree's ``chip_smoke.py`` as a module (it puts the tree's ``src``
    first on the path, so the port imported after it is the tree's)."""
    sys.path.insert(0, str(tree.resolve()))
    return importlib.import_module("chip_smoke")


def rows(cs) -> list:
    """(label, M, K, N): each distinct forward shape once, labelled by the
    first model and role that launch it."""
    out, seen = [], set()

    def add(label, M, K, N):
        if (M, K, N) not in seen:
            seen.add((M, K, N))
            out.append((label, M, K, N))

    for arch in ARCHS:
        cfg = cs.get_arch(arch)
        mm = cs.slice_matmuls(cfg)
        for i, ((K, N), _) in enumerate(mm):
            role = "head" if i == len(mm) - 1 else (
                ROLES.get(i, f"#{i}") if cfg.family in cs.ATTN_FAMILIES else f"mixer#{i}")
            add(f"{arch} {role}", PREFILL_M, K, N)
    add(*PROBE)
    for i, ((K, N), _) in enumerate(cs.slice_matmuls(cs.get_arch("tinyllama-1.1b"))):
        add(f"train {K}x{N}", TRAIN_M, K, N)
    return out


def schedule_of(ops, M, K, N) -> dict:
    if not hasattr(ops, "schedule"):
        return {"bn": ops.pick_blocks(M, K, N, 2)[2]}
    s = ops.schedule(M, K, N)
    return describe(s)


def describe(s) -> dict:
    return {"bn": s.bn, "tiles": s.tiles, "dp_waves": (s.tiles - s.split_tiles) // 132,
            "split_tiles": s.split_tiles, "split": s.split, "grid": s.grid,
            "longest_blocks": s.longest(), "cost": s.cost()}


def sweep(ops, M, K, N) -> list:
    """The ragged wave's tiles cut into 2, 3, 4, 6 and 8 k-slices where
    ``candidates`` leaves them out for their depth (slices of 4 to 7
    k-blocks), up to one slice an SM."""
    out = []
    for bn in ((256, 128) if N > 128 else (128,)):
        dp = ops.data_parallel(M, K, N, bn)
        rem = dp.tiles % 132
        out += [ops.data_parallel(M, K, N, bn, s) for s in (2, 3, 4, 6, 8)
                if rem and s * rem <= 132 and 4 <= dp.n_k // s < ops.WGMMA_MIN_SLICE_BLOCKS]
    return out


def time_backward(cs, K, N, gen) -> dict:
    """The train step's dX (nt) and dW (tn) of x (TRAIN_M, K) @ w (K, N)."""
    import torch
    from repro_torch.kernels.ltrf_matmul import ops
    dev, M = torch.device("cuda"), TRAIN_M
    x = torch.randn(M, K, device=dev, generator=gen).bfloat16()
    w = (torch.randn(K, N, device=dev, generator=gen) / math.sqrt(K)).bfloat16()
    dy = (torch.randn(M, N, device=dev, generator=gen) / math.sqrt(N)).bfloat16()
    rec = {"label": f"train dX/dW {K}x{N}", "M": M, "K": K, "N": N}
    rec["dX_ms"], _ = cs.time_ms([lambda: ops._product(dy, w, "nt")], min_iters=5)
    rec["dW_ms"], _ = cs.time_ms([lambda: ops._product(x, dy, "tn")], min_iters=5)
    rec["dX_library_ms"], _ = cs.time_ms([lambda: torch.matmul(dy, w.t())], min_iters=5)
    rec["dW_library_ms"], _ = cs.time_ms([lambda: torch.matmul(x.t(), dy)], min_iters=5)
    return rec


def time_row(cs, label, M, K, N, gen, study: bool) -> dict:
    import torch
    from repro_torch.kernels.ltrf_matmul import ops
    dev = torch.device("cuda")
    x = torch.randn(M, K, device=dev, generator=gen).bfloat16()
    w = (torch.randn(K, N, device=dev, generator=gen) / math.sqrt(K)).bfloat16()
    copies = [w] + [w.clone() for _ in range(max(0, math.ceil(2 * cs.L2_BYTES / w.nbytes) - 1))]
    want = ops.matmul_ref(x, w).float()
    err = float((ops.ltrf_matmul(x, w).float() - want).abs().max())
    ms, _ = cs.time_ms([lambda w=c: ops.ltrf_matmul(x, w) for c in copies])
    lib, _ = cs.time_ms([lambda w=c: torch.matmul(x, w) for c in copies])
    bound, by = cs.bound((M * K + K * N + M * N) * 2, 2 * M * K * N, torch.bfloat16)
    rec = {"label": label, "M": M, "K": K, "N": N, "ms": ms, "library_ms": lib,
           "vs_library": ms / lib, "bound_ms": bound, "bound_by": by, "max_abs_err": err,
           "schedule": schedule_of(ops, M, K, N)}
    if study:
        rec["candidates"] = []
        for s in ops.candidates(M, K, N) + sweep(ops, M, K, N):
            out = torch.empty(M, N, dtype=torch.bfloat16, device=dev)

            def launch(w, s=s, out=out):
                ops._launch(x, w, out, K, "nn", (128, 64, s.bn), ops.wgmma_stages(s.bn), 1, s)
            launch(w)
            torch.cuda.synchronize()
            c_err = float((out.float() - want).abs().max())
            c_ms, _ = cs.time_ms([lambda w=c: launch(w) for c in copies])
            rec["candidates"].append({**describe(s), "ms": c_ms, "max_abs_err": c_err})
    del copies
    return rec


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--label", required=True)
    ap.add_argument("--tree", type=Path, default=Path(__file__).resolve().parents[1])
    ap.add_argument("--study", action="store_true")
    args = ap.parse_args()
    cs = load_chip_smoke(args.tree)
    import torch
    from repro_torch.kernels import _build
    if not torch.cuda.is_available():
        raise SystemExit("matmul_ab: needs a CUDA card")
    _build.build(["ltrf_matmul"])
    gen = torch.Generator(torch.device("cuda")).manual_seed(0)
    out = {"label": args.label, "tree": str(args.tree),
           "rows": [time_row(cs, *row, gen, args.study) for row in rows(cs)],
           "backward": [time_backward(cs, K, N, gen) for (K, N), _ in
                        dict.fromkeys(cs.slice_matmuls(cs.get_arch("tinyllama-1.1b")))]}
    out["geomean_vs_library"] = math.exp(sum(math.log(r["vs_library"]) for r in out["rows"])
                                         / len(out["rows"]))
    out["card"] = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                  "--format=csv,noheader"], capture_output=True,
                                 text=True).stdout.strip()
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
