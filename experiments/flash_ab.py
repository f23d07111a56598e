"""Time flash_attention's bf16 forward on the card, one tree of the port at a
time, at every shape of PERF.md's flash rows.

    python3 experiments/flash_ab.py --tree <tree> --label <name>

For an A/B comparison of two trees (a parent and a change) run it once per
tree, in turns (parent, change, change, parent), one after another on one
card.  ``--tree`` (default: this script's checkout) is the checkout whose
port and ``chip_smoke.py`` run: the script imports that ``chip_smoke.py``,
which puts the tree's ``src`` first on the path, and times with its
``time_ms`` (the calls replayed from one CUDA graph, CUDA events; the
inputs stay where the last call left them, as in ``kernel_checks``).  Rows:
``kernel_checks``' flash shapes (B=2, S=1024, causal, each model's heads and
head dim) and the train shape (B=8, tinyllama-1.1b's heads) with the LSE
written and, where the tree's ``_attend`` takes ``split_p``, P split, as
``FlashAttentionFn`` runs it.  Each row: the kernel's device ms,
``scaled_dot_product_attention``'s on the same inputs, the bound (bytes or
operations, ``chip_smoke.bound``), the kernel's largest error against
``attention_ref``; where the tree has the V pre-pass and the row runs it
(no LSE), its device ms a call from the profiler
(``chip_smoke.prepass_ms``).  Then
the tree's ``-Xptxas -v`` lines for the kernel and the card's name and power
limit.  Prints one JSON line.  The kernel builds at first use under the tree.
"""
import argparse
import importlib
import json
import math
import re
import subprocess
import sys
from inspect import signature
from pathlib import Path

# (row, arch, batch, with the LSE)
ROWS = [("tinyllama", "tinyllama-1.1b", 2, False), ("zamba2", "zamba2-1.2b", 2, False),
        ("granite-moe", "granite-moe-3b-a800m", 2, False), ("musicgen", "musicgen-large", 2, False),
        ("llava", "llava-next-34b", 2, False), ("dbrx", "dbrx-132b", 2, False),
        ("phi3", "phi3-medium-14b", 2, False), ("granite-20b", "granite-20b", 2, False),
        ("train", "tinyllama-1.1b", 8, True)]
S = 1024


def load_chip_smoke(tree: Path):
    """The tree's ``chip_smoke.py`` as a module (it puts the tree's ``src``
    first on the path, so the port imported after it is the tree's)."""
    sys.path.insert(0, str(tree.resolve()))
    return importlib.import_module("chip_smoke")


def time_row(cs, arch, B, with_lse, gen) -> dict:
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops
    cfg = cs.get_arch(arch)
    H, KV, d = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    dev = torch.device("cuda")
    q, k, v = (torch.randn(B, n, S, d, device=dev, generator=gen).bfloat16() for n in (H, KV, KV))
    # the train row as FlashAttentionFn runs it: P split where the tree has the choice
    kw = {"split_p": True} if with_lse and "split_p" in signature(ops._attend).parameters else {}
    got = ops._attend(q, k, v, True, with_lse, **kw)[0]
    err = float((got.float() - ops.attention_ref(q, k, v).float()).abs().max())
    ms, _ = cs.time_ms([lambda: ops._attend(q, k, v, True, with_lse, **kw)])
    sdpa, _ = cs.time_ms([lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                                 enable_gqa=True)])
    pairs = B * H * S * (S + 1) / 2
    bound, by = cs.bound((2 * q.numel() + k.numel() + v.numel()) * 2, 4 * d * pairs,
                         torch.bfloat16)
    rec = {"B": B, "H": H, "KV": KV, "S": S, "d": d, "lse": with_lse, **kw, "ms": ms,
           "sdpa_ms": sdpa,
           "vs_sdpa": ms / sdpa, "bound_ms": bound, "bound_by": by, "max_abs_err": err}
    if hasattr(cs, "prepass_ms") and not with_lse:
        rec["prepass_ms"] = cs.prepass_ms(q, k, v)
    return rec


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--label", required=True)
    ap.add_argument("--tree", type=Path, default=Path(__file__).resolve().parents[1])
    args = ap.parse_args()
    cs = load_chip_smoke(args.tree)
    import torch
    from repro_torch.kernels import _build
    if not torch.cuda.is_available():
        raise SystemExit("flash_ab: needs a CUDA card")
    _build.build(["flash_attention"])
    gen = torch.Generator(torch.device("cuda")).manual_seed(0)
    out = {"label": args.label, "tree": str(args.tree),
           "rows": {name: time_row(cs, arch, B, lse, gen) for name, arch, B, lse in ROWS}}
    out["geomean_vs_sdpa"] = math.exp(sum(math.log(r["vs_sdpa"]) for r in out["rows"].values())
                                      / len(out["rows"]))
    log = (_build.BUILD_DIR / "flash_attention.log").read_text()
    out["ptxas"] = [ln.strip() for ln in log.splitlines()
                    if re.search(r"registers|spill|Compiling entry|serializ", ln)]
    out["card"] = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                  "--format=csv,noheader"], capture_output=True,
                                 text=True).stdout.strip()
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
