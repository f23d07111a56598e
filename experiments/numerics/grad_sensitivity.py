"""How far a smoke model's bf16 gradients move, kernel path against plain
path, when only the rounding of the attention forward changes.

    PYTHONPATH=src python experiments/numerics/grad_sensitivity.py \\
        [--arch zamba2-1.2b] [--seeds 1 2 3] [--device cpu|cuda] [--forms ...] [--leaves]

Builds the arch's smoke config in bf16 under remat "full" with weights from
seed 0 and, for each batch seed, B=2 x S=40 tokens, as
``tests/test_torch_gpu.py``'s gradient test draws them on its device.  Runs
``grads_of`` on the plain path, then on the kernel path with
``flash_attention``'s forward (``ops._attend``) as one of these forms:

- ``kernel``: as it is (on CUDA tensors the kernel, on CPU tensors the
  plain version);
- ``exact``: ``attention_lse_ref``, the plain path's own output bits;
- ``split`` / ``fp16`` / ``bf16``: ``tests/flash_numerics.py``'s
  emulation with P in that form (the kernel's forward under autograd,
  its forward without, FA2/FA3's), with ``attention_lse_ref``'s LSE;
- ``fp16_normal``: fp16 P scaled by 2^15 before its rounding, so that no P
  above 2^-29 leaves fp16's normal range (fp16 P loses bits below 2^-14);
- ``fp16_lsum``: fp16 P with the row sum l taken over the rounded P.

Prints one line per seed: each form's largest per-leaf relative L2 (the
reading the gradient test holds to 5e-2 in bf16), the leaf it is at, and
the loss's relative difference from the plain path's; with ``--leaves``
every leaf's, beside its shape and its plain gradient's norm.  A few
seconds a form on the CPU.
"""
import argparse
import dataclasses
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2] / "tests"))

from flash_numerics import P_FORMS, wgmma_numerics  # noqa: E402

from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.kernels.flash_attention import ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_lse_ref  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.runtime import grads_of  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

P_FORMS["fp16_normal"] = (lambda p: (p * 2.0 ** 15).half().float() * 2.0 ** -15, True)
FORMS = ["kernel", "exact", "split", "fp16", "bf16", "fp16_normal", "fp16_lsum"]


def forward_as(form):
    """``ops._attend`` in the given form (None: as it is)."""
    if form == "kernel":
        return None

    def attend(q, k, v, causal, with_lse, split_p=False):
        o, lse = attention_lse_ref(q, k, v, causal)
        if form == "fp16_lsum":
            o = wgmma_numerics(q, k, v, causal, "fp16", l_sums_rounded=True)
        elif form != "exact":
            o = wgmma_numerics(q, k, v, causal, form)
        return o, (lse if with_lse else None)
    return attend


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="zamba2-1.2b")
    ap.add_argument("--seeds", type=int, nargs="+", default=[1, 2, 3])
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--forms", nargs="+", default=FORMS[:5], choices=FORMS)
    ap.add_argument("--leaves", action="store_true")
    args = ap.parse_args()
    dev = torch.device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_smoke(args.arch), dtype="bfloat16", remat="full")
    params = lm.init_params(cfg, torch.Generator(dev).manual_seed(0), dev)
    real = ops._attend
    for seed in args.seeds:
        toks = torch.randint(0, cfg.vocab, (2, 40), device=dev,
                             generator=torch.Generator(dev).manual_seed(seed))
        batch = {"tokens": toks, "labels": toks}
        loss_p, _, plain = grads_of(cfg, params, batch, kernels=False)
        plain = tree_leaves(plain)
        errs, dloss = {}, {}
        for form in args.forms:
            ops._attend = forward_as(form) or real
            try:
                loss, _, got = grads_of(cfg, params, batch)
            finally:
                ops._attend = real
            dloss[form] = float((loss.float() - loss_p.float()).abs() / loss_p.float().abs())
            errs[form] = [float((a.float() - b.float()).norm()
                                / b.float().norm().clamp_min(1e-30))
                          for a, b in zip(tree_leaves(got), plain)]
        print(f"{args.arch} {args.device} seed {seed}: " + ", ".join(
            f"{f} {max(e):.3e} (leaf {e.index(max(e))}, loss {dloss[f]:.1e})"
            for f, e in errs.items()), flush=True)
        if args.leaves:
            print("  leaf shape |plain grad| " + " ".join(args.forms))
            for i, b in enumerate(plain):
                print(f"  {i} {tuple(b.shape)} {float(b.float().norm()):.3e} "
                      + " ".join(f"{errs[f][i]:.2e}" for f in args.forms), flush=True)


if __name__ == "__main__":
    main()
