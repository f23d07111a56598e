"""Emulate the P V precision of ``csrc/flash_attention.cu``'s bf16 forward on
the CPU, in the three forms of P.

    PYTHONPATH=src python experiments/numerics/flash_p_emulation.py

Runs the test module's ``_wgmma_numerics`` (S = Q K^T in fp32, an online
softmax over 128-key tiles, one rounding of the output) at the
configurations and seed of ``tests/test_torch_flash_attention.py``'s limit
test, with P V as ``split`` (P in bf16 hi + lo, two products: the kernel's
forward that writes the LSE), ``fp16`` (P in fp16 against V scaled to fp16
per KV head: its forward without the LSE) and ``bf16`` (P rounded once to
bf16, as FA2/FA3 round it), and prints for each the worst query head's
share of the flash check's elementwise limit (rtol 1e-2, atol 1e-3 times
the head's V scale; above 1 fails) and its relative L2 against the JAX
package's ``attention_ref`` (limit 1e-2).  Imports the test module, so it
needs the JAX package too; ~20 s on a few CPU cores.
"""
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2] / "tests"))

import test_torch_flash_attention as t  # noqa: E402
from test_torch_parity import to_jax, to_torch  # noqa: E402

CONFIGS = {"s1024": dict(B=2, H=8, KV=1, S=1024, d=64),
           "s63": dict(B=1, H=4, KV=1, S=63, d=128),
           "gqa128": dict(B=1, H=8, KV=2, S=1024, d=128),
           "v_scaled": dict(B=1, H=8, KV=2, S=1024, d=128, v_scales=[2.0 ** 20, 2.0 ** -20])}


def worst_head(got, want, head_scales) -> tuple[float, float]:
    got, want = got.float(), want.float()
    share, l2 = 0.0, 0.0
    for h, sc in enumerate(head_scales.tolist()):
        g, w = got[:, h], want[:, h]
        lim = t.FLASH_TOL["atol"] * sc + t.FLASH_TOL["rtol"] * w.abs()
        share = max(share, float(((g - w).abs() / lim).max()))
        l2 = max(l2, float((g - w).norm() / w.norm().clamp_min(1e-30)))
    return share, l2


def main() -> None:
    for name, cfg in CONFIGS.items():
        q, k, v, head_scales = t._scaled_qkv(**cfg)
        want = to_torch(t.jax_attention_ref(*(to_jax(a.float().numpy(), "bfloat16")
                                              for a in (q, k, v)))).float()
        row = []
        for mode in ("split", "fp16", "bf16"):
            share, l2 = worst_head(t._wgmma_numerics(q, k, v, True, mode), want, head_scales)
            row.append(f"{mode} {share:.3f} of the limit (rel L2 {l2:.1e})")
        print(f"{name} {cfg}: " + "; ".join(row), flush=True)


if __name__ == "__main__":
    torch.set_num_threads(4)
    main()
