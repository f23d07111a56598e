"""Emulate the precision of ``csrc/ssd_scan_bwd.cu`` on the CPU.

    PYTHONPATH=src python experiments/numerics/ssd_bwd_emulation.py [--seeds 5]

Runs the backward of the SSD intra-chunk dual form at mamba2-1.3b's and
zamba2-1.2b's train shapes (B=2, S=1024, H=64, P=64, N=128 or 64, Q=256) on
seeded inputs at the Mamba2 block's scales, in four forms, and prints each
gradient's relative L2 against ``ssd_chunk_bwd_ref`` in float64:

- ``fp32``: every product in fp32, revcumsum(dcum) as the reverse cumsum of
  the row sums minus the column sums of dseg (the earlier kernel's form);
- ``tc``: five products (M^T dy, B dS^T, dG B, dG^T C, (de o xdt)^T dS) in
  bf16x3 (each operand split into a bf16 high and low part, three products,
  fp32 sums), G = C B^T and dM = dy xdt^T in fp32, the same difference form;
- ``tc+crossing``: as ``tc``, revcumsum(dcum)_i formed as the sum of dseg
  over the pairs (a, b) with a >= i > b, which the difference telescopes to;
- ``all_tc+crossing``: G and dM in bf16x3 too (the kernel's form).

cum and the reverse cumsums run in float64 in every form, as in the kernel.
Takes a few GB and ~1 min a seed on a few CPU cores.
"""
import argparse

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd_scan.ref import (_chunked, _clamp_grad, decay, ssd_chunk_bwd_ref,
                                              ssd_chunk_ref)

GRADS = ("dx", "ddt", "dA", "dB", "dC")
SHAPES = {"mamba2-1.3b": (2, 1024, 64, 64, 128, 256), "zamba2-1.2b": (2, 1024, 64, 64, 64, 256)}


def split(x):
    hi = x.bfloat16().float()
    return hi, (x - hi).bfloat16().float()


def mm3(a, b):
    """a @ b in bf16x3: the small products first, fp32 sums."""
    ah, al = split(a)
    bh, bl = split(b)
    return al @ bh + ah @ bl + ah @ bh


def backward(x, dt, A, Bm, Cm, Q, grads, tc, crossing, all_tc):
    mm = mm3 if tc else torch.matmul
    mm0 = mm3 if all_tc else torch.matmul
    xc, dtc, Bc, Cc = _chunked(x, dt, Bm, Cm, Q, torch.float32)
    gy, gst, gin, gcd = grads
    a = A.double()[:, None]
    cum = torch.cumsum(dtc.double() * a, dim=-1)
    cend = cum[..., -1:]
    seg = cum[..., :, None] - cum[..., None, :]
    L = torch.where(torch.ones((Q, Q), dtype=torch.bool).tril(), decay(seg.float()), 0.0)
    xdt = xc * dtc[..., None]
    G = mm0(Cc, Bc.transpose(-1, -2))
    de = decay((cend - cum).float())
    gM = mm0(gy, xdt.transpose(-1, -2))
    gxdt = mm((G * L).transpose(-1, -2), gy)
    gG = (gM * L).sum(2)
    gC = mm(gG, Bc[:, :, 0])
    gB = mm(gG.transpose(-1, -2), Cc[:, :, 0])
    gseg = gM * G * L * _clamp_grad(seg.float())
    st = mm(Bc, gst.transpose(-1, -2))
    gxdt = gxdt + de[..., None] * st
    gB = gB + mm(xdt * de[..., None], gst).sum(2)
    t = (xdt * st).sum(-1) * de * _clamp_grad((cend - cum).float())
    if crossing:
        T = torch.flip(torch.cumsum(torch.flip(gseg, (-2,)), -2), (-2,))   # sum over a >= i
        R = (T * torch.ones((Q, Q), dtype=torch.bool).tril(-1)).sum(-1).double()
    else:
        diff = gseg.sum(-1).double() - gseg.sum(-2).double()
        R = torch.flip(torch.cumsum(torch.flip(diff, (-1,)), -1), (-1,))
    g = R + torch.cumsum(t.double(), -1) - t.double()
    gin_terms = (gin * decay(cum.float()) * _clamp_grad(cum.float())).double()
    g = g + torch.flip(torch.cumsum(torch.flip(gin_terms, (-1,)), -1), (-1,))
    g = g + (gcd[..., 0] * decay(cend[..., 0].float())
             * _clamp_grad(cend[..., 0].float())).double()[..., None]
    gdtc = (gxdt * xc).sum(-1) + (g * a).float()
    gA = (g * dtc.double()).sum((0, 1, 3))
    Bsz, S = x.shape[:2]
    nc = xc.shape[1]
    gx = (gxdt * dtc[..., None]).transpose(2, 3).reshape(Bsz, nc * Q, -1, x.shape[-1])[:, :S]
    gdt = gdtc.transpose(2, 3).reshape(Bsz, nc * Q, -1)[:, :S]
    gB, gC = (v.reshape(Bsz, nc * Q, -1)[:, :S] for v in (gB, gC))
    return gx, gdt, gA.float(), gB, gC


FORMS = {"fp32": dict(tc=False, crossing=False, all_tc=False),
         "tc": dict(tc=True, crossing=False, all_tc=False),
         "tc+crossing": dict(tc=True, crossing=True, all_tc=False),
         "all_tc+crossing": dict(tc=True, crossing=True, all_tc=True)}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, default=5)
    args = ap.parse_args()
    for name, (B, S, H, P, N, Q) in SHAPES.items():
        for seed in range(args.seeds):
            g = torch.Generator().manual_seed(100 + seed)
            x = F.silu(torch.randn(B, S, H, P, generator=g))
            dt = F.softplus(torch.randn(B, S, H, generator=g))
            A = -torch.linspace(1.0, 16.0, H)
            Bm, Cm = (F.silu(torch.randn(B, S, N, generator=g)) for _ in range(2))
            grads = tuple(torch.randn(o.shape, generator=g)
                          for o in ssd_chunk_ref(x, dt, A, Bm, Cm, Q))
            want = ssd_chunk_bwd_ref(*(t.double() for t in (x, dt, A, Bm, Cm)), Q,
                                     tuple(t.double() for t in grads))
            for form, kw in FORMS.items():
                got = backward(x, dt, A, Bm, Cm, Q, grads, **kw)
                errs = {n: float((a.double() - b).norm() / b.norm())
                        for n, a, b in zip(GRADS, got, want)}
                print(name, seed, form, {n: f"{e:.2e}" for n, e in errs.items()}, flush=True)


if __name__ == "__main__":
    main()
