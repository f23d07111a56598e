"""Error-feedback int8 gradient compression (port of
``repro.optim.compression``).

Each gradient leaf is quantized to ``bits`` with a per-leaf scale; the
quantization error is kept in an error-feedback buffer (fp32, shaped like
the gradient) and added back at the next step.  ``torch.round`` rounds half
to even, as ``jnp.round`` does, so the quantized values are the reference's.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..tree import tree_leaves, tree_map


@dataclass(frozen=True)
class CompressionConfig:
    enabled: bool = True
    bits: int = 8
    ef: bool = True  # error feedback


def _quantize(x: torch.Tensor, bits: int) -> torch.Tensor:
    x = x.float()
    qmax = float(2 ** (bits - 1) - 1)
    scale = torch.clamp(torch.max(torch.abs(x)), min=1e-12) / qmax
    q = torch.clamp(torch.round(x / scale), -qmax, qmax)
    return q * scale  # dequantized value (int8 on the wire)


def compress_gradients(grads, err_state, cfg: CompressionConfig):
    """Returns (compressed_grads, new_err_state, stats)."""
    if err_state is None:
        err_state = tree_map(lambda g: torch.zeros_like(g, dtype=torch.float32), grads)

    def one(g, e):
        g32 = g.float()
        corrected = g32 + (e if cfg.ef else 0.0)
        q = _quantize(corrected, cfg.bits)
        new_e = corrected - q if cfg.ef else torch.zeros_like(g32)
        return q.to(g.dtype), new_e

    out = tree_map(one, grads, err_state)     # (q, new_e) pairs, matched by key
    comp = tree_map(lambda o: o[0], out)
    new_err = tree_map(lambda o: o[1], out)
    err_norm = torch.sqrt(sum(torch.sum(torch.square(e)) for e in tree_leaves(new_err)))
    return comp, new_err, {"compression_err_norm": err_norm}
