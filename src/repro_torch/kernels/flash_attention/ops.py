"""Wrapper: blocked causal GQA attention on the hand-written Hopper kernel.

``flash_attention(q, k, v)`` runs the plain version (``ref.attention_ref``)
when q, k and v lie on the CPU.  For CUDA tensors it checks them and launches
``csrc/flash_attention.cu`` on the current stream; anything the kernel does
not take raises.  Unlike the TPU wrapper, S need not be a multiple of the
block: the kernel masks the ragged edge.  The route follows from the dtype:
``"wgmma"`` for bf16 (TMA ring feeding wgmma), ``"fp32"`` for float32 (CUDA
cores).  ``flash_attention.launches`` counts the launches and
``flash_attention.launches_by_route`` counts them per route.

Gradients: where grad is enabled and q, k or v requires it, the call runs
inside ``FlashAttentionFn``, whose forward launches the kernel and whose
backward (``flash_vjp``) recomputes the plain version under autograd on
detached inputs and returns its gradients: the GQA group sum and the causal
mask come with it.  The JAX package has no backward kernel either (it
differentiates XLA einsums); a Hopper backward kernel is later work.
"""
from __future__ import annotations

import ctypes
import math

import torch

from .. import _build
from .ref import attention_ref

HEAD_DIMS = (16, 32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
ROUTES = {torch.bfloat16: "wgmma", torch.float32: "fp32"}


def _library():
    lib = _build.load("flash_attention")
    fn = lib.flash_attention_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """q: (B, H, S, d); k/v: (B, KV, S, d) -> (B, H, S, d) in q's dtype;
    differentiable."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttentionFn.apply(q, k, v, causal)
    return _attend(q, k, v, causal)


def flash_vjp(q, k, v, causal: bool, do):
    """(dq, dk, dv): the plain version recomputed under autograd (its fp32
    scores, B x H x S x S, live only for this call)."""
    with torch.enable_grad():
        q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
        out = attention_ref(q, k, v, causal)
        return torch.autograd.grad(out, (q, k, v), do)


class FlashAttentionFn(torch.autograd.Function):
    """``flash_attention``: the kernel forward, the plain recompute backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        ctx.save_for_backward(q, k, v)
        ctx.causal = causal
        return _attend(q, k, v, causal)

    @staticmethod
    def backward(ctx, do):
        return (*flash_vjp(*ctx.saved_tensors, ctx.causal, do), None)


def _attend(q, k, v, causal: bool) -> torch.Tensor:
    """The plain version for CPU tensors, else one launch of the kernel."""
    if all(t.device.type == "cpu" for t in (q, k, v)):
        return attention_ref(q, k, v, causal)
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError("flash_attention: q, k, v must all be on the CPU or "
                         "on one CUDA device")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: dtypes {q.dtype}, {k.dtype}, "
                        f"{v.dtype}; need all float32 or all bfloat16")
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(f"flash_attention: shapes {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, H, S, d = q.shape
    KV = k.shape[1]
    if (k.shape[0], k.shape[2], k.shape[3]) != (B, S, d) or H % KV:
        raise ValueError(f"flash_attention: k/v {tuple(k.shape)} do not match "
                         f"q {tuple(q.shape)} (need equal B, S, d; KV | H)")
    if d not in HEAD_DIMS or S == 0:
        raise ValueError(f"flash_attention: head_dim {d} not in {HEAD_DIMS} "
                         f"or empty sequence")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: q, k, v must be contiguous")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention: q, k, v must be 16-byte aligned")
    out = torch.empty_like(q)
    launch = _library()
    with torch.cuda.device(q.device):
        err = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                     B * H, S, d, H // KV, int(causal), _DTYPES[q.dtype],
                     1.0 / math.sqrt(d), torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention kernel launch failed: cudaError {err}")
    flash_attention.launches += 1
    flash_attention.launches_by_route[ROUTES[q.dtype]] += 1
    return out


flash_attention.launches = 0
flash_attention.launches_by_route = dict.fromkeys(ROUTES.values(), 0)

__all__ = ["FlashAttentionFn", "attention_ref", "flash_attention", "flash_vjp"]
