"""Wrapper: blocked causal GQA attention on the hand-written Hopper kernel.

``flash_attention(q, k, v)`` runs the plain version (``ref.attention_ref``)
when q, k and v lie on the CPU.  For CUDA tensors it checks them and launches
``csrc/flash_attention.cu`` on the current stream; anything the kernel does
not take raises.  Unlike the TPU wrapper, S need not be a multiple of the
block: the kernel masks the ragged edge.  The route follows from the dtype:
``"wgmma"`` for bf16 (a persistent kernel: TMA rings feeding wgmma; P V
in fp16 against V written as fp16 times a power of two per KV head by a
pre-pass, or, in ``FlashAttentionFn``'s forward, P split into bf16 hi + lo
against the bf16 V), ``"fp32"`` for float32 (CUDA cores).
``flash_attention.launches`` counts the calls (a bf16 call's pre-pass and
kernel count once) and ``flash_attention.launches_by_route`` counts them
per route.

Gradients: where grad is enabled and q, k or v requires it, the call runs
inside ``FlashAttentionFn``, whose forward launches the kernel with its row
log-sum-exp (LSE) written too and P split (fp16 P's rounding moves a bf16
model's gradients several times further from the plain path's), and whose
backward is ``flash_bwd``: on CUDA
tensors the hand-written backward kernel ``csrc/flash_attention_bwd.cu``
(three launches: D = rowsum(dO o O), then dK and dV with the GQA group sum
inside each CTA, then dQ; no float atomics, so two runs give the same bits),
on CPU tensors its plain version ``ref.flash_bwd_ref``.  ``flash_bwd.launches``
counts the backward calls that launched the kernel, ``flash_bwd.launches_by_route``
the same per route (``"wgmma"`` for bf16: TMA rings feeding wgmma;
``"fp32"``: CUDA cores).  The JAX package has no backward kernel (it
differentiates XLA einsums).
"""
from __future__ import annotations

import ctypes
import math

import torch

from .. import _build
from .ref import attention_lse_ref, attention_ref, flash_bwd_ref

HEAD_DIMS = (16, 32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
ROUTES = {torch.bfloat16: "wgmma", torch.float32: "fp32"}
BWD_ROUTES = {torch.bfloat16: "wgmma", torch.float32: "fp32"}


def _library():
    lib = _build.load("flash_attention")
    fn = lib.flash_attention_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                       + [ctypes.c_float] + [ctypes.c_void_p] * 4)
        fn.restype = ctypes.c_int
    return fn


def _bwd_library():
    lib = _build.load("flash_attention_bwd")
    fn = lib.flash_attention_bwd_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 6
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """q: (B, H, S, d); k/v: (B, KV, S, d) -> (B, H, S, d) in q's dtype;
    differentiable."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttentionFn.apply(q, k, v, causal)
    return _attend(q, k, v, causal, with_lse=False)[0]


class FlashAttentionFn(torch.autograd.Function):
    """``flash_attention``: the kernel forward (with its LSE), the kernel
    backward (``flash_bwd``)."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        out, lse = _attend(q, k, v, causal, with_lse=True, split_p=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        return (*flash_bwd(q, k, v, out, lse, do, ctx.causal), None)


def _check(q, k, v, what: str):
    """Raise unless the kernels take q, k, v (on one CUDA device)."""
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(f"{what}: q, k, v must all be on the CPU or on one CUDA device")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{what}: dtypes {q.dtype}, {k.dtype}, {v.dtype}; need all "
                        "float32 or all bfloat16")
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(f"{what}: shapes {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, H, S, d = q.shape
    KV = k.shape[1]
    if (k.shape[0], k.shape[2], k.shape[3]) != (B, S, d) or H % KV:
        raise ValueError(f"{what}: k/v {tuple(k.shape)} do not match q {tuple(q.shape)} "
                         "(need equal B, S, d; KV | H)")
    if d not in HEAD_DIMS or S == 0:
        raise ValueError(f"{what}: head_dim {d} not in {HEAD_DIMS} or empty sequence")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError(f"{what}: q, k, v must be contiguous")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError(f"{what}: q, k, v must be 16-byte aligned")


def _attend(q, k, v, causal: bool, with_lse: bool, split_p: bool = False):
    """(output, fp32 LSE (B, H, S) or None): the plain version for CPU
    tensors, else one call of the kernel, which writes the LSE only when
    asked (the output's bits do not depend on it).  In bf16, P V takes P in
    fp16 against the pre-pass's fp16 V, or with ``split_p`` P in bf16 hi +
    lo against the bf16 V (two products a k-step, no pre-pass)."""
    if all(t.device.type == "cpu" for t in (q, k, v)):
        return attention_lse_ref(q, k, v, causal) if with_lse else (attention_ref(q, k, v, causal),
                                                                     None)
    _check(q, k, v, "flash_attention")
    B, H, S, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device) if with_lse else None
    v16 = vexp = None
    if q.dtype == torch.bfloat16:           # the pre-pass's exponents, + a tile counter
        vexp = torch.empty(B * k.shape[1] + 1, dtype=torch.int32, device=q.device)
        if not split_p:                     # the pre-pass's V
            v16 = torch.empty_like(v, dtype=torch.float16)
    launch = _library()
    with torch.cuda.device(q.device):
        err = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                     B * H, S, d, H // k.shape[1], int(causal), _DTYPES[q.dtype],
                     1.0 / math.sqrt(d), None if lse is None else lse.data_ptr(),
                     None if v16 is None else v16.data_ptr(),
                     None if vexp is None else vexp.data_ptr(),
                     torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention kernel launch failed: cudaError {err}")
    flash_attention.launches += 1
    flash_attention.launches_by_route[ROUTES[q.dtype]] += 1
    return out, lse


def flash_bwd(q, k, v, o, lse, do, causal: bool):
    """(dq, dk, dv), each in its input's dtype, for output gradient ``do``,
    from the forward's output ``o`` and fp32 LSE (B, H, S): the plain
    version (``flash_bwd_ref``) for CPU tensors, else the backward kernel
    (its three launches count once); anything it does not take raises."""
    if all(t.device.type == "cpu" for t in (q, k, v, o, lse, do)):
        return flash_bwd_ref(q, k, v, o, lse, do, causal)
    _check(q, k, v, "flash_bwd")
    do = do.contiguous()
    B, H, S, d = q.shape
    if (o.shape != q.shape or do.shape != q.shape or o.dtype != q.dtype
            or do.dtype != q.dtype or tuple(lse.shape) != (B, H, S)
            or lse.dtype != torch.float32 or not (o.is_contiguous() and lse.is_contiguous())
            or any(t.device != q.device for t in (o, lse, do))):
        raise ValueError(f"flash_bwd: o {tuple(o.shape)} {o.dtype}, lse {tuple(lse.shape)} "
                         f"{lse.dtype}, do {tuple(do.shape)} {do.dtype} do not match q "
                         f"{tuple(q.shape)} {q.dtype} (need o, do like q, lse fp32 (B, H, S), "
                         "contiguous, on q's device)")
    if any(t.data_ptr() % 16 for t in (o, do)):
        raise ValueError("flash_bwd: o and do must be 16-byte aligned")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    launch = _bwd_library()
    with torch.cuda.device(q.device):
        err = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
                     do.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                     delta.data_ptr(), B * H, S, d, H // k.shape[1], int(causal),
                     _DTYPES[q.dtype], 1.0 / math.sqrt(d),
                     torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention backward kernel launch failed: cudaError {err}")
    _FLASH_BWD.launches += 1
    _FLASH_BWD.launches_by_route[BWD_ROUTES[q.dtype]] += 1
    return dq, dk, dv


flash_attention.launches = 0
flash_attention.launches_by_route = dict.fromkeys(ROUTES.values(), 0)
# the counts live on the wrapper, reached by a name of its own, so that they
# count on while a test patches the module's ``flash_bwd``
_FLASH_BWD = flash_bwd
flash_bwd.launches = 0
flash_bwd.launches_by_route = dict.fromkeys(BWD_ROUTES.values(), 0)

__all__ = ["FlashAttentionFn", "attention_lse_ref", "attention_ref", "flash_attention",
           "flash_bwd", "flash_bwd_ref"]
