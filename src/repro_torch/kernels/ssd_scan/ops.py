"""Wrapper: the Mamba2 SSD scan with its intra-chunk part on a Hopper kernel.

``ssd_chunk(x, dt, A, Bm, Cm, chunk)`` returns the TPU kernel's four outputs.
It runs the plain version (``ref.ssd_chunk_ref``) when every input lies on
the CPU.  For CUDA tensors it checks them and launches ``csrc/ssd_scan.cu``
on the current stream; anything the kernel does not take raises.  bf16
inputs are cast to fp32 first, as the TPU kernel's first lines do.  Unlike
the TPU wrapper, S need not be a multiple of the chunk: the kernel treats
rows past S as the zero padding (dt = x = B = C = 0).

``ssd_scan`` is the full scan with the contract of the JAX package's
``ssd_scan``: the chunk outputs, then the inter-chunk recurrence over
(B, H, P, N) states and the ``y_inter`` product in torch, as the JAX wrapper
keeps them outside Pallas.  ``ssd_scan.launches`` counts the kernel's
launches.

Gradients: where grad is enabled and an input requires it, ``ssd_chunk``
runs inside ``SsdChunkFn``, whose forward launches the kernel and whose
backward is ``ssd_chunk_bwd``: on CUDA tensors the hand-written backward
kernel ``csrc/ssd_scan_bwd.cu`` (two launches: one CTA per (b, chunk, group
of heads, 64-row j-block), its products on the tensor cores in bf16x3; then
a small launch that sums the CTAs' partials in a fixed order and runs the
reverse cumsum in float64), on CPU tensors
its plain version ``ref.ssd_chunk_bwd_ref``; each gradient comes back in its
input's dtype and an output with no gradient counts as zeros.  No float
atomics, so two runs give the same bits; the wrapper sums dA over (b, chunk)
with ``torch.sum`` (a fixed order).  ``ssd_chunk_bwd.launches`` counts its
calls (each two launches).  The recurrence ``chunk_carry`` and the
``y_inter`` product stay plain autograd.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from .. import _build
from .ref import chunk_carry, ssd_chunk_bwd_ref, ssd_chunk_ref, ssd_ref

MAX_CHUNK = 256
MAX_DIM = 128          # P and N


def _library():
    lib = _build.load("ssd_scan")
    fn = lib.ssd_chunk_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _bwd_library():
    """(launch, scratch size) of the backward kernel."""
    lib = _build.load("ssd_scan_bwd")
    fn, size = lib.ssd_chunk_bwd_launch, lib.ssd_chunk_bwd_scratch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        size.argtypes = [ctypes.c_int] * 6
        size.restype = ctypes.c_longlong
    return fn, size


def ssd_chunk(x, dt, A, Bm, Cm, chunk: int):
    """x: (B,S,H,P); dt: (B,S,H); A: (H,); Bm/Cm: (B,S,N) -> (y_intra
    (B,nc,H,Q,P), states (B,nc,H,P,N), in_decay (B,nc,H,Q), chunk_decay
    (B,nc,H,1)), all fp32, with Q = ``chunk`` and nc = ceil(S / Q);
    differentiable."""
    ins = (x, dt, A, Bm, Cm)
    if torch.is_grad_enabled() and any(t.requires_grad for t in ins):
        return SsdChunkFn.apply(*ins, chunk)
    return _chunk(*ins, chunk)


class SsdChunkFn(torch.autograd.Function):
    """``ssd_chunk``: the kernel forward, the kernel backward (``ssd_chunk_bwd``)."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, chunk):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, dt, A, Bm, Cm)
        ctx.chunk = chunk
        return _chunk(x, dt, A, Bm, Cm, chunk)

    @staticmethod
    def backward(ctx, *grads):
        return (*ssd_chunk_bwd(ctx.saved_tensors, ctx.chunk, grads), None)


def _check(ins, chunk: int, what: str):
    """The inputs in fp32, checked: raise unless the kernels take them."""
    x = ins[0]
    if x.device.type != "cuda" or any(t.device != x.device for t in ins):
        raise ValueError(f"{what}: x, dt, A, Bm, Cm must all be on the CPU or on one "
                         "CUDA device")
    if any(t.dtype not in (torch.float32, torch.bfloat16) for t in ins):
        raise TypeError(f"{what}: dtypes {[t.dtype for t in ins]}; need float32 or bfloat16")
    x, dt, A, Bm, Cm = (t.float() for t in ins)
    if x.dim() != 4 or dt.dim() != 3 or A.dim() != 1 or Bm.dim() != 3:
        raise ValueError(f"{what}: shapes {[tuple(t.shape) for t in ins]}")
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    if (tuple(dt.shape) != (Bsz, S, H) or tuple(A.shape) != (H,)
            or tuple(Bm.shape) != (Bsz, S, N) or Cm.shape != Bm.shape):
        raise ValueError(f"{what}: shapes {[tuple(t.shape) for t in ins]} do not match "
                         "x (B,S,H,P), dt (B,S,H), A (H,), Bm/Cm (B,S,N)")
    if not (0 < chunk <= MAX_CHUNK and 0 < P <= MAX_DIM and 0 < N <= MAX_DIM
            and P % 4 == 0 and N % 4 == 0 and S > 0):
        raise ValueError(f"{what}: chunk {chunk}, P {P}, N {N}, S {S}: the kernels take "
                         f"chunk <= {MAX_CHUNK}, P and N multiples of 4 up to {MAX_DIM}, "
                         "S > 0")
    if not all(t.is_contiguous() for t in (x, dt, A, Bm, Cm)):
        raise ValueError(f"{what}: inputs must be contiguous")
    if any(t.data_ptr() % 16 for t in (x, Bm, Cm)):
        raise ValueError(f"{what}: x, Bm, Cm must be 16-byte aligned")
    return x, dt, A, Bm, Cm


def _chunk(x, dt, A, Bm, Cm, chunk: int):
    """The plain version for CPU tensors, else one launch of the kernel."""
    ins = (x, dt, A, Bm, Cm)
    if all(t.device.type == "cpu" for t in ins):
        return ssd_chunk_ref(x, dt, A, Bm, Cm, chunk)
    x, dt, A, Bm, Cm = _check(ins, chunk, "ssd_chunk")
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    nc = -(-S // chunk)
    f32 = dict(dtype=torch.float32, device=x.device)
    y = torch.empty((Bsz, nc, H, chunk, P), **f32)
    states = torch.empty((Bsz, nc, H, P, N), **f32)
    in_decay = torch.empty((Bsz, nc, H, chunk), **f32)
    chunk_decay = torch.empty((Bsz, nc, H, 1), **f32)
    launch = _library()
    with torch.cuda.device(x.device):
        err = launch(x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
                     Cm.data_ptr(), y.data_ptr(), states.data_ptr(),
                     in_decay.data_ptr(), chunk_decay.data_ptr(),
                     Bsz, S, H, P, N, chunk, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"ssd_scan kernel launch failed: cudaError {err}")
    ssd_scan.launches += 1
    return y, states, in_decay, chunk_decay


def ssd_chunk_bwd(ins, chunk: int, grads):
    """Gradients of (x, dt, A, Bm, Cm), each in its input's dtype, for the
    four outputs' gradients ``grads`` (None where an output has none): the
    plain version (``ssd_chunk_bwd_ref``) for CPU tensors, else one launch
    of the backward kernel; anything it does not take raises."""
    given = [g for g in grads if g is not None]
    if all(t.device.type == "cpu" for t in (*ins, *given)):
        return ssd_chunk_bwd_ref(*ins, chunk, grads)
    x, dt, A, Bm, Cm = _check(ins, chunk, "ssd_chunk_bwd")
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    nc = -(-S // chunk)
    shapes = [(Bsz, nc, H, chunk, P), (Bsz, nc, H, P, N), (Bsz, nc, H, chunk), (Bsz, nc, H, 1)]
    gs = []
    for g, shape in zip(grads, shapes):
        if g is not None:
            if tuple(g.shape) != shape or g.device != x.device:
                raise ValueError(f"ssd_chunk_bwd: an output gradient {tuple(g.shape)} on "
                                 f"{g.device}, need {shape} on {x.device}")
            g = g.float().contiguous()
            if g.data_ptr() % 16:            # the kernel reads it in 16-byte vectors
                g = g.clone()
        gs.append(g)
    f32 = dict(dtype=torch.float32, device=x.device)
    gx, gdt = torch.empty_like(x), torch.empty_like(dt)
    gA = torch.empty((Bsz, nc, H), **f32)
    gB, gC = torch.empty_like(Bm), torch.empty_like(Cm)
    launch, size = _bwd_library()
    # the CTAs' partials: dB per head group, dC per (head group, j-block),
    # dcum's row sums per j-block, the crossing pairs, decay_end's terms
    scratch = torch.empty(size(Bsz, S, H, P, N, chunk), **f32)
    with torch.cuda.device(x.device):
        err = launch(x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
                     *(0 if g is None else g.data_ptr() for g in gs),
                     gx.data_ptr(), gdt.data_ptr(), gA.data_ptr(), gB.data_ptr(),
                     gC.data_ptr(), scratch.data_ptr(), Bsz, S, H, P, N, chunk,
                     torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"ssd_scan backward kernel launch failed: cudaError {err}")
    _SSD_CHUNK_BWD.launches += 1
    return (gx.to(ins[0].dtype), gdt.to(ins[1].dtype), gA.sum((0, 1)).to(ins[2].dtype),
            gB.to(ins[3].dtype), gC.to(ins[4].dtype))


def ssd_scan(x, dt, A, Bm, Cm, chunk: int = 64):
    """Chunked SSD forward.  Same contract as ``ssd_ref``.

    x: (B,S,H,P); dt: (B,S,H); A: (H,); Bm/Cm: (B,S,N)
    -> (y: (B,S,H,P) in x's dtype, final_state: (B,H,P,N) fp32)
    """
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    Q = min(chunk, S)
    y_intra, states, in_decay, chunk_decay = ssd_chunk(x, dt, A, Bm, Cm, Q)
    nc = states.shape[1]
    final, prev = chunk_carry(states, chunk_decay[..., 0])

    # Y_inter[i] = (C_i . h_prev_chunk) * exp(cum_i)
    Cc = F.pad(Cm.float(), (0, 0, 0, nc * Q - S)).reshape(Bsz, nc, Q, N)
    y_inter = torch.einsum("bcin,bchpn,bchi->bchip", Cc, prev, in_decay)
    y = (y_intra + y_inter).transpose(2, 3).reshape(Bsz, nc * Q, H, P)
    return y[:, :S].to(x.dtype), final


ssd_scan.launches = 0
# the count lives on the wrapper, reached by a name of its own, so that it
# counts on while a test patches the module's ``ssd_chunk_bwd``
_SSD_CHUNK_BWD = ssd_chunk_bwd
ssd_chunk_bwd.launches = 0

__all__ = ["SsdChunkFn", "ssd_chunk", "ssd_chunk_bwd", "ssd_chunk_bwd_ref", "ssd_chunk_ref",
           "ssd_ref", "ssd_scan"]
