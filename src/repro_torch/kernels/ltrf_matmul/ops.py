"""Wrapper: LTRF-planned matmul on the hand-written Hopper kernel.

``ltrf_matmul(x, w)`` runs the plain version (``ref.matmul_ref``) when both
operands lie on the CPU.  For CUDA tensors it checks them, sizes the tiles
and the ring depth with ``pick_blocks``, builds and validates the per-CTA
``IntervalPlan`` of that stream once per shape (``matmul_plan``) and launches
``csrc/ltrf_matmul.cu`` on the current stream; anything the kernel does not
take raises.  The kernel reads only the plan's ``num_slots`` (which is
``pick_blocks``' depth); its intervals and slot colouring are not used yet, as
the ring is filled round-robin.

The route follows from dtype and M alone (``route``): ``"wgmma"`` for bf16
with M > 64 (prefill: TMA ring feeding wgmma), ``"decode"`` for bf16 with
M <= 64 (cp.async ring, mma.sync) and ``"fp32"`` for float32 (cp.async ring,
FFMA).  ``ltrf_matmul.launches`` counts the launches and
``ltrf_matmul.launches_by_route`` counts them per route.
"""
from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from ...core.plan import IntervalPlan, plan_for_matmul
from .. import _build
from .ref import matmul_ref

SMEM_PER_CTA = 232_448   # H100: dynamic shared memory one block may use
NUM_SMS = 132            # H100 SXM
MAX_STAGES = 6
# wgmma route: shared memory kept beside the ring -- the 1024-byte alignment of
# the swizzled tiles, the consumers' output staging (2 x 64 x 128 bf16) and
# the ring's full and empty mbarriers
WGMMA_RESERVE = 34 * 1024
ROUTES = ("wgmma", "decode", "fp32")
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def route(M: int, dtype_bytes: int = 2) -> str:
    """The kernel route for M rows of this dtype (see the module docstring)."""
    if dtype_bytes == 4:
        return "fp32"
    return "decode" if M <= 64 else "wgmma"


def stage_bytes(bm: int, bk: int, bn: int, dtype_bytes: int,
                swizzled: bool = False) -> int:
    """Shared memory of one ring slot: the x tile and the weight tile.  The
    cp.async routes pad each row by 16 bytes; the wgmma route's TMA boxes
    are 128-byte swizzled (``swizzled``) and unpadded."""
    ch = 0 if swizzled else 16 // dtype_bytes
    return (bm * (bk + ch) + bk * (bn + ch)) * dtype_bytes


def _wgmma_bn(M: int, N: int) -> int:
    """128 or 256 output columns a CTA: the one with the fewer column-units of
    work on the busiest SM, a 128-wide tile counted 15 % dearer (it moves more
    shared-memory bytes per flop), so narrow N still spreads over the SMs."""
    m_tiles = -(-M // 128)

    def cost(bn):
        waves = -(-(m_tiles * -(-N // bn)) // NUM_SMS)
        return waves * bn * (1.0 if bn == 256 else 1.15)

    return min((256, 128), key=cost)


def pick_blocks(M: int, K: int, N: int,
                dtype_bytes: int = 2) -> tuple[int, int, int, int]:
    """(bm, bk, bn, stages) for one CTA of the kernel.

    wgmma (bf16, M > 64): 128 x 128 or 128 x 256 output tiles (``_wgmma_bn``)
    fed 64 deep; the ring takes as many stages (up to MAX_STAGES) as fit in one
    CTA's shared memory beside ``WGMMA_RESERVE``, one CTA an SM.
    Decode (M <= 64): one M-tile covers every row, so each weight byte is read
    from HBM once; narrow 32-column tiles give more CTAs to stream weights.
    fp32 with M > 64: 128 x 128 output tiles fed 32 deep.  The cp.async
    routes take as many stages (2..MAX_STAGES) as fit in half of
    ``SMEM_PER_CTA``, so two CTAs can share an SM.
    """
    kind = route(M, dtype_bytes)
    if kind == "wgmma":
        bm, bk, bn = 128, 64, _wgmma_bn(M, N)
        per_stage = stage_bytes(bm, bk, bn, dtype_bytes, swizzled=True)
        stages = min(MAX_STAGES, (SMEM_PER_CTA - WGMMA_RESERVE) // per_stage)
        assert stages >= 2
        return bm, bk, bn, stages
    if M <= 64:
        bm = 16 if M <= 16 else 32 if M <= 32 else 64
        bk, bn = (128 if dtype_bytes == 2 else 64), 32
    else:
        bm, bk, bn = 128, 32, 128
    per_stage = stage_bytes(bm, bk, bn, dtype_bytes)
    stages = max(2, min(MAX_STAGES, SMEM_PER_CTA // 2 // per_stage))
    assert stages * per_stage <= SMEM_PER_CTA
    return bm, bk, bn, stages


@lru_cache(maxsize=128)
def matmul_plan(M: int, K: int, N: int, dtype_bytes: int = 2
                ) -> tuple[IntervalPlan, tuple[int, int, int]]:
    """The validated per-CTA IntervalPlan of this matmul's weight stream.

    One CTA streams its column of ceil(K / bk) weight tiles (bk x bn) through
    a ring of ``stages`` shared-memory slots (``pick_blocks`` sets the depth);
    the plan's budget is that CTA's dynamic shared memory and its
    ``num_slots`` is that depth, which the kernel is launched with.  Planning the whole matrix instead would be a
    plan of every CTA's stream at once, which costs seconds per shape.
    Memoized per shape and dtype.
    """
    bm, bk, bn, stages = pick_blocks(M, K, N, dtype_bytes)
    per_stage = stage_bytes(bm, bk, bn, dtype_bytes,
                            swizzled=route(M, dtype_bytes) == "wgmma")
    plan = plan_for_matmul(M, K, bn, bk, bn, vmem_budget=stages * per_stage,
                           num_slots=stages, dtype_bytes=dtype_bytes)
    plan.validate()
    return plan, (bm, bk, bn)


def _library():
    lib = _build.load("ltrf_matmul")
    fn = lib.ltrf_matmul_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 8
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def ltrf_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (M, K) @ w: (K, N) -> (M, N) in x's dtype."""
    if x.device.type == "cpu" and w.device.type == "cpu":
        return matmul_ref(x, w)
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError(f"ltrf_matmul: operands on {x.device} and {w.device}; "
                         "both must be on the CPU or on one CUDA device")
    if x.dtype not in _DTYPES or w.dtype != x.dtype:
        raise TypeError(f"ltrf_matmul: dtypes {x.dtype}, {w.dtype}; "
                        "need both float32 or both bfloat16")
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"ltrf_matmul: shapes {tuple(x.shape)} @ {tuple(w.shape)}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("ltrf_matmul: operands must be contiguous")
    M, K = x.shape
    N = w.shape[1]
    ch = 16 // x.element_size()
    if M == 0 or K % ch or N % ch or x.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError(
            f"ltrf_matmul: needs M > 0, K and N multiples of {ch} and 16-byte "
            f"aligned operands; got M, K, N = {M}, {K}, {N}")
    plan, (bm, bk, bn) = matmul_plan(M, K, N, x.element_size())
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    launch = _library()
    with torch.cuda.device(x.device):
        err = launch(x.data_ptr(), w.data_ptr(), out.data_ptr(), M, K, N,
                     _DTYPES[x.dtype], bm, bk, bn, plan.num_slots,
                     torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"ltrf_matmul kernel launch failed: cudaError {err}")
    ltrf_matmul.launches += 1
    ltrf_matmul.launches_by_route[route(M, x.element_size())] += 1
    return out


ltrf_matmul.launches = 0
ltrf_matmul.launches_by_route = dict.fromkeys(ROUTES, 0)

__all__ = ["ltrf_matmul", "matmul_plan", "matmul_ref", "pick_blocks"]
