"""Wrapper: LTRF-planned matmul on the hand-written Hopper kernel.

``ltrf_matmul(x, w)`` runs the plain version (``ref.matmul_ref``) when both
operands lie on the CPU.  For CUDA tensors it checks them, sizes the tiles
and the ring depth with ``pick_blocks``, builds and validates the per-CTA
``IntervalPlan`` of that stream once per shape (``matmul_plan``) and launches
``csrc/ltrf_matmul.cu`` on the current stream; anything the kernel does not
take raises.  The kernel reads only the plan's ``num_slots`` (which is
``pick_blocks``' depth); its intervals and slot colouring are not used yet, as
the ring is filled round-robin.

The route follows from dtype, M and the operands' layout (``route``):
``"wgmma"`` for bf16 with M > 64 or a backward layout (TMA ring feeding
wgmma; the forward on a stream-K schedule whose shares are whole-tile
k-slices, ``schedule``: whole output tiles in full waves of NUM_SMS CTAs,
the tiles of a ragged last wave each cut into k-slices over the idle SMs,
a tile's fp32 partials summed in a fixed order by whichever of its slices
arrives last), ``"decode"`` for a bf16 forward with M <= 64 (the product
swapped
so the weight is wgmma's A operand, K split over ``split_k`` CTAs a tile,
TMA ring, fp32 partials summed in a fixed order inside a thread block
cluster, or past 8 slices by the last CTA of each tile) and ``"fp32"`` for
float32 (cp.async ring, FFMA).
``ltrf_matmul.launches`` counts the launches,
``ltrf_matmul.launches_by_route`` counts them per route and
``ltrf_matmul.launches_by_layout`` per operand layout (``LAYOUTS``).

Gradients: where grad is enabled and an operand requires it, the product
runs inside ``LtrfMatmulFn`` (a ``torch.autograd.Function``), whose backward
is the two products of a matmul on the same kernel: ``dX = dY @ w^T``
(layout ``nt``: w is read K-major, as it lies) and ``dW = x^T @ dY`` (layout
``tn``: x is read with wgmma's A transpose bit), with no transpose copied and
no row padded.  A backward product with too few output tiles to fill the
card has its reduction (the M rows) split over ``split_k`` CTAs a tile and
summed in a fixed order.  The fp32 route has no backward layouts: there each
transpose is still copied (and dW's rows padded to 16 bytes) before an
``nn`` launch.  On CPU tensors the Function's forward and backward run
``matmul_ref`` through the same wrapper.
"""
from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ...core.plan import IntervalPlan, plan_for_matmul
from .. import _build
from .ref import matmul_ref

SMEM_PER_CTA = 232_448   # H100: dynamic shared memory one block may use
SMEM_PER_SM = 233_472    # H100: shared memory of an SM (1 KB of it kept per CTA)
NUM_SMS = 132            # H100 SXM
MAX_STAGES = 6
# decode route: 32 K rows x 64 columns of weight a stage; up to 12 stages
# (48 KB of weight in flight a CTA) when one CTA streams all of K, 8 when K
# is split, fewer where the last wave of CTAs would be less than half full
# (pick_blocks); the K split sized so every
# shape has at least NUM_SMS CTAs; the split's fp32 partials need at most
# 2 * NUM_SMS tiles of 64 x 64 floats (a split > 1 only when the tiles are
# fewer than NUM_SMS)
DECODE_BK, DECODE_BN, DECODE_MAX_STAGES = 32, 64, (12, 8)
DECODE_RESERVE = 2 * 1024 + 16    # a CTA's 1024-byte alignment, the SM's 1 KB, a flag
# a split of up to 8 slices is reduced inside a thread block cluster (slice
# 0's shared memory gathers the others' fp32 partials); a larger one through
# the workspace
DECODE_MAX_CLUSTER = 8
WORKSPACE_CTAS = 2 * NUM_SMS
# wgmma route: shared memory kept beside the ring -- the 1024-byte alignment of
# the swizzled tiles, the consumers' output staging (2 x 64 x 128 bf16) and
# the ring's full and empty mbarriers
WGMMA_RESERVE = 34 * 1024
# a split product (backward or forward): each K slice at least this many
# 64-row blocks, so the slice's partial (written once, read once by the
# tile's last CTA) stays a small part of its stream
WGMMA_MIN_SLICE_BLOCKS = 8
# the forward's schedule cost model (``schedule``), in units of one 64-deep
# k-block of a 128 x 256 tile, fitted to the split study on an H100
# (``experiments/matmul_ab.py --study``, PERF.md): a k-block of a 128 x 128
# tile (more shared-memory bytes per flop); one k-slice's 128 x 256 fp32
# partial, written and read in the fixup (half of it for a 128-wide tile); a
# split tile's fixed cost (the count, the fixup's first round trip); and the
# share of the whole-tile cost a split must save, which at shapes with full
# waves beside the split fell 5-10 % short of the model (the partials' L2
# traffic, the whole tiles started late)
WGMMA_NARROW_BLOCK_COST = 0.6
WGMMA_PARTIAL_COST = 4.2
WGMMA_FIXUP_LATENCY = 4.6
WGMMA_SPLIT_MARGIN = 0.05
# the workspace of fp32 partials, shared by the decode route's splits of more
# than DECODE_MAX_CLUSTER slices (WORKSPACE_CTAS tiles of 64 x 64) and the
# wgmma route's split products (at most NUM_SMS slices of 128 x 256, forward
# or backward); the counters: one a split tile (fewer than NUM_SMS)
WORKSPACE_FLOATS = max(WORKSPACE_CTAS * DECODE_BN * 64, NUM_SMS * 128 * 256)
WORKSPACE_COUNTERS = NUM_SMS
ROUTES = ("wgmma", "decode", "fp32")
# out = op(a) @ op(b): nn the forward x @ w, nt dX = dY @ w^T, tn dW = x^T @ dY
LAYOUTS = ("nn", "nt", "tn")
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def route(M: int, dtype_bytes: int = 2, layout: str = "nn") -> str:
    """The kernel route for a product of M output rows of this dtype in this
    layout (see the module docstring): the backward layouts take the wgmma
    route at every M."""
    if dtype_bytes == 4:
        return "fp32"
    return "decode" if M <= 64 and layout == "nn" else "wgmma"


def stage_bytes(bm: int, bk: int, bn: int, dtype_bytes: int,
                swizzled: bool = False) -> int:
    """Shared memory of one ring slot: the x tile and the weight tile.  The
    cp.async routes pad each row by 16 bytes; the wgmma route's TMA boxes
    are 128-byte swizzled (``swizzled``) and unpadded."""
    ch = 0 if swizzled else 16 // dtype_bytes
    return (bm * (bk + ch) + bk * (bn + ch)) * dtype_bytes


def _wgmma_bn(M: int, N: int) -> int:
    """The backward layouts' tile width, 128 or 256 output columns a CTA: the
    one with the fewer column-units of work on the busiest SM, a 128-wide
    tile counted 15 % dearer (it moves more shared-memory bytes per flop), so
    narrow N still spreads over the SMs.  (The forward's comes with its
    schedule.)"""
    m_tiles = -(-M // 128)

    def cost(bn):
        waves = -(-(m_tiles * -(-N // bn)) // NUM_SMS)
        return waves * bn * (1.0 if bn == 256 else 1.15)

    return min((256, 128), key=cost)


class Schedule(NamedTuple):
    """The forward wgmma route's work (a stream-K schedule whose shares are
    whole-tile k-slices).  Output tiles of 128 x ``bn`` are numbered M-tile
    fastest; each has ``n_k`` 64-deep k-blocks.  The first ``split_tiles``
    tiles are split: each into ``split`` k-slices (slice j is k-blocks
    [j * n_k // split, (j + 1) * n_k // split)), one work unit a slice; the
    other tiles are one unit each, whole.  Units are numbered slices first,
    slice-major (unit j * split_tiles + t is slice j of tile t), then the whole
    tiles in order, and CTA c takes units c, c + grid, ...  A slice writes
    its fp32 partial to workspace slot (its unit) and counts itself at its
    tile's counter; the tile's last slice to arrive sums the slices in the
    order 0 .. split-1 and stores the tile.  The kernel walks the same units
    (``ltrf_matmul.cu``, ``Walk``), as the backward's split does."""
    bn: int
    m_tiles: int
    tiles: int
    n_k: int
    split_tiles: int = 0
    split: int = 1

    @property
    def n_units(self) -> int:
        return self.split_tiles * self.split + self.tiles - self.split_tiles

    @property
    def grid(self) -> int:
        return min(NUM_SMS, self.n_units)

    def unit(self, v: int) -> tuple[int, int, int]:
        """Unit v: (tile, kb0, kb1)."""
        if v < self.split_tiles * self.split:
            j = v // self.split_tiles
            return (v % self.split_tiles, j * self.n_k // self.split,
                    (j + 1) * self.n_k // self.split)
        return v - self.split_tiles * (self.split - 1), 0, self.n_k

    def units(self, c: int) -> list[tuple[int, int, int]]:
        """CTA c's work in order: (tile, kb0, kb1)."""
        return [self.unit(v) for v in range(c, self.n_units, self.grid)]

    def slices(self, tile: int) -> list[int]:
        """The units of a split tile in k order, whose partials are summed in
        this order."""
        return [tile + j * self.split_tiles for j in range(self.split)]

    def longest(self) -> int:
        """The k-blocks of the busiest CTA."""
        return max(sum(b - a for _, a, b in self.units(c)) for c in range(self.grid))

    def cost(self) -> float:
        """The busiest CTA's time in k-blocks of a 128 x 256 tile: its
        k-blocks, plus, where tiles are split, the partials its tile's fixup
        writes and reads and the fixed latency of the count (the cost model
        of ``schedule``)."""
        scale = 1.0 if self.bn == 256 else WGMMA_NARROW_BLOCK_COST
        fix = 0 if self.split == 1 else (
            self.split * WGMMA_PARTIAL_COST * self.bn / 256 + WGMMA_FIXUP_LATENCY)
        return self.longest() * scale + fix


def data_parallel(M: int, K: int, N: int, bn: int, split: int = 1) -> Schedule:
    """Whole tiles in waves of NUM_SMS CTAs, one a CTA, as before the forward
    split; with ``split`` > 1 the tiles of the ragged last wave (all of them
    where they are less than a wave) each cut into that many k-slices."""
    m_tiles, n_k = -(-M // 128), -(-K // 64)
    tiles = m_tiles * -(-N // bn)
    if split == 1:
        return Schedule(bn, m_tiles, tiles, n_k)
    return Schedule(bn, m_tiles, tiles, n_k, tiles % NUM_SMS, split)


def candidates(M: int, K: int, N: int) -> list[Schedule]:
    """The schedules ``schedule`` chooses among, in its order of preference
    where their costs tie: 256-wide tiles (128 where N <= 128), whole tiles
    alone, then the ragged last wave's tiles cut into 2, 3, 4, 6 or 8
    k-slices (at most NUM_SMS slices, each at least WGMMA_MIN_SLICE_BLOCKS
    deep).  Shares that cross tiles, and ragged waves with one full wave
    moved into the split, ran slower at every shape measured (PERF.md)."""
    out = []
    for bn in ((256, 128) if N > 128 else (128,)):
        dp = data_parallel(M, K, N, bn)
        rem = dp.tiles % NUM_SMS
        out.append(dp)
        out += [data_parallel(M, K, N, bn, s) for s in (2, 3, 4, 6, 8)
                if rem and s * rem <= NUM_SMS and dp.n_k // s >= WGMMA_MIN_SLICE_BLOCKS]
    return out


@lru_cache(maxsize=512)
def schedule(M: int, K: int, N: int) -> Schedule:
    """The forward wgmma route's schedule of the product (M, K, N): the
    cheapest candidate (``Schedule.cost``), a split one only where it costs
    at least WGMMA_SPLIT_MARGIN less than whole tiles."""
    cands = candidates(M, K, N)
    whole = min((s for s in cands if s.split == 1), key=Schedule.cost)
    split = min((s for s in cands if s.split > 1), key=Schedule.cost, default=None)
    if split is not None and split.cost() < (1 - WGMMA_SPLIT_MARGIN) * whole.cost():
        return split
    return whole


def wgmma_stages(bn: int) -> int:
    """The wgmma route's ring depth at tile width ``bn``: as many 128 x 64 +
    64 x bn stages (up to MAX_STAGES) as fit in one CTA's shared memory
    beside ``WGMMA_RESERVE``."""
    stages = min(MAX_STAGES, (SMEM_PER_CTA - WGMMA_RESERVE) // stage_bytes(128, 64, bn, 2, True))
    assert stages >= 2
    return stages


def _decode_rows(M: int) -> int:
    """The decode route's padded row count: wgmma's N of 8, 16, 32 or 64."""
    return next(mp for mp in (8, 16, 32, 64) if M <= mp)


def decode_stage_bytes(bm: int) -> int:
    """Shared memory of one decode stage as the kernel lays it out: the 4 KB
    weight box, the x box (at least 1 KB: it starts 1024-byte aligned) and
    the stage's two mbarriers."""
    return DECODE_BK * DECODE_BN * 2 + max(1024, bm * DECODE_BK * 2) + 16


def decode_gather_bytes(bm: int, split: int) -> int:
    """Slice 0's slots for the other slices' fp32 partials (a clustered split)."""
    return (split - 1) * DECODE_BN * bm * 4 if 1 < split <= DECODE_MAX_CLUSTER else 0


def split_k(M: int, K: int, N: int, dtype_bytes: int = 2, layout: str = "nn") -> int:
    """The number of K slices (CTAs) per output tile of the product (M, K, N).

    Decode (bf16, M <= 64) is bound by the weight bytes, which must be in
    flight on every SM: when the ceil(N / 64) tiles are fewer than NUM_SMS,
    K is split so that tiles x split >= NUM_SMS, up to one 32-row K block a
    CTA.  Tiles that cover the card once but not twice are split in two, so
    that no SM streams two whole tiles while others stream one (mamba2-1.3b's
    in_proj has 133).
    The wgmma route's backward products (``nt``, ``tn``) with at most half a
    wave of output tiles split K into as many slices as keep tiles x split
    within one wave of NUM_SMS CTAs, each slice at least
    WGMMA_MIN_SLICE_BLOCKS 64-row blocks deep: dW of a 256-wide projection at
    M = 8192 (32 tiles, K = 8192) takes 4.  The forward (``nn``: its split is
    ``schedule``'s) and the fp32 route take 1.
    """
    kind = route(M, dtype_bytes, layout)
    if kind == "wgmma" and layout != "nn":
        tiles = -(-M // 128) * -(-N // _wgmma_bn(M, N))
        return max(1, min(NUM_SMS // tiles, -(-K // 64) // WGMMA_MIN_SLICE_BLOCKS))
    if kind != "decode":
        return 1
    tiles, n_kb = -(-N // DECODE_BN), -(-K // DECODE_BK)
    if tiles >= 2 * NUM_SMS:
        return 1
    return min(n_kb, max(2, -(-NUM_SMS // tiles)))


def _decode_stages(bm: int, split: int, blocks: int, tiles: int) -> int:
    """The decode ring's depth: as deep as the slice (``blocks`` stages) and
    DECODE_MAX_STAGES allow, but no deeper than keeps the launch's last wave
    of CTAs at least half full, or the launch in one wave (shared memory sets
    how many CTAs an SM holds)."""
    ctas = tiles * split
    for stages in range(min(DECODE_MAX_STAGES[split > 1], blocks), 2, -1):
        per_cta = DECODE_RESERVE + decode_gather_bytes(bm, split) + stages * decode_stage_bytes(bm)
        slots = NUM_SMS * (SMEM_PER_SM // per_cta)
        if ctas <= slots or ctas % slots == 0 or 2 * (ctas % slots) >= slots:
            return stages
    return 2


def pick_blocks(M: int, K: int, N: int, dtype_bytes: int = 2,
                layout: str = "nn") -> tuple[int, int, int, int]:
    """(bm, bk, bn, stages) for one CTA of the kernel.

    wgmma (bf16, M > 64 or a backward layout): 128 x 128 or 128 x 256
    output tiles (the forward's ``schedule``, the backward's ``_wgmma_bn``)
    fed 64 deep; the ring takes as many stages (up to MAX_STAGES) as fit in
    one CTA's shared memory beside ``WGMMA_RESERVE``, one CTA an SM.
    Decode (bf16, M <= 64): one M-tile of M rows padded to 8, 16, 32 or 64
    covers every row, so each weight byte is read from HBM once; 64 output
    columns a CTA, 32 K rows a stage, and as many stages as the CTA's K slice
    has blocks, up to DECODE_MAX_STAGES (12 unsplit, 8 split), fewer where
    the CTAs that shared memory lets an SM hold would leave a last wave of
    CTAs less than half full (its SMs would stream alone, the others idle).
    fp32: 128 x 128 output tiles fed 32 deep (M > 64) or one M-tile of 16,
    32 or 64 rows by 32 columns fed 64 deep (M <= 64), with as many stages
    (2..MAX_STAGES) as fit in half of ``SMEM_PER_CTA``, so two CTAs can share
    an SM.
    """
    kind = route(M, dtype_bytes, layout)
    if kind == "wgmma":
        bn = schedule(M, K, N).bn if layout == "nn" else _wgmma_bn(M, N)
        return 128, 64, bn, wgmma_stages(bn)
    if kind == "decode":
        bm, split = _decode_rows(M), split_k(M, K, N, dtype_bytes)
        blocks = -(-(-(-K // DECODE_BK)) // split)
        return bm, DECODE_BK, DECODE_BN, _decode_stages(bm, split, blocks, -(-N // DECODE_BN))
    if M <= 64:
        bm = 16 if M <= 16 else 32 if M <= 32 else 64
        bk, bn = 64, 32
    else:
        bm, bk, bn = 128, 32, 128
    per_stage = stage_bytes(bm, bk, bn, dtype_bytes)
    stages = max(2, min(MAX_STAGES, SMEM_PER_CTA // 2 // per_stage))
    assert stages * per_stage <= SMEM_PER_CTA
    return bm, bk, bn, stages


@lru_cache(maxsize=256)
def matmul_plan(M: int, K: int, N: int, dtype_bytes: int = 2, layout: str = "nn"
                ) -> tuple[IntervalPlan, tuple[int, int, int]]:
    """The validated per-CTA IntervalPlan of this matmul's weight stream.

    One CTA streams weight tiles (bk x bn) through a ring of ``stages``
    shared-memory slots (``pick_blocks`` sets the depth): on the forward
    wgmma route the k-blocks of every unit of the busiest CTA under its
    ``schedule``, one after another as the ring runs on across them; else
    its column of weight tiles -- all ceil(K / bk) of them, or where K is
    split (the decode route, a split backward product) the longest of its
    ``split_k`` K slices.  The plan's budget is that CTA's ring and its
    ``num_slots`` is that depth, which the kernel is launched with.  Planning
    every CTA's stream at once instead would cost seconds per shape (the
    busiest CTA's alone takes seconds at the widest heads).  Memoized per
    shape, dtype and layout, which fix the schedule.
    """
    bm, bk, bn, stages = pick_blocks(M, K, N, dtype_bytes, layout)
    kind = route(M, dtype_bytes, layout)
    per_stage = stage_bytes(bm, bk, bn, dtype_bytes, swizzled=kind != "fp32")
    if kind == "wgmma" and layout == "nn":
        stream = schedule(M, K, N).longest() * bk
    else:
        stream = min(K, -(-(-(-K // bk)) // split_k(M, K, N, dtype_bytes, layout)) * bk)
    plan = plan_for_matmul(M, stream, bn, bk, bn, vmem_budget=stages * per_stage,
                           num_slots=stages, dtype_bytes=dtype_bytes)
    plan.validate()
    return plan, (bm, bk, bn)


_WORKSPACES: dict = {}


def _workspace(device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """The workspace of split products on ``device`` (the decode route's
    splits of more than DECODE_MAX_CLUSTER slices, the wgmma route's split
    products, backward or forward): WORKSPACE_FLOATS fp32
    partials and WORKSPACE_COUNTERS int32 counters, zeroed once; the kernel
    leaves every counter at 0 again.  One per device, made outside any CUDA
    graph capture by the first launch there; launches that share it are
    ordered on one stream."""
    ws = _WORKSPACES.get(device)
    if ws is None:
        ws = _WORKSPACES[device] = (
            torch.empty(WORKSPACE_FLOATS, dtype=torch.float32, device=device),
            torch.zeros(WORKSPACE_COUNTERS, dtype=torch.int32, device=device))
    return ws


def _library():
    lib = _build.load("ltrf_matmul")
    fn = lib.ltrf_matmul_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 9
                       + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def ltrf_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (M, K) @ w: (K, N) -> (M, N) in x's dtype; differentiable.
    Without a gradient to record (prefill, serving) it launches directly,
    with no autograd node to build for each call."""
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return LtrfMatmulFn.apply(x, w)
    return _product(x, w)


def matmul_vjp(x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor, needs: tuple):
    """(dX, dW) of ``x @ w`` for the output gradient ``dy``, each one launch
    with its operands as they lie (None where ``needs`` says it is not
    wanted): dX = dY @ w^T in layout ``nt``, dW = x^T @ dY in layout ``tn``.
    x and w are the forward's operands, which the kernel took contiguous;
    a strided ``dy`` (a shard's, say) is made contiguous first: TMA reads
    rows of unit stride."""
    dy = dy.contiguous()
    dx = _product(dy, w, "nt") if needs[0] else None
    dw = _product(x, dy, "tn") if needs[1] else None
    return dx, dw


class LtrfMatmulFn(torch.autograd.Function):
    """``ltrf_matmul`` with its backward on the same kernel (``matmul_vjp``)."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _product(x, w)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        return matmul_vjp(x, w, dy, ctx.needs_input_grad)


def _operands(a: torch.Tensor, b: torch.Tensor, layout: str) -> tuple:
    """The product's (op(a), op(b)) as views: out = op(a) @ op(b)."""
    return (a.t() if layout == "tn" else a), (b.t() if layout == "nt" else b)


def _fp32_as_nn(a: torch.Tensor, b: torch.Tensor, layout: str) -> tuple:
    """The fp32 route has no backward layouts: each transposed operand is
    copied, and a tn product's reduction (a's and b's rows) padded with zero
    rows to 16 bytes, which the FFMA kernel's rows need."""
    if layout == "tn":
        pad = -a.shape[0] % (16 // a.element_size())
        if pad:
            a, b = F.pad(a, (0, 0, 0, pad)), F.pad(b, (0, 0, 0, pad))
    a, b = _operands(a, b, layout)
    return a.contiguous(), b.contiguous()


def _product(a: torch.Tensor, b: torch.Tensor, layout: str = "nn") -> torch.Tensor:
    """One product out = op(a) @ op(b) in ``layout`` (``LAYOUTS``; a and b
    as they lie): the plain version for CPU tensors, else one launch."""
    if a.device.type == "cpu" and b.device.type == "cpu":
        return matmul_ref(*_operands(a, b, layout))
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(f"ltrf_matmul: operands on {a.device} and {b.device}; "
                         "both must be on the CPU or on one CUDA device")
    if a.dtype not in _DTYPES or b.dtype != a.dtype:
        raise TypeError(f"ltrf_matmul: dtypes {a.dtype}, {b.dtype}; "
                        "need both float32 or both bfloat16")
    if layout not in LAYOUTS:
        raise ValueError(f"ltrf_matmul: layout {layout!r}, not one of {LAYOUTS}")
    if a.dim() != 2 or b.dim() != 2:
        raise ValueError(f"ltrf_matmul: operands of {a.dim()} and {b.dim()} dimensions")
    x, w = _operands(a, b, layout)
    if x.shape[1] != w.shape[0]:
        raise ValueError(f"ltrf_matmul: shapes {tuple(x.shape)} @ {tuple(w.shape)} "
                         f"(layout {layout})")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("ltrf_matmul: operands must be contiguous")
    kernel_layout = layout
    if a.dtype == torch.float32 and layout != "nn":
        a, b = x, w = _fp32_as_nn(a, b, layout)
        kernel_layout = "nn"
    (M, K), N = x.shape, w.shape[1]
    ch = 16 // a.element_size()
    # TMA and cp.async read rows of 16-byte multiples: the rows of a, b and
    # out are K and N long, or M and N in tn (whose reduction runs down them)
    rows = (M, N) if kernel_layout == "tn" else (K, N)
    if M == 0 or any(r % ch for r in rows) or a.data_ptr() % 16 or b.data_ptr() % 16:
        raise ValueError(
            f"ltrf_matmul: needs M > 0, row lengths that are multiples of {ch} and "
            f"16-byte aligned operands; got M, K, N = {M}, {K}, {N} (layout {layout})")
    nbytes = a.element_size()
    kind = route(M, nbytes, kernel_layout)
    plan, (bm, bk, bn) = matmul_plan(M, K, N, nbytes, kernel_layout)
    split = split_k(M, K, N, nbytes, kernel_layout)
    sched = schedule(M, K, N) if kind == "wgmma" and kernel_layout == "nn" else None
    out = torch.empty((M, N), dtype=a.dtype, device=a.device)
    _launch(a, b, out, K, kernel_layout, (bm, bk, bn), plan.num_slots, split, sched)
    ltrf_matmul.launches += 1
    ltrf_matmul.launches_by_route[kind] += 1
    ltrf_matmul.launches_by_layout[layout] += 1
    return out


def _launch(a, b, out, K: int, layout: str, blocks: tuple, stages: int, split: int,
            sched: Schedule | None) -> None:
    """One launch of the kernel on the current stream for out (M, N) =
    op(a) @ op(b) summed over K (``_product`` has checked the operands):
    ``sched`` is the forward wgmma route's schedule (None elsewhere), whose
    split tiles, like the split products, use the device's workspace, held
    here to its bounds."""
    (M, N), (bm, bk, bn) = out.shape, blocks
    split_tiles = 0
    if sched is not None:
        assert sched.bn == bn and split == 1
        split, split_tiles = sched.split, sched.split_tiles
    partials = counters = None
    if split > DECODE_MAX_CLUSTER or (split > 1 and (layout != "nn" or split_tiles)):
        partials, counters = _workspace(out.device)
        tiles = split_tiles or -(-M // bm) * -(-N // bn)
        assert tiles * split * bm * bn <= partials.numel() and tiles <= counters.numel()
    with torch.cuda.device(out.device):
        err = _library()(a.data_ptr(), b.data_ptr(), out.data_ptr(), M, K, N,
                         _DTYPES[a.dtype], bm, bk, bn, stages, split,
                         partials.data_ptr() if partials is not None else None,
                         counters.data_ptr() if counters is not None else None,
                         LAYOUTS.index(layout), split_tiles,
                         torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"ltrf_matmul kernel launch failed: cudaError {err}")


ltrf_matmul.launches = 0
ltrf_matmul.launches_by_route = dict.fromkeys(ROUTES, 0)
ltrf_matmul.launches_by_layout = dict.fromkeys(LAYOUTS, 0)

__all__ = ["LtrfMatmulFn", "Schedule", "ltrf_matmul", "matmul_plan", "matmul_ref",
           "matmul_vjp", "pick_blocks", "schedule", "split_k"]
