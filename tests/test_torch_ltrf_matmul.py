"""The port's ltrf_matmul (plain path on the CPU) and its per-CTA plan against
the JAX package's Pallas kernel (interpret mode), matmul_ref and core.plan."""
import pytest

torch = pytest.importorskip("torch")

from test_torch_parity import DTYPES, assert_close, randn, to_jax, to_torch  # noqa: E402

from repro.core import plan as jplan  # noqa: E402
from repro.kernels.ltrf_matmul.ops import ltrf_matmul as jax_ltrf_matmul  # noqa: E402
from repro.kernels.ltrf_matmul.ref import matmul_ref as jax_matmul_ref  # noqa: E402
from repro_torch.core import plan as tplan  # noqa: E402
from repro_torch.kernels.ltrf_matmul import (  # noqa: E402
    ltrf_matmul, matmul_plan, matmul_ref, pick_blocks, split_k,
)
from repro_torch.kernels.ltrf_matmul.ops import (  # noqa: E402
    DECODE_BK, DECODE_BN, DECODE_MAX_CLUSTER, DECODE_MAX_STAGES, DECODE_RESERVE, NUM_SMS, ROUTES, SMEM_PER_CTA,
    SMEM_PER_SM, WGMMA_RESERVE, WORKSPACE_CTAS, decode_gather_bytes, decode_stage_bytes, route,
    schedule, stage_bytes,
)

# test_kernels.py:27-28, plus decode-like shapes (M = 8 rows)
SHAPES = [(128, 128, 128), (256, 384, 128), (300, 500, 200), (64, 1024, 96),
          (8, 2048, 256), (8, 512, 384)]
# the slice's projections: decode (M=8) and prefill (M=2048) of tinyllama-1.1b
SLICE_KN = [(2048, 2048), (2048, 256), (2048, 5632), (5632, 2048), (2048, 32000)]
# and the other main-path projections: mamba2-1.3b's in_proj, out_proj and
# vocab; zamba2-1.2b's in_proj and shared MLP
MAIN_PATH_KN = SLICE_KN + [(2048, 8512), (4096, 2048), (2048, 50280), (2048, 8384),
                           (2048, 8192), (8192, 2048), (2048, 50304)]
# the other models' forward projections and heads (granite-moe-3b-a800m,
# llava-next-34b, dbrx-132b, phi3-medium-14b, granite-20b)
OTHER_FORWARD_KN = [(1536, 1536), (1536, 512), (1536, 49216), (7168, 7168), (7168, 1024),
                    (7168, 20480), (20480, 7168), (7168, 64000), (6144, 6144), (6144, 1024),
                    (6144, 100352), (5120, 5120), (5120, 1280), (5120, 17920), (17920, 5120),
                    (5120, 100352), (6144, 128), (6144, 24576), (24576, 6144), (6144, 49152)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_path_matches_pallas_and_ref(shape, dtype):
    M, K, N = shape
    x, w = randn(0, (M, K)), randn(1, (K, N))
    got = ltrf_matmul(to_torch(x, dtype), to_torch(w, dtype))
    assert got.dtype == getattr(torch, dtype) and got.shape == (M, N)
    jx, jw = to_jax(x, dtype), to_jax(w, dtype)
    assert_close(got, jax_ltrf_matmul(jx, jw, bm=128, bk=128, bn=128, interpret=True), dtype)
    assert_close(got, jax_matmul_ref(jx, jw), dtype)
    # the wrapper's CPU path is exactly the plain version
    torch.testing.assert_close(got, matmul_ref(to_torch(x, dtype), to_torch(w, dtype)),
                               rtol=0, atol=0)


def _plan_tuple(plan):
    return (plan.vmem_budget, plan.num_slots, plan.tile_bytes,
            [(p.interval_id, p.layer_names, [(t.name, t.bytes) for t in p.tiles],
              p.slots, p.fetch_bytes) for p in plan.prefetches])


@pytest.mark.parametrize("args", [
    (8, 2048, 32, 128, 32, 87552, 6, 2),        # one decode CTA's column
    (2048, 5632, 128, 32, 128, 113664, 6, 2),   # one prefill CTA's column
    (4096, 17920, 5120, 512, 1024, 96 * 2 ** 20, 2, 2),  # test_kernels.py:65 scale
    (300, 500, 200, 128, 128, 1 << 16, 3, 4),
    (64, 1024, 96, 64, 32, 50_000, 4, 4),
])
def test_plan_for_matmul_equals_reference(args):
    m, k, n, bk, bn, budget, slots, nbytes = args
    want = jplan.plan_for_matmul(m, k, n, bk, bn, vmem_budget=budget,
                                 num_slots=slots, dtype_bytes=nbytes)
    got = tplan.plan_for_matmul(m, k, n, bk, bn, vmem_budget=budget,
                                num_slots=slots, dtype_bytes=nbytes)
    assert _plan_tuple(got) == _plan_tuple(want)


@pytest.mark.parametrize("budget,slots", [(4096, 2), (10_000, 3), (1 << 20, 4)])
def test_plan_layer_stream_equals_reference(budget, slots):
    spec = [("embed", [("e", 3000)]), ("l0", [("a", 1500), ("b", 700)]),
            ("l1", [("b", 700), ("c", 5000)]), ("l2", [("a", 1500), ("d", 64)]),
            ("head", [("h", 9000)])]

    def build(mod):
        return [mod.LayerNode(name, [mod.Tile(t, b) for t, b in tiles])
                for name, tiles in spec]

    want = jplan.plan_layer_stream(build(jplan), budget, num_slots=slots)
    got = tplan.plan_layer_stream(build(tplan), budget, num_slots=slots)
    assert _plan_tuple(got) == _plan_tuple(want)


@pytest.mark.parametrize("M", [8, 2048])
@pytest.mark.parametrize("kn", SLICE_KN)
def test_per_cta_plan_validates(M, kn):
    K, N = kn
    plan, (bm, bk, bn) = matmul_plan(M, K, N, 2)
    plan.validate()
    _, _, _, stages = pick_blocks(M, K, N, 2)
    assert plan.num_slots == stages
    # both bf16 routes load unpadded, swizzled TMA boxes
    assert plan.vmem_budget == stages * stage_bytes(bm, bk, bn, 2, swizzled=True) <= SMEM_PER_CTA
    # the plan covers the busiest CTA's weight tiles: on the forward wgmma
    # route every k-block of its units under the schedule, on the decode
    # route the longest of its K slices
    if route(M, 2) == "wgmma":
        sched = schedule(M, K, N)
        assert sched.bn == bn
        stream = max(sum(b - a for _, a, b in sched.units(c)) for c in range(sched.grid))
        assert stream == sched.longest() >= -(-K // bk) * sched.tiles / NUM_SMS
    else:
        stream = -(-(-(-K // bk)) // split_k(M, K, N))
    assert sum(len(p.tiles) for p in plan.prefetches) >= stream
    assert matmul_plan(M, K, N, 2) is matmul_plan(M, K, N, 2)  # memoized


@pytest.mark.parametrize("dtype_bytes", [2, 4])
@pytest.mark.parametrize("shape", SHAPES + [(M, K, N) for M in (1, 8, 33, 64, 65, 2048)
                                             for K, N in SLICE_KN])
def test_pick_blocks_fits_shared_memory(shape, dtype_bytes):
    M, K, N = shape
    bm, bk, bn, stages = pick_blocks(M, K, N, dtype_bytes)
    assert 2 <= stages and stages * stage_bytes(bm, bk, bn, dtype_bytes) <= SMEM_PER_CTA
    assert SMEM_PER_CTA == 232_448
    if M <= 64:
        assert bm >= M  # decode: one M-tile covers every row
    if route(M, dtype_bytes) == "decode":
        # wgmma's N (the padded rows) is 8, 16, 32 or 64; 32 K rows x 64
        # output columns of weight a stage
        assert bm in (8, 16, 32, 64) and bm < 2 * max(M, 8) and (bk, bn) == (32, 64)
        assert stages <= max(DECODE_MAX_STAGES)
    else:
        assert bm % 16 == 0 and bk % 16 == 0 and bn % 8 == 0


@pytest.mark.parametrize("dtype_bytes", [2, 4])
@pytest.mark.parametrize("M", [1, 8, 16, 63, 64, 65, 128, 129, 300, 2048])
def test_wgmma_route_is_exactly_bf16_prefill(M, dtype_bytes):
    kind = route(M, dtype_bytes)
    assert kind in ROUTES
    assert (kind == "wgmma") == (dtype_bytes == 2 and M > 64)
    assert (kind == "decode") == (dtype_bytes == 2 and M <= 64)
    bm, bk, bn, stages = pick_blocks(M, 2048, 2048, dtype_bytes)
    # the wgmma kernel's tiles: 128 rows (two warpgroups of 64), 64 deep
    # (one 128-byte swizzled bf16 row), 128 or 256 columns
    assert ((bm, bk) == (128, 64) and bn in (128, 256)) == (kind == "wgmma")


@pytest.mark.parametrize("M", [65, 300, 2048])
@pytest.mark.parametrize("kn", MAIN_PATH_KN)
def test_wgmma_ring_fits_one_cta(M, kn):
    """The swizzled ring and its barriers fit one CTA's shared memory at every
    main-path shape, at least 2 and at most MAX_STAGES deep, and the per-CTA
    plan validates with num_slots equal to that depth."""
    K, N = kn
    bm, bk, bn, stages = pick_blocks(M, K, N, 2)
    per_stage = stage_bytes(bm, bk, bn, 2, swizzled=True)
    assert per_stage == (bm * bk + bk * bn) * 2          # no row padding
    assert 2 <= stages <= 6
    assert stages * per_stage + WGMMA_RESERVE <= SMEM_PER_CTA
    assert (stages + 1) * per_stage + WGMMA_RESERVE > SMEM_PER_CTA or stages == 6
    plan, blocks = matmul_plan(M, K, N, 2)
    plan.validate()
    assert blocks == (bm, bk, bn)
    assert plan.num_slots == stages and plan.vmem_budget == stages * per_stage


def test_wgmma_tile_width_spreads_narrow_n():
    # tinyllama's wk / wv (N = 256): its 32 tiles of 128 x 128 are each cut
    # into k-slices, spread over at least 96 CTAs (they were 32), each at
    # least 8 k-blocks deep
    sched = schedule(2048, 2048, 256)
    assert sched.split_tiles == sched.tiles == 32 and sched.grid >= 96
    assert WGMMA_MIN_SLICE_BLOCKS <= sched.longest() <= 32 // 3 + 1
    assert pick_blocks(2048, 2048, 256, 2)[2] == sched.bn == 128
    # wide N takes 256-wide tiles (fewer bytes of shared memory per flop)
    for N in (2048, 5632, 8384, 8512, 32000, 50304):
        assert pick_blocks(2048, 2048, N, 2)[2] == schedule(2048, 2048, N).bn == 256


@pytest.mark.parametrize("M", [1, 8, 33, 64])
@pytest.mark.parametrize("kn", MAIN_PATH_KN)
def test_decode_split_fills_the_card(M, kn):
    """Every main-path decode shape launches at least NUM_SMS CTAs (64-column
    tiles x K slices), each slice at least one 32-row K block, and a split
    fits the workspace of fp32 partials."""
    K, N = kn
    tiles, split = -(-N // DECODE_BN), split_k(M, K, N)
    assert tiles * split >= NUM_SMS
    assert 1 <= split <= -(-K // DECODE_BK)
    assert split <= DECODE_MAX_CLUSTER or tiles * split <= WORKSPACE_CTAS
    assert split == 1 or tiles < 2 * NUM_SMS
    assert split_k(2048, K, N) == 1 and split_k(M, K, N, 4) == 1   # other routes


def _slices(K, split, bk=DECODE_BK):
    """The kernel's K slices: 32-row blocks kb0 = s * n_kb // split, in rows."""
    n_kb = -(-K // bk)
    bounds = [s * n_kb // split for s in range(split + 1)]
    return [(bk * a, min(K, bk * b)) for a, b in zip(bounds, bounds[1:])]


@pytest.mark.parametrize("kn", MAIN_PATH_KN + [(136, 8), (136, 264), (5632, 8)])
def test_decode_slice_plan_validates(kn):
    """The per-CTA plan of a decode CTA is that of its K slice: it validates,
    its num_slots is the ring depth, and it covers the longest slice."""
    K, N = kn
    split = split_k(8, K, N)
    slices = _slices(K, split)
    assert len(slices) == split and slices[0][0] == 0 and slices[-1][1] == K
    assert all(a < b for a, b in slices)
    longest = max(-(-(b - a) // DECODE_BK) for a, b in slices)
    plan, (bm, bk, bn) = matmul_plan(8, K, N, 2)
    plan.validate()
    stages = pick_blocks(8, K, N, 2)[3]
    assert plan.num_slots == stages <= max(2, min(DECODE_MAX_STAGES[split > 1], longest))
    # the launch's CTAs fit in one wave, or its last wave is at least half full
    ctas = -(-N // DECODE_BN) * split
    per_cta = DECODE_RESERVE + decode_gather_bytes(bm, split) + stages * decode_stage_bytes(bm)
    slots = NUM_SMS * (SMEM_PER_SM // per_cta)
    assert stages == 2 or ctas <= slots or 2 * (ctas % slots) >= slots or ctas % slots == 0
    assert sum(len(p.tiles) for p in plan.prefetches) >= longest


@pytest.mark.parametrize("shape", [(8, 2048, 256), (8, 2048, 2048), (1, 136, 264), (33, 5632, 8),
                                   (64, 4096, 200)])
def test_split_k_emulation_matches_ref(shape):
    """The decode route's arithmetic on the CPU: per K slice an fp32 partial
    (bf16 products are exact in fp32), the partials summed in the fixed order
    0 .. split-1, one rounding to bf16.  It agrees with matmul_ref at the bf16
    tolerance and gives the same bits twice."""
    M, K, N = shape
    x = to_torch(randn(0, (M, K)), "bfloat16")
    w = to_torch(randn(1, (K, N)) / K ** 0.5, "bfloat16")

    def emulate():
        acc = torch.zeros(M, N)
        for a, b in _slices(K, split_k(M, K, N)):
            acc = acc + x[:, a:b].float() @ w[a:b].float()
        return acc.to(torch.bfloat16)

    got = emulate()
    assert split_k(M, K, N) > 1
    torch.testing.assert_close(got.float(), matmul_ref(x, w).float(), rtol=3e-2, atol=8e-2)
    assert torch.equal(got, emulate())


# ---------------------------------------------------------------------------
# the autograd Function (backward: dX = dY w^T and dW = x^T dY on the wrapper)
# ---------------------------------------------------------------------------

from repro_torch.kernels.ltrf_matmul import ops as mm_ops  # noqa: E402


@pytest.mark.parametrize("shape", [(5, 7, 3), (8, 16, 24), (1, 12, 12)])
def test_function_gradcheck_float64(shape):
    M, K, N = shape
    g = torch.Generator().manual_seed(0)
    x = torch.randn(M, K, dtype=torch.float64, generator=g, requires_grad=True)
    w = torch.randn(K, N, dtype=torch.float64, generator=g, requires_grad=True)
    assert torch.autograd.gradcheck(ltrf_matmul, (x, w))
    assert ltrf_matmul(x, w).grad_fn.name() == "LtrfMatmulFnBackward"


def test_function_gradcheck_catches_a_transposed_dw(monkeypatch):
    real = mm_ops.matmul_vjp

    def transposed(x, w, dy, needs):
        dx, dw = real(x, w, dy, needs)
        return dx, None if dw is None else dw.t()

    monkeypatch.setattr(mm_ops, "matmul_vjp", transposed)
    g = torch.Generator().manual_seed(0)
    x = torch.randn(6, 9, dtype=torch.float64, generator=g, requires_grad=True)
    w = torch.randn(9, 9, dtype=torch.float64, generator=g, requires_grad=True)
    assert not torch.autograd.gradcheck(ltrf_matmul, (x, w), raise_exception=False)


@pytest.mark.parametrize("dtype", DTYPES)
def test_function_grads_match_jax(dtype):
    import jax
    x, w, dy = randn(0, (24, 40)), randn(1, (40, 16)), randn(2, (24, 16))
    tx, tw = (to_torch(a, dtype).requires_grad_() for a in (x, w))
    ltrf_matmul(tx, tw).backward(to_torch(dy, dtype))
    _, vjp = jax.vjp(jax_matmul_ref, to_jax(x, dtype), to_jax(w, dtype))
    jdx, jdw = vjp(to_jax(dy, dtype))
    assert tx.grad.dtype == getattr(torch, dtype) and tw.grad.dtype == getattr(torch, dtype)
    assert_close(tx.grad, jdx, dtype)
    assert_close(tw.grad, jdw, dtype)


def test_function_only_where_a_gradient_is_wanted():
    x, w = torch.randn(4, 8), torch.randn(8, 8)
    assert ltrf_matmul(x, w).grad_fn is None
    w.requires_grad_()
    with torch.no_grad():
        assert ltrf_matmul(x, w).grad_fn is None
    out = ltrf_matmul(x, w)
    out.sum().backward()
    assert x.grad is None and w.grad is not None


# ---------------------------------------------------------------------------
# the backward's layouts (nt: dX = dY w^T, tn: dW = x^T dY) and its split
# ---------------------------------------------------------------------------

from repro_torch.kernels.ltrf_matmul.ops import (  # noqa: E402
    LAYOUTS, WGMMA_MIN_SLICE_BLOCKS, WGMMA_SPLIT_MARGIN, WORKSPACE_COUNTERS, WORKSPACE_FLOATS,
    _fp32_as_nn, _product, _wgmma_bn, candidates, data_parallel, wgmma_stages,
)

# the train step's projections (chip_smoke.py's slice_matmuls): tinyllama-1.1b
# and mamba2-1.3b's in_proj, out_proj and 50280-wide head
TRAIN_KN = SLICE_KN + [(2048, 8512), (4096, 2048), (2048, 50280)]


def _backward_product(M, K, N, which):
    """The kernel's (M', K', N', layout) of one backward product of x(M, K) @ w(K, N)."""
    return (M, N, K, "nt") if which == "dX" else (K, M, N, "tn")


def _wgmma_slices(K, split):
    """The wgmma route's K slices: 64-row blocks kb0 = s * n_kb // split, in rows."""
    return _slices(K, split, bk=64)


@pytest.mark.parametrize("which", ["dX", "dW"])
@pytest.mark.parametrize("M", [2048, 8192])
@pytest.mark.parametrize("kn", TRAIN_KN)
def test_backward_products_fill_the_card(M, kn, which):
    """Each backward product of a train step takes the wgmma tiles in its
    layout and launches at least ~one wave of work units (output tiles x K
    slices); a split stays within one wave, gives each slice at least
    WGMMA_MIN_SLICE_BLOCKS blocks and fits the workspace, and the per-CTA plan
    covers the longest slice."""
    m, k, n, layout = _backward_product(M, *kn, which)
    assert route(m, 2, layout) == "wgmma"
    bm, bk, bn, stages = pick_blocks(m, k, n, 2, layout)
    assert (bm, bk) == (128, 64) and bn == _wgmma_bn(m, n)
    assert stages == wgmma_stages(bn)         # the ring as deep as the forward's at bn
    tiles, split = -(-m // bm) * -(-n // bn), split_k(m, k, n, 2, layout)
    assert tiles * split >= 0.96 * NUM_SMS
    if split > 1:
        assert tiles * split <= NUM_SMS and 2 * tiles <= NUM_SMS
        assert min(b - a for a, b in _wgmma_slices(k, split)) >= 64 * WGMMA_MIN_SLICE_BLOCKS
        assert tiles * split * bm * bn <= WORKSPACE_FLOATS and tiles <= NUM_SMS
    assert split_k(m, k, n, 2) == 1 and split_k(m, k, n, 4, layout) == 1   # forward, fp32
    plan, blocks = matmul_plan(m, k, n, 2, layout)
    plan.validate()
    assert blocks == (bm, bk, bn) and plan.num_slots == stages
    longest = max(-(-(b - a) // bk) for a, b in _wgmma_slices(k, split))
    assert sum(len(p.tiles) for p in plan.prefetches) >= longest


def test_narrow_dw_is_split_over_the_card():
    # tinyllama's wk / wv dW at M = 8192: 32 output tiles of 128 x 128, the
    # 8192-row reduction cut in 4 slices of 2048: 128 CTAs where 32 were
    m, k, n, layout = _backward_product(8192, 2048, 256, "dW")
    assert (m, k, n) == (2048, 8192, 256)
    assert pick_blocks(m, k, n, 2, layout)[2] == 128 and split_k(m, k, n, 2, layout) == 4
    # dW of wq / wo (128 tiles) is not split: two waves would cost more
    assert split_k(2048, 8192, 2048, 2, "tn") == 1
    # the forward never splits on the wgmma route
    assert all(split_k(m, k, n, 2, "nn") == 1 for m in (65, 2048, 8192))


@pytest.mark.parametrize("shape,split", [((2048, 2048, 256), 4), ((2048, 1001, 256), 2),
                                         ((2048, 960, 256), 1), ((256, 8192, 128), 16),
                                         ((136, 7, 264), 1)])
def test_split_backward_emulation_matches_ref(shape, split):
    """The wgmma route's split dW on the CPU, in the kernel's order: an fp32
    partial per K slice (bf16 products are exact in fp32), the slices summed
    from zero in the fixed order 0 .. split-1, one rounding to bf16.  The fp32
    sum agrees with one fp32 product to fp32 rounding, the bf16 result with
    matmul_ref at the bf16 tolerance, and two runs give the same bits."""
    m, k, n = shape
    x = to_torch(randn(0, (k, m)), "bfloat16")          # as it lies: rows are the reduction
    dy = to_torch(randn(1, (k, n)) / k ** 0.5, "bfloat16")
    assert split_k(m, k, n, 2, "tn") == split

    def emulate():
        acc = torch.zeros(m, n)
        for a, b in _wgmma_slices(k, split):
            acc = acc + x[a:b].t().float() @ dy[a:b].float()
        return acc

    acc = emulate()
    torch.testing.assert_close(acc, x.t().float() @ dy.float(), rtol=1e-5, atol=1e-5)
    got = acc.to(torch.bfloat16)
    torch.testing.assert_close(got.float(), matmul_ref(x.t(), dy).float(), rtol=3e-2, atol=8e-2)
    assert torch.equal(got, emulate().to(torch.bfloat16))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("M", [7, 1001])
def test_matmul_vjp_odd_rows_match_jax(M, dtype):
    """matmul_vjp at row counts that are no multiple of 16 bytes (no row is
    padded now) against jax.vjp of the JAX package's matmul_ref, at the
    parity harness's tolerance for the dtype; each layout's plain path is
    matmul_ref of the transposed views, bit for bit."""
    import jax
    K, N = 48, 24
    x, w, dy = randn(0, (M, K)), randn(1, (K, N)), randn(2, (M, N))
    tx, tw, tdy = (to_torch(a, dtype) for a in (x, w, dy))
    dx, dw = mm_ops.matmul_vjp(tx, tw, tdy, (True, True))
    _, vjp = jax.vjp(jax_matmul_ref, to_jax(x, dtype), to_jax(w, dtype))
    jdx, jdw = vjp(to_jax(dy, dtype))
    assert dx.shape == (M, K) and dw.shape == (K, N) and dx.dtype == dw.dtype == tx.dtype
    assert_close(dx, jdx, dtype)
    assert_close(dw, jdw, dtype)
    assert torch.equal(dx, matmul_ref(tdy, tw.t())) and torch.equal(dw, matmul_ref(tx.t(), tdy))
    assert mm_ops.matmul_vjp(tx, tw, tdy, (False, True))[0] is None
    assert mm_ops.matmul_vjp(tx, tw, tdy, (True, False))[1] is None


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("rows", [7, 8, 1001])
def test_fp32_backward_copies_into_the_forward_layout(layout, rows):
    """The fp32 route has no backward layouts: its operands become the
    forward's (contiguous copies; tn's reduction padded with zero rows to 16
    bytes), whose product is the layout's."""
    a = to_torch(randn(0, (rows, 12)), "float32")
    b = to_torch(randn(1, {"nn": (12, 20), "nt": (20, 12), "tn": (rows, 20)}[layout]), "float32")
    x, w = _fp32_as_nn(a, b, layout)
    assert x.is_contiguous() and w.is_contiguous() and x.shape[1] == w.shape[0]
    if layout == "tn":
        assert x.shape == (12, -(-rows // 4) * 4)
    torch.testing.assert_close(x @ w, _product(a, b, layout), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the forward's split schedule (wgmma route, layout nn)
# ---------------------------------------------------------------------------

# ragged shapes whose tiles are split: a tile cut into 2 .. 79 k-slices, a
# single tile, a ragged last wave beside whole waves
RAGGED = [(300, 4104, 136), (1000, 1000, 264), (100, 5000, 104), (257, 640, 384),
          (700, 2056, 520)]


def _covers_once(sched) -> bool:
    """Whether the units of all CTAs cover every (tile, k-block) once: each
    tile's k-ranges, sorted, join end to end from 0 to n_k."""
    ranges = {}
    for c in range(sched.grid):
        for tile, kb0, kb1 in sched.units(c):
            assert 0 <= kb0 < kb1 <= sched.n_k
            ranges.setdefault(tile, []).append((kb0, kb1))
    ends = [0] * sched.tiles
    for tile, rs in ranges.items():
        for kb0, kb1 in sorted(rs):
            if kb0 != ends[tile]:
                return False
            ends[tile] = kb1
    return sorted(ranges) == list(range(sched.tiles)) and set(ends) == {sched.n_k}


@pytest.mark.parametrize("M", [2048, 8192])
@pytest.mark.parametrize("kn", MAIN_PATH_KN + OTHER_FORWARD_KN[:8])
def test_schedule_covers_every_block_once(M, kn):
    """Every candidate schedule (and so the one picked) covers every
    (tile, k-block) of the product exactly once; a split tile's slices
    differ by at most one k-block and hold at least WGMMA_MIN_SLICE_BLOCKS;
    the split tiles are the ragged last wave's (whole tiles come in full
    waves), one slice an SM at most."""
    K, N = kn
    for sched in candidates(M, K, N):
        assert _covers_once(sched), sched
        if sched.split > 1:
            depths = [kb1 - kb0 for _, kb0, kb1 in map(sched.unit, sched.slices(0))]
            assert max(depths) - min(depths) <= 1 and sum(depths) == sched.n_k
            assert min(depths) >= WGMMA_MIN_SLICE_BLOCKS
            assert sched.split_tiles == sched.tiles % NUM_SMS
            assert sched.split_tiles * sched.split <= NUM_SMS
    assert schedule(M, K, N) in candidates(M, K, N)


def _fill(sched) -> float:
    """The SM time the product's k-blocks fill: all of them over NUM_SMS x
    the busiest CTA's (one tile width, so the same flops a block)."""
    return sched.tiles * sched.n_k / (NUM_SMS * sched.longest())


@pytest.mark.parametrize("M", [2048, 8192])
@pytest.mark.parametrize("kn", MAIN_PATH_KN + OTHER_FORWARD_KN)
def test_schedule_fills_the_card(M, kn):
    """At every main-path forward shape some candidate keeps at least 95 %
    of the card's SM time busy, weighted by flops; the picked schedule is
    the cheapest under the cost model, a split one only where it saves
    WGMMA_SPLIT_MARGIN of whole tiles' cost; it is at least as full as
    whole 128-wide tiles wherever those leave a third of the card idle
    (tinyllama's wk/wv: 32 tiles, a fill of 0.24)."""
    K, N = kn
    cands = candidates(M, K, N)
    pick = schedule(M, K, N)
    assert max(map(_fill, cands)) >= 0.95
    whole = min(s.cost() for s in cands if s.split == 1)
    split = min((s.cost() for s in cands if s.split > 1), default=whole)
    assert pick.cost() == (split if split < (1 - WGMMA_SPLIT_MARGIN) * whole else whole)
    whole = data_parallel(M, K, N, 128)
    if _fill(whole) < 2 / 3:
        assert _fill(pick) >= _fill(whole)
    if (M, K, N) in ((2048, 2048, 256), (2048, 6144, 128)):
        assert _fill(whole) < 0.25 and _fill(pick) >= 0.7


@pytest.mark.parametrize("M", [2048, 8192])
@pytest.mark.parametrize("kn", MAIN_PATH_KN + OTHER_FORWARD_KN)
def test_split_fits_the_workspace(M, kn):
    """A split schedule's partials fit the workspace, one slot a slice (its
    unit number), and its split tiles the counters."""
    K, N = kn
    for sched in candidates(M, K, N):
        if sched.split == 1:
            continue
        slots = [v for t in range(sched.split_tiles) for v in sched.slices(t)]
        assert sorted(slots) == list(range(sched.split_tiles * sched.split))
        assert sched.split_tiles * sched.split * 128 * sched.bn <= WORKSPACE_FLOATS
        assert sched.split_tiles <= WORKSPACE_COUNTERS


def _emulate(x, w, sched):
    """The kernel's arithmetic on the CPU: per unit an fp32 partial (bf16
    products are exact in fp32), a split tile's partials summed from slice
    0 in k order, one rounding to bf16."""
    M, N = x.shape[0], w.shape[1]
    xf, wf = x.float(), w.float()
    out = torch.empty(M, N)

    def part(v):
        tile, kb0, kb1 = sched.unit(v)
        m0, n0 = (tile % sched.m_tiles) * 128, (tile // sched.m_tiles) * sched.bn
        return (m0, n0), xf[m0:m0 + 128, 64 * kb0:64 * kb1] @ wf[64 * kb0:64 * kb1,
                                                               n0:n0 + sched.bn]

    for tile in range(sched.tiles):
        if tile < sched.split_tiles:
            (m0, n0), acc = part(sched.slices(tile)[0])
            for v in sched.slices(tile)[1:]:
                acc = acc + part(v)[1]
        else:
            (m0, n0), acc = part(tile + sched.split_tiles * (sched.split - 1))
        out[m0:m0 + 128, n0:n0 + sched.bn] = acc
    return out.to(torch.bfloat16)


@pytest.mark.parametrize("shape", RAGGED)
def test_stream_k_emulation_matches_ref(shape):
    """The fixed-order fixup of every candidate schedule and of deeper
    splits (down to one k-block a slice), emulated, agrees with the JAX
    package's matmul_ref and its Pallas kernel (interpret mode) at the bf16
    tolerance, gives the same bits twice, and a fixup that drops one
    partial of a split tile does not agree."""
    M, K, N = shape
    x, w = randn(0, (M, K)), randn(1, (K, N)) / K ** 0.5
    tx, tw = to_torch(x, "bfloat16"), to_torch(w, "bfloat16")
    jx, jw = to_jax(x, "bfloat16"), to_jax(w, "bfloat16")
    want_ref = jax_matmul_ref(jx, jw)
    want_pallas = jax_ltrf_matmul(jx, jw, bm=128, bk=128, bn=128, interpret=True)
    scheds = candidates(M, K, N) + [data_parallel(M, K, N, bn, -(-K // 64)) for bn in (128, 256)
                                    if data_parallel(M, K, N, bn).tiles <= NUM_SMS]
    assert any(s.split > 1 for s in scheds)
    for sched in scheds:
        got = _emulate(tx, tw, sched)
        assert_close(got, want_ref, "bfloat16")
        assert_close(got, want_pallas, "bfloat16")
        assert torch.equal(got, _emulate(tx, tw, sched))
    sched = max(scheds, key=lambda s: s.split)
    tile, kb0, kb1 = sched.unit(sched.slices(0)[sched.split // 2])
    m0, n0 = (tile % sched.m_tiles) * 128, (tile // sched.m_tiles) * sched.bn
    dropped = _emulate(tx, tw, sched).float()
    dropped[m0:m0 + 128, n0:n0 + sched.bn] -= (tx[m0:m0 + 128, 64 * kb0:64 * kb1].float()
                                               @ tw[64 * kb0:64 * kb1, n0:n0 + sched.bn].float())
    with pytest.raises(AssertionError):
        assert_close(dropped.to(torch.bfloat16), want_ref, "bfloat16")
