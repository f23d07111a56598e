"""The port's Hopper kernels against their plain versions on the card.

Marked ``gpu``: each test skips with a reason where no CUDA card is present
(the decision is made inside the fixture, at run time).  On a machine with an
H100: ``PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_smoke, smoke_shape  # noqa: E402
from repro_torch.kernels.flash_attention import attention_ref, flash_attention  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_lse_ref, flash_bwd_ref  # noqa: E402
from repro_torch.kernels.ltrf_matmul import ltrf_matmul, matmul_ref  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_chunk, ssd_chunk_ref, ssd_ref, ssd_scan  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import ssd_chunk_bwd_ref  # noqa: E402
from repro_torch.models import lm  # noqa: E402

pytestmark = pytest.mark.gpu

# stated tolerances: bf16 outputs differ by sum order, at most ~1 bf16 ulp;
# fp32 runs FFMA (not TF32) against torch's full-fp32 product
TOL = {torch.bfloat16: dict(rtol=3e-2, atol=8e-2), torch.float32: dict(rtol=2e-4, atol=1e-4)}
# flash_attention in bf16 (the wgmma kernel) computes S = Q K^T in fp32 (the
# products of bf16 values are exact, so only the sum order differs), rounds P
# to fp16 against V scaled to fp16 by a power of two per KV head (11 bits
# kept) -- or, in FlashAttentionFn's forward, splits P into bf16 hi + lo
# (~16 bits) against the bf16 V -- (a single bf16 P would move single
# outputs by up to ~2e-3 relative and miss the elementwise limit) and
# accumulates P V in fp32; the plain version computes in fp32.  Both round
# once to bf16, so they differ by about one ulp (< 8e-3 of the value) where
# the two fp32 values straddle a rounding point.  In fp32 the kernel is the
# CUDA-core one.  Its outputs are averages over the keys, well below 1, so
# the atol is small.
FLASH_TOL = {torch.bfloat16: dict(rtol=1e-2, atol=1e-3), torch.float32: TOL[torch.float32]}
# ssd_scan's chunk kernel against ssd_chunk_ref, both fp32 (chip_smoke.py's
# limits and their reasons): a relative L2 per output, and elementwise rtol
# 1e-2 with atol 1e-3 times each output's RMS
SSD_RTOL, SSD_ATOL, SSD_REL_L2 = 1e-2, 1e-3, 1e-4


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (sm_90a); run on the H100")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1, 8, 8), (8, 2048, 256), (17, 136, 40), (64, 1024, 96),
                                   (65, 128, 264), (300, 504, 200), (256, 384, 128)])
def test_ltrf_matmul_matches_plain(dev, shape, dtype):
    M, K, N = shape
    g = torch.Generator(dev).manual_seed(0)
    x = torch.randn(M, K, device=dev, generator=g).to(dtype)
    w = (torch.randn(K, N, device=dev, generator=g) / K ** 0.5).to(dtype)
    got = ltrf_matmul(x, w)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), matmul_ref(x, w).float(), **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cfg", [(1, 2, 2, 128, 64, True), (2, 4, 2, 100, 64, True),
                                 (1, 8, 1, 256, 32, True), (1, 2, 1, 77, 128, True),
                                 (1, 2, 2, 130, 32, False)])
def test_flash_attention_matches_plain(dev, cfg, dtype):
    B, H, KV, S, d, causal = cfg
    g = torch.Generator(dev).manual_seed(1)
    q, k, v = (torch.randn(B, n, S, d, device=dev, generator=g).to(dtype) for n in (H, KV, KV))
    got = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), attention_ref(q, k, v, causal).float(),
                               **FLASH_TOL[dtype])


@pytest.mark.parametrize("K,N", [(136, 264), (136, 8512), (5632, 264), (5632, 8512)])
@pytest.mark.parametrize("M", [65, 128, 129, 300, 2048])
def test_ltrf_matmul_wgmma_route_edges(dev, M, K, N):
    """bf16 with M > 64 takes the wgmma route: M, K and N ragged against the
    128-row, 64-deep and 128/256-column tiles."""
    g = torch.Generator(dev).manual_seed(2)
    x = torch.randn(M, K, device=dev, generator=g).bfloat16()
    w = (torch.randn(K, N, device=dev, generator=g) / K ** 0.5).bfloat16()
    before = dict(ltrf_matmul.launches_by_route)
    got = ltrf_matmul(x, w)
    torch.cuda.synchronize()
    assert ltrf_matmul.launches_by_route == {**before, "wgmma": before["wgmma"] + 1}
    torch.testing.assert_close(got.float(), matmul_ref(x, w).float(), **TOL[torch.bfloat16])


# the forward's split schedule at its edges (M, K, N): ragged M, N and K;
# K shorter than one slice of the floor (too shallow to split) and shorter
# than one k-block; tiles that make exactly one wave (1408 rows: 11 x 12
# tiles of 128 x 256); a single tile; and the narrow and ragged-wave rows of
# granite-20b (wk/wv), granite-moe (wk/wv, wq/wo) and phi3 (wk/wv, w_down)
STREAM_K_EDGES = [(1000, 1000, 264), (300, 4104, 136), (2048, 64, 256), (2048, 40, 520),
                  (1408, 2048, 3072), (100, 5000, 104), (2048, 6144, 128), (2048, 1536, 512),
                  (2048, 1536, 1536), (2048, 5120, 1280), (2048, 17920, 5120)]


@pytest.mark.parametrize("M,K,N", STREAM_K_EDGES)
def test_ltrf_matmul_stream_k_edges(dev, M, K, N):
    """The forward wgmma route under every candidate schedule of the shape
    (whole tiles alone, the ragged wave's tiles cut into k-slices, both tile
    widths), under slices down to one k-block and as many as the SMs hold,
    and under the one it picks: each within TOL's bf16 row of matmul_ref,
    two launches the same bits, the pick counted on the wgmma route, and
    every counter back at 0."""
    from repro_torch.kernels.ltrf_matmul import ops as mm_ops
    g = torch.Generator(dev).manual_seed(12)
    x = torch.randn(M, K, device=dev, generator=g).bfloat16()
    w = (torch.randn(K, N, device=dev, generator=g) / K ** 0.5).bfloat16()
    want = matmul_ref(x, w).float()
    before = dict(ltrf_matmul.launches_by_route)
    got, again = ltrf_matmul(x, w), ltrf_matmul(x, w)
    torch.cuda.synchronize()
    assert ltrf_matmul.launches_by_route == {**before, "wgmma": before["wgmma"] + 2}
    assert torch.equal(got, again)
    torch.testing.assert_close(got.float(), want, **TOL[torch.bfloat16])
    deep = []
    for bn in (128, 256):
        dp = mm_ops.data_parallel(M, K, N, bn)
        rem, n_k = dp.tiles % mm_ops.NUM_SMS, dp.n_k
        splits = {2, n_k, mm_ops.NUM_SMS // max(rem, 1)}
        deep += [mm_ops.data_parallel(M, K, N, bn, s) for s in splits
                 if rem and 1 < s <= n_k and s * rem <= mm_ops.NUM_SMS]
    for s in mm_ops.candidates(M, K, N) + deep:
        outs = [torch.full((M, N), float("nan"), dtype=torch.bfloat16, device=dev)
                for _ in range(2)]
        for out in outs:
            mm_ops._launch(x, w, out, K, "nn", (128, 64, s.bn), mm_ops.wgmma_stages(s.bn), 1, s)
        torch.cuda.synchronize()
        assert torch.equal(outs[0], outs[1]), s
        torch.testing.assert_close(outs[0].float(), want, **TOL[torch.bfloat16], msg=str(s))
    assert not mm_ops._workspace(dev)[1].any()


@pytest.mark.parametrize("N", [8, 264, 2048, 50280])
@pytest.mark.parametrize("K", [136, 2048, 5632])
@pytest.mark.parametrize("M", [1, 7, 8, 9, 16, 33, 64])
def test_ltrf_matmul_decode_route_edges(dev, M, K, N):
    """bf16 with M <= 64 takes the decode route: rows padded to 8-64, K ragged
    against the 32-row stages and split over up to 132 CTAs a tile, N
    ragged against the 64-column tiles (and narrower than one)."""
    g = torch.Generator(dev).manual_seed(4)
    x = torch.randn(M, K, device=dev, generator=g).bfloat16()
    w = (torch.randn(K, N, device=dev, generator=g) / K ** 0.5).bfloat16()
    before = dict(ltrf_matmul.launches_by_route)
    got = ltrf_matmul(x, w)
    torch.cuda.synchronize()
    assert ltrf_matmul.launches_by_route == {**before, "decode": before["decode"] + 1}
    torch.testing.assert_close(got.float(), matmul_ref(x, w).float(), **TOL[torch.bfloat16])


@pytest.mark.parametrize("shape", [(8, 2048, 256), (8, 2048, 2048), (8, 5632, 2048), (3, 136, 8)])
def test_ltrf_matmul_decode_is_deterministic(dev, shape):
    """The split-K partials are summed in a fixed order by the last CTA of
    each tile: two launches on the same inputs give the same bits."""
    M, K, N = shape
    g = torch.Generator(dev).manual_seed(5)
    x = torch.randn(M, K, device=dev, generator=g).bfloat16()
    w = (torch.randn(K, N, device=dev, generator=g) / K ** 0.5).bfloat16()
    first = ltrf_matmul(x, w)
    for _ in range(3):
        assert torch.equal(ltrf_matmul(x, w), first)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("heads", [(4, 4), (4, 2), (4, 1)], ids=["mha", "gqa", "mqa"])
@pytest.mark.parametrize("S", [1, 63, 65, 1000, 1024])
@pytest.mark.parametrize("d", [16, 32, 64, 128])
def test_flash_attention_wgmma_route_edges(dev, d, S, heads, causal):
    """bf16 takes the wgmma route at every head dim, S ragged against the
    128-row query and KV tiles, in MHA, GQA and MQA."""
    H, KV = heads
    g = torch.Generator(dev).manual_seed(3)
    q, k, v = (torch.randn(2, n, S, d, device=dev, generator=g).bfloat16() for n in (H, KV, KV))
    before = dict(flash_attention.launches_by_route)
    got = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention.launches_by_route == {**before, "wgmma": before["wgmma"] + 1}
    torch.testing.assert_close(got.float(), attention_ref(q, k, v, causal).float(),
                               **FLASH_TOL[torch.bfloat16])


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    x = torch.randn(8, 10, device=dev)             # K not a multiple of 4 floats
    with pytest.raises(ValueError):
        ltrf_matmul(x, torch.randn(10, 16, device=dev))
    with pytest.raises(TypeError):
        ltrf_matmul(x.half(), torch.randn(10, 16, device=dev).half())
    q = torch.randn(1, 2, 16, 48, device=dev)      # head_dim 48 not built
    with pytest.raises(ValueError):
        flash_attention(q, q, q)


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "qwen3-0.6b"])
def test_smoke_model_kernel_path_matches_plain_path(dev, arch):
    cfg = dataclasses.replace(get_smoke(arch), dtype="float32")
    params = lm.init_params(cfg, torch.Generator(dev).manual_seed(0), dev)
    toks = torch.randint(0, cfg.vocab, (2, 40), device=dev,
                         generator=torch.Generator(dev).manual_seed(1))
    batch = {"tokens": toks, "labels": toks}
    before = ltrf_matmul.launches, flash_attention.launches
    got, _ = lm.logits_fn(params, batch, cfg)
    assert ltrf_matmul.launches - before[0] == 7 * cfg.n_layers + 1
    assert flash_attention.launches - before[1] == cfg.n_layers
    want, _ = lm.logits_fn(params, batch, cfg, kernels=False)
    torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-3)


def _ssd_inputs(B, S, H, P, N, dev, seed=0):
    g = torch.Generator(dev).manual_seed(seed)
    x = torch.nn.functional.silu(torch.randn(B, S, H, P, device=dev, generator=g))
    dt = torch.nn.functional.softplus(torch.randn(B, S, H, device=dev, generator=g))
    A = -torch.linspace(1.0, 16.0, H, device=dev)
    Bm, Cm = (torch.nn.functional.silu(torch.randn(B, S, N, device=dev, generator=g))
              for _ in range(2))
    return x, dt, A, Bm, Cm


def _ssd_within(got, want) -> bool:
    ok = True
    for g, w in zip(got, want):
        rms = w.square().mean().sqrt()
        ok &= bool(((g - w).abs() <= SSD_ATOL * rms + SSD_RTOL * w.abs()).all())
        ok &= bool((g - w).norm() <= SSD_REL_L2 * w.norm())
    return ok


@pytest.mark.parametrize("shape", [(2, 1024, 8, 64, 128, 256), (1, 1000, 4, 64, 128, 256),
                                   (2, 1024, 4, 64, 64, 256), (2, 300, 3, 16, 16, 96),
                                   (1, 77, 2, 8, 12, 32), (1, 40, 2, 4, 4, 16),
                                   (1, 130, 2, 128, 128, 64)])
def test_ssd_chunk_matches_plain(dev, shape):
    B, S, H, P, N, Q = shape
    ins = _ssd_inputs(B, S, H, P, N, dev)
    before = ssd_scan.launches
    got = ssd_chunk(*ins, Q)
    torch.cuda.synchronize()
    assert ssd_scan.launches == before + 1
    want = ssd_chunk_ref(*ins, Q)
    assert [tuple(g.shape) for g in got] == [tuple(w.shape) for w in want]
    assert _ssd_within(got, want)


@pytest.mark.parametrize("N", [16, 64, 128])
@pytest.mark.parametrize("Q", [64, 96, 256])
@pytest.mark.parametrize("H", [1, 3, 64])
def test_ssd_chunk_head_groups_and_ragged_s(dev, H, Q, N):
    """H not a multiple of the kernel's head groups (8 for y, 4 for states),
    Q not a multiple of its 64-row blocks, S ragged against Q."""
    S = 2 * Q + 37
    ins = _ssd_inputs(1, S, H, 64, N, dev, seed=H + Q + N)
    got = ssd_chunk(*ins, Q)
    torch.cuda.synchronize()
    assert _ssd_within(got, ssd_chunk_ref(*ins, Q))


def test_ssd_check_catches_a_zeroed_block(dev):
    ins = _ssd_inputs(2, 1024, 4, 64, 128, dev, seed=3)
    got = ssd_chunk(*ins, 256)
    x = ins[0].clone()
    x[:, 320:384] = 0                          # rows 64..127 of the second chunk
    assert not _ssd_within(got, ssd_chunk_ref(x, *ins[1:], 256))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_scan_matches_recurrence(dev, dtype):
    ins = [t.to(dtype) if i != 2 else t for i, t in enumerate(_ssd_inputs(1, 200, 3, 16, 32, dev))]
    y, fin = ssd_scan(*ins, chunk=64)
    yr, finr = ssd_ref(*ins)
    assert y.dtype == dtype and fin.dtype == torch.float32
    tol = TOL[dtype] if dtype == torch.bfloat16 else dict(rtol=3e-3, atol=3e-3)
    torch.testing.assert_close(y.float(), yr.float(), **tol)
    torch.testing.assert_close(fin, finr, rtol=3e-3, atol=3e-3)


def test_ssd_wrapper_refuses_what_the_kernel_does_not_take(dev):
    ins = _ssd_inputs(1, 64, 2, 8, 16, dev)
    with pytest.raises(ValueError):
        ssd_chunk(*ins, 512)                      # chunk > 256
    with pytest.raises(ValueError):
        ssd_chunk(ins[0][..., :6].contiguous(), *ins[1:], 32)   # P not a multiple of 4
    with pytest.raises(ValueError):
        ssd_chunk(ins[0].transpose(1, 2).contiguous().transpose(1, 2), *ins[1:], 32)
    with pytest.raises(TypeError):
        ssd_chunk(*[t.half() for t in ins], 32)
    with pytest.raises(ValueError):
        ssd_chunk(ins[0].cpu(), *ins[1:], 32)


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "zamba2-1.2b"])
def test_ssm_smoke_model_kernel_path_matches_plain_path(dev, arch):
    cfg = dataclasses.replace(get_smoke(arch), dtype="float32")
    params = lm.init_params(cfg, torch.Generator(dev).manual_seed(0), dev)
    toks = torch.randint(0, cfg.vocab, (2, 40), device=dev,
                         generator=torch.Generator(dev).manual_seed(1))
    batch = {"tokens": toks, "labels": toks}
    shared = cfg.n_layers // cfg.attn_every if cfg.family == "hybrid" else 0
    before = ltrf_matmul.launches, flash_attention.launches, ssd_scan.launches
    got, _ = lm.logits_fn(params, batch, cfg)
    assert ltrf_matmul.launches - before[0] == 2 * cfg.n_layers + 7 * shared + 1
    assert flash_attention.launches - before[1] == shared
    assert ssd_scan.launches - before[2] == cfg.n_layers
    want, _ = lm.logits_fn(params, batch, cfg, kernels=False)
    torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-3)
    ck, cp = (lm.init_decode_cache(cfg, 2, 8, dev) for _ in range(2))
    for step in range(3):
        lk, ck = lm.decode_step(params, ck, toks[:, step:step + 1], step, cfg)
        lp, cp = lm.decode_step(params, cp, toks[:, step:step + 1], step, cfg, kernels=False)
        torch.testing.assert_close(lk, lp, rtol=1e-3, atol=1e-3)


# the moe, audio, vlm and wide dense families' projections (K, N), the
# padded 49216-wide granite-moe head included, on both bf16 routes
NEW_FAMILY_SHAPES = [
    (1536, 1536), (1536, 512), (1536, 49216),                      # granite-moe-3b-a800m
    (2048, 2048), (2048, 8192), (8192, 2048),                      # musicgen-large
    (7168, 7168), (7168, 1024), (7168, 20480), (7168, 64000), (20480, 7168),  # llava-next-34b
    (6144, 6144), (6144, 1024), (6144, 100352),                    # dbrx-132b
    (5120, 5120), (5120, 1280), (5120, 17920), (5120, 100352), (17920, 5120),  # phi3-medium-14b
    (6144, 128), (6144, 24576), (6144, 49152), (24576, 6144),      # granite-20b
]


@pytest.mark.parametrize("M", [8, 2048])
@pytest.mark.parametrize("K,N", NEW_FAMILY_SHAPES)
def test_ltrf_matmul_new_family_shapes(dev, K, N, M):
    g = torch.Generator(dev).manual_seed(6)
    x = torch.randn(M, K, device=dev, generator=g).bfloat16()
    w = (torch.randn(K, N, device=dev, generator=g) / K ** 0.5).bfloat16()
    route = "decode" if M <= 64 else "wgmma"
    before = dict(ltrf_matmul.launches_by_route)
    got = ltrf_matmul(x, w)
    torch.cuda.synchronize()
    assert ltrf_matmul.launches_by_route == {**before, route: before[route] + 1}
    torch.testing.assert_close(got.float(), matmul_ref(x, w).float(), **TOL[torch.bfloat16])


@pytest.mark.parametrize("H,KV,d", [(24, 8, 64), (32, 32, 64), (56, 8, 128), (48, 8, 128),
                                    (40, 10, 128), (48, 1, 128)],
                         ids=["granite-moe", "musicgen", "llava", "dbrx", "phi3", "granite-20b"])
def test_flash_attention_new_family_shapes(dev, H, KV, d):
    g = torch.Generator(dev).manual_seed(7)
    q, k, v = (torch.randn(2, n, 1024, d, device=dev, generator=g).bfloat16() for n in (H, KV, KV))
    before = dict(flash_attention.launches_by_route)
    got = flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert flash_attention.launches_by_route == {**before, "wgmma": before["wgmma"] + 1}
    torch.testing.assert_close(got.float(), attention_ref(q, k, v).float(),
                               **FLASH_TOL[torch.bfloat16])


@pytest.mark.parametrize("split_p", [False, True], ids=["fp16_p", "split_p"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("heads", [(32, 4), (16, 1)], ids=["gqa", "mqa"])
@pytest.mark.parametrize("d", [16, 32, 64, 128])
def test_flash_attention_persistent_walks_many_tiles(dev, d, heads, causal, split_p):
    """More work tiles (B H x 128-row query blocks: 1,024 or 496) than the
    card has SMs, so each persistent CTA walks several, its rings running on
    from tile to tile, with a ragged S, in both forms of P (training's
    forward splits it), the LSE written; two launches give the same bits."""
    H, KV = heads
    S = 2048 if H == 32 else 1983
    g = torch.Generator(dev).manual_seed(8)
    q, k, v = (torch.randn(2, n, S, d, device=dev, generator=g).bfloat16() for n in (H, KV, KV))
    got, lse = flash_ops._attend(q, k, v, causal, True, split_p)
    again = flash_ops._attend(q, k, v, causal, True, split_p)[0]
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    want, want_lse = attention_lse_ref(q, k, v, causal)
    torch.testing.assert_close(got.float(), want.float(), **FLASH_TOL[torch.bfloat16])
    torch.testing.assert_close(lse, want_lse, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("d", [16, 32, 64, 128])
def test_flash_attention_scaled_v_heads(dev, d):
    """V's KV heads at 2^20, 2^-20, 1 and 0 times N(0, 1): the pre-pass
    scales each to fp16 by a power of two of its own and the kernel scales
    each head's output back; each query head within the flash limits, its
    atol times its V's scale, and a relative L2 of its own."""
    B, H, KV, S = 2, 8, 4, 300
    g = torch.Generator(dev).manual_seed(9)
    q, k, v = (torch.randn(B, n, S, d, device=dev, generator=g) for n in (H, KV, KV))
    scales = torch.tensor([2.0 ** 20, 2.0 ** -20, 1.0, 0.0], device=dev)
    q, k, v = q.bfloat16(), k.bfloat16(), (v * scales[None, :, None, None]).bfloat16()
    got = flash_attention(q, k, v).float()
    torch.cuda.synchronize()
    want = attention_ref(q, k, v).float()
    tol = FLASH_TOL[torch.bfloat16]
    for h, sc in enumerate(scales.repeat_interleave(H // KV).tolist()):
        torch.testing.assert_close(got[:, h], want[:, h], rtol=tol["rtol"], atol=tol["atol"] * sc)
        assert float((got[:, h] - want[:, h]).norm()) <= 1e-2 * float(want[:, h].norm())


@pytest.mark.parametrize("d", [16, 32, 64, 128])
def test_flash_attention_nonfinite_v_keeps_its_heads_range(dev, d):
    """A KV head holding NaN beside finite values above fp16's 65504 (N(0, 1)
    times 2^20), another holding inf: the pre-pass takes each head's
    exponent from its largest finite value, so query rows whose causal tiles
    never reach the non-finite key stay finite and within the flash limits
    (atol times the head's scale), and rows that attend it are NaN or inf as
    in the plain version."""
    B, H, KV, S, pos = 2, 4, 2, 300, 200
    g = torch.Generator(dev).manual_seed(12)
    q, k, v = (torch.randn(B, n, S, d, device=dev, generator=g) for n in (H, KV, KV))
    v[:, 0] *= 2.0 ** 20
    q, k, v = q.bfloat16(), k.bfloat16(), v.bfloat16()
    v[:, 0, pos, 0] = float("nan")
    v[:, 1, pos, 1] = float("inf")
    got = flash_attention(q, k, v).float()
    torch.cuda.synchronize()
    clean = v.clone()
    clean[:, :, pos] = 0
    want = attention_ref(q, k, clean).float()      # rows < pos never attend key pos
    tol = FLASH_TOL[torch.bfloat16]
    for h, sc in enumerate([2.0 ** 20] * (H // KV) + [1.0] * (H // KV)):
        torch.testing.assert_close(got[:, h, :128], want[:, h, :128], rtol=tol["rtol"],
                                   atol=tol["atol"] * sc)
    assert torch.isnan(got[:, :H // KV, pos:, 0]).all()
    assert torch.isinf(got[:, H // KV:, pos:, 1]).all()


def _family_batch(cfg, dev, S=40):
    g = torch.Generator(dev).manual_seed(1)
    if cfg.family == "audio":
        codes = torch.randint(0, cfg.vocab, (2, cfg.n_codebooks, S), device=dev, generator=g)
        return {"codes": codes, "labels": codes}
    toks = torch.randint(0, cfg.vocab, (2, S), device=dev, generator=g)
    if cfg.family == "vlm":
        patches = 0.02 * torch.randn(2, cfg.n_patches, cfg.d_model, device=dev, generator=g)
        labels = torch.cat([toks.new_zeros((2, cfg.n_patches)), toks], 1)
        return {"tokens": toks, "patches": patches, "labels": labels}
    return {"tokens": toks, "labels": toks}


@pytest.mark.parametrize("vocab", [None, 253])
@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "dbrx-132b", "musicgen-large",
                                  "llava-next-34b", "granite-20b"])
def test_new_family_smoke_model_kernel_path_matches_plain_path(dev, arch, vocab):
    cfg = dataclasses.replace(get_smoke(arch), dtype="float32")
    if vocab:
        cfg = dataclasses.replace(cfg, vocab=vocab)
    params = lm.init_params(cfg, torch.Generator(dev).manual_seed(0), dev)
    batch = _family_batch(cfg, dev)
    dense = 3 if cfg.family != "moe" else 0
    before = ltrf_matmul.launches, flash_attention.launches
    got, _ = lm.logits_fn(params, batch, cfg)
    assert ltrf_matmul.launches - before[0] == (4 + dense) * cfg.n_layers + 1
    assert flash_attention.launches - before[1] == cfg.n_layers
    want, _ = lm.logits_fn(params, batch, cfg, kernels=False)
    torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-3)
    ck, cp = (lm.init_decode_cache(cfg, 2, 8, dev) for _ in range(2))
    for step in range(3):
        toks = (batch["codes"][:, :, step:step + 1] if cfg.family == "audio"
                else batch["tokens"][:, step:step + 1])
        lk, ck = lm.decode_step(params, ck, toks, step, cfg)
        lp, cp = lm.decode_step(params, cp, toks, step, cfg, kernels=False)
        torch.testing.assert_close(lk, lp, rtol=1e-3, atol=1e-3)


# ---------------------------------------------------------------------------
# training: gradients through the kernels' autograd Functions
# ---------------------------------------------------------------------------

from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.kernels.ltrf_matmul import ops as mm_ops  # noqa: E402
from repro_torch.kernels.ssd_scan import ops as ssd_ops  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.runtime.train_step import grads_of  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

TRAIN_ARCHS = ["tinyllama-1.1b", "mamba2-1.3b", "zamba2-1.2b", "granite-moe-3b-a800m"]
# kernel path against plain path, per gradient leaf, as a relative L2 (the
# largest over the leaves), per dtype and family, each between the sound
# reading and the weakest planted fault's (NVIDIA H100 80GB HBM3, 700 W;
# the tests print their readings under ``-s``).  fp32, where the paths
# differ by sum order: sound 7.9e-7 (dense), 7.0e-7 (moe), 1.3e-5 (ssm) and
# 3.7e-4 (hybrid: zamba2's A_log and dt_bias gradients sum ssd_scan's small
# bf16x3 rounding over every position).  bf16, where the paths round at
# other points: sound 1.1e-4, 3.4e-3, 3.5e-3 and 2.0e-2, with the MoE
# routing pinned (see _grads_both_paths).  The faults of FAMILY_FAULTS read
# 0.18-1.0 in both dtypes, the weakest a dropped in_decay gradient (0.18 on
# the hybrid, 0.33 on the ssm model), the others >= 0.82.
GRAD_REL_L2 = {torch.float32: {"dense": 1e-4, "moe": 1e-4, "ssm": 2e-3, "hybrid": 2e-3},
               torch.bfloat16: {"dense": 5e-2, "moe": 5e-2, "ssm": 5e-2, "hybrid": 5e-2}}

_real_matmul_vjp = mm_ops.matmul_vjp
_real_flash_bwd = flash_ops.flash_bwd
_real_ssd_bwd = ssd_ops.ssd_chunk_bwd


def _dw_zeroed(x, w, dy, needs):
    dx, dw = _real_matmul_vjp(x, w, dy, needs)
    return dx, None if dw is None else torch.zeros_like(dw)


# planted faults in the kernels' backward (chip_smoke.py's): name -> (module,
# attribute, replacement), and the faults each family's backward can reach
GRAD_FAULTS = {
    "matmul_dw_zeroed": (mm_ops, "matmul_vjp", _dw_zeroed),
    "flash_not_causal": (flash_ops, "flash_bwd", lambda q, k, v, o, lse, do, causal:
                         _real_flash_bwd(q, k, v, *flash_ops._attend(q, k, v, False, True), do,
                                         False)),
    "ssd_in_decay_dropped": (ssd_ops, "ssd_chunk_bwd", lambda ins, chunk, g: _real_ssd_bwd(
        ins, chunk, (g[0], g[1], None, g[3]))),
}
FAMILY_FAULTS = {"dense": ("matmul_dw_zeroed", "flash_not_causal"),
                 "moe": ("matmul_dw_zeroed", "flash_not_causal"),
                 "ssm": ("matmul_dw_zeroed", "ssd_in_decay_dropped"),
                 "hybrid": ("matmul_dw_zeroed", "flash_not_causal", "ssd_in_decay_dropped")}


def _train_batch(cfg, dev, B=2, S=40):
    g = torch.Generator(dev).manual_seed(1)
    toks = torch.randint(0, cfg.vocab, (B, S), device=dev, generator=g)
    return {"tokens": toks, "labels": toks}


def _grad_rel_l2(a, b) -> list:
    return [float((x.float() - y.float()).norm() / y.float().norm().clamp_min(1e-30))
            for x, y in zip(tree_leaves(a), tree_leaves(b))]


def _grads_both_paths(dev, arch, dtype, monkeypatch, fault=None):
    """(kernel-path loss, plain-path loss, per-leaf relative L2s, kernel-path
    grads) of the smoke model under remat, ``fault`` planted in the kernel
    path's backward.  The MoE router's top-k is pinned to the plain path's
    choices (recorded there, replayed in the same call order on the kernel
    path), so a near-tie that the two paths' rounding breaks apart does not
    send a token to another expert."""
    cfg = dataclasses.replace(get_smoke(arch), dtype=str(dtype).split(".")[-1], remat="full")
    params = lm.init_params(cfg, torch.Generator(dev).manual_seed(0), dev)
    batch = _train_batch(cfg, dev)
    real_gates, chosen, replayed = moe.top_k_gates, [], []

    def recording(probs, top_k):
        gates, idx = real_gates(probs, top_k)
        chosen.append(idx)
        return gates, idx

    def replaying(probs, top_k):
        idx = chosen[len(replayed)]
        replayed.append(idx)
        vals = probs.gather(-1, idx)
        return vals / (vals.sum(-1, keepdim=True) + 1e-9), idx

    with monkeypatch.context() as m:
        m.setattr(moe, "top_k_gates", recording)
        lp, _, gp = grads_of(cfg, params, batch, kernels=False)
    with monkeypatch.context() as m:
        m.setattr(moe, "top_k_gates", replaying)
        if fault:
            m.setattr(*GRAD_FAULTS[fault])
        lk, _, gk = grads_of(cfg, params, batch)
    assert len(replayed) == len(chosen)
    return lk, lp, _grad_rel_l2(gk, gp), gk


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_kernel_path_gradients_match_plain_path(dev, arch, dtype, monkeypatch):
    lk, lp, errs, gk = _grads_both_paths(dev, arch, dtype, monkeypatch)
    print(f"GRADS sound {arch} {dtype} {max(errs):.3e}")
    assert all(bool(torch.isfinite(g).all()) for g in tree_leaves(gk))
    assert max(errs) <= GRAD_REL_L2[dtype][get_smoke(arch).family], errs
    torch.testing.assert_close(lk, lp, rtol=2e-2 if dtype == torch.bfloat16 else 1e-4, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("arch,fault", [(a, f) for a in TRAIN_ARCHS
                                        for f in FAMILY_FAULTS[get_smoke(a).family]])
def test_gradient_limits_fail_planted_faults(dev, arch, fault, dtype, monkeypatch):
    """Each backward fault the family can reach reads above its limit."""
    _, _, errs, _ = _grads_both_paths(dev, arch, dtype, monkeypatch, fault)
    print(f"GRADS fault {arch} {dtype} {fault} {max(errs):.3e}")
    assert max(errs) > GRAD_REL_L2[dtype][get_smoke(arch).family], errs


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_backward_matmuls_take_the_kernel_routes(dev, arch, monkeypatch):
    """Every ltrf_matmul launch of a train step's gradient -- forward, remat
    recompute and both backward products -- is counted on wgmma (a forward
    with M <= 64 on decode), in its layout: nn for the forward and the
    recompute, nt for each dX and tn for each dW."""
    cfg = dataclasses.replace(get_smoke(arch), remat="full")
    params = lm.init_params(cfg, torch.Generator(dev).manual_seed(0), dev)
    seen = []
    real = mm_ops._product

    def product(a, b, layout="nn"):
        before = dict(ltrf_matmul.launches_by_route), dict(ltrf_matmul.launches_by_layout)
        out = real(a, b, layout)
        after = ltrf_matmul.launches_by_route, ltrf_matmul.launches_by_layout
        seen.append((out.shape[0], layout, [r for r in after[0] if after[0][r] != before[0][r]],
                     [k for k in after[1] if after[1][k] != before[1][k]]))
        return out

    monkeypatch.setattr(mm_ops, "_product", product)
    batch = _train_batch(cfg, dev, B=4, S=64)
    with torch.no_grad():
        lm.loss_fn(params, batch, cfg)
    forward = len(seen)
    seen.clear()
    grads_of(cfg, params, batch)
    assert all(routes == ["wgmma" if M > 64 or layout != "nn" else "decode"]
               and layouts == [layout] for M, layout, routes, layouts in seen), seen
    # the forward, the blocks' recompute (all but the head) and two products each
    assert len(seen) == forward + (forward - 1) + 2 * forward
    assert [layout for _, layout, _, _ in seen].count("nt") == forward
    assert [layout for _, layout, _, _ in seen].count("tn") == forward


def _within_tol_at_rms(got, want) -> bool:
    """TOL's bf16 row with its atol scaled by the plain output's RMS (the
    backward products' outputs are not of unit size: dX ~ 1/sqrt(K), dW ~
    sqrt(M/N)), as chip_smoke.py's check_train_matmuls holds them."""
    got, want = got.float(), want.float()
    rms = float(want.square().mean().sqrt().clamp_min(1e-30))
    tol = TOL[torch.bfloat16]
    return bool(((got - want).abs() <= tol["atol"] * rms + tol["rtol"] * want.abs()).all())


def _vjp_inputs(dev, M, K, N, dtype, seed=7):
    g = torch.Generator(dev).manual_seed(seed)
    x = torch.randn(M, K, device=dev, generator=g).to(dtype)
    w = (torch.randn(K, N, device=dev, generator=g) / K ** 0.5).to(dtype)
    dy = (torch.randn(M, N, device=dev, generator=g) / N ** 0.5).to(dtype)
    return x, w, dy


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,K,N", [(M, K, N) for M in (7, 80, 1000, 8190)
                                   for K, N in ((2048, 256), (264, 2048), (136, 264))]
                         + [(1000, 2048, 32000)])
def test_matmul_vjp_matches_plain(dev, M, K, N, dtype):
    """dX = dY w^T (layout nt) and dW = x^T dY (layout tn) against matmul_ref
    at row counts off every tile and 16-byte edge, narrow and 32000-wide N:
    bf16 on the wgmma route with the operands read in place (split where the
    tiles are few), fp32 on its FFMA route through copies; one launch of
    each layout per call."""
    x, w, dy = _vjp_inputs(dev, M, K, N, dtype)
    before = dict(ltrf_matmul.launches_by_layout), dict(ltrf_matmul.launches_by_route)
    dx, dw = mm_ops.matmul_vjp(x, w, dy, (True, True))
    torch.cuda.synchronize()
    assert ltrf_matmul.launches_by_layout == {**before[0], "nt": before[0]["nt"] + 1,
                                              "tn": before[0]["tn"] + 1}
    kind = "wgmma" if dtype == torch.bfloat16 else "fp32"
    assert ltrf_matmul.launches_by_route == {**before[1], kind: before[1][kind] + 2}
    want_dx, want_dw = matmul_ref(dy, w.t()), matmul_ref(x.t(), dy)
    if dtype == torch.bfloat16:
        assert _within_tol_at_rms(dx, want_dx) and _within_tol_at_rms(dw, want_dw)
    else:
        torch.testing.assert_close(dx, want_dx, **TOL[dtype])
        torch.testing.assert_close(dw, want_dw, **TOL[dtype])


@pytest.mark.parametrize("shape", [(8192, 2048, 256), (1000, 2048, 256), (8190, 136, 264),
                                   (64, 264, 2048), (2048, 2048, 5632)])
def test_matmul_vjp_gives_the_same_bits_twice(dev, shape):
    """dX and dW, split products included (their partials summed in a fixed
    order by each tile's last CTA), give the same bits on every launch."""
    M, K, N = shape
    x, w, dy = _vjp_inputs(dev, M, K, N, torch.bfloat16, seed=8)
    splits = (mm_ops.split_k(M, N, K, 2, "nt"), mm_ops.split_k(K, M, N, 2, "tn"))
    if shape in ((8192, 2048, 256), (1000, 2048, 256)):
        assert splits[1] > 1
    first = mm_ops.matmul_vjp(x, w, dy, (True, True))
    for _ in range(3):
        again = mm_ops.matmul_vjp(x, w, dy, (True, True))
        assert torch.equal(again[0], first[0]) and torch.equal(again[1], first[1])


def test_matmul_vjp_copies_nothing(dev):
    """One bf16 matmul_vjp call with contiguous operands: no copy or clone
    op under the profiler, one nt and one tn launch, nothing else."""
    from torch.profiler import ProfilerActivity, profile
    x, w, dy = _vjp_inputs(dev, 8192, 2048, 256, torch.bfloat16, seed=9)
    mm_ops.matmul_vjp(x, w, dy, (True, True))          # builds, plans, the workspace
    torch.cuda.synchronize()
    before = dict(ltrf_matmul.launches_by_layout)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        mm_ops.matmul_vjp(x, w, dy, (True, True))
    torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages()]
    assert not [n for n in names if n in ("aten::copy_", "aten::clone", "aten::constant_pad_nd",
                                          "aten::matmul", "aten::mm")]
    assert ltrf_matmul.launches_by_layout == {**before, "nt": before["nt"] + 1,
                                              "tn": before["tn"] + 1}


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_backward_reaches_every_weight(dev, arch):
    """loss.backward() with grad enabled: no weight's .grad is left None."""
    cfg = get_smoke(arch)
    params = lm.init_params(cfg, torch.Generator(dev).manual_seed(0), dev)
    for t in tree_leaves(params):
        t.requires_grad_()
    loss, _ = lm.loss_fn(params, _train_batch(cfg, dev), cfg)
    loss.backward()
    assert all(t.grad is not None for t in tree_leaves(params))


def test_every_kernel_output_carries_a_backward(dev):
    x = torch.randn(128, 64, device=dev, dtype=torch.bfloat16, requires_grad=True)
    w = torch.randn(64, 128, device=dev, dtype=torch.bfloat16, requires_grad=True)
    assert ltrf_matmul(x, w).grad_fn is not None
    q = torch.randn(1, 4, 64, 64, device=dev, dtype=torch.bfloat16, requires_grad=True)
    kv = torch.randn(1, 2, 64, 64, device=dev, dtype=torch.bfloat16, requires_grad=True)
    assert flash_attention(q, kv, kv).grad_fn is not None
    ins = [t.requires_grad_() for t in _ssd_inputs(1, 64, 4, 16, 16, dev)]
    assert all(o.grad_fn is not None for o in ssd_chunk(*ins, 32))


# ------------------------------------------------ the backward kernels

# flash's backward kernel against flash_bwd_ref on the same inputs, O and
# LSE from the kernel forward, per gradient as a relative L2: in fp32 (CUDA
# cores) sum order only; in bf16 (wgmma) the kernel rounds P and dS once to
# bf16 before its products (emulated on the CPU at the train shape: 2.4e-3 against
# an fp32 backward) and each gradient to bf16 at the end
FLASH_BWD_REL_L2 = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
# ssd_scan's backward kernel (its products in bf16x3) against
# ssd_chunk_bwd_ref run in float64, per gradient: dA sums a reverse cumsum
# whose terms cancel (with only the states' gradient its first entry is 0 in
# exact arithmetic), so an fp32 plain version is itself ~1e-4 off there
SSD_BWD_REL_L2 = 1e-4


def _ssd_bwd_f64(ins, Q, grads):
    """ssd_chunk_bwd_ref in float64 on the same inputs and gradients."""
    return ssd_chunk_bwd_ref(*(t.double() for t in ins), Q,
                             tuple(None if g is None else g.double() for g in grads))


def _flash_bwd_inputs(dev, B, H, KV, S, d, causal, dtype, seed=3):
    g = torch.Generator(dev).manual_seed(seed)
    q, k, v = (torch.randn(B, n, S, d, device=dev, generator=g).to(dtype) for n in (H, KV, KV))
    do = torch.randn(B, H, S, d, device=dev, generator=g).to(dtype)
    o, lse = flash_ops._attend(q, k, v, causal, with_lse=True)
    return q, k, v, o, lse, do


def _rel_l2s(got, want) -> list:
    return [float((a.double() - b.double()).norm() / b.double().norm().clamp_min(1e-30))
            for a, b in zip(got, want)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("heads", [(4, 4), (4, 2), (8, 1)], ids=["mha", "gqa", "mqa"])
@pytest.mark.parametrize("S", [3, 77, 256])
@pytest.mark.parametrize("d", [16, 32, 64, 128])
def test_flash_backward_matches_plain(dev, d, S, heads, causal, dtype):
    H, KV = heads
    q, k, v, o, lse, do = _flash_bwd_inputs(dev, 2, H, KV, S, d, causal, dtype)
    _, want_lse = attention_lse_ref(q, k, v, causal)
    torch.testing.assert_close(lse, want_lse, rtol=1e-5, atol=1e-4)
    before = flash_ops.flash_bwd.launches
    got = flash_ops.flash_bwd(q, k, v, o, lse, do, causal)
    torch.cuda.synchronize()
    assert flash_ops.flash_bwd.launches == before + 1
    assert [g.dtype for g in got] == [dtype] * 3
    errs = _rel_l2s(got, flash_bwd_ref(q, k, v, o, lse, do, causal))
    assert max(errs) <= FLASH_BWD_REL_L2[dtype], errs


# the bf16 kernels' tile edges: a dK/dV CTA owns 128 keys and walks query
# tiles of 64, a dQ CTA owns 128 queries and walks key tiles of 64; S past
# a multiple of 128, S under 64, one KV head (group 8) and group 8 over two
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("heads", [(8, 1), (16, 2)], ids=["kv1", "group8"])
@pytest.mark.parametrize("S", [40, 130, 1000])
@pytest.mark.parametrize("d", [16, 32, 64, 128])
def test_flash_backward_tile_edges(dev, d, S, heads, causal):
    H, KV = heads
    ins = _flash_bwd_inputs(dev, 2, H, KV, S, d, causal, torch.bfloat16, seed=5)
    got = flash_ops.flash_bwd(*ins, causal)
    again = flash_ops.flash_bwd(*ins, causal)
    torch.cuda.synchronize()
    errs = _rel_l2s(got, flash_bwd_ref(*ins, causal))
    assert max(errs) <= FLASH_BWD_REL_L2[torch.bfloat16], errs
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_backward_checks_fail_planted_faults(dev, dtype):
    """A non-causal backward, the GQA group sum dropped and D dropped (O
    read as zeros) each read above the limit."""
    q, k, v, o, lse, do = _flash_bwd_inputs(dev, 2, 8, 2, 200, 64, True, dtype)
    want = flash_bwd_ref(q, k, v, o, lse, do, True)
    rep = q.shape[1] // k.shape[1]
    dq, dke, dve = flash_ops.flash_bwd(q, *(t.repeat_interleave(rep, 1) for t in (k, v)), o, lse,
                                       do, True)
    faults = {"not_causal": flash_ops.flash_bwd(
                  q, k, v, *flash_ops._attend(q, k, v, False, True), do, False),
              "group_sum_dropped": (dq, dke[:, ::rep] * rep, dve[:, ::rep] * rep),
              "delta_dropped": flash_ops.flash_bwd(q, k, v, torch.zeros_like(o), lse, do, True)}
    for name, got in faults.items():
        assert max(_rel_l2s(got, want)) > FLASH_BWD_REL_L2[dtype], name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_backward_gives_the_same_bits_twice(dev, dtype):
    ins = _flash_bwd_inputs(dev, 2, 32, 4, 1024, 64, True, dtype)
    a, b = flash_ops.flash_bwd(*ins, True), flash_ops.flash_bwd(*ins, True)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_flash_lse_leaves_the_output_bits(dev):
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, o, _, _ = _flash_bwd_inputs(dev, 2, 8, 2, 300, 64, True, dtype)
        assert torch.equal(o, flash_ops._attend(q, k, v, True, with_lse=False)[0])
        split = flash_ops._attend(q, k, v, True, True, split_p=True)[0]   # training's form
        assert torch.equal(split, flash_ops._attend(q, k, v, True, False, split_p=True)[0])


def _ssd_grads(outs, dev, seed, used=(0, 1, 2, 3)):
    g = torch.Generator(dev).manual_seed(seed)
    return tuple(torch.randn(o.shape, device=dev, generator=g) if i in used else None
                 for i, o in enumerate(outs))


@pytest.mark.parametrize("used", [(0, 1, 2, 3), (0,), (1,), (2, 3), (0, 1, 3)],
                         ids=["all", "y", "states", "decays", "no_in_decay"])
@pytest.mark.parametrize("shape", [(2, 1024, 8, 64, 128, 256), (1, 1000, 5, 64, 128, 256),
                                   (2, 1024, 4, 64, 64, 256), (2, 300, 3, 16, 16, 96),
                                   (1, 77, 2, 8, 12, 32), (1, 40, 2, 4, 4, 16),
                                   (1, 130, 2, 128, 128, 64), (1, 200, 6, 128, 32, 200)])
def test_ssd_backward_matches_plain(dev, shape, used):
    B, S, H, P, N, Q = shape
    ins = _ssd_inputs(B, S, H, P, N, dev)
    grads = _ssd_grads(ssd_chunk(*ins, Q), dev, 7, used)
    before = ssd_ops.ssd_chunk_bwd.launches
    got = ssd_ops.ssd_chunk_bwd(ins, Q, grads)
    torch.cuda.synchronize()
    assert ssd_ops.ssd_chunk_bwd.launches == before + 1
    want = _ssd_bwd_f64(ins, Q, grads)
    for name, a, b in zip(("dx", "ddt", "dA", "dB", "dC"), got, want):
        assert a.shape == b.shape and a.dtype == torch.float32, name
        if b.norm() == 0:
            assert not a.any(), name
        else:
            assert _rel_l2s([a], [b])[0] <= SSD_BWD_REL_L2, (name, _rel_l2s([a], [b]))


# the kernel's edges: a CTA per (b, chunk, head group, 64-row j-block), its
# i-blocks 64 rows; chunks of one, two and four blocks, both state widths'
# tiles, H off the head group (6 heads in groups of 4), S ragged against
# every chunk
@pytest.mark.parametrize("N", [64, 128])
@pytest.mark.parametrize("Q", [64, 128, 256])
def test_ssd_backward_tile_edges(dev, Q, N):
    ins = _ssd_inputs(1, 1000, 6, 64, N, dev)
    grads = _ssd_grads(ssd_chunk(*ins, Q), dev, 9)
    got = ssd_ops.ssd_chunk_bwd(ins, Q, grads)
    again = ssd_ops.ssd_chunk_bwd(ins, Q, grads)
    torch.cuda.synchronize()
    for name, a, b in zip(("dx", "ddt", "dA", "dB", "dC"), got, _ssd_bwd_f64(ins, Q, grads)):
        assert _rel_l2s([a], [b])[0] <= SSD_BWD_REL_L2, (name, _rel_l2s([a], [b]))
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_ssd_backward_check_fails_a_dropped_in_decay_gradient(dev):
    ins = _ssd_inputs(2, 1024, 8, 64, 128, dev)
    grads = _ssd_grads(ssd_chunk(*ins, 256), dev, 7)
    want = _ssd_bwd_f64(ins, 256, grads)
    got = ssd_ops.ssd_chunk_bwd(ins, 256, (grads[0], grads[1], None, grads[3]))
    assert max(_rel_l2s(got, want)) > SSD_BWD_REL_L2


def test_ssd_backward_gives_the_same_bits_twice(dev):
    ins = _ssd_inputs(2, 1024, 64, 64, 128, dev)
    grads = _ssd_grads(ssd_chunk(*ins, 256), dev, 7)
    a, b = ssd_ops.ssd_chunk_bwd(ins, 256, grads), ssd_ops.ssd_chunk_bwd(ins, 256, grads)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_backward_wrappers_refuse_what_the_kernels_do_not_take(dev):
    q, k, v, o, lse, do = _flash_bwd_inputs(dev, 1, 2, 1, 16, 32, True, torch.float32)
    with pytest.raises(ValueError):
        flash_ops.flash_bwd(q, k, v, o, lse[..., :8], do, True)       # LSE of other rows
    with pytest.raises(ValueError):
        flash_ops.flash_bwd(q, k, v, o.bfloat16(), lse, do, True)     # O in another dtype
    with pytest.raises(ValueError):
        flash_ops.flash_bwd(q, k, v, o, lse, do.cpu(), True)          # dO off the card
    q48 = torch.randn(1, 2, 16, 48, device=dev)                        # head_dim 48 not built
    with pytest.raises(ValueError):
        flash_ops.flash_bwd(q48, q48, q48, q48, lse, q48, True)
    ins = _ssd_inputs(1, 64, 2, 8, 16, dev)
    grads = _ssd_grads(ssd_chunk(*ins, 32), dev, 1)
    with pytest.raises(ValueError):
        ssd_ops.ssd_chunk_bwd(ins, 512, grads)                        # chunk > 256
    with pytest.raises(ValueError):
        ssd_ops.ssd_chunk_bwd(ins, 16, grads)                         # gradients of other chunks
    with pytest.raises(TypeError):
        ssd_ops.ssd_chunk_bwd([t.half() for t in ins], 32, grads)


def test_train_backward_launches_the_kernels(dev):
    """A smoke model's gradient on the card launches both backward kernels
    (flash's on its route) and no plain backward."""
    for arch, kern in (("tinyllama-1.1b", flash_ops.flash_bwd),
                       ("mamba2-1.3b", ssd_ops.ssd_chunk_bwd)):
        cfg = dataclasses.replace(get_smoke(arch), dtype="bfloat16")
        params = lm.init_params(cfg, torch.Generator(dev).manual_seed(0), dev)
        before = kern.launches
        grads_of(cfg, params, _train_batch(cfg, dev))
        assert kern.launches - before == cfg.n_layers, arch


# ------------------------------------------------ the batch simulator on the card

def _sim_lanes(chunk):
    from repro_torch.sim import batch, design_config
    from repro_torch.workloads import Workload, get_workload, listing1_program
    out = []
    for name, design, nw in chunk:
        w = (Workload(name="listing1", program=listing1_program(), trips={"L1": 100},
                      register_sensitive=False, regs_per_thread=8, suite="paper")
             if name == "listing1" else get_workload(name))
        cfg = design_config(design, table2_config=7, num_warps=nw)
        out.append(batch._Lane(w, cfg, batch._encode_plan(w, cfg), batch._occupancy(w, cfg)))
    return out


def _sim_state(lanes, device, **opts):
    from repro_torch.sim import batch
    co, st = batch._build(lanes)
    run = batch._Chunk(co, st, torch.device(device), **opts)
    while not run.done:
        run.launch()
        run.settle()
    return {k: v.cpu().numpy() for k, v in run.state().items()}, run.stats


def _same_state(a, b):
    import numpy as np
    return sorted(a) == sorted(b) and all(
        a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]) for k in a)


# small jobs: an eager tick on the card costs 10-30 ms of host dispatch
SIM_CHUNKS = {
    "listing1_all_designs": [("listing1", d, 16) for d in
                             ("BL", "RFC", "SHRF", "LTRF", "LTRF_conf", "LTRF_plus", "Ideal")],
    "rfc_and_bl": [("listing1", "RFC", 16), ("listing1", "BL", 8)],
    "cached_mix": [("listing1", "SHRF", 16), ("listing1", "LTRF_plus", 8),
                   ("listing1", "LTRF", 12)],
}


@pytest.mark.parametrize("name", sorted(SIM_CHUNKS))
def test_sim_batch_card_gives_the_cpu_bits(dev, name):
    """Graph replay on the card, and the same blocks run eagerly, give the
    CPU's final state bit for bit (float64 sites included)."""
    lanes = _sim_lanes(SIM_CHUNKS[name])
    cpu, _ = _sim_state(lanes, "cpu")
    graph, stats = _sim_state(lanes, "cuda")
    assert stats["captures"] == 1 and stats["replays"] > 0
    eager, estats = _sim_state(lanes, "cuda", graphs=False)
    assert estats["replays"] == 0
    assert _same_state(graph, cpu)
    assert _same_state(eager, cpu)


def test_sim_batch_card_rolls_back_overflowing_blocks(dev):
    """A bound of 0 activation prefetches overflows in every block that
    charges one: the rolled-back and rerun blocks still give the CPU's bits."""
    lanes = _sim_lanes(SIM_CHUNKS["cached_mix"])
    cpu, _ = _sim_state(lanes, "cpu")
    graph, stats = _sim_state(lanes, "cuda", block=8, act_k=0)
    assert stats["reruns"] > 0
    assert _same_state(graph, cpu)


def test_sim_batch_card_ties_pick_the_first_index(dev):
    col = torch.tensor([[7, 3, 3, 3], [0, 0, 0, 0], [9, 9, 2, 2]], dtype=torch.int64, device=dev)
    assert torch.argmin(col, dim=1).tolist() == [1, 0, 2]
    assert torch.argmin(col, dim=1, keepdim=True).flatten().tolist() == [1, 0, 2]
    cand = torch.tensor([[0, 1, 1, 0], [1, 1, 1, 1], [0, 0, 0, 0]], dtype=torch.uint8, device=dev)
    assert torch.argmax(cand, dim=1).tolist() == [1, 0, 0]
    wide = torch.zeros((3, 64), dtype=torch.int64, device=dev)
    wide[0, 40:] = -1
    assert torch.argmin(wide, dim=1).tolist() == [40, 0, 0]


def test_sim_batch_card_division_is_ieee(dev):
    """A float64 division by a device tensor is the IEEE quotient (the
    jitter hash's `/ 65535`), as on the CPU; by a Python scalar CUDA
    PyTorch multiplies by the reciprocal, which the engine never does."""
    h = torch.arange(0, 65536, dtype=torch.float64)
    want = h / torch.tensor(65535.0, dtype=torch.float64)
    got = h.to(dev) / torch.tensor(65535.0, dtype=torch.float64, device=dev)
    assert torch.equal(got.cpu(), want)


def test_sim_batch_run_batch_on_the_card_matches_the_scalar_engine(dev):
    from repro_torch.sim import design_config, run_batch, simulate
    from repro_torch.workloads import get_workload
    jobs = [(get_workload(n), design_config(d, table2_config=7, num_warps=nw))
            for n, d, nw in [("kmeans", "LTRF", 2), ("btree", "RFC", 2), ("kmeans", "BL", 2),
                             ("kmeans", "LTRF_conf", 3), ("kmeans", "Ideal", 3)]]
    for (w, cfg), got in zip(jobs, run_batch(jobs, fallback=False)):
        assert got == simulate(w, cfg), cfg.design


# the kernel (csrc/sim_batch.cu) against the plain tick: the CPU tests' jobs
# (985, 1,310 and 206 ticks), a chunk of wide lanes (64 warps, 40 active
# slots: two rounds of the warp's 32 threads) with a one-warp lane, lanes
# stopped by the maxc watchdog, and a chunk cut by a tick cap (tmax)
SIM_KERNEL_CHUNKS = {
    "kmeans_ltrf_2w": [("kmeans", "LTRF", 2)],
    "rfc_and_bl": [("btree", "RFC", 4), ("kmeans", "BL", 2)],
    "listing1_all_designs": SIM_CHUNKS["listing1_all_designs"],
    "wide": [("listing1", "BL", 64, {"active_slots": 40}), ("listing1", "LTRF", 64,
                                                             {"active_slots": 40}),
             ("listing1", "RFC", 64, {}), ("listing1", "SHRF", 1,
                                           {"issue_width": 1, "max_inflight_prefetch": 1,
                                            "num_collectors": 1})],
    "watchdog": [("listing1", d, 16, {"max_cycles": m}) for d, m in
                 zip(("BL", "RFC", "SHRF", "LTRF", "LTRF_conf", "LTRF_plus", "Ideal"),
                     (300, 900, 0, 150, 2000, 700, 1))],
    "tmax_wedge": SIM_CHUNKS["listing1_all_designs"],
    # an 8-entry RFC table that fills and evicts
    "rfc_evict": [("listing1", "RFC", 16, {"rfc_size_kb": 1}),
                  ("listing1", "RFC", 4, {"rfc_size_kb": 1})],
}
# a 256-entry table, half past the kernel's registers (its state set below)
SIM_WIDE_RFC = [("listing1", "RFC", 16, {"rfc_size_kb": 32}),
                ("listing1", "RFC", 4, {"rfc_size_kb": 32})]


def _sim_kernel_lanes(chunk):
    import dataclasses
    from repro_torch.sim import batch
    lanes = _sim_lanes([job[:3] for job in chunk])
    out = []
    for ln, job in zip(lanes, chunk):
        cfg = dataclasses.replace(ln.cfg, **(job[3] if len(job) > 3 else {}))
        out.append(batch._Lane(ln.workload, cfg, batch._encode_plan(ln.workload, cfg),
                               batch._occupancy(ln.workload, cfg)))
    return out


@pytest.mark.parametrize("name", sorted(SIM_KERNEL_CHUNKS))
def test_sim_batch_kernel_gives_the_plain_tick_state(dev, name):
    """One launch of the kernel leaves the plain tick's final state, every
    plane and ``guard`` bit for bit, on the card (graph replay) and on the
    CPU; the chunk's guard is the longest lane's ticks, watchdog and tick
    cap included."""
    import numpy as np
    from repro_torch.kernels.sim_batch import sim_batch
    from repro_torch.sim import batch
    co, st = batch._build(_sim_kernel_lanes(SIM_KERNEL_CHUNKS[name]))
    if name == "tmax_wedge":
        co["tmax"] = np.asarray(120, np.int64)
    before = sim_batch.launches
    kernel = {k: v.cpu().numpy() for k, v in batch._run_torch(co, st, "cuda").items()}
    assert sim_batch.launches - before == 1
    card = {k: v.cpu().numpy() for k, v in batch._run_torch(co, st, "cuda", engine="plain").items()}
    cpu = {k: v.numpy() for k, v in batch._run_torch(co, st, "cpu").items()}
    assert _same_state(kernel, card)
    assert _same_state(kernel, cpu)
    if name == "watchdog":
        assert kernel["budget"].sum() == 3 and not kernel["alive"].any()
    if name == "tmax_wedge":
        assert int(kernel["guard"]) == 121 and kernel["alive"].any()


def _sim_kernel_route(co, st):
    """One launch of the kernel on the route ``plan`` takes: the final state
    and the plan."""
    from repro_torch.kernels.sim_batch import ops
    from repro_torch.sim import batch
    cuda = torch.device("cuda")
    c, s = batch._place(co, cuda), batch._place(batch._trash(st), cuda)
    dims = batch._dims(co, st)
    plan = ops.sim_batch(c, s, dims, torch.cuda.current_stream().cuda_stream,
                         batch._KERNEL_NUMBERING)
    torch.cuda.synchronize()
    out = batch._untrash(s, dims[1], dims[12], dims[4], dims[3])
    return {k: v.cpu().numpy() for k, v in out.items()}, plan


@pytest.mark.parametrize("route", ["shared", "global"])
def test_sim_batch_kernel_routes_give_the_plain_tick_state(dev, monkeypatch, route):
    """Each route of the lane's image in shared memory (``rv`` and the
    tables in it, or left in their global planes, taken here by cutting the
    shared memory ``plan`` may give to the global route's image) gives the
    plain tick's state, on wide lanes, RFC lanes that evict, a full table of
    tied stamps (the first entry is the victim) and a 256-entry table whose
    hits and evictions land past the kernel's registers; each launch
    counted on its route."""
    import numpy as np
    from repro_torch.kernels.sim_batch import ops, sim_batch
    from repro_torch.sim import batch
    for name in ("wide", "rfc_evict", "rfc_tied", "rfc_wide"):
        co, st = batch._build(_sim_kernel_lanes(
            SIM_WIDE_RFC if name == "rfc_wide"
            else SIM_KERNEL_CHUNKS["rfc_evict" if name == "rfc_tied" else name]))
        if name == "rfc_tied":
            E = st["rc"].shape[1]
            st["rc"][:, :, 0] = 10 ** 9 + np.arange(E)
            st["rc"][:, :, 1] = 0
            st["rcnt"][:] = co["ecap"]
        if name == "rfc_wide":
            # full: entries 0-127 keys no operand has (stamp 100), 128-255
            # the even registers' keys and more unused ones (stamps 0-127)
            R = co["rdims"].shape[0] - 1
            keys = [w * (R + 1) + r for w in range(16) for r in range(0, 8, 2)]
            st["rc"][:, :128, 0] = 10 ** 9 + np.arange(128)
            st["rc"][:, :128, 1] = 100
            st["rc"][:, 128:, 0] = keys + [2 * 10 ** 9 + e for e in range(128 - len(keys))]
            st["rc"][:, 128:, 1] = np.arange(128)
            st["rcnt"][:] = co["ecap"]
        width = ops.widths(co, batch._trash(st), batch._dims(co, st))
        if route == "global":
            monkeypatch.setattr(ops, "SHARED_BYTES", ops.image_bytes(width, "global"))
        before = sim_batch.launches_by_route[route]
        got, plan = _sim_kernel_route(co, st)
        assert plan["route"] == route and sim_batch.launches_by_route[route] == before + 1
        assert plan["image_bytes"] == ops.image_bytes(width, route)
        cpu = {k: v.numpy() for k, v in batch._run_torch(co, st, "cpu").items()}
        assert _same_state(got, cpu), name


def test_sim_batch_kernel_twice_gives_the_same_bits(dev):
    from repro_torch.sim import batch
    co, st = batch._build(_sim_kernel_lanes(SIM_KERNEL_CHUNKS["wide"]))
    runs = [{k: v.cpu().numpy() for k, v in batch._run_torch(co, st, "cuda").items()}
            for _ in range(2)]
    assert _same_state(*runs)


def test_sim_batch_kernel_catches_a_planted_fault(dev):
    """The DRAM queue's interval one cycle longer changes the kernel's state."""
    from repro_torch.sim import batch
    co, st = batch._build(_sim_kernel_lanes(SIM_KERNEL_CHUNKS["kmeans_ltrf_2w"]))
    want = {k: v.cpu().numpy() for k, v in batch._run_torch(co, st, "cuda").items()}
    co["drint"] = co["drint"] + 1.0
    got = {k: v.cpu().numpy() for k, v in batch._run_torch(co, st, "cuda").items()}
    assert not _same_state(got, want)


def test_sim_batch_run_batch_on_the_card_launches_the_kernel_once_a_chunk(dev):
    """``run_batch`` on the card: every job on the kernel, one launch a
    chunk, no graph captured, each result the scalar engine's (watchdog
    outcomes included)."""
    import dataclasses
    from repro_torch.kernels.sim_batch import sim_batch
    from repro_torch.sim import batch, design_config, run_batch, simulate
    from repro_torch.sim.engine import SimBudgetExceeded
    from repro_torch.workloads import get_workload
    jobs = [(get_workload(n), design_config(d, table2_config=7, num_warps=nw))
            for n, d, nw in [("kmeans", "LTRF", 2), ("btree", "RFC", 2), ("kmeans", "BL", 2),
                             ("kmeans", "LTRF_conf", 3), ("kmeans", "Ideal", 3),
                             ("pathfinder", "SHRF", 8), ("bfs", "LTRF_plus", 6)]]
    jobs.append((jobs[0][0], dataclasses.replace(jobs[0][1], max_cycles=200)))
    before = sim_batch.launches
    stats = batch.reset_run_stats()
    got = run_batch(jobs, fallback=False)
    assert sim_batch.launches - before == stats["launches"] > 0
    assert stats["compiles"] == 0 and stats["compile_s"] == 0.0
    assert batch.BLOCK_STATS["replays"] == batch.BLOCK_STATS["reruns"] == 0
    for (w, cfg), r in zip(jobs, got):
        if cfg.max_cycles:
            with pytest.raises(SimBudgetExceeded) as e:
                simulate(w, cfg)
            assert isinstance(r, SimBudgetExceeded) and r.args == e.value.args
        else:
            assert r == simulate(w, cfg), cfg.design


def test_sweep_service_batches_on_the_card(dev, tmp_path):
    """The sweep service's prefill of Listing 1's 7 designs runs them on the
    card's batch engine, each result the scalar engine's."""
    from repro_torch.serving import SimRunner
    from repro_torch.sim import design_config, simulate
    from repro_torch.workloads import WORKLOADS, Workload, listing1_program, register_workload
    name = "listing1_sweep_service"
    w = register_workload(Workload(name=name, program=listing1_program(), trips={"L1": 100},
                                   register_sensitive=False, regs_per_thread=8, suite="paper"))
    try:
        jobs = [(name, design_config(d, table2_config=7, num_warps=16)) for d in
                ("BL", "RFC", "SHRF", "LTRF", "LTRF_conf", "LTRF_plus", "Ideal")]
        runner = SimRunner(device="cuda", batch=True, processes=1, cache_dir=tmp_path)
        report = runner.prefill(jobs)
        assert report.ok and report.computed == 7 and runner.stats["batched"] == 7
        for _, cfg in jobs:
            assert runner.sim(name, cfg) == simulate(w, cfg), cfg.design
    finally:
        del WORKLOADS[name]


def test_traced_workloads_batch_on_the_card(dev, tmp_path):
    """Workloads of the traced suite, lifted in this process, through the
    sweep service on the card's batch engine, and traced_matmul's 7 designs
    through ``run_batch`` there: each result the scalar engine's (which
    tests/test_torch_frontend.py holds to TRACED_MATMUL_GOLDEN)."""
    from repro_torch.serving import SimRunner
    from repro_torch.sim import design_config, run_batch, simulate
    from repro_torch.workloads import get_workload
    jobs = [(name, design_config(d, table2_config=7, num_warps=4))
            for name in ("traced_rmsnorm", "traced_ssd") for d in ("BL", "LTRF")]
    runner = SimRunner(device="cuda", batch=True, processes=1, cache_dir=tmp_path)
    report = runner.prefill(jobs)
    assert report.ok and runner.stats["batched"] == len(jobs)
    for name, cfg in jobs:
        assert runner.sim(name, cfg) == simulate(get_workload(name), cfg), (name, cfg.design)
    w = get_workload("traced_matmul")
    cfgs = [design_config(d, table2_config=7, num_warps=16)
            for d in ("BL", "RFC", "SHRF", "LTRF", "LTRF_conf", "LTRF_plus", "Ideal")]
    for cfg, r in zip(cfgs, run_batch([(w, c) for c in cfgs], fallback=False)):
        assert r == simulate(w, cfg), cfg.design


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "zamba2-1.2b", "granite-moe-3b-a800m"])
def test_one_rank_nccl_mesh_step_is_the_unsharded_step(dev, arch):
    """A smoke train step on a one-rank NCCL mesh (``make_host_mesh``),
    through the kernels, gives the bits of the step without rules (the
    group is started here and ended)."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from repro_torch.data import batch_for_step
    from repro_torch.distributed import default_rules, reshard_state
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.runtime import train_step as TT
    from repro_torch.tree import tree_leaves, tree_map
    cfg = get_smoke(arch)
    state = TT.make_train_state(cfg, torch.Generator(dev).manual_seed(0), dev)
    batch = batch_for_step(cfg, dataclasses.replace(smoke_shape(), global_batch=4), 0, 1)
    plain, plain_m = TT.build_train_step(cfg)(tree_map(torch.clone, state), batch)
    mesh = make_host_mesh(device=dev)
    try:
        placed, rules = reshard_state(state, TT.train_state_axes(cfg), mesh,
                                      shapes_tree=TT.train_state_shapes(cfg))
        before = ltrf_matmul.launches
        got, m = TT.build_train_step(cfg, rules=rules)(placed, batch)
        torch.cuda.synchronize()
        assert ltrf_matmul.launches > before         # through the kernel
        assert all(isinstance(t, DTensor) for t in tree_leaves(got))
        assert all(torch.equal(a, b.to_local()) for a, b in zip(tree_leaves(plain),
                                                                tree_leaves(got)))
        assert {k: float(v) for k, v in m.items()} == {k: float(v) for k, v in plain_m.items()}
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the serving engine's decode step, captured once as a CUDA graph
# ---------------------------------------------------------------------------

from repro_torch.configs import ARCH_IDS  # noqa: E402
from repro_torch.kernels import counts  # noqa: E402
from repro_torch.serving import ServeConfig, ServingEngine  # noqa: E402

ENGINE_SC = dict(max_len=32, active_slots=4, total_pages=16)


def _engine_workload(kind):
    """(ServeConfig fields, prompts, max_new): 7 requests on 4 slots (as
    tests/test_torch_serving.py's), 250-token prompts that cross a page
    boundary with one spare page (preemption), or more steps than max_len
    (cache_len clamped at max_len - 1)."""
    if kind == "preemption":
        return dict(max_len=32, active_slots=2, total_pages=3), [[1] * 250, [2] * 250, [3] * 5], \
            [12, 12, 6]
    if kind == "clamp":
        return dict(max_len=6, active_slots=2, total_pages=8), [[5], [6, 7]], [9, 4]
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 256, rng.integers(1, 8)).tolist() for _ in range(7)]
    return ENGINE_SC, prompts, [int(rng.integers(2, 10)) for _ in prompts]


def _engines(dev, arch, sc_kw):
    """The compiled and the eager engine on one set of smoke weights."""
    cfg = get_smoke(arch)
    params = lm.init_params(cfg, torch.Generator(dev).manual_seed(0), dev)
    sc = ServeConfig(**sc_kw)
    return (ServingEngine(cfg, params, sc, device=dev),
            ServingEngine(cfg, params, sc, device=dev, graphs=False))


@pytest.mark.parametrize("arch,kind", [(a, "requests") for a in ARCH_IDS]
                         + [("tinyllama-1.1b", "preemption"), ("tinyllama-1.1b", "clamp")])
def test_compiled_engine_gives_the_eager_engines_tokens(dev, arch, kind):
    sc_kw, prompts, max_new = _engine_workload(kind)
    compiled, eager = _engines(dev, arch, sc_kw)
    assert compiled.graph is not None and eager.graph is None
    for engine in (compiled, eager):
        for p, m in zip(prompts, max_new):
            engine.submit(p, max_new_tokens=m)
    assert compiled.run() == eager.run()
    assert compiled.steps == eager.steps
    assert compiled.sched.preemptions == eager.sched.preemptions
    if kind == "preemption":
        assert compiled.sched.preemptions > 0
    if kind == "clamp":
        assert compiled.steps > sc_kw["max_len"]
    assert compiled.aau.used_count == 0


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "zamba2-1.2b", "musicgen-large"])
def test_replayed_step_counts_the_eager_steps_launches(dev, arch):
    before = counts.read()
    compiled, eager = _engines(dev, arch, ENGINE_SC)
    assert counts.read() == before, "warm-up and capture left launches counted"
    before = counts.read()
    eager.decode(0)
    eager_step = counts.since(before)
    before = counts.read()
    compiled.decode(0)
    torch.cuda.synchronize()
    assert counts.since(before) == eager_step == compiled.step_launches
    assert eager_step[(ltrf_matmul, "launches")] == eager_step[(ltrf_matmul, "launches_by_route")][
        "decode"] > 0


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_capture_makes_no_sync(dev, arch):
    cfg = get_smoke(arch)
    params = lm.init_params(cfg, torch.Generator(dev).manual_seed(0), dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        engine = ServingEngine(cfg, params, ServeConfig(**ENGINE_SC), device=dev)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert engine.graph is not None
