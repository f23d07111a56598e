"""The port's ssd_scan (plain path on the CPU) against the JAX package's Pallas
kernel (interpret mode) and ssd_ref, on the cases of tests/test_kernels.py.

Both sides compute the same fp32 math in another summation order, so fp32
cases use the _tol row (rtol 2e-4 / atol 1e-4) and bf16 cases the bf16 row;
the long-horizon decay case keeps its own rtol 1e-4 / atol 1e-5.
"""
import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

torch = pytest.importorskip("torch")

from test_torch_parity import assert_close, randn, to_jax, to_torch  # noqa: E402

from repro.kernels.ssd_scan.kernel import ssd_chunk_kernel as jax_chunk  # noqa: E402
from repro.kernels.ssd_scan.ops import ssd_scan as jax_scan  # noqa: E402
from repro.kernels.ssd_scan.ref import ssd_ref as jax_ref  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_chunk, ssd_chunk_ref, ssd_ref, ssd_scan  # noqa: E402

FP32 = dict(rtol=2e-4, atol=1e-4)


def _softplus(a):
    return np.log1p(np.exp(a)).astype(np.float32)


def _inputs(B, S, H, P, N, seed=0, a_hi=1.5):
    """x, dt, A, Bm, Cm as float32 numpy, at the scales of test_kernels.py."""
    return (randn(seed, (B, S, H, P), 0.5), _softplus(randn(seed + 1, (B, S, H))),
            (-np.exp(np.linspace(0.0, a_hi, H))).astype(np.float32),
            randn(seed + 2, (B, S, N), 0.3), randn(seed + 3, (B, S, N), 0.3))


def _both(arrays, dtype="float32"):
    """The inputs for JAX and for the port; A stays fp32, as the model feeds it."""
    j = [to_jax(a, "float32" if i == 2 else dtype) for i, a in enumerate(arrays)]
    t = [to_torch(a, "float32" if i == 2 else dtype) for i, a in enumerate(arrays)]
    return j, t


@pytest.mark.parametrize("chunk", [16, 32, 96])
@pytest.mark.parametrize("S", [96, 160])
def test_chunk_sizes_match_pallas_and_ref(S, chunk):
    j, t = _both(_inputs(2, S, 3, 8, 16))
    y, fin = ssd_scan(*t, chunk=chunk)
    assert y.shape == (2, S, 3, 8) and y.dtype == torch.float32
    assert fin.shape == (2, 3, 8, 16) and fin.dtype == torch.float32
    jy, jfin = jax_scan(*j, chunk=chunk, interpret=True)
    assert_close(y, jy, **FP32)
    assert_close(fin, jfin, **FP32)
    ry, rfin = ssd_ref(*t)
    jry, jrfin = jax_ref(*j)
    assert_close(ry, jry, **FP32)
    assert_close(rfin, jrfin, **FP32)
    # the chunked scan against the recurrence, at test_kernels.py's 3e-3
    assert_close(y, ry, rtol=3e-3, atol=3e-3)
    assert_close(fin, rfin, rtol=3e-3, atol=3e-3)


def test_bf16_inputs():
    j, t = _both(_inputs(1, 64, 2, 8, 8, a_hi=1.0), "bfloat16")
    y, fin = ssd_scan(*t, chunk=32)
    assert y.dtype == torch.bfloat16 and fin.dtype == torch.float32
    jy, jfin = jax_scan(*j, chunk=32, interpret=True)
    assert_close(y, jy, "bfloat16")
    assert_close(fin, jfin, "bfloat16")
    ry, _ = ssd_ref(*t)
    assert ry.dtype == torch.bfloat16
    assert_close(ry, jax_ref(*j)[0], "bfloat16")


@settings(max_examples=6, deadline=None)
@given(seed=st.integers(0, 30), chunk=st.sampled_from([8, 16, 32]))
def test_property_matches_pallas_and_recurrence(seed, chunk):
    B, S, H, P, N = 1, 64, 2, 4, 8
    rng = np.random.default_rng(seed)
    arrays = (randn(seed, (B, S, H, P), 0.5), _softplus(randn(seed + 1, (B, S, H))),
              (-np.exp(rng.uniform(size=H))).astype(np.float32),
              randn(seed + 3, (B, S, N), 0.3), randn(seed + 4, (B, S, N), 0.3))
    j, t = _both(arrays)
    y, fin = ssd_scan(*t, chunk=chunk)
    jy, jfin = jax_scan(*j, chunk=chunk, interpret=True)
    assert_close(y, jy, **FP32)
    assert_close(fin, jfin, **FP32)
    ry, rfin = ssd_ref(*t)
    assert_close(y, ry, rtol=5e-3, atol=5e-3)
    assert_close(fin, rfin, rtol=5e-3, atol=5e-3)


def test_long_horizon_decay_matches_recurrence():
    """C == B == const and positive x: the scan equals the recurrence over a
    long horizon (test_kernels.py's stability case, rtol 1e-4)."""
    B, S, H, P, N = 1, 128, 1, 4, 4
    arrays = (np.full((B, S, H, P), 0.1, np.float32), np.full((B, S, H), 0.5, np.float32),
              np.array([-1.0], np.float32), np.full((B, S, N), 0.2, np.float32),
              np.full((B, S, N), 0.2, np.float32))
    j, t = _both(arrays)
    y, _ = ssd_scan(*t, chunk=32)
    assert_close(y, jax_ref(*j)[0], rtol=1e-4, atol=1e-5)
    assert_close(y, ssd_ref(*t)[0], rtol=1e-4, atol=1e-5)
    assert_close(y, jax_scan(*j, chunk=32, interpret=True)[0], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("shape", [(2, 64, 3, 8, 16, 16), (1, 192, 2, 16, 16, 96),
                                   (2, 128, 4, 8, 12, 64)],
                         ids=["q16", "q96", "q64"])
def test_chunk_ref_outputs_match_pallas_kernel(shape):
    B, S, H, P, N, Q = shape
    j, t = _both(_inputs(B, S, H, P, N, seed=5))
    got = ssd_chunk_ref(*t, chunk=Q)
    want = jax_chunk(*j, chunk=Q, interpret=True)
    nc = S // Q
    shapes = [(B, nc, H, Q, P), (B, nc, H, P, N), (B, nc, H, Q), (B, nc, H, 1)]
    for g, w, shp in zip(got, want, shapes):
        assert tuple(g.shape) == shp == w.shape and g.dtype == torch.float32
        assert_close(g, w, **FP32)


def test_chunk_ref_pads_a_ragged_sequence_with_zeros():
    """S not a multiple of the chunk: the outputs are the Pallas kernel's on
    the zero-padded inputs (what the TPU wrapper feeds it)."""
    B, S, H, P, N, Q = 2, 100, 3, 8, 16, 32
    arrays = _inputs(B, S, H, P, N, seed=7)
    _, t = _both(arrays)
    got = ssd_chunk_ref(*t, chunk=Q)
    pad = 128 - S
    padded = [np.pad(a, [(0, 0), (0, pad)] + [(0, 0)] * (a.ndim - 2)) if i != 2 else a
              for i, a in enumerate(arrays)]
    want = jax_chunk(*[to_jax(a) for a in padded], chunk=Q, interpret=True)
    for g, w in zip(got, want):
        assert_close(g, w, **FP32)
    # and the wrapper's plain path is that function
    for g, w in zip(ssd_chunk(*t, chunk=Q), got):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_upper_triangle_and_padding_contribute_nothing():
    """The lower-triangle mask: y_intra of row 0 of a chunk depends on row 0
    only, and rows past S add nothing to the chunk's state."""
    x, dt, A, Bm, Cm = (to_torch(a) for a in _inputs(1, 40, 2, 4, 8, seed=11))
    y, state, _, _ = ssd_chunk_ref(x, dt, A, Bm, Cm, chunk=16)
    x2 = x.clone()
    x2[:, 1:16] += 1.0                       # rows after row 0 of chunk 0
    y2, _, _, _ = ssd_chunk_ref(x2, dt, A, Bm, Cm, chunk=16)
    torch.testing.assert_close(y2[:, 0, :, 0], y[:, 0, :, 0], rtol=0, atol=0)
    assert not torch.allclose(y2[:, 0, :, 1:], y[:, 0, :, 1:])
    # the last chunk (rows 32..39, then 8 padded rows): its state equals the
    # state of the same rows run as a chunk of their own
    _, st8, _, _ = ssd_chunk_ref(x[:, 32:], dt[:, 32:], A, Bm[:, 32:], Cm[:, 32:], chunk=8)
    torch.testing.assert_close(state[:, 2], st8[:, 0], rtol=1e-6, atol=1e-7)


# chip_smoke.py's ssd_scan limits, per output: relative L2 and elementwise
# rtol / atol times the output's RMS
SSD_REL_L2, SSD_RTOL, SSD_ATOL = 1e-4, 1e-2, 1e-3


def _tf32(a):
    """a rounded to TF32 (nearest, ties away from zero: cvt.rna.tf32.f32)."""
    return ((a.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _bf16(a):
    """a rounded to bf16 (nearest even), back in fp32."""
    return a.bfloat16().float()


def _tc_matmul(a, b, mode):
    """a @ b as the tensor cores compute it from fp32 operands, sums in fp32:
    "bf16x3" (the kernel) splits each operand into a bf16 high part and a
    bf16 low part (the remainder, rounded) and sums lo.hi + hi.lo + hi.hi,
    each product exact in fp32; "tf32" and "bf16" round each operand once."""
    if mode == "tf32":
        return _tf32(a) @ _tf32(b)
    ah, bh = _bf16(a), _bf16(b)
    if mode == "bf16":
        return ah @ bh
    al, bl = _bf16(a - ah), _bf16(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def _ssd_kernel_numerics(x, dt, A, Bm, Cm, Q, mode, head_group=8):
    """The Hopper kernel's decomposition in fp32 torch: G = C B^T once per
    (b, chunk) and shared by every head of a group, (G o L) formed in fp32
    (decays as the reference's, mask after the exp) and multiplied by x dt,
    and the state product, every product through ``_tc_matmul``."""
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    nc = -(-S // Q)
    pad = nc * Q - S
    x, dt, Bm, Cm = (torch.nn.functional.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
                     for t in (x, dt, Bm, Cm))
    cum = torch.cumsum((dt * A).reshape(Bsz, nc, Q, H), dim=2)         # (B,nc,Q,H)
    causal = torch.ones(Q, Q, dtype=torch.bool).tril()
    y = torch.empty(Bsz, nc, H, Q, P)
    states = torch.empty(Bsz, nc, H, P, N)
    for b in range(Bsz):
        for c in range(nc):
            rows = slice(c * Q, (c + 1) * Q)
            G = _tc_matmul(Cm[b, rows], Bm[b, rows].T, mode)
            for h0 in range(0, H, head_group):
                for h in range(h0, min(H, h0 + head_group)):
                    ch = cum[b, c, :, h]
                    L = torch.where(causal, torch.exp((ch[:, None] - ch[None, :]).clamp(-60, 0)), 0.0)
                    xdt = x[b, rows, h] * dt[b, rows, h, None]
                    y[b, c, h] = _tc_matmul(G * L, xdt, mode)
                    w = torch.exp((ch[-1] - ch).clamp(-60, 0))
                    states[b, c, h] = _tc_matmul((xdt * w[:, None]).T, Bm[b, rows], mode)
    cum = cum.transpose(2, 3)
    return y, states, torch.exp(cum.clamp(-60, 0)), torch.exp(cum[..., -1:].clamp(-60, 0))


def _ssd_limits(got, want):
    """(largest relative L2, largest elementwise excess) over the 4 outputs."""
    rel, excess = 0.0, 0.0
    for g, w in zip(got, want):
        rms = float(w.square().mean().sqrt())
        rel = max(rel, float((g - w).norm() / w.norm()))
        excess = max(excess, float(((g - w).abs() / (SSD_ATOL * rms + SSD_RTOL * w.abs())).max()))
    return rel, excess


def test_bf16x3_keeps_the_kernel_within_the_ssd_limits():
    """Why the kernel's products are bf16x3: at the mamba2-1.3b widths (P 64,
    N 128, Q 256, a shorter S and fewer heads; inputs at chip_smoke.py's
    scales) the kernel's decomposition holds ssd_chunk_ref within the
    relative L2 limit with a margin of ~20, while single TF32 products miss
    it ~3x over and single bf16 products by far more."""
    rng = np.random.default_rng(0)

    def silu(a):
        return a / (1 + np.exp(-a))

    B, S, H, P, N, Q = 1, 400, 3, 64, 128, 256
    arrays = (silu(rng.standard_normal((B, S, H, P))), _softplus(rng.standard_normal((B, S, H))),
              -np.linspace(1.0, 16.0, H), silu(rng.standard_normal((B, S, N))),
              silu(rng.standard_normal((B, S, N))))
    x, dt, A, Bm, Cm = (torch.from_numpy(np.asarray(a, np.float32)) for a in arrays)
    want = ssd_chunk_ref(x, dt, A, Bm, Cm, Q)
    rel, excess = _ssd_limits(_ssd_kernel_numerics(x, dt, A, Bm, Cm, Q, "bf16x3"), want)
    assert rel <= SSD_REL_L2 / 10 and excess <= 0.1
    rel_tf32, _ = _ssd_limits(_ssd_kernel_numerics(x, dt, A, Bm, Cm, Q, "tf32"), want)
    assert rel_tf32 > 2 * SSD_REL_L2
    rel_bf16, _ = _ssd_limits(_ssd_kernel_numerics(x, dt, A, Bm, Cm, Q, "bf16"), want)
    assert rel_bf16 > 10 * SSD_REL_L2


# ---------------------------------------------------------------------------
# the autograd Function (backward: ssd_chunk_bwd, its plain version on the CPU)
# ---------------------------------------------------------------------------

from repro_torch.kernels.ssd_scan import ops as ssd_ops  # noqa: E402

def out_shapes(B, S, H, P, N, Q):
    """The four chunk outputs' shapes."""
    nc = -(-S // Q)
    return [(B, nc, H, Q, P), (B, nc, H, P, N), (B, nc, H, Q), (B, nc, H, 1)]


def _chunk_grads(fn, arrays, chunk, cots, dtype="float32"):
    ins = [to_torch(a, "float32" if i == 2 else dtype).requires_grad_()
           for i, a in enumerate(arrays)]
    outs = fn(*ins, chunk)
    loss = sum((o * to_torch(c)).sum() for o, c in zip(outs, cots) if c is not None)
    loss.backward()
    return [t.grad for t in ins]


@pytest.mark.parametrize("used", [(0, 1, 2, 3), (0,), (2, 3), (1,)],
                         ids=["all", "y", "decays", "states"])
def test_chunk_function_matches_plain_autograd(used):
    shape = (2, 40, 3, 8, 16)
    arrays = _inputs(*shape)
    cots = [randn(20 + i, s) if i in used else None
            for i, s in enumerate(out_shapes(*shape, 16))]
    got = _chunk_grads(ssd_chunk, arrays, 16, cots)
    want = _chunk_grads(ssd_chunk_ref, arrays, 16, cots)
    # the backward's explicit formulas (ssd_chunk_bwd_ref) against autograd
    # of the plain forward: fp32 sum order only
    for a, b in zip(got, want):
        if b is None:
            assert a is None or not a.any()
        else:
            assert float((a - b).norm() / b.norm().clamp_min(1e-30)) <= 1e-5


def test_scan_grads_match_jax_recurrence():
    """The chunked scan's gradients (kernel Function + chunk_carry + y_inter)
    against jax.vjp of the JAX package's sequential recurrence."""
    import jax
    arrays = _inputs(2, 48, 3, 8, 16, seed=4)
    dy, dh = randn(30, (2, 48, 3, 8)), randn(31, (2, 3, 8, 16))
    ins = [to_torch(a).requires_grad_() for a in arrays]
    y, h = ssd_scan(*ins, chunk=16)
    ((y * to_torch(dy)).sum() + (h * to_torch(dh)).sum()).backward()
    _, vjp = jax.vjp(jax_ref, *(to_jax(a) for a in arrays))
    for t, j in zip(ins, vjp((to_jax(dy), to_jax(dh)))):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j), rtol=1e-3, atol=1e-4)


def test_chunk_function_check_catches_a_dropped_in_decay_gradient(monkeypatch):
    arrays = _inputs(2, 48, 3, 8, 16, seed=4)
    dy = randn(30, (2, 48, 3, 8))

    def grads():
        ins = [to_torch(a).requires_grad_() for a in arrays]
        (ssd_scan(*ins, chunk=16)[0] * to_torch(dy)).sum().backward()
        return [t.grad for t in ins]

    want = grads()
    real = ssd_ops.ssd_chunk_bwd
    monkeypatch.setattr(ssd_ops, "ssd_chunk_bwd", lambda ins, chunk, g: real(
        ins, chunk, (g[0], g[1], None, g[3])))
    got = grads()
    assert not all(torch.allclose(a, b, **FP32) for a, b in zip(got, want))


def test_chunk_function_grads_keep_the_input_dtype():
    arrays = _inputs(1, 20, 2, 4, 8)
    ins = [to_torch(a, "float32" if i == 2 else "bfloat16").requires_grad_()
           for i, a in enumerate(arrays)]
    outs = ssd_chunk(*ins, 8)
    assert outs[0].grad_fn.name() == "SsdChunkFnBackward"
    sum(o.sum() for o in outs).backward()
    assert [t.grad.dtype for t in ins] == [t.dtype for t in ins]
