"""The port's flash_attention (plain path on the CPU) against the JAX package's
Pallas kernel (interpret mode) and attention_ref."""
import pytest

torch = pytest.importorskip("torch")

from test_torch_parity import DTYPES, assert_close, randn, to_jax, to_torch  # noqa: E402

from repro.kernels.flash_attention.ops import flash_attention as jax_flash  # noqa: E402
from repro.kernels.flash_attention.ref import attention_ref as jax_attention_ref  # noqa: E402
from repro_torch.kernels.flash_attention import attention_ref, flash_attention  # noqa: E402
from repro_torch.kernels.flash_attention.ref import v_to_f16_ref  # noqa: E402

from flash_numerics import wgmma_numerics as _wgmma_numerics  # noqa: E402

# test_kernels.py:84-88
CONFIGS = [dict(B=1, H=2, KV=2, S=128, d=64),    # MHA
           dict(B=2, H=4, KV=2, S=128, d=64),    # GQA 2:1
           dict(B=1, H=8, KV=1, S=256, d=32)]    # MQA


def _qkv(B, H, KV, S, d, seed=0):
    return (randn(seed, (B, H, S, d)), randn(seed + 1, (B, KV, S, d)),
            randn(seed + 2, (B, KV, S, d)))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("cfg", CONFIGS, ids=["mha", "gqa", "mqa"])
def test_plain_path_matches_pallas(cfg, dtype):
    q, k, v = _qkv(**cfg)
    got = flash_attention(*(to_torch(a, dtype) for a in (q, k, v)))
    assert got.dtype == getattr(torch, dtype) and got.shape == q.shape
    want = jax_flash(*(to_jax(a, dtype) for a in (q, k, v)), bq=64, bk=64, interpret=True)
    assert_close(got, want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_non_causal_matches_reference(dtype):
    q, k, v = _qkv(1, 2, 2, 128, 32, seed=3)
    got = flash_attention(*(to_torch(a, dtype) for a in (q, k, v)), causal=False)
    assert_close(got, jax_attention_ref(*(to_jax(a, dtype) for a in (q, k, v)),
                                        causal=False), dtype)
    want = jax_flash(*(to_jax(a, dtype) for a in (q, k, v)), bq=64, bk=64,
                     causal=False, interpret=True)
    assert_close(got, want, dtype)


@pytest.mark.parametrize("S", [1, 37, 100, 130])
@pytest.mark.parametrize("dtype", DTYPES)
def test_ragged_sequence_matches_reference(S, dtype):
    """S not a multiple of any block: the TPU wrapper refuses it, the port's
    kernel masks it; the plain path must agree with attention_ref."""
    q, k, v = _qkv(2, 4, 2, S, 32, seed=S)
    got = flash_attention(*(to_torch(a, dtype) for a in (q, k, v)))
    assert_close(got, jax_attention_ref(*(to_jax(a, dtype) for a in (q, k, v))), dtype)


def test_first_causal_row_attends_to_itself():
    q, k, v = _qkv(1, 1, 1, 64, 32, seed=9)
    got = attention_ref(*(to_torch(a) for a in (q, k, v)))
    torch.testing.assert_close(got[0, 0, 0], to_torch(v)[0, 0, 0], rtol=1e-4, atol=1e-4)


# chip_smoke.py's flash limits (elementwise, and a relative L2 over the output)
FLASH_TOL = dict(rtol=1e-2, atol=1e-3)
FLASH_REL_L2 = 1e-2


def _scaled_qkv(B, H, KV, S, d, v_scales=None, seed=11):
    """Seeded bf16 q, k, v, each KV head's V times its entry of ``v_scales``
    (powers of two or 0: exact in bf16), and each query head's scale."""
    q, k, v = (to_torch(a, "bfloat16") for a in _qkv(B, H, KV, S, d, seed=seed))
    scales = torch.tensor(v_scales or [1.0] * KV, dtype=torch.float64)
    v = (v.double() * scales[None, :, None, None]).bfloat16()
    return q, k, v, scales.repeat_interleave(H // KV)


def _within_flash_limits(got, want, head_scales) -> bool:
    """Each query head held to FLASH_TOL, its atol times its V's scale, and
    to FLASH_REL_L2."""
    got, want = got.float(), want.float()
    for h, sc in enumerate(head_scales.tolist()):
        g, w = got[:, h], want[:, h]
        if not torch.allclose(g, w, rtol=FLASH_TOL["rtol"], atol=FLASH_TOL["atol"] * sc):
            return False
        if float((g - w).norm() / w.norm().clamp_min(1e-30)) > FLASH_REL_L2:
            return False
    return True


@pytest.mark.parametrize("cfg", [dict(B=2, H=8, KV=1, S=1024, d=64),    # chip_smoke's MQA check
                                 dict(B=1, H=4, KV=1, S=63, d=128),
                                 dict(B=1, H=8, KV=2, S=1024, d=128),
                                 dict(B=1, H=8, KV=2, S=1024, d=128, v_scales=[2.0 ** 20,
                                                                            2.0 ** -20]),
                                 dict(B=1, H=8, KV=2, S=1024, d=128, v_scales=[0.0, 1.0])],
                         ids=["s1024", "s63", "gqa128", "v_scaled", "zero_head"])
def test_split_p_keeps_the_wgmma_kernel_within_the_flash_limits(cfg):
    """Why the bf16 kernel does not round P once to bf16, as FA2/FA3 do:
    single outputs would move past the elementwise limit (the relative L2
    stays far under its own).  P split into bf16 hi + lo (two products: the
    forward that writes the LSE) and P in fp16 with the scaled fp16 V (one
    product: the forward without it) both hold the reference within both,
    per head, at any power-of-two scale of V.  A zeroed KV tile in the
    kernel's arithmetic must fail them."""
    q, k, v, head_scales = _scaled_qkv(**cfg)
    want = to_torch(jax_attention_ref(*(to_jax(a.float().numpy(), "bfloat16")
                                        for a in (q, k, v)))).float()

    def rel_l2(got):
        return float((got.float() - want).norm() / want.norm())

    for mode in ("split", "fp16"):
        assert _within_flash_limits(_wgmma_numerics(q, k, v, True, mode), want, head_scales), mode
    single = _wgmma_numerics(q, k, v, True, "bf16")
    assert not _within_flash_limits(single, want, head_scales)
    assert rel_l2(single) <= FLASH_REL_L2
    S = q.shape[2]
    k0, v0 = k.clone(), v.clone()
    k0[:, :, S // 2:S // 2 + 64] = 0
    v0[:, :, S // 2:S // 2 + 64] = 0
    assert not _within_flash_limits(_wgmma_numerics(q, k0, v0, True, "fp16"), want, head_scales)


def test_v_prepass_plain_version_is_exact_and_bounded():
    """``v_to_f16_ref``: V = fp16 x 2^e exactly wherever V 2^-e lies in
    fp16's normal range; the largest finite |V| 2^-e in (2^14, 2^15] on
    every head with a finite nonzero value, down to bf16's subnormals, and
    on heads that also hold inf or NaN (NaN beside finite values above
    fp16's 65504 included), whose inf and NaN go through as they are; e = 0
    on an all-zero head and on one of inf and NaN alone."""
    scales = [1.0, 2.0 ** 20, 2.0 ** -20, 2.0 ** 100, 2.0 ** -126, 0.0, 1.0, 2.0 ** 20, 0.0]
    q, k, v, _ = _scaled_qkv(2, 9, 9, 100, 32, v_scales=scales, seed=21)
    v = v.clone()
    v[:, 6, 7, 3] = float("inf")
    v[:, 7, 9, 1] = float("nan")
    v[:, 8, 0, 0], v[:, 8, 1, 1] = float("nan"), float("-inf")
    v16, e = v_to_f16_ref(v)
    assert v16.dtype == torch.float16 and v16.shape == v.shape
    assert e.dtype == torch.int32 and e.shape == (2, 9)
    a = v.double().abs()
    mx = torch.where(torch.isfinite(a), a, 0.0).flatten(2).amax(-1)
    top = mx * torch.exp2(-e.double())
    live = [0, 1, 2, 3, 4, 6, 7]
    assert ((top[:, live] > 2.0 ** 14) & (top[:, live] <= 2.0 ** 15)).all()
    assert (e[:, 5] == 0).all() and (e[:, 8] == 0).all() and (e[:, 7] > 0).all()
    finite = torch.isfinite(v)
    normal = finite & (v16.double().abs() >= 2.0 ** -14)
    back = v16.double() * torch.exp2(e.double())[..., None, None]
    assert torch.equal(back[normal], v.double()[normal])
    assert torch.isfinite(v16[finite]).all()
    assert normal[:, live].float().mean() > 0.99     # all but values far below their head's max
    assert torch.isinf(v16[:, 6, 7, 3]).all() and torch.isnan(v16[:, 7, 9, 1]).all()
    assert torch.isnan(v16[:, 8, 0, 0]).all() and (v16[:, 8, 1, 1] == float("-inf")).all()
    assert (v16[:, 5] == 0).all()


# ---------------------------------------------------------------------------
# the autograd Function (backward: the plain version recomputed)
# ---------------------------------------------------------------------------

from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402


def _grads(fn, q, k, v, do, causal):
    ins = [to_torch(a).requires_grad_() for a in (q, k, v)]
    fn(*ins, causal=causal).backward(to_torch(do))
    return [t.grad for t in ins]


def _group_sum_dropped(real):
    """``real`` (``flash_bwd``) with dk, dv taken from the first query head
    of each group, not summed."""
    def bwd(q, k, v, o, lse, do, causal):
        rep = q.shape[1] // k.shape[1]
        dq, dke, dve = real(q, *(t.repeat_interleave(rep, dim=1) for t in (k, v)), o, lse, do,
                            causal)
        return dq, dke[:, ::rep] * rep, dve[:, ::rep] * rep
    return bwd


def _rel_l2(a, b) -> float:
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("group", [1, 2, 4])
def test_function_grads_match_plain_autograd_and_jax(group, causal):
    import jax
    q, k, v = _qkv(2, 4, 4 // group, 40, 16, seed=5)
    do = randn(9, q.shape)
    got = _grads(flash_attention, q, k, v, do, causal)
    plain = _grads(attention_ref, q, k, v, do, causal)
    # the backward's explicit formulas (flash_bwd_ref) against autograd of
    # the plain forward: fp32 sum order only
    for a, b in zip(got, plain):
        assert _rel_l2(a, b) <= 1e-5
    _, vjp = jax.vjp(lambda *a: jax_attention_ref(*a, causal=causal),
                     *(to_jax(a) for a in (q, k, v)))
    for a, b in zip(got, vjp(to_jax(do))):
        assert_close(a, b, "float32")


@pytest.mark.parametrize("fault", ["group_sum_dropped", "not_causal"])
@pytest.mark.parametrize("group", [2, 4])
def test_function_check_catches_planted_faults(monkeypatch, group, fault):
    q, k, v = _qkv(2, 4, 4 // group, 40, 16, seed=5)
    do = randn(9, q.shape)
    plain = _grads(attention_ref, q, k, v, do, True)
    real = flash_ops.flash_bwd
    bad = (_group_sum_dropped(real) if fault == "group_sum_dropped"
           else lambda q, k, v, o, lse, do, causal: real(q, k, v, o, lse, do, False))
    monkeypatch.setattr(flash_ops, "flash_bwd", bad)
    got = _grads(flash_attention, q, k, v, do, True)
    assert not all(torch.allclose(a, b, rtol=2e-4, atol=1e-4) for a, b in zip(got, plain))


@pytest.mark.parametrize("dtype", DTYPES)
def test_function_grads_keep_the_input_dtype(dtype):
    q, k, v = (to_torch(a, dtype).requires_grad_() for a in _qkv(1, 4, 2, 24, 16))
    out = flash_attention(q, k, v)
    assert out.grad_fn.name() == "FlashAttentionFnBackward"
    out.float().square().sum().backward()
    assert all(t.grad.dtype == getattr(torch, dtype) for t in (q, k, v))
