"""The port's flash_attention (plain path on the CPU) against the JAX package's
Pallas kernel (interpret mode) and attention_ref."""
import pytest

torch = pytest.importorskip("torch")

from test_torch_parity import DTYPES, assert_close, randn, to_jax, to_torch  # noqa: E402

from repro.kernels.flash_attention.ops import flash_attention as jax_flash  # noqa: E402
from repro.kernels.flash_attention.ref import attention_ref as jax_attention_ref  # noqa: E402
from repro_torch.kernels.flash_attention import attention_ref, flash_attention  # noqa: E402

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


def _wgmma_numerics(q, k, v, causal, split_p, block=128):
    """The bf16 wgmma kernel's arithmetic in fp32 torch: S = Q K^T summed in
    fp32 (products of bf16 values are exact), an online softmax over 128-key
    tiles in the log2 domain, P rounded to bf16 before P V -- or split into
    bf16 hi + lo parts, each through P V, as the kernel does -- the row sum
    of the unrounded P, and one rounding of the output."""
    B, H, S, d = q.shape
    rep = H // k.shape[1]
    q, k, v = q.float(), k.repeat_interleave(rep, 1).float(), v.repeat_interleave(rep, 1).float()
    scale = 1.4426950408889634 / d ** 0.5
    m = torch.full((B, H, S, 1), -1e30)
    l = torch.zeros(B, H, S, 1)
    o = torch.zeros(B, H, S, d)
    qp = torch.arange(S).view(S, 1)
    for k0 in range(0, S, block):
        s = torch.einsum("bhqd,bhkd->bhqk", q, k[:, :, k0:k0 + block])
        if causal:
            s = s.masked_fill(torch.arange(k0, min(k0 + block, S)).view(1, -1) > qp, -1e30)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp2((m - m_new) * scale)
        p = torch.exp2(s * scale - m_new * scale)
        l = l * alpha + p.sum(-1, keepdim=True)
        hi = p.bfloat16().float()
        p_used = hi + (p - hi).bfloat16().float() if split_p else hi
        o = o * alpha + torch.einsum("bhqk,bhkd->bhqd", p_used, v[:, :, k0:k0 + block])
        m = m_new
    return (o / l.clamp_min(1e-30)).bfloat16()


@pytest.mark.parametrize("cfg", [dict(B=2, H=8, KV=1, S=1024, d=64),    # chip_smoke's MQA check
                                 dict(B=1, H=4, KV=1, S=63, d=128)], ids=["s1024", "s63"])
def test_split_p_keeps_the_wgmma_kernel_within_the_flash_limits(cfg):
    """Why the bf16 kernel splits P: with P rounded once to bf16, as FA2/FA3
    round it, single outputs move past the elementwise limit (the relative
    L2 stays far under its own); split into hi + lo, P keeps ~16 bits and
    the kernel's arithmetic holds the reference within both."""
    q, k, v = (to_torch(a, "bfloat16") for a in _qkv(**cfg, seed=11))
    want = to_torch(jax_attention_ref(*(to_jax(a.float().numpy(), "bfloat16")
                                        for a in (q, k, v)))).float()

    def rel_l2(got):
        return float((got.float() - want).norm() / want.norm())

    split = _wgmma_numerics(q, k, v, True, split_p=True)
    assert torch.allclose(split.float(), want, **FLASH_TOL) and rel_l2(split) <= FLASH_REL_L2
    single = _wgmma_numerics(q, k, v, True, split_p=False)
    assert not torch.allclose(single.float(), want, **FLASH_TOL)
    assert rel_l2(single) <= FLASH_REL_L2


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
