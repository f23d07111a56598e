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
