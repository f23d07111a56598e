"""Shared helpers for the PyTorch port's parity tests (and tests of them).

Inputs are made with numpy from fixed seeds and handed to both frameworks.
bf16 crosses the numpy bridge through float32, which holds every bf16 value
exactly; both sides then round the same float32 values to bf16 (round to
nearest even), so they start from identical bits.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

DTYPES = ("float32", "bfloat16")


def tol(dtype):
    """The tolerance table of tests/test_kernels.py:17-19."""
    if isinstance(dtype, str):
        name = dtype
    elif isinstance(dtype, torch.dtype):
        name = str(dtype).split(".")[-1]
    else:
        name = np.dtype(dtype).name
    return dict(rtol=3e-2, atol=8e-2) if name == "bfloat16" else dict(rtol=2e-4, atol=1e-4)


def randn(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def to_jax(a, dtype="float32"):
    return jnp.asarray(np.asarray(a, np.float32)).astype(getattr(jnp, dtype))


def to_torch(a, dtype=None):
    """numpy (incl. ml_dtypes.bfloat16) or jax array -> CPU tensor; bf16 via fp32."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(getattr(torch, dtype))


def to_np(x):
    """jax array or tensor -> float32 numpy, for comparison."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def assert_close(got, want, dtype="float32", **kw):
    np.testing.assert_allclose(to_np(got), to_np(want), **(kw or tol(dtype)))


@pytest.mark.parametrize("dtype", DTYPES)
def test_bridge_round_trip_is_exact(dtype):
    a = randn(0, (7, 13), 3.0)
    j = to_jax(a, dtype)
    t = to_torch(a, dtype)
    np.testing.assert_array_equal(to_np(j), to_np(t))
    np.testing.assert_array_equal(to_np(to_torch(np.asarray(j))), to_np(t))
    assert to_torch(np.asarray(j)).dtype == getattr(torch, dtype)


def test_tol_table_matches_kernel_tests():
    assert tol("bfloat16") == tol(jnp.bfloat16) == tol(torch.bfloat16) == dict(rtol=3e-2, atol=8e-2)
    assert tol("float32") == tol(jnp.float32) == dict(rtol=2e-4, atol=1e-4)
