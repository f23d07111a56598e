"""Every function of the port's models/mamba2.py against its JAX counterpart,
on the same numpy inputs and weights.

fp32 uses the _tol row (rtol 2e-4 / atol 1e-4); bf16 the bf16 row (rtol 3e-2
/ atol 8e-2): both sides round to bf16 at the same ops, but compute the fp32
parts of those ops in another order.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_parity import DTYPES, assert_close, randn, to_jax, to_torch  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import mamba2 as J  # noqa: E402
from repro_torch.models import mamba2 as T  # noqa: E402

B, S, D, N, HD, EXPAND, CHUNK = 2, 40, 32, 16, 8, 2, 16
DI = EXPAND * D
H = DI // HD
C = DI + 2 * N
FP32 = dict(rtol=2e-4, atol=1e-4)


def _tol(dtype):
    return FP32 if dtype == "float32" else {}


def _params(dtype, seed=0):
    jp, _ = J.init_mamba2(jax.random.PRNGKey(seed), D, N, HD, EXPAND, getattr(jnp, dtype))
    # non-trivial dt_bias, D and norm, so that each enters the comparison
    jp = dict(jp, dt_bias=jnp.asarray(randn(seed + 1, (H,), 0.5)),
              D=jnp.asarray(1 + randn(seed + 2, (H,), 0.1)),
              norm=jnp.asarray(1 + randn(seed + 3, (DI,), 0.1)))
    return jp, {k: to_torch(np.asarray(v)) for k, v in jp.items()}


def _ssd_inputs(dtype, S_=S, seed=0):
    arrays = (randn(seed, (B, S_, H, HD), 0.5),
              np.log1p(np.exp(randn(seed + 1, (B, S_, H)))).astype(np.float32),
              (-np.exp(np.linspace(0.0, 1.5, H))).astype(np.float32),
              randn(seed + 2, (B, S_, N), 0.3), randn(seed + 3, (B, S_, N), 0.3))
    kinds = [dtype, dtype, "float32", dtype, dtype]
    return ([to_jax(a, k) for a, k in zip(arrays, kinds)],
            [to_torch(a, k) for a, k in zip(arrays, kinds)])


def test_init_matches_reference_shapes_and_values():
    jp, _ = J.init_mamba2(jax.random.PRNGKey(0), D, N, HD, EXPAND, jnp.bfloat16)
    tp = T.init_mamba2(torch.Generator().manual_seed(0), D, N, HD, EXPAND,
                       torch.bfloat16, "cpu")
    assert tp.keys() == jp.keys()
    for k in jp:
        assert tuple(tp[k].shape) == jp[k].shape, k
        assert str(tp[k].dtype).split(".")[-1] == jp[k].dtype.name, k
    for k in ("A_log", "dt_bias", "D", "norm"):   # deterministic entries
        assert_close(tp[k], jp[k], **FP32)


@pytest.mark.parametrize("with_state", [False, True], ids=["prefill", "streaming"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_causal_conv(dtype, with_state):
    x, w = randn(0, (B, 5 if with_state else S, C)), randn(1, (T.CONV_K, C), 0.5)
    state = randn(2, (B, T.CONV_K - 1, C)) if with_state else None
    jy, jst = J._causal_conv(to_jax(x, dtype), to_jax(w, dtype),
                             None if state is None else to_jax(state, dtype))
    ty, tst = T._causal_conv(to_torch(x, dtype), to_torch(w, dtype),
                             None if state is None else to_torch(state, dtype))
    assert ty.dtype == getattr(torch, dtype)
    assert_close(ty, jy, dtype, **_tol(dtype))
    np.testing.assert_array_equal(tst.float().numpy(), np.asarray(jst, np.float32))


@pytest.mark.parametrize("S_", [S, 48, 7])
def test_ssd_chunked(S_):
    # fp32 only: the model feeds it fp32, and the reference's chunk scan
    # refuses bf16 inputs (its fp32 carry does not match a bf16 init)
    j, t = _ssd_inputs("float32", S_)
    jy, jfin = J.ssd_chunked(*j, CHUNK)
    ty, tfin = T.ssd_chunked(*t, CHUNK)
    assert tuple(ty.shape) == jy.shape and tuple(tfin.shape) == jfin.shape
    assert_close(ty, jy, **FP32)
    assert_close(tfin, jfin, **FP32)


def test_ssd_decode_step():
    # fp32 only: mamba2_decode casts every input to fp32 before the step
    j, t = _ssd_inputs("float32", 1)
    st = randn(9, (B, H, HD, N), 0.5)
    args_j = (to_jax(st), j[0][:, 0], j[1][:, 0], j[2], j[3][:, 0], j[4][:, 0])
    args_t = (to_torch(st), t[0][:, 0], t[1][:, 0], t[2], t[3][:, 0], t[4][:, 0])
    jy, jst = J.ssd_decode_step(*args_j)
    ty, tst = T.ssd_decode_step(*args_t)
    assert_close(ty, jy, **FP32)
    assert_close(tst, jst, **FP32)


@pytest.mark.parametrize("kernels", [True, False], ids=["kernels", "plain"])
@pytest.mark.parametrize("initial", [False, True], ids=["fresh", "carry_in"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_mamba2_block(dtype, initial, kernels):
    jp, tp = _params(dtype)
    x = randn(4, (B, S, D))
    init_j = init_t = None
    if initial:
        conv, ssm = randn(5, (B, T.CONV_K - 1, C)), randn(6, (B, H, HD, N), 0.5)
        init_j = {"conv": to_jax(conv, dtype), "ssm": to_jax(ssm)}
        init_t = {"conv": to_torch(conv, dtype), "ssm": to_torch(ssm)}
    kw = dict(d_state=N, headdim=HD, expand=EXPAND, chunk=CHUNK, return_state=True)
    jout, jst = J.mamba2_block(jp, to_jax(x, dtype), initial=init_j, **kw)
    tout, tst = T.mamba2_block(tp, to_torch(x, dtype), initial=init_t, kernels=kernels, **kw)
    assert tout.dtype == getattr(torch, dtype) and tst["ssm"].dtype == torch.float32
    assert_close(tout, jout, dtype, **_tol(dtype))
    assert_close(tst["ssm"], jst["ssm"], dtype, **_tol(dtype))
    assert_close(tst["conv"], jst["conv"], dtype, **_tol(dtype))


@pytest.mark.parametrize("dtype", DTYPES)
def test_mamba2_decode_steps(dtype):
    jp, tp = _params(dtype, seed=3)
    conv = randn(5, (B, T.CONV_K - 1, C))
    jc = {"conv": to_jax(conv, dtype), "ssm": jnp.zeros((B, H, HD, N), getattr(jnp, dtype))}
    tc = {"conv": to_torch(conv, dtype), "ssm": torch.zeros((B, H, HD, N))}
    kw = dict(d_state=N, headdim=HD, expand=EXPAND)
    for step in range(4):
        x = randn(10 + step, (B, 1, D))
        jout, jc = J.mamba2_decode(jp, to_jax(x, dtype), jc, **kw)
        tout, tc = T.mamba2_decode(tp, to_torch(x, dtype), tc, **kw)
        assert jc["ssm"].dtype == jnp.float32 and tc["ssm"].dtype == torch.float32
        assert_close(tout, jout, dtype, **_tol(dtype))
        assert_close(tc["ssm"], jc["ssm"], dtype, **_tol(dtype))
        assert_close(tc["conv"], jc["conv"], dtype, **_tol(dtype))


def test_decode_continues_a_prefill():
    """The block's returned state, fed to decode, gives what a longer prefill
    gives for the next token (fp32, the port alone)."""
    _, tp = _params("float32", seed=4)
    x = to_torch(randn(7, (B, S + 1, D)))
    kw = dict(d_state=N, headdim=HD, expand=EXPAND)
    full = T.mamba2_block(tp, x, chunk=CHUNK, **kw)
    _, st = T.mamba2_block(tp, x[:, :S], chunk=CHUNK, return_state=True, **kw)
    nxt, _ = T.mamba2_decode(tp, x[:, S:], st, **kw)
    torch.testing.assert_close(nxt, full[:, S:], **FP32)
