"""Every function of the port's models/layers.py against its JAX counterpart,
on the same numpy inputs (fp32: rtol 2e-4 / atol 1e-4)."""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_parity import assert_close, randn, to_jax, to_torch  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import layers as J  # noqa: E402
from repro_torch.models import layers as T  # noqa: E402

B, S, D, H, KV, HD = 2, 24, 32, 4, 2, 8
FP32 = dict(rtol=2e-4, atol=1e-4)


def _attn_params(qk_norm, seed=0):
    p = {"wq": randn(seed, (D, H * HD), 1 / math.sqrt(D)),
         "wk": randn(seed + 1, (D, KV * HD), 1 / math.sqrt(D)),
         "wv": randn(seed + 2, (D, KV * HD), 1 / math.sqrt(D)),
         "wo": randn(seed + 3, (H * HD, D), 1 / math.sqrt(2 * D))}
    if qk_norm:
        p["q_norm"] = 1 + randn(seed + 4, (HD,), 0.1)
        p["k_norm"] = 1 + randn(seed + 5, (HD,), 0.1)
    return ({k: to_jax(v) for k, v in p.items()}, {k: to_torch(v) for k, v in p.items()})


def _positions(Sq=S, offset=0):
    pos = np.broadcast_to(np.arange(Sq, dtype=np.int32) + offset, (B, Sq))
    return jnp.asarray(pos), torch.from_numpy(np.array(pos))


def test_rms_norm():
    x, w = randn(0, (B, S, D), 3.0), 1 + randn(1, (D,), 0.1)
    assert_close(T.rms_norm(to_torch(x), to_torch(w), 1e-6),
                 J.rms_norm(to_jax(x), to_jax(w), 1e-6), **FP32)
    got = T.rms_norm(to_torch(x, "bfloat16"), to_torch(w))
    assert got.dtype == torch.bfloat16
    assert_close(got, J.rms_norm(to_jax(x, "bfloat16"), to_jax(w)), "bfloat16")


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_rope(theta):
    np.testing.assert_array_equal(T.rope_freqs(HD, theta), J.rope_freqs(HD, theta))
    x = randn(2, (B, S, H, HD))
    jpos, tpos = _positions(offset=5)
    assert_close(T.apply_rope(to_torch(x), tpos, theta),
                 J.apply_rope(to_jax(x), jpos, theta), **FP32)


@pytest.mark.parametrize("qk_norm", [False, True])
def test_qkv(qk_norm):
    jp, tp = _attn_params(qk_norm)
    x = randn(3, (B, S, D))
    jpos, tpos = _positions()
    want = J._qkv(jp, to_jax(x), H, KV, HD, jpos, qk_norm, 10_000.0, 1e-5)
    got = T._qkv(tp, to_torch(x), H, KV, HD, tpos, qk_norm, 10_000.0, 1e-5)
    for g, w in zip(got, want):
        assert_close(g, w, **FP32)


@pytest.mark.parametrize("n_heads,n_kv", [(4, 2), (8, 1), (4, 4), (6, 4)])
def test_repeat_kv(n_heads, n_kv):
    k = randn(4, (B, S, n_kv, HD))
    got = T._repeat_kv(to_torch(k), n_heads)
    np.testing.assert_array_equal(got.numpy(), np.asarray(J._repeat_kv(to_jax(k), n_heads)))


@pytest.mark.parametrize("q_block", [512, 8, 7])
@pytest.mark.parametrize("q_offset", [None, 0, 5])
def test_causal_attention(q_block, q_offset):
    Sq, Skv = 12, 20
    q, k, v = randn(5, (B, Sq, H, HD)), randn(6, (B, Skv, KV, HD)), randn(7, (B, Skv, KV, HD))
    want = J.causal_attention(to_jax(q), to_jax(k), to_jax(v), q_block=q_block,
                              q_offset=q_offset)
    got = T.causal_attention(to_torch(q), to_torch(k), to_torch(v), q_block=q_block,
                             q_offset=q_offset)
    assert_close(got, want, **FP32)


@pytest.mark.parametrize("kernels", [True, False])
@pytest.mark.parametrize("qk_norm", [False, True])
def test_attention_block(qk_norm, kernels):
    """kernels=True goes through the wrappers (their plain versions on the
    CPU, incl. the (B,H,S,d) layout glue); kernels=False is plain PyTorch."""
    jp, tp = _attn_params(qk_norm, seed=10)
    x = randn(11, (B, S, D))
    jpos, tpos = _positions()
    kw = dict(n_heads=H, n_kv=KV, head_dim=HD, qk_norm=qk_norm)
    want = J.attention_block(jp, to_jax(x), positions=jpos, q_block=8, **kw)
    got = T.attention_block(tp, to_torch(x), positions=tpos, q_block=8,
                            kernels=kernels, **kw)
    assert_close(got, want, **FP32)


@pytest.mark.parametrize("qk_norm", [False, True])
def test_attention_decode(qk_norm):
    S_max = 8
    jp, tp = _attn_params(qk_norm, seed=20)
    kw = dict(n_heads=H, n_kv=KV, head_dim=HD, qk_norm=qk_norm)
    ck, cv = np.zeros((B, S_max, KV, HD), np.float32), np.zeros((B, S_max, KV, HD), np.float32)
    jk, jv = to_jax(ck), to_jax(cv)
    tk, tv = to_torch(ck), to_torch(cv)
    # several cache_len values, incl. past the end (the write clamps, the mask does not)
    for step, cache_len in enumerate([0, 1, 2, 5, 7, 9]):
        x = randn(30 + step, (B, 1, D))
        want, jk, jv = J.attention_decode(jp, to_jax(x), jk, jv, jnp.int32(cache_len), **kw)
        got, tk, tv = T.attention_decode(tp, to_torch(x), tk, tv, cache_len, **kw)
        assert_close(got, want, **FP32)
        assert_close(tk, jk, **FP32)
        assert_close(tv, jv, **FP32)


@pytest.mark.parametrize("kernels", [True, False])
def test_mlp_block(kernels):
    F = 48
    p = {"w_gate": randn(40, (D, F), 1 / math.sqrt(D)), "w_up": randn(41, (D, F), 1 / math.sqrt(D)),
         "w_down": randn(42, (F, D), 1 / math.sqrt(F))}
    x = randn(43, (B, S, D))
    want = J.mlp_block({k: to_jax(v) for k, v in p.items()}, to_jax(x))
    got = T.mlp_block({k: to_torch(v) for k, v in p.items()}, to_torch(x), kernels)
    assert_close(got, want, **FP32)


def test_embed_unembed_cross_entropy():
    V = 50
    table = randn(50, (V, D))
    tokens = np.random.default_rng(51).integers(0, V, (B, S)).astype(np.int32)
    e = T.embed(to_torch(table), torch.from_numpy(tokens))
    np.testing.assert_array_equal(e.numpy(), np.asarray(J.embed(to_jax(table), jnp.asarray(tokens))))
    x = randn(52, (B, S, D))
    logits_t = T.unembed(to_torch(x), to_torch(table))
    logits_j = J.unembed(to_jax(x), to_jax(table))
    assert_close(logits_t, logits_j, **FP32)
    labels = np.random.default_rng(53).integers(0, V, (B, S)).astype(np.int32)
    assert_close(T.cross_entropy(logits_t, torch.from_numpy(labels)),
                 J.cross_entropy(logits_j, jnp.asarray(labels)), **FP32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_functions_match_reference_distributions(dtype):
    """Same keys, shapes and dtypes as the JAX init functions; normal x scale."""
    gen = torch.Generator().manual_seed(0)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    key = jax.random.PRNGKey(0)
    d, f, v = 64, 176, 256
    pairs = [
        (T.init_attention(gen, d, 4, 2, 16, True, tdt, "cpu"),
         J.init_attention(key, d, 4, 2, 16, True, jdt)[0]),
        (T.init_mlp(gen, d, f, tdt, "cpu"), J.init_mlp(key, d, f, jdt)[0]),
        ({"emb": T.init_embedding(gen, v, d, tdt, "cpu"), "rms": T.init_rms(d, "cpu")},
         {"emb": J.init_embedding(key, v, d, jdt)[0], "rms": J.init_rms(d)[0]}),
    ]
    for tp, jp in pairs:
        assert tp.keys() == jp.keys()
        for name in tp:
            t, j = tp[name], jp[name]
            assert tuple(t.shape) == j.shape and str(t.dtype).split(".")[-1] == j.dtype.name
            jstd = float(np.std(np.asarray(j, np.float32)))
            tstd = float(t.float().std())
            assert abs(tstd - jstd) <= 0.1 * jstd + 1e-6, (name, tstd, jstd)


@pytest.mark.parametrize("name", ["rmsnorm", "mlp", "attn_layer"])
def test_traced_workload_shapes(name):
    """The shapes of the traced suite (repro/frontend/workloads.py:77-113)."""
    if name == "rmsnorm":
        x, w = randn(60, (8, 64)), 1 + randn(61, (64,), 0.1)
        assert_close(T.rms_norm(to_torch(x), to_torch(w)), J.rms_norm(to_jax(x), to_jax(w)), **FP32)
    elif name == "mlp":
        p = {"w_gate": randn(62, (64, 128), 0.125), "w_up": randn(63, (64, 128), 0.125),
             "w_down": randn(64, (128, 64), 1 / math.sqrt(128))}
        x = randn(65, (1, 8, 64))
        assert_close(T.mlp_block({k: to_torch(v) for k, v in p.items()}, to_torch(x)),
                     J.mlp_block({k: to_jax(v) for k, v in p.items()}, to_jax(x)), **FP32)
    else:
        q, k, v = randn(66, (1, 64, 4, 32)), randn(67, (1, 64, 2, 32)), randn(68, (1, 64, 2, 32))
        assert_close(T.causal_attention(to_torch(q), to_torch(k), to_torch(v), q_block=32),
                     J.causal_attention(to_jax(q), to_jax(k), to_jax(v), q_block=32), **FP32)
