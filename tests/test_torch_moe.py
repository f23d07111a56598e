"""The port's MoE layer against the JAX package's ``repro.models.moe``, on
the same numpy inputs and weights, at the _tol tolerances (fp32 rtol 2e-4 /
atol 1e-4; bf16 3e-2 / 8e-2): routing, capacity drops, grouped dispatch and
the aux loss."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_parity import assert_close, randn, to_jax, to_torch  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import moe as J  # noqa: E402
from repro_torch.models import moe as T  # noqa: E402

D, F, E = 32, 48, 8


def _weights(seed, dtype, zero_router=False):
    router = np.zeros((D, E), np.float32) if zero_router else randn(seed, (D, E), D ** -0.5)
    w = {"w_gate": randn(seed + 1, (E, D, F), D ** -0.5),
         "w_up": randn(seed + 2, (E, D, F), D ** -0.5),
         "w_down": randn(seed + 3, (E, F, D), F ** -0.5)}
    jp = {"router": jnp.asarray(router), **{k: to_jax(v, dtype) for k, v in w.items()}}
    tp = {"router": torch.from_numpy(router), **{k: to_torch(v, dtype) for k, v in w.items()}}
    return jp, tp


def _both(B, S, dtype, seed=0, zero_router=False, **kw):
    jp, tp = _weights(seed, dtype, zero_router)
    x = randn(seed + 10, (B, S, D))
    jy, jaux = J.moe_block(jp, to_jax(x, dtype), **kw)
    ty, taux = T.moe_block(tp, to_torch(x, dtype), **kw)
    return (jy, jaux), (ty, taux)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("bs", [(2, 16), (8, 1)], ids=["prefill", "decode_T8"])
def test_moe_block_matches_reference(bs, groups, capacity_factor, dtype):
    (jy, jaux), (ty, taux) = _both(*bs, dtype, top_k=2, capacity_factor=capacity_factor,
                                   groups=groups)
    assert ty.shape == jy.shape and ty.dtype == getattr(torch, dtype)
    assert_close(ty, jy, dtype)
    assert taux.dtype == torch.float32
    assert_close(taux, jaux, "float32")


@pytest.mark.parametrize("top_k", [1, 2, 3])
def test_forced_drops_zero_exactly_the_reference_rows(top_k):
    """capacity_factor 0.5: most experts overflow; the tokens whose every
    assignment was dropped come out exactly 0 on both sides."""
    (jy, _), (ty, _) = _both(4, 8, "float32", seed=3, top_k=top_k, capacity_factor=0.5)
    jz = np.all(np.asarray(jy) == 0, axis=-1)
    tz = np.all(ty.numpy() == 0, axis=-1)
    np.testing.assert_array_equal(tz, jz)
    assert jz.any()
    assert_close(ty, jy)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bs", [(2, 16), (8, 1)], ids=["prefill", "decode_T8"])
def test_zeroed_router_ties(bs, dtype):
    """Every probability ties: top-k takes experts 0..k-1 for every token,
    and capacity keeps only the first C tokens of each (torch.topk would pick
    other experts and drop other tokens)."""
    (jy, jaux), (ty, taux) = _both(*bs, dtype, zero_router=True, top_k=2)
    assert_close(ty, jy, dtype)
    assert_close(taux, jaux, "float32")
    T_ = bs[0] * bs[1]
    C = T.capacity(T_ * 2, E, 1.25)
    kept = ~np.all(T.moe_block(_weights(0, "float32", True)[1],
                               to_torch(randn(10, (*bs, D))), top_k=2)[0].reshape(T_, D).numpy()
                   == 0, axis=-1)
    np.testing.assert_array_equal(kept, np.arange(T_) < C)


def test_top_k_breaks_ties_as_lax_top_k():
    probs = np.array([[0.1, 0.3, 0.3, 0.2, 0.3, 0.1], [0.2] * 5 + [0.0]], np.float32)
    jv, ji = jax.lax.top_k(jnp.asarray(probs), 3)
    tv, ti = T.top_k_gates(torch.from_numpy(probs), 3)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(ti[0].numpy(), [1, 2, 4])
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv) / np.asarray(jv).sum(-1, keepdims=True),
                               rtol=1e-6)


def test_inverse_permutation_is_argsort():
    order = torch.from_numpy(np.random.default_rng(0).permutation(37))
    torch.testing.assert_close(T.inverse_permutation(order), torch.argsort(order))


def test_capacity_chunks_cover_every_slot(monkeypatch):
    """More slots than a chunk: the expert products run chunk by chunk and
    give what one chunk gives."""
    jp, tp = _weights(5, "float32")
    x = to_torch(randn(6, (2, 16, D)))
    whole, _ = T.moe_block(tp, x, top_k=2)
    monkeypatch.setattr(T, "CHUNK", 3)
    chunked, _ = T.moe_block(tp, x, top_k=2)
    torch.testing.assert_close(chunked, whole, rtol=2e-6, atol=1e-6)
    assert_close(chunked, J.moe_block(jp, to_jax(randn(6, (2, 16, D))), top_k=2)[0])


def test_init_moe_and_flops_match_reference():
    jparams, _ = J.init_moe(jax.random.PRNGKey(0), D, F, E, jnp.bfloat16)
    tparams = T.init_moe(torch.Generator().manual_seed(0), D, F, E, torch.bfloat16, "cpu")
    assert tparams.keys() == jparams.keys()
    for k in jparams:
        assert tuple(tparams[k].shape) == jparams[k].shape
        assert str(tparams[k].dtype).split(".")[-1] == jparams[k].dtype.name
    assert T.moe_flops_per_token(D, F, 2) == J.moe_flops_per_token(D, F, 2)


def test_groups_must_divide_tokens():
    _, tp = _weights(0, "float32")
    with pytest.raises(ValueError, match="groups"):
        T.moe_block(tp, torch.zeros(1, 5, D), top_k=2, groups=2)
