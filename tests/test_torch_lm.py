"""The port's LM (forward, loss, decode) against the JAX package's, with the
JAX weights carried across by params_from_numpy, on the smoke configs.

fp32 tolerance is 1e-3 / 1e-3: both sides sum in another order in every
layer, and the differences compound over depth.  bf16 uses the _tol table.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_parity import assert_close  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke as jax_get_smoke  # noqa: E402
from repro.models import lm as J  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.models import lm as T  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402

ARCHS = ["tinyllama-1.1b", "qwen3-0.6b"]
FP32 = dict(rtol=1e-3, atol=1e-3)


def _configs(arch, dtype):
    jcfg = dataclasses.replace(jax_get_smoke(arch), dtype=dtype, scan_layers=False)
    tcfg = dataclasses.replace(get_smoke(arch), dtype=dtype)
    return jcfg, tcfg


def _params(jcfg, tcfg, seed=0):
    jp, _ = J.init_params(jcfg, jax.random.PRNGKey(seed))
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")


def _batch(cfg, B=2, S=16, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    return ({"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks)},
            {"tokens": torch.from_numpy(toks).long(), "labels": torch.from_numpy(toks).long()})


def test_params_from_numpy_is_exact():
    jcfg, tcfg = _configs("qwen3-0.6b", "bfloat16")
    jp, tp = _params(jcfg, tcfg)
    assert len(tp["layers"]) == tcfg.n_layers
    np.testing.assert_array_equal(tp["embed"].float().numpy(), np.asarray(jp["embed"], np.float32))
    for i in range(tcfg.n_layers):
        for name in ("wq", "wo", "q_norm"):
            t = tp["layers"][i]["attn"][name]
            j = np.asarray(jp["layers"]["attn"][name][i])
            assert str(t.dtype).split(".")[-1] == j.dtype.name
            np.testing.assert_array_equal(t.float().numpy(), j.astype(np.float32))
        assert tp["layers"][i]["mlp"]["w_down"].is_contiguous()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_loss(arch, dtype):
    jcfg, tcfg = _configs(arch, dtype)
    jp, tp = _params(jcfg, tcfg)
    jb, tb = _batch(tcfg)
    kw = FP32 if dtype == "float32" else {}
    jx, jpos = J.embed_inputs(jp, jcfg, jb)
    tx, tpos = T.embed_inputs(tp, tcfg, tb)
    assert_close(tx, jx, dtype, **kw)
    jh, _ = J.forward(jp, jcfg, jx, jpos)
    th, _ = T.forward(tp, tcfg, tx, tpos)
    assert th.dtype == tcfg.torch_dtype
    assert_close(th, jh, dtype, **kw)
    jloss, jm = J.loss_fn(jp, jb, jcfg)
    tloss, tm = T.loss_fn(tp, tb, tcfg)
    assert np.isfinite(float(tloss))
    assert_close(tloss, jloss, dtype, **kw)
    assert_close(tm["loss"], jm["loss"], dtype, **kw)
    # the plain path (kernels=False) agrees with the kernel wrappers' CPU path
    pl_loss, _ = T.loss_fn(tp, tb, tcfg, kernels=False)
    assert_close(pl_loss, tloss, dtype, **kw)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_and_cache(arch):
    jcfg, tcfg = _configs(arch, "float32")
    jp, tp = _params(jcfg, tcfg, seed=1)
    B, S_max = 3, 8
    jc, _ = J.init_decode_cache(jcfg, B, S_max)
    tc = T.init_decode_cache(tcfg, B, S_max, device="cpu")
    assert tuple(tc["k"].shape) == jc["k"].shape
    rng = np.random.default_rng(2)
    decode = jax.jit(lambda p, c, t, n: J.decode_step(p, c, t, n, jcfg))
    for step in range(6):
        toks = rng.integers(0, tcfg.vocab, (B, 1)).astype(np.int32)
        jl, jc = decode(jp, jc, jnp.asarray(toks), jnp.int32(step))
        tl, tc = T.decode_step(tp, tc, torch.from_numpy(toks).long(), step, tcfg)
        assert tuple(tl.shape) == jl.shape
        assert_close(tl, jl, **FP32)
        assert_close(tc["k"], jc["k"], **FP32)
        assert_close(tc["v"], jc["v"], **FP32)
        np.testing.assert_array_equal(tl[:, -1].argmax(-1).numpy(),
                                      np.asarray(jnp.argmax(jl[:, -1], -1)))


def test_init_params_shapes_match_reference():
    jcfg, tcfg = _configs("qwen3-0.6b", "bfloat16")
    jp, _ = J.init_params(jcfg, jax.random.PRNGKey(0))
    tp = T.init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    ref = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")

    def flat(p):
        out = {k: v for k, v in p.items() if k != "layers"}
        for i, layer in enumerate(p["layers"]):
            for blk, d in layer.items():
                for name, t in (d.items() if isinstance(d, dict) else [("", d)]):
                    out[f"{i}.{blk}.{name}"] = t
        return out

    got, want = flat(tp), flat(ref)
    assert got.keys() == want.keys()
    for k in got:
        assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype, k


@pytest.mark.parametrize("family_arch", ["mamba2-1.3b", "granite-moe-3b-a800m"])
def test_unported_families_raise(family_arch):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        get_smoke(family_arch)
    cfg = dataclasses.replace(get_smoke("tinyllama-1.1b"), family="moe")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        T.init_params(cfg, device="cpu")
