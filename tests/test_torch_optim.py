"""The port's AdamW and int8 gradient compression against the JAX package's,
on the same numpy inputs.

AdamW follows the reference's arithmetic order, but the two frameworks'
elementwise code may contract a multiply and an add into one rounding (XLA
on the CPU does) and their ``pow``/``cos`` differ in the last bit: values
are held to 1e-6 relative, moments and parameters to 1e-6 relative L2.  The
quantized gradients must be equal: ``torch.round`` and ``jnp.round`` both
round half to even.  Each check has a planted fault that must fail it.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.optim import adamw as JA  # noqa: E402
from repro.optim import compression as JC  # noqa: E402
from repro_torch.optim import adamw as TA  # noqa: E402
from repro_torch.optim import compression as TC  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

VALUE_REL = 1e-6
TREE_REL_L2 = 1e-6
SHAPES = {"embed": (32, 16), "layers": [{"w": (16, 24), "norm": (16,)}] * 2, "head": (16, 40)}


def np_tree(seed, scale=1.0, shapes=SHAPES):
    rng = np.random.default_rng(seed)

    def make(s):
        if isinstance(s, dict):
            return {k: make(v) for k, v in s.items()}
        if isinstance(s, list):
            return [make(v) for v in s]
        return (rng.standard_normal(s) * scale).astype(np.float32)
    return make(shapes)


def to_torch(tree):
    if isinstance(tree, dict):
        return {k: to_torch(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_torch(v) for v in tree]
    return torch.from_numpy(tree.copy())


def to_jax(tree):
    """The JAX trees stack nothing here: lists stay lists (pytree nodes)."""
    return jax.tree.map(jnp.asarray, tree)


def leaves_np(tree):
    """Leaves as numpy arrays in JAX's order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves_np(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in leaves_np(v)]
    return [tree.numpy() if isinstance(tree, torch.Tensor) else np.asarray(tree)]


def rel(a, b) -> float:
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)


def rel_l2(a, b) -> float:
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("cfg", [JA.AdamWConfig(), JA.AdamWConfig(lr=1e-3, warmup_steps=10,
                                                                   total_steps=50)])
def test_lr_schedule_matches_jax(cfg):
    tcfg = TA.AdamWConfig(**cfg.__dict__)
    for step in [0, 1, 5, cfg.warmup_steps - 1, cfg.warmup_steps, cfg.warmup_steps + 7,
                 cfg.total_steps // 2, cfg.total_steps, cfg.total_steps + 100]:
        got = TA.lr_schedule(tcfg, torch.tensor(step, dtype=torch.int32))
        want = JA.lr_schedule(cfg, jnp.int32(step))
        assert got.dtype == torch.float32
        assert rel(got, want) <= VALUE_REL or abs(float(got) - float(want)) < 1e-12, step


def test_global_norm_matches_jax():
    g = np_tree(1)
    assert rel(TA.global_norm(to_torch(g)), JA.global_norm(to_jax(g))) <= VALUE_REL


def test_init_opt_state_is_fp32_zeros_and_an_int32_step():
    p = to_torch(np_tree(0))
    p["embed"] = p["embed"].bfloat16()
    st = TA.init_opt_state(p)
    for t, q in zip(tree_leaves(st["mu"]) + tree_leaves(st["nu"]), tree_leaves(p) * 2):
        assert t.dtype == torch.float32 and t.shape == q.shape and not t.any()
    assert st["step"].dtype == torch.int32 and st["step"].shape == () and int(st["step"]) == 0


def _steps(module, cfg, params, grads_list, state, wrap):
    metrics = []
    for g in grads_list:
        params, state, m = module.adamw_update(cfg, params, wrap(g), state)
        metrics.append({k: float(v) for k, v in m.items()})
    return params, state, metrics


def adamw_errors(grad_scale=1.0) -> dict:
    """Three AdamW steps on both sides; each reading beside its limit's verdict."""
    jcfg = JA.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=10)
    tcfg = TA.AdamWConfig(**jcfg.__dict__)
    p0 = np_tree(0)
    grads = [np_tree(s, grad_scale) for s in (1, 2, 3)]
    jp, js, jm = _steps(JA, jcfg, to_jax(p0), grads, JA.init_opt_state(to_jax(p0)), to_jax)
    tp = to_torch(p0)
    tp, ts, tm = _steps(TA, tcfg, tp, grads, TA.init_opt_state(tp), to_torch)
    out = {k: max(rel(a[k], b[k]) for a, b in zip(tm, jm)) for k in ("grad_norm", "lr")}
    out["params"] = max(rel_l2(a, b) for a, b in zip(leaves_np(tp), leaves_np(jp)))
    for k in ("mu", "nu"):
        out[k] = max(rel_l2(a, b) for a, b in zip(leaves_np(ts[k]), leaves_np(js[k])))
    out["step"] = int(ts["step"]) - int(js["step"])
    return out


@pytest.mark.parametrize("grad_scale", [1e-3, 1.0], ids=["unclipped", "clipped"])
def test_adamw_update_matches_jax(grad_scale):
    errs = adamw_errors(grad_scale)
    assert errs.pop("step") == 0
    assert max(errs.values()) <= max(VALUE_REL, TREE_REL_L2), errs


def test_adamw_check_catches_dropped_bias_correction(monkeypatch):
    """b1 ** step replaced by 0: no bias correction of the first moment."""
    real_pow = torch.Tensor.__rpow__

    def no_b1(self, base):
        return torch.zeros_like(self) if base == 0.9 else real_pow(self, base)

    monkeypatch.setattr(torch.Tensor, "__rpow__", no_b1)
    errs = adamw_errors(1.0)
    assert errs["params"] > TREE_REL_L2


def test_adamw_keeps_dtypes_and_updates_in_place():
    p = to_torch(np_tree(0))
    p["embed"] = p["embed"].bfloat16()
    st = TA.init_opt_state(p)
    before = tree_leaves(p)
    p2, st2, _ = TA.adamw_update(TA.AdamWConfig(), p, to_torch(np_tree(1)), st)
    assert all(a is b for a, b in zip(before, tree_leaves(p2)))
    assert p2["embed"].dtype == torch.bfloat16 and int(st2["step"]) == 1


# ---------------------------------------------------------------------------
# compression
# ---------------------------------------------------------------------------

def compress_both(rounds=3, ef=True):
    jcfg = JC.CompressionConfig(ef=ef)
    tcfg = TC.CompressionConfig(ef=ef)
    je = te = None
    out = []
    for r in range(rounds):
        g = np_tree(10 + r, scale=1e-2)
        jq, je, jst = JC.compress_gradients(to_jax(g), je, jcfg)
        tq, te, tst = TC.compress_gradients(to_torch(g), te, tcfg)
        out.append((leaves_np(tq), leaves_np(jq), leaves_np(te), leaves_np(je),
                    float(tst["compression_err_norm"]), float(jst["compression_err_norm"])))
    return out


@pytest.mark.parametrize("ef", [True, False])
def test_compress_gradients_equals_jax(ef):
    for tq, jq, te, je, tn, jn in compress_both(ef=ef):
        for a, b in zip(tq + te, jq + je):
            np.testing.assert_array_equal(a, b)
        assert rel(tn, jn) <= VALUE_REL


def test_compression_check_catches_round_half_away_from_zero(monkeypatch):
    """Quantizing with round-half-away-from-zero in place of half-to-even."""
    monkeypatch.setattr(torch, "round", lambda x: torch.sign(x) * torch.floor(x.abs() + 0.5))
    x = np.array([0.5, 1.5, 2.5, -0.5, -2.5, 127.0], np.float32)
    got = TC._quantize(torch.from_numpy(x), 8).numpy()
    want = np.asarray(JC._quantize(jnp.asarray(x), 8))
    assert not np.array_equal(got, want)


def test_compression_check_catches_skipped_quantization(monkeypatch):
    monkeypatch.setattr(TC, "_quantize", lambda x, bits: x.float())
    tq, jq, *_ = compress_both(rounds=1)[0]
    assert any(not np.array_equal(a, b) for a, b in zip(tq, jq))


def test_compression_keeps_gradient_dtypes():
    g = to_torch(np_tree(4))
    g["embed"] = g["embed"].bfloat16()
    q, e, _ = TC.compress_gradients(g, None, TC.CompressionConfig())
    assert q["embed"].dtype == torch.bfloat16 and e["embed"].dtype == torch.float32
