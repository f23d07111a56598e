"""The port's training path against the JAX package's, on the smoke configs.

Weights are the JAX package's, carried across with ``params_from_numpy``;
inputs come from numpy seeds.  The reference's train step is built on a
(1, 1) mesh with Auto axes: under jax 0.9 ``make_host_mesh`` gives Explicit
axes, which ``with_sharding_constraint`` rejects, so every reference train
step on it fails.  Gradients on the port's side go through the kernel
wrappers' autograd Functions (``kernels=True`` on CPU tensors: their plain
versions inside the Functions' forward and backward).

Tolerances, each with a planted fault that must fail it:
- gradients per leaf, fp32: relative L2 <= 1e-4 and elementwise the fp32
  row of ``tests/test_kernels.py:17-19`` (rtol 2e-4, atol 1e-4); the two
  frameworks sum in other orders, so equality is not expected;
- AdamW steps: loss, grad_norm and lr within 1e-5 relative, mu and nu per
  leaf within 1e-4 relative L2, parameters within 2 x the sum of the steps'
  learning rates absolute (at a step the update is +-lr wherever g != 0, so
  a near-zero gradient whose sign differs moves a value by 2 lr);
- microbatches: the tolerances of ``tests/test_system.py:149-177`` (loss
  rtol 2e-2 / atol 2e-3, parameters rtol 5e-2 / atol 5e-2), and, sharper,
  the first moment within 1e-4 relative L2 of the single-batch step's.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AxisType  # noqa: E402

from repro.configs import base as jax_base  # noqa: E402
from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.configs import get_smoke as jax_get_smoke  # noqa: E402
from repro.data import pipeline as jax_pipeline  # noqa: E402
from repro.distributed.sharding import default_rules  # noqa: E402
from repro.models import lm as J  # noqa: E402
from repro.optim.adamw import init_opt_state as jax_init_opt_state  # noqa: E402
from repro.runtime import train_step as JT  # noqa: E402
from repro_torch.configs import (  # noqa: E402
    ARCH_IDS, SHAPES, cell_is_runnable, get_arch, get_smoke, smoke_shape,
)
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.kernels.ltrf_matmul import ops as mm_ops  # noqa: E402
from repro_torch.kernels.ssd_scan import ops as ssd_ops  # noqa: E402
from repro_torch.models import lm as T  # noqa: E402
from repro_torch.models.convert import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.runtime import train_step as TT  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

GRAD_REL_L2 = 1e-4
GRAD_TOL = dict(rtol=2e-4, atol=1e-4)
STEP_REL = 1e-5
MOMENT_REL_L2 = 1e-4
MICRO_LOSS = dict(rtol=2e-2, atol=2e-3)
MICRO_PARAMS = dict(rtol=5e-2, atol=5e-2)


def rules():
    mesh = jax.make_mesh((1, 1), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    return default_rules(mesh)


def configs(arch, dtype="float32", **kw):
    jcfg = dataclasses.replace(jax_get_smoke(arch), dtype=dtype, **kw)
    tcfg = dataclasses.replace(get_smoke(arch), dtype=dtype, **kw)
    return jcfg, tcfg


def params(jcfg, tcfg, seed=0):
    jp, _ = J.init_params(jcfg, jax.random.PRNGKey(seed))
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")


def np_batch(cfg, B=4, S=32, seed=0):
    """A batch as the data pipeline builds it (numpy, int32 tokens)."""
    return jax_pipeline.batch_for_step(cfg, ShapeConfig("t", S, B, "train"), seed)


def flat(tree, prefix=""):
    """(path, float32 array) of a nested dict in sorted-key order; a raw-bits
    bf16 leaf (uint16, "bfloat16") is widened to float32."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in flat(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, tuple):
        bits, _ = tree
        return [(prefix, (bits.astype(np.uint32) << 16).view(np.float32))]
    return [(prefix, np.asarray(jnp.asarray(tree).astype(jnp.float32)))]


def rel_l2(a, b) -> float:
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def grad_errors(port_grads, tcfg, jax_grads) -> dict:
    """path -> (relative L2, elementwise within GRAD_TOL) of each leaf."""
    got, want = flat(params_to_numpy(port_grads, tcfg)), flat(jax_grads)
    assert [p for p, _ in got] == [p for p, _ in want]
    return {p: (rel_l2(g, w), bool(np.allclose(g, w, **GRAD_TOL)))
            for (p, g), (_, w) in zip(got, want)}


def grads_within(errors) -> bool:
    return all(r <= GRAD_REL_L2 and ok for r, ok in errors.values())


def jax_grads(jcfg, jp, batch):
    return jax.grad(lambda p: J.loss_fn(p, batch, jcfg)[0])(jp)


def port_grads(tcfg, tp, batch):
    return TT.grads_of(tcfg, tp, TT.to_device(batch, "cpu"))[2]


# ---------------------------------------------------------------------------
# gradients, every architecture
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCH_IDS)
def test_grads_match_jax(arch):
    jcfg, tcfg = configs(arch)
    jp, tp = params(jcfg, tcfg)
    batch = np_batch(jcfg, B=2, S=32)
    errors = grad_errors(port_grads(tcfg, tp, batch), tcfg, jax_grads(jcfg, jp, batch))
    assert grads_within(errors), {p: e for p, e in errors.items()
                                  if e[0] > GRAD_REL_L2 or not e[1]}


def _dw_zeroed(x, w, dy, needs):
    dx, dw = mm_ops._ltrf_vjp(x, w, dy, needs)
    return dx, None if dw is None else torch.zeros_like(dw)


def _not_causal(q, k, v, o, lse, do, causal):
    return flash_ops._flash_bwd(q, k, v, o, lse, do, False)


def _group_sum_dropped(q, k, v, o, lse, do, causal):
    """dk, dv of the first query head of each group only, not the group's sum."""
    rep = q.shape[1] // k.shape[1]
    dq, dke, dve = flash_ops._flash_bwd(q, *(t.repeat_interleave(rep, dim=1) for t in (k, v)),
                                        o, lse, do, causal)
    return dq, dke[:, ::rep] * rep, dve[:, ::rep] * rep


def _in_decay_dropped(ins, chunk, grads):
    return ssd_ops._ssd_bwd(ins, chunk, (grads[0], grads[1], None, grads[3]))


# planted faults in the kernel Functions' backward: (arch, module, name, fault)
GRAD_FAULTS = {
    "matmul_dw_zeroed": ("tinyllama-1.1b", mm_ops, "matmul_vjp", _dw_zeroed),
    "flash_not_causal": ("tinyllama-1.1b", flash_ops, "flash_bwd", _not_causal),
    "flash_group_sum_dropped": ("tinyllama-1.1b", flash_ops, "flash_bwd", _group_sum_dropped),
    "ssd_in_decay_dropped": ("mamba2-1.3b", ssd_ops, "ssd_chunk_bwd", _in_decay_dropped),
}


@pytest.fixture
def sound_vjps(monkeypatch):
    """The sound backward functions under private names, for the faults."""
    monkeypatch.setattr(mm_ops, "_ltrf_vjp", mm_ops.matmul_vjp, raising=False)
    monkeypatch.setattr(flash_ops, "_flash_bwd", flash_ops.flash_bwd, raising=False)
    monkeypatch.setattr(ssd_ops, "_ssd_bwd", ssd_ops.ssd_chunk_bwd, raising=False)


@pytest.mark.parametrize("fault", GRAD_FAULTS)
def test_grad_check_catches_planted_faults(fault, sound_vjps, monkeypatch):
    arch, module, name, fn = GRAD_FAULTS[fault]
    jcfg, tcfg = configs(arch)
    jp, tp = params(jcfg, tcfg)
    batch = np_batch(jcfg, B=2, S=32)
    want = jax_grads(jcfg, jp, batch)
    monkeypatch.setattr(module, name, fn)
    assert not grads_within(grad_errors(port_grads(tcfg, tp, batch), tcfg, want))


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "mamba2-1.3b", "zamba2-1.2b",
                                  "granite-moe-3b-a800m"])
def test_remat_full_gives_the_same_gradients_bit_for_bit(arch):
    _, tcfg = configs(arch)
    tp = T.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    batch = TT.to_device(np_batch(tcfg, B=2, S=32), "cpu")
    none = TT.grads_of(dataclasses.replace(tcfg, remat="none"), tp, batch)[2]
    full = TT.grads_of(dataclasses.replace(tcfg, remat="full"), tp, batch)[2]
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(none), tree_leaves(full)))


def test_remat_check_catches_a_cut_graph(monkeypatch):
    """A recompute that detaches the block's input stops the gradient."""
    _, tcfg = configs("tinyllama-1.1b")
    tp = T.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    batch = TT.to_device(np_batch(tcfg, B=2, S=32), "cpu")
    none = TT.grads_of(tcfg, tp, batch)[2]
    monkeypatch.setattr(T, "checkpoint", lambda block, cfg, p, x, *a, use_reentrant:
                        block(cfg, p, x.detach(), *a))
    full = TT.grads_of(dataclasses.replace(tcfg, remat="full"), tp, batch)[2]
    assert not all(torch.equal(a, b) for a, b in zip(tree_leaves(none), tree_leaves(full)))


def test_remat_runs_only_with_grad(monkeypatch):
    _, tcfg = configs("tinyllama-1.1b", remat="full")
    tp = T.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    batch = TT.to_device(np_batch(tcfg, B=2, S=16), "cpu")
    calls = []
    real = T.checkpoint
    monkeypatch.setattr(T, "checkpoint", lambda *a, **k: calls.append(1) or real(*a, **k))
    with torch.no_grad():
        T.loss_fn(tp, batch, tcfg)
    T.loss_fn(tp, batch, tcfg)        # grad enabled, but nothing requires it
    assert not calls
    TT.grads_of(tcfg, tp, batch)
    assert len(calls) == tcfg.n_layers


# ---------------------------------------------------------------------------
# AdamW steps against the reference's build_train_step
# ---------------------------------------------------------------------------

def jax_steps(jcfg, jp, batches, n_micro=1):
    step = jax.jit(JT.build_train_step(jcfg, rules(), n_micro=n_micro))
    state = {"params": jp, "opt": jax_init_opt_state(jp)}
    metrics = []
    for b in batches:
        state, m = step(state, b)
        metrics.append({k: float(v) for k, v in m.items()})
    return state, metrics


def port_steps(tcfg, tp, batches, n_micro=1, accum_dtype=torch.float32):
    step = TT.build_train_step(tcfg, n_micro=n_micro, accum_dtype=accum_dtype)
    state = {"params": tree_map(torch.clone, tp), "opt": adamw.init_opt_state(tp)}
    metrics = []
    for b in batches:
        state, m = step(state, b)
        metrics.append({k: float(v) for k, v in m.items()})
    return state, metrics


def step_errors(tcfg, tstate, tmetrics, jstate, jmetrics) -> dict:
    """Each check's reading and whether it is within its tolerance."""
    out = {}
    for key in ("loss", "grad_norm", "lr"):
        r = max(abs(t[key] - j[key]) / abs(j[key]) for t, j in zip(tmetrics, jmetrics))
        out[key] = (r, r <= STEP_REL)
    for key in ("mu", "nu"):
        pairs = zip(flat(params_to_numpy(tstate["opt"][key], tcfg)), flat(jstate["opt"][key]))
        r = max(rel_l2(t, j) for (_, t), (_, j) in pairs)
        out[key] = (r, r <= MOMENT_REL_L2)
    atol = 2 * sum(j["lr"] for j in jmetrics)
    pairs = zip(flat(params_to_numpy(tstate["params"], tcfg)), flat(jstate["params"]))
    r = max(float(np.abs(t - j).max()) for (_, t), (_, j) in pairs)
    out["params"] = (r, r <= atol)
    out["step"] = (int(tstate["opt"]["step"]), int(tstate["opt"]["step"])
                   == int(jstate["opt"]["step"]) == len(jmetrics))
    return out


@pytest.mark.parametrize("n_steps", [1, 3])
@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "mamba2-1.3b"])
def test_adamw_steps_match_jax(arch, n_steps):
    jcfg, tcfg = configs(arch)
    jp, tp = params(jcfg, tcfg)
    batches = [np_batch(jcfg, seed=s) for s in range(n_steps)]
    jstate, jm = jax_steps(jcfg, jp, batches)
    tstate, tm = port_steps(tcfg, tp, batches)
    errors = step_errors(tcfg, tstate, tm, jstate, jm)
    assert all(ok for _, ok in errors.values()), errors


def test_adamw_step_check_catches_a_planted_fault(monkeypatch):
    """The global norm doubled: the clip scale, mu, nu and grad_norm move."""
    jcfg, tcfg = configs("tinyllama-1.1b")
    jp, tp = params(jcfg, tcfg)
    batches = [np_batch(jcfg)]
    jstate, jm = jax_steps(jcfg, jp, batches)
    real = adamw.global_norm
    monkeypatch.setattr(adamw, "global_norm", lambda tree: 2 * real(tree))
    tstate, tm = port_steps(tcfg, tp, batches)
    errors = step_errors(tcfg, tstate, tm, jstate, jm)
    assert not errors["mu"][1] and not errors["grad_norm"][1]


def test_train_step_consumes_its_state_in_place():
    _, tcfg = configs("tinyllama-1.1b")
    state = TT.make_train_state(tcfg, torch.Generator().manual_seed(0), "cpu")
    before = tree_leaves(state)
    new, _ = TT.build_train_step(tcfg)(state, np_batch(tcfg))
    after = tree_leaves(new)
    assert all(a is b for a, b in zip(before[:-1], after[:-1]))   # all but the step
    assert int(new["opt"]["step"]) == 1


# ---------------------------------------------------------------------------
# microbatches
# ---------------------------------------------------------------------------

def _host(tree, tcfg):
    """A port params tree (layers a list) or a JAX one, as flat host leaves."""
    return flat(params_to_numpy(tree, tcfg) if isinstance(tree["layers"], list) else tree)


def _micro_checks(tcfg, state, m, ref_state, ref_m, sharp_state=None) -> dict:
    out = {"loss": bool(np.allclose(m[0]["loss"], ref_m[0]["loss"], **MICRO_LOSS))}
    pairs = zip(_host(state["params"], tcfg), _host(ref_state["params"], tcfg))
    out["params"] = all(np.allclose(g, w, **MICRO_PARAMS) for (_, g), (_, w) in pairs)
    if sharp_state is not None:
        mu = zip(_host(state["opt"]["mu"], tcfg), _host(sharp_state["opt"]["mu"], tcfg))
        out["mu_rel_l2"] = max(rel_l2(g, w) for (_, g), (_, w) in mu) <= MOMENT_REL_L2
    return out


def test_n_micro_2_matches_n_micro_1_and_jax():
    jcfg, tcfg = configs("tinyllama-1.1b")
    jp, tp = params(jcfg, tcfg)
    batches = [np_batch(jcfg)]
    one, m1 = port_steps(tcfg, tp, batches, n_micro=1)
    two, m2 = port_steps(tcfg, tp, batches, n_micro=2)
    jtwo, jm2 = jax_steps(jcfg, jp, batches, n_micro=2)
    checks = {"vs_n_micro_1": _micro_checks(tcfg, two, m2, one, m1, sharp_state=one),
              "vs_jax": _micro_checks(tcfg, two, m2, jtwo, jm2),
              "n_micro_1_vs_jax": _micro_checks(tcfg, one, m1, jtwo, jm2)}
    assert all(all(c.values()) for c in checks.values()), checks


def test_n_micro_check_catches_a_dropped_microbatch(monkeypatch):
    _, tcfg = configs("tinyllama-1.1b")
    tp = T.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    batches = [np_batch(tcfg)]
    one, m1 = port_steps(tcfg, tp, batches, n_micro=1)
    real = TT._microbatches
    monkeypatch.setattr(TT, "_microbatches", lambda b, n: [real(b, n)[0]] * n)
    two, m2 = port_steps(tcfg, tp, batches, n_micro=2)
    assert not all(_micro_checks(tcfg, two, m2, one, m1, sharp_state=one).values())


def test_bf16_accumulation_stays_finite():
    _, tcfg = configs("tinyllama-1.1b", dtype="bfloat16")
    tp = T.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    state, m = port_steps(tcfg, tp, [np_batch(tcfg, seed=s) for s in range(2)], n_micro=2,
                          accum_dtype=torch.bfloat16)
    assert all(np.isfinite(x[k]) for x in m for k in ("loss", "grad_norm"))
    assert all(bool(torch.isfinite(t).all()) for t in tree_leaves(state))


def test_microbatches_must_divide_the_batch():
    _, tcfg = configs("tinyllama-1.1b")
    state = TT.make_train_state(tcfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError, match="microbatches"):
        TT.build_train_step(tcfg, n_micro=3)(state, np_batch(tcfg, B=4))


# ---------------------------------------------------------------------------
# eval, prefill and decode steps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "granite-moe-3b-a800m", "musicgen-large"])
def test_eval_and_prefill_steps_match_jax(arch):
    jcfg, tcfg = configs(arch)
    jp, tp = params(jcfg, tcfg)
    batch = np_batch(jcfg)
    got = TT.build_eval_step(tcfg)(tp, batch)
    want = JT.build_eval_step(jcfg, rules())(jp, batch)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-4, atol=1e-6)
    got = TT.build_prefill_step(tcfg, n_micro=2)(tp, batch)
    want = jax.jit(JT.build_prefill_step(jcfg, rules(), n_micro=2))(jp, batch)
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), rtol=1e-4)
    got = TT.build_prefill_step(tcfg)(tp, batch)
    want = JT.build_prefill_step(jcfg, rules())(jp, batch)
    assert set(got) == set(want)
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), rtol=1e-4)


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "mamba2-1.3b", "musicgen-large"])
def test_decode_step_matches_jax(arch):
    jcfg, tcfg = configs(arch)
    jp, tp = params(jcfg, tcfg)
    rng = np.random.default_rng(3)
    shape = (2, tcfg.n_codebooks, 1) if tcfg.family == "audio" else (2, 1)
    jstep, tstep = JT.build_decode_step(jcfg, rules()), TT.build_decode_step(tcfg)
    jc, tc = J.init_decode_cache(jcfg, 2, 8)[0], T.init_decode_cache(tcfg, 2, 8, "cpu")
    toks = rng.integers(0, tcfg.vocab, shape).astype(np.int32)
    for pos in range(3):
        jt, jc = jstep(jp, jc, jnp.asarray(toks), jnp.int32(pos))
        tt, tc = tstep(tp, tc, torch.from_numpy(toks).long(), pos)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        toks = np.asarray(jt).reshape(shape).astype(np.int32)


# ---------------------------------------------------------------------------
# configs and the data pipeline: the copies against the originals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_counts_match_jax(arch):
    for full in (True, False):
        t = get_arch(arch) if full else get_smoke(arch)
        j = jax_get_arch(arch) if full else jax_get_smoke(arch)
        assert (t.param_count(), t.active_param_count()) == (j.param_count(),
                                                             j.active_param_count())
        assert (t.attention_free, t.sub_quadratic) == (j.attention_free, j.sub_quadratic)


def test_param_count_is_what_init_params_makes():
    """The analytic count, as the reference's, leaves out qk_norm's two
    head_dim vectors a layer; the held head's zero padding is not counted."""
    for arch in ARCH_IDS:
        cfg = get_smoke(arch)
        tp = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        held = sum(t.numel() for t in tree_leaves(tp))
        pad = cfg.d_model * (T.held_width(T.head_width(cfg)) - T.head_width(cfg))
        qk_norm = 2 * cfg.hd * cfg.n_layers if cfg.qk_norm else 0
        assert held - pad - qk_norm == cfg.param_count(), arch


def test_shapes_match_jax():
    assert {k: dataclasses.astuple(v) for k, v in SHAPES.items()} == {
        k: dataclasses.astuple(v) for k, v in jax_base.SHAPES.items()}
    for kind in ("train", "decode"):
        assert dataclasses.astuple(smoke_shape(kind)) == dataclasses.astuple(
            jax_base.smoke_shape(kind))
    for arch in ARCH_IDS:
        for name, shape in SHAPES.items():
            assert cell_is_runnable(get_arch(arch), shape) == jax_base.cell_is_runnable(
                jax_get_arch(arch), jax_base.SHAPES[name])


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_data_copy_matches_jax(arch):
    cfg, jcfg = get_smoke(arch), jax_get_smoke(arch)
    shape = ShapeConfig("t", 48 if cfg.family == "vlm" else 32, 4, "train")
    for step in (0, 1, 7):
        got = pipeline.batch_for_step(cfg, shape, step, seed=11)
        want = jax_pipeline.batch_for_step(jcfg, shape, step, seed=11)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
    got = pipeline.batch_for_step(cfg, shape, 3, seed=11, host_slice=slice(1, 3))
    want = jax_pipeline.batch_for_step(jcfg, shape, 3, seed=11, host_slice=slice(1, 3))
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_data_check_catches_a_shifted_stream():
    cfg = get_smoke("tinyllama-1.1b")
    shape = ShapeConfig("t", 32, 4, "train")
    got = pipeline.batch_for_step(cfg, shape, 2, seed=11)
    want = jax_pipeline.batch_for_step(jax_get_smoke("tinyllama-1.1b"), shape, 1, seed=11)
    assert not np.array_equal(got["tokens"], want["tokens"])


def test_prefetching_loader_replays_the_stream():
    cfg = get_smoke("tinyllama-1.1b")
    shape = ShapeConfig("t", 16, 2, "train")
    loader = pipeline.PrefetchingLoader(cfg, shape, pipeline.DataConfig(seed=5))
    try:
        first = [loader.get()["tokens"] for _ in range(4)]
        loader.restore(1)
        again = [loader.get()["tokens"] for _ in range(3)]
    finally:
        loader.close()
    want = [jax_pipeline.batch_for_step(jax_get_smoke("tinyllama-1.1b"), shape, s, 5)["tokens"]
            for s in range(4)]
    for a, b in zip(first, want):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(again, want[1:]):
        np.testing.assert_array_equal(a, b)
