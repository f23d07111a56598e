"""The port's mesh layer against the JAX package's, on the CPU.

- Layouts: for every architecture (full and smoke configs), every tree a step
  takes (params, optimizer state, train/prefill batch, decode batch, decode
  cache), the four layouts of ``default_rules`` and the meshes (1, 1), (1, 4),
  (16, 16) and (2, 16, 16), the port's spec of each leaf equals the
  reference's ``NamedSharding.spec`` and its local shard shape (by DTensor's
  own arithmetic on the placements) equals ``shard_shape``.  The reference
  runs on an ``AbstractMesh`` with Auto axes; the port on ``DeviceMesh``es over
  a fake process group of 512 ranks, set up and torn down by a fixture.  The
  port holds layers as a list where the reference stacks them: each layer's
  leaf is held to the stacked leaf without its leading (unsharded) axis.
- The copies: ``default_rules``' tables, ``tests/test_sharding.py``'s cases,
  ``input_specs`` and the 40 cells.
- One device, exactly: all ten smoke architectures, one train step under
  rules on a one-rank gloo mesh gives the bits of the step without rules, and
  is held to the JAX reference step within ``test_torch_train_step``'s
  tolerances.
- Across ranks: four spawned gloo ranks on a 2x2 mesh (layouts ``2d`` and
  ``fsdp_pure``; tinyllama, mamba2 and granite-moe smoke, fp32; and
  granite-moe with 3 experts under ``2d``, whose experts do not split over
  ``model=2`` so its ``ffn`` takes it): loss and every gradient within rtol
  2e-4 / atol 1e-4 of the unsharded step.
- Elastic resharding: onto ``degraded_mesh(ranks[:1], model=1)``, and of a
  checkpoint the JAX package wrote.
"""
import dataclasses
import functools
import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import torch.distributed as dist  # noqa: E402
from jax.sharding import AbstractMesh, AxisType, NamedSharding  # noqa: E402
from torch.distributed.device_mesh import DeviceMesh  # noqa: E402
from torch.distributed.tensor import DTensor  # noqa: E402
from torch.distributed.tensor._utils import compute_local_shape_and_global_offset  # noqa: E402

import repro.distributed.sharding as JS  # noqa: E402
import test_torch_train_step as TS  # noqa: E402
from repro.checkpoint import Checkpointer as JaxCheckpointer  # noqa: E402
from repro.configs import input_specs as jax_input_specs  # noqa: E402
from repro.configs import get_arch as jax_get_arch, get_smoke as jax_get_smoke  # noqa: E402
from repro.launch.hlo_stats import _eval_shape_with_axes  # noqa: E402
from repro.models import lm as J  # noqa: E402
from repro.optim.adamw import init_opt_state as jax_init_opt_state  # noqa: E402
from repro.optim.adamw import opt_state_axes as jax_opt_state_axes  # noqa: E402
from repro.runtime.train_step import batch_axes_for as jax_batch_axes_for  # noqa: E402

from repro_torch.checkpoint import Checkpointer  # noqa: E402
from repro_torch.configs import (  # noqa: E402
    ARCH_IDS, SHAPES, all_cells, get_arch, get_smoke, input_specs, smoke_shape,
)
from repro_torch.distributed import sharding as S  # noqa: E402
from repro_torch.distributed.elastic import degraded_mesh, reshard_state  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.models import lm as T  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.optim.adamw import init_opt_state, opt_state_axes  # noqa: E402
from repro_torch.runtime import train_step as TT  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
LAYOUTS = ("2d", "fsdp_pure", "ep_only", "ep_dp")
MESHES = {"1x1": (1, 1), "1x4": (1, 4), "16x16": (16, 16), "2x16x16": (2, 16, 16)}


def _names(shape):
    return ("data", "model") if len(shape) == 2 else ("pod", "data", "model")


def _norm(spec) -> tuple:
    """A spec as a tuple, one-name tuples read as the name."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in spec)


@pytest.fixture(scope="class")
def fake_world():
    """A fake process group of 512 ranks (rank 0): the port's meshes."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=512)
    try:
        yield
    finally:
        dist.destroy_process_group()


@pytest.fixture
def one_rank():
    """A one-rank gloo group, as ``make_host_mesh(device="cpu")`` starts it."""
    mesh = make_host_mesh(device="cpu")
    try:
        yield mesh
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# layouts: the port's specs and shard shapes equal the reference's
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def jax_trees(arch: str, smoke: bool):
    """The reference's (shapes, axes) of each tree a step takes."""
    cfg = jax_get_smoke(arch) if smoke else jax_get_arch(arch)
    train = smoke_shape("train") if smoke else SHAPES["train_4k"]
    decode = smoke_shape("decode") if smoke else SHAPES["decode_32k"]
    p, pa = _eval_shape_with_axes(lambda k: J.init_params(cfg, k), jax.random.PRNGKey(0))
    c, ca = _eval_shape_with_axes(
        lambda: J.init_decode_cache(cfg, decode.global_batch, decode.seq_len))
    return {
        "params": (p, pa),
        "opt": (jax.eval_shape(jax_init_opt_state, p), jax_opt_state_axes(pa)),
        "train_batch": (jax_input_specs(cfg, train), jax_batch_axes_for(cfg, "train")),
        "decode_batch": (jax_input_specs(cfg, decode), jax_batch_axes_for(cfg, "decode")),
        "cache": (c, ca),
    }


@functools.lru_cache(maxsize=None)
def port_trees(arch: str, smoke: bool):
    cfg = get_smoke(arch) if smoke else get_arch(arch)
    train = smoke_shape("train") if smoke else SHAPES["train_4k"]
    decode = smoke_shape("decode") if smoke else SHAPES["decode_32k"]
    p, pa = T.param_shapes(cfg), T.param_axes(cfg)
    return {
        "params": (p, pa),
        "opt": (init_opt_state(p), opt_state_axes(pa)),
        "train_batch": (input_specs(cfg, train), TT.batch_axes_for(cfg, "train")),
        "decode_batch": (input_specs(cfg, decode), TT.batch_axes_for(cfg, "decode")),
        "cache": (T.init_decode_cache(cfg, decode.global_batch, decode.seq_len, "meta"),
                  T.decode_cache_axes(cfg)),
    }


def _pairs(port, ref, path=""):
    """(path, port leaf, reference leaf, stacked) over matching trees; a
    port list of layers meets the reference's stacked leaves."""
    if isinstance(port, list):
        for i, v in enumerate(port):
            for p, a, b, _ in _pairs(v, ref, f"{path}[{i}]"):
                yield p, a, b, True
    elif isinstance(port, dict):
        assert set(port) == set(ref), (path, sorted(port), sorted(ref))
        for k in port:
            yield from _pairs(port[k], ref[k], f"{path}/{k}")
    else:
        yield path, port, ref, False


def layout_mismatches(arch, smoke, layout, mesh_shape) -> list:
    names = _names(mesh_shape)
    jrules = JS.default_rules(AbstractMesh(mesh_shape, names,
                                           axis_types=(AxisType.Auto,) * len(names)),
                              layout=layout)
    mesh = DeviceMesh("cpu", torch.arange(int(np.prod(mesh_shape))).reshape(mesh_shape),
                      mesh_dim_names=names)
    rules = S.default_rules(mesh, layout=layout)
    bad = []
    for tree, (shapes, axes) in port_trees(arch, smoke).items():
        jshapes, jaxes = jax_trees(arch, smoke)[tree]
        got = S.shardings_for(rules, axes, shapes)
        want = JS.shardings_for(jrules, jaxes, jshapes)
        for path, (sh, shp), (ns, jshp), stacked in _pairs(
                tree_map(lambda a, b: (a, b), got, shapes),
                jax.tree.map(lambda a, b: (a, b), want, jshapes,
                             is_leaf=lambda x: isinstance(x, NamedSharding)), tree):
            jspec, jlocal = _norm(ns.spec), tuple(ns.shard_shape(jshp.shape))
            if stacked:        # the reference's leading "layers" axis, never sharded
                assert jspec[0] is None and jlocal[0] == jshp.shape[0]
                jspec, jlocal = jspec[1:], jlocal[1:]
            local = tuple(compute_local_shape_and_global_offset(
                tuple(shp.shape), mesh, list(sh.placements))[0])
            if (_norm(sh.spec), local, tuple(sh.shard_shape(shp.shape))) != (jspec, jlocal, jlocal):
                bad.append((path, _norm(sh.spec), local, jspec, jlocal))
    return bad


@pytest.mark.usefixtures("fake_world")
class TestLayouts:
    @pytest.mark.parametrize("mesh", MESHES)
    @pytest.mark.parametrize("layout", LAYOUTS)
    @pytest.mark.parametrize("arch", ARCH_IDS)
    def test_specs_and_shard_shapes_match_jax(self, arch, layout, mesh):
        for smoke in (False, True):
            bad = layout_mismatches(arch, smoke, layout, MESHES[mesh])
            assert not bad, (smoke, bad[:5])

    def test_padded_head_is_sharded_as_its_true_width(self):
        """granite-moe's head is held at 49216 columns (16 | 49216) but its
        vocabulary is 49155: replicated over model=16, as the reference."""
        cfg = get_arch("granite-moe-3b-a800m")
        mesh = DeviceMesh("cpu", torch.arange(256).reshape(16, 16),
                          mesh_dim_names=("data", "model"))
        rules = S.default_rules(mesh)
        held = T.init_params(cfg, torch.Generator(), "meta")["lm_head"]
        assert held.shape[1] == 49216 and T.param_shapes(cfg)["lm_head"].shape[1] == 49155
        true = S.shardings_for(rules, ("embed", "vocab"), T.param_shapes(cfg)["lm_head"])
        assert true.spec == ("data", None)
        assert S.shardings_for(rules, ("embed", "vocab"), held).spec == ("data", "model")

    def test_a_planted_layout_fault_is_caught(self, monkeypatch):
        """Dropping the act_kv -> act_hd fallback breaks the cache's parity."""
        assert not layout_mismatches("tinyllama-1.1b", False, "2d", (16, 16))
        monkeypatch.setattr(S, "_FALLBACK_TARGETS", {})
        bad = layout_mismatches("tinyllama-1.1b", False, "2d", (16, 16))
        assert {p for p, *_ in bad} == {"cache/k", "cache/v"}


# ---------------------------------------------------------------------------
# the copies: default_rules, shardings_for's cases, input_specs, the cells
# ---------------------------------------------------------------------------

class _NamedMesh:
    """A mesh that only names its dimensions: what ``default_rules`` reads."""

    def __init__(self, names):
        self.axis_names = self.mesh_dim_names = names


@pytest.mark.parametrize("names", [("data", "model"), ("pod", "data", "model")])
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("fsdp", [True, False])
@pytest.mark.parametrize("sequence_parallel", [False, True])
def test_default_rules_tables_equal_jax(names, layout, fsdp, sequence_parallel):
    mesh = _NamedMesh(names)
    kw = dict(sequence_parallel=sequence_parallel, fsdp=fsdp, layout=layout)
    assert S.default_rules(mesh, **kw).table == JS.default_rules(mesh, **kw).table


@pytest.mark.usefixtures("fake_world")
class TestShardingCases:
    """``tests/test_sharding.py``'s cases on the port."""

    def rules(self, shape=(1, 1)):
        mesh = DeviceMesh("cpu", torch.arange(int(np.prod(shape))).reshape(shape),
                          mesh_dim_names=("data", "model"))
        return S.default_rules(mesh)

    def test_shape_safe_drops_nondivisible(self):
        assert S.shardings_for(self.rules(), {"w": ("embed", "ffn")},
                               {"w": torch.empty(8, 8, device="meta")})["w"].spec == \
            ("data", "model")
        sh = S.shardings_for(self.rules((1, 16)), {"w": ("embed", "vocab")},
                             {"w": torch.empty(8, 50280, device="meta")})
        assert sh["w"].spec == ("data", None)

    def test_shape_safe_dedups_mesh_axes(self):
        spec = S.shardings_for(self.rules(), {"w": ("experts", "embed", "ffn")},
                               {"w": torch.empty(4, 8, 8, device="meta")})["w"].spec
        assert [s for s in spec if s == "model"] == ["model"] and spec[0] == "model"

    def test_kv_fallback_to_head_dim(self):
        spec = S.shardings_for(self.rules((1, 4)),
                               {"k": ("layers", "act_batch", None, "act_kv", "act_hd")},
                               {"k": torch.empty(2, 8, 16, 2, 8, device="meta")})["k"].spec
        assert spec[3] is None and spec[4] == "model"

    def test_constrain_redistributes_a_dtensor_under_rules(self):
        rules = self.rules((2, 2))
        from torch.distributed.tensor import Replicate, Shard
        x = DTensor.from_local(torch.empty(2, 4, device="meta"), rules.mesh,
                               [Replicate(), Replicate()], run_check=False)
        with S.use_rules(rules):
            y = S.constrain(x, ("act_batch", "act_vocab"))
            z = S.constrain(x[:, :3], ("act_batch", "act_vocab"))    # 3 % 2: not split
        assert tuple(y.placements) == (Shard(0), Shard(1)) and y.shape == x.shape
        assert tuple(z.placements) == (Shard(0), Replicate())

    @pytest.mark.parametrize("kind", ["train", "decode"])
    @pytest.mark.parametrize("arch", ["tinyllama-1.1b", "musicgen-large", "llava-next-34b"])
    def test_batch_shardings_equal_jax(self, arch, kind):
        from repro.runtime.train_step import batch_shardings as jax_batch_shardings
        jrules = JS.default_rules(AbstractMesh((2, 2), ("data", "model"),
                                               axis_types=(AxisType.Auto,) * 2))
        got = TT.batch_shardings(self.rules((2, 2)), TT.batch_axes_for(get_arch(arch), kind))
        want = jax_batch_shardings(jrules, jax_batch_axes_for(jax_get_arch(arch), kind))
        assert {k: _norm(v.spec) for k, v in got.items()} == \
            {k: _norm(v.spec) for k, v in want.items()}

    def test_three_experts_give_the_ffn_dimension_to_model(self):
        """The 2x2 ffn-split case's layout: 3 experts do not split over
        model=2, so the experts' ffn takes it."""
        cfg = dataclasses.replace(get_smoke(FFN_BASE), n_experts=FFN_EXPERTS)
        sh = S.shardings_for(self.rules((2, 2)), T.param_axes(cfg), T.param_shapes(cfg))
        moe = sh["layers"][0]["moe"]
        assert _norm(moe["w_gate"].spec) == _norm(moe["w_up"].spec) == (None, "data", "model")
        assert _norm(moe["w_down"].spec) == (None, "model", "data")

    def test_a_mesh_dimension_of_one_splits_nothing(self):
        from torch.distributed.tensor import Replicate, Shard
        sh = S.shardings_for(self.rules((1, 4)), ("act_batch", "act_vocab"),
                             torch.empty(4, 8, device="meta"))
        assert sh.spec == ("data", "model")
        assert sh.placements == (Replicate(), Shard(1)) and sh.shard_shape((4, 8)) == (4, 2)


def test_constrain_noop_without_rules():
    x = torch.ones(4, 4)
    assert S.constrain(x, ("act_batch", None)) is x


def test_constrain_leaves_a_plain_tensor_under_rules(one_rank):
    x = torch.ones(4, 4)
    with S.use_rules(S.default_rules(one_rank)):
        assert S.constrain(x, ("act_batch", "act_embed")) is x


def test_layouts_exist(one_rank):
    for layout in LAYOUTS:
        r = S.default_rules(one_rank, layout=layout)
        assert r.axis("batch") is not None or layout == "2d"


def test_40_cells_defined():
    from repro.configs import all_cells as jax_all_cells
    cells = all_cells()
    assert cells == jax_all_cells()
    assert len(cells) == 40
    skips = [c for c in cells if not c[2]]
    assert len(skips) == 8 and all(s[1] == "long_500k" for s in skips)


@pytest.mark.parametrize("arch_id", ARCH_IDS)
@pytest.mark.parametrize("shape", list(SHAPES))
def test_input_specs_equal_jax(arch_id, shape):
    got = input_specs(get_arch(arch_id), SHAPES[shape])
    want = jax_input_specs(jax_get_arch(arch_id), SHAPES[shape])
    assert set(got) == set(want)
    for k in got:
        assert got[k].device.type == "meta"
        assert tuple(got[k].shape) == tuple(want[k].shape)
        assert str(got[k].dtype).removeprefix("torch.") == str(want[k].dtype)


# ---------------------------------------------------------------------------
# one device, exactly
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCH_IDS)
def test_one_rank_step_is_the_unsharded_step_bit_for_bit(arch, one_rank):
    jcfg, tcfg = TS.configs(arch)
    jp, tp = TS.params(jcfg, tcfg)
    batch = TS.np_batch(jcfg, B=4, S=32)
    plain, plain_m = TS.port_steps(tcfg, tp, [batch])
    rules = S.default_rules(one_rank)
    state = {"params": tree_map(torch.clone, tp), "opt": init_opt_state(tp)}
    state = S.place(state, S.shardings_for(rules, TT.train_state_axes(tcfg),
                                           TT.train_state_shapes(tcfg)))
    assert all(isinstance(t, DTensor) for t in tree_leaves(state))
    state, m = TT.build_train_step(tcfg, rules=rules)(state, batch)
    sharded = tree_map(DTensor.full_tensor, state)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(plain), tree_leaves(sharded)))
    assert {k: float(v) for k, v in m.items()} == plain_m[0]
    jstate, jm = TS.jax_steps(jcfg, jp, [batch])
    errors = TS.step_errors(tcfg, sharded, [{k: float(v) for k, v in m.items()}], jstate, jm)
    assert all(ok for _, ok in errors.values()), errors


def test_one_rank_bit_check_catches_a_planted_fault(one_rank, monkeypatch):
    """One gradient zeroed inside the placed step: the bits differ."""
    _, tcfg = TS.configs("tinyllama-1.1b")
    tp = T.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    batch = TS.np_batch(tcfg, B=4, S=32)
    plain, _ = TS.port_steps(tcfg, tp, [batch])
    rules = S.default_rules(one_rank)
    state = S.place({"params": tree_map(torch.clone, tp), "opt": init_opt_state(tp)},
                    S.shardings_for(rules, TT.train_state_axes(tcfg), TT.train_state_shapes(tcfg)))
    real = TT.adamw_update

    def update(cfg, params, grads, opt):
        grads["final_norm"] = torch.zeros_like(grads["final_norm"])
        return real(cfg, params, grads, opt)

    monkeypatch.setattr(TT, "adamw_update", update)
    state, _ = TT.build_train_step(tcfg, rules=rules)(state, batch)
    sharded = tree_map(DTensor.full_tensor, state)
    assert not all(torch.equal(a, b) for a, b in zip(tree_leaves(plain), tree_leaves(sharded)))


# ---------------------------------------------------------------------------
# across ranks: a 2x2 gloo mesh in four spawned processes
# ---------------------------------------------------------------------------

SHARDED_ARCHS = ("tinyllama-1.1b", "mamba2-1.3b", "granite-moe-3b-a800m")
SHARDED_LAYOUTS = ("2d", "fsdp_pure")
# granite-moe smoke with 3 experts ("<arch>/e<n>": n_experts=n): 3 does not
# split over model=2, so under "2d" the experts' ffn dimension takes model
FFN_BASE, FFN_EXPERTS = "granite-moe-3b-a800m", 3
FFN_ARCH = f"{FFN_BASE}/e{FFN_EXPERTS}"


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_ranks(script: str, *args: str, world: int = 4, timeout: float = 600) -> str:
    """``script`` in ``world`` processes (argv: rank, world, a free port,
    then ``args``): rank 0's standard output; any rank failing fails."""
    port = str(free_port())
    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "PYTHONPATH": os.pathsep.join([str(ROOT / "src"), os.environ.get("PYTHONPATH", "")])}
    procs = [subprocess.Popen([sys.executable, "-c", script, str(r), str(world), port, *args],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
             for r in range(world)]
    try:
        outs = [p.communicate(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, out + err[-4000:]
    return outs[0][0]


SCRIPT = textwrap.dedent("""
    import dataclasses, sys
    import torch, torch.distributed as dist
    from torch.distributed.tensor import Shard
    from repro_torch.configs import get_smoke, smoke_shape
    from repro_torch.data import batch_for_step
    from repro_torch.distributed import sharding as S, sites
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.runtime import train_step as TT
    from repro_torch.tree import tree_leaves

    rank, world, port = (int(a) for a in sys.argv[1:4])
    cases = [c.split(":") for c in sys.argv[4].split(",")]      # arch, layout, fault
    torch.set_num_threads(1)
    real = sites._run

    def grads_dropped(fn, mesh, args, ins, outs, grads=None):
        # every gradient placement taken as its input's
        return real(fn, mesh, args, ins, outs)

    def ffn_partial_dropped(fn, mesh, args, ins, outs, grads=None):
        # the MoE site's x and router gradients taken as whole over the
        # mesh dimensions that split the experts' ffn
        if fn.__qualname__.startswith("moe."):
            ffn = {i for i, p in enumerate(ins[2]) if p == Shard(2)}
            g_x, g_r = (tuple(ins[k][i] if i in ffn else p for i, p in enumerate(grads[k]))
                        for k in (0, 1))
            grads = (g_x, g_r, *grads[2:])
        return real(fn, mesh, args, ins, outs, grads)

    faults = {"": real, "grads": grads_dropped, "ffn": ffn_partial_dropped}
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=world)
    mesh = make_host_mesh(model=2, device="cpu")
    unsharded = {}
    for key, layout, fault in cases:
        arch, _, experts = key.partition("/e")
        cfg = dataclasses.replace(get_smoke(arch), dtype="float32")
        if experts:
            cfg = dataclasses.replace(cfg, n_experts=int(experts))
        batch = TT.to_device(batch_for_step(cfg, smoke_shape(), 0, 1), "cpu")
        params = TT.make_train_state(cfg, torch.Generator().manual_seed(0), "cpu")["params"]
        if key not in unsharded:
            unsharded[key] = TT.grads_of(cfg, params, batch, kernels=False)
        loss0, _, g0 = unsharded[key]
        rules = S.default_rules(mesh, layout=layout)
        placed = S.place(params, S.shardings_for(
            rules, TT.train_state_axes(cfg)["params"], TT.train_state_shapes(cfg)["params"]))
        sites._run = faults[fault]
        try:
            with TT._under(rules):
                loss1, _, g1 = TT.grads_of(cfg, placed, TT._placed(batch, cfg, rules, "train"),
                                           kernels=False)
                loss1 = loss1.full_tensor()
                g1 = [g.full_tensor() for g in tree_leaves(g1)]
        finally:
            sites._run = real
        ok = torch.allclose(loss1, loss0, rtol=2e-4, atol=1e-4) and all(
            torch.allclose(a, b, rtol=2e-4, atol=1e-4) for a, b in zip(g1, tree_leaves(g0)))
        print(f"CASE {key} {layout} {fault or '-'} {'OK' if ok else 'DIFFERS'}", flush=True)
    dist.destroy_process_group()
""")


def run_cases(cases) -> dict:
    """(arch, layout, fault) -> "OK" or "DIFFERS" for each case, all in one
    set of four ranks; fault "" plants nothing."""
    out = run_ranks(SCRIPT, ",".join(":".join(c) for c in cases))
    got = {}
    for line in out.splitlines():
        if line.startswith("CASE "):
            arch, layout, fault, verdict = line.split()[1:]
            got[(arch, layout, "" if fault == "-" else fault)] = verdict
    assert set(got) == set(cases), out
    return got


def run_2x2(archs, layouts, planted=False) -> dict:
    fault = "grads" if planted else ""
    cases = run_cases([(a, layout, fault) for a in archs for layout in layouts])
    return {(a, layout): v for (a, layout, _), v in cases.items()}


@pytest.fixture(scope="module")
def sharded_cases():
    return run_cases([(a, layout, "") for a in SHARDED_ARCHS for layout in SHARDED_LAYOUTS]
                     + [(FFN_ARCH, "2d", ""), (FFN_ARCH, "2d", "ffn")])


@pytest.mark.parametrize("layout", SHARDED_LAYOUTS)
@pytest.mark.parametrize("arch", SHARDED_ARCHS)
def test_2x2_gloo_step_matches_the_unsharded_step(arch, layout, sharded_cases):
    assert sharded_cases[(arch, layout, "")] == "OK"


def test_2x2_check_catches_partial_gradients_taken_as_whole():
    """The sites' gradient placements dropped (a weight gathered over the
    batch's ranks given a replicated gradient): the 2x2 check must fail."""
    assert run_2x2(("tinyllama-1.1b",), ("2d",), planted=True) == {
        ("tinyllama-1.1b", "2d"): "DIFFERS"}


def test_2x2_gloo_step_with_the_experts_ffn_split_matches_the_unsharded_step(sharded_cases):
    """3 experts under "2d": the MoE site keeps w_gate and w_up on their ffn
    columns and w_down on its ffn rows over model=2 (expert-tensor
    parallelism); loss and every gradient as the unsharded step's."""
    assert sharded_cases[(FFN_ARCH, "2d", "")] == "OK"


def test_2x2_check_catches_the_ffn_split_partial_gradients_taken_as_whole(sharded_cases):
    """The MoE site's x and router gradients declared whole over the ffn
    split (each rank's share only its d_ff slice's): the check must fail."""
    assert sharded_cases[(FFN_ARCH, "2d", "ffn")] == "DIFFERS"


def test_the_ffn_split_case_is_the_references_step():
    """The 3-expert step, unsharded, against the reference's
    ``build_train_step`` on the Auto-axes mesh, within
    ``test_torch_train_step``'s tolerances."""
    jcfg, tcfg = TS.configs(FFN_BASE, n_experts=FFN_EXPERTS)
    jp, tp = TS.params(jcfg, tcfg)
    batch = TS.np_batch(jcfg)
    jstate, jm = TS.jax_steps(jcfg, jp, [batch])
    tstate, tm = TS.port_steps(tcfg, tp, [batch])
    errors = TS.step_errors(tcfg, tstate, tm, jstate, jm)
    assert all(ok for _, ok in errors.values()), errors


# ---------------------------------------------------------------------------
# elastic resharding
# ---------------------------------------------------------------------------

def test_elastic_reshard_to_smaller_mesh(one_rank):
    cfg = get_smoke("tinyllama-1.1b")
    params = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    mesh = degraded_mesh(list(range(dist.get_world_size()))[:1], model=1)
    assert mesh.mesh_dim_names == ("data", "model") and tuple(mesh.mesh.shape) == (1, 1)
    out, rules = reshard_state(params, T.param_axes(cfg), mesh)
    assert rules.mesh is mesh
    for x, y in zip(tree_leaves(params), tree_leaves(out)):
        assert isinstance(y, DTensor) and torch.equal(x, y.full_tensor())


def test_degraded_mesh_picks_the_widest_model_axis(fake_world_16):
    assert tuple(degraded_mesh().mesh.shape) == (1, 16)
    assert tuple(degraded_mesh(range(12)).mesh.shape) == (3, 4)
    assert tuple(degraded_mesh(range(6), model=2).mesh.shape) == (3, 2)


@pytest.fixture
def fake_world_16():
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=16)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_reshard_a_checkpoint_the_jax_package_wrote(tmp_path, one_rank):
    jcfg, tcfg = TS.configs("granite-moe-3b-a800m", vocab=250)     # a padded head
    jp, _ = J.init_params(jcfg, jax.random.PRNGKey(3))
    rng = np.random.default_rng(0)
    jstate = {"params": jp, "opt": {
        k: jax.tree.map(lambda p: rng.standard_normal(p.shape).astype(np.float32), jp)
        for k in ("mu", "nu")}}
    jstate["opt"]["step"] = np.int32(7)
    JaxCheckpointer(tmp_path).save(7, jstate)
    like = TT.make_train_state(tcfg, torch.Generator().manual_seed(5), "cpu")
    host = Checkpointer(tmp_path, tcfg).restore(7, like)
    out, _ = reshard_state(host, TT.train_state_axes(tcfg), one_rank,
                           shapes_tree=TT.train_state_shapes(tcfg))
    h = jax.tree.map(np.asarray, jstate)
    want = {"params": params_from_numpy(h["params"], tcfg, "cpu"),
            "opt": {"mu": params_from_numpy(h["opt"]["mu"], tcfg, "cpu"),
                    "nu": params_from_numpy(h["opt"]["nu"], tcfg, "cpu"),
                    "step": torch.tensor(7, dtype=torch.int32)}}
    tree_map(lambda a, b: None if torch.equal(a.full_tensor(), b) else pytest.fail(str(a.shape)),
             out, want)
