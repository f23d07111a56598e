"""The port's dry-run (``repro_torch.launch.dryrun``) and its trackers.

- ``hlo_stats``' HLO-text parsers are the reference's text, and pass the
  reference's cases; ``comm_stats`` maps torch's collectives onto the same
  schema, with each rank's output bytes.
- ``CommTracker`` tells a weight's collectives (made from the weights alone)
  from an activation's, and sums each by the line of the port that called
  it; the sums are the totals, and extrapolate as they do.
- On a fake (2, 2) mesh with smoke configs, each cell's per-device argument
  bytes equal the sum over the reference's shardings of ``shard_shape``s (the
  port's SSM decode state is fp32 where the reference's is the model dtype,
  and is counted so); under the default (FSDP) layout the parameters'
  all-gathers and the gradients' reductions show.
- On a one-rank mesh the dry-run's FLOPs equal ``FlopCounterMode`` of the
  unsharded plain step, and no collective runs.
- A step of many microbatches extrapolated from two traces equals its
  direct trace.
- granite-moe with 3 experts on a (2, 2) mesh under ``2d`` (its experts'
  ``ffn`` split over ``model``): the expert products' FLOPs a rank are half
  the unsharded step's, exactly.
- ``python -m repro_torch.launch.dryrun`` on one cell, in a fresh process,
  starts no CUDA; neither does a trace where a card is visible.
"""
import ast
import dataclasses
import inspect
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import torch.distributed as dist  # noqa: E402
from jax.sharding import AbstractMesh, AxisType  # noqa: E402
from torch.distributed.device_mesh import DeviceMesh  # noqa: E402
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard  # noqa: E402
from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

import repro.distributed.sharding as JS  # noqa: E402
import repro.launch.hlo_stats as ref_hlo_stats  # noqa: E402
from repro.configs import get_smoke as jax_get_smoke  # noqa: E402
from repro.configs import input_specs as jax_input_specs  # noqa: E402
from repro.launch.hlo_stats import _eval_shape_with_axes  # noqa: E402
from repro.models import lm as J  # noqa: E402
from repro.optim.adamw import init_opt_state as jax_init_opt_state  # noqa: E402
from repro.optim.adamw import opt_state_axes as jax_opt_state_axes  # noqa: E402
from repro.runtime.train_step import batch_axes_for as jax_batch_axes_for  # noqa: E402

import repro_torch.launch.hlo_stats as hlo_stats  # noqa: E402
from repro_torch.configs import ARCH_IDS, ShapeConfig, get_smoke, input_specs  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.runtime import train_step as TT  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TRAIN = ShapeConfig("smoke_train", 64, 4, "train")
DECODE = ShapeConfig("smoke_decode", 64, 4, "decode")
COPIED = ("_SHAPE_RE", "_BYTES", "_COLL_OPS", "_shape_bytes", "collective_stats")


@pytest.fixture(scope="module")
def fake_world():
    """A fake process group of 4 ranks (rank 0)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    try:
        yield
    finally:
        dist.destroy_process_group()


def mesh(shape):
    return DeviceMesh("cpu", torch.arange(math.prod(shape)).reshape(shape),
                      mesh_dim_names=("data", "model"))


# ---------------------------------------------------------------------------
# the copied parsers
# ---------------------------------------------------------------------------

def _definitions(module) -> dict:
    """name -> syntax tree (docstrings dropped) of each top-level definition."""
    out = {}
    for node in ast.parse(inspect.getsource(module)).body:
        if isinstance(node, ast.FunctionDef):
            if ast.get_docstring(node):
                node.body = node.body[1:]
            out[node.name] = ast.dump(node)
        elif isinstance(node, ast.Assign) and isinstance(node.targets[0], ast.Name):
            out[node.targets[0].id] = ast.dump(node)
    return out


@pytest.mark.parametrize("name", COPIED)
def test_parser_is_the_references_text(name):
    assert _definitions(hlo_stats)[name] == _definitions(ref_hlo_stats)[name]


def test_shape_bytes():
    assert hlo_stats._shape_bytes("f32[4,4]") == 64
    assert hlo_stats._shape_bytes("bf16[2,3]") == 12
    assert hlo_stats._shape_bytes("(f32[2], s8[4])") == 12
    assert hlo_stats._shape_bytes("pred[8]") == 8


def test_collective_stats_parsing():
    hlo = """
      %ag = bf16[16,128]{1,0} all-gather(%x), dimensions={0}
      %ar = (f32[4,4]{1,0}, f32[4,4]{1,0}) all-reduce(%a, %b), to_apply=%sum
      %cp = f32[8]{0} collective-permute(%y), source_target_pairs={{0,1}}
      %notacoll = f32[8]{0} add(%y, %y)
    """
    st = hlo_stats.collective_stats(hlo)
    assert st == ref_hlo_stats.collective_stats(hlo)
    assert st["all-gather"] == {"count": 1, "bytes": 16 * 128 * 2}
    assert st["all-reduce"] == {"count": 1, "bytes": 2 * 16 * 4}
    assert st["collective-permute"]["count"] == 1 and st["total_count"] == 3


@pytest.mark.usefixtures("fake_world")
def test_comm_stats_counts_each_collective_and_its_output_bytes():
    m = mesh((2, 2))
    x = DTensor.from_local(torch.empty(3, 8, device="meta"), m, [Shard(0), Shard(1)],
                           run_check=False)                     # global (6, 16) fp32
    p = DTensor.from_local(torch.empty(6, 16, device="meta"), m, [Partial(), Replicate()],
                           run_check=False)
    comms = hlo_stats.CommTracker()
    with comms:
        x.redistribute(m, [Replicate(), Shard(1)])              # all-gather, out (6, 8)
        p.redistribute(m, [Replicate(), Replicate()])           # all-reduce, out (6, 16)
        p.redistribute(m, [Shard(0), Replicate()])              # reduce-scatter, out (3, 16)
    st = hlo_stats.comm_stats(comms)
    assert st["all-gather"] == {"count": 1, "bytes": 6 * 8 * 4}
    assert st["all-reduce"] == {"count": 1, "bytes": 6 * 16 * 4}
    assert st["reduce-scatter"] == {"count": 1, "bytes": 3 * 16 * 4}
    assert (st["total_count"], st["total_bytes"]) == (3, (48 + 96 + 48) * 4)


@pytest.mark.usefixtures("fake_world")
def test_comm_sources_tell_weights_from_activations():
    m = mesh((2, 2))
    w, x = (DTensor.from_local(torch.empty(3, 8, device="meta"), m, [Shard(0), Shard(0)],
                               run_check=False) for _ in range(2))      # global (12, 8)
    comms = hlo_stats.CommTracker()
    comms.weights([w])
    with comms:
        w.redistribute(m, [Replicate(), Replicate()])       # a weight's, two hops
        (w * 2).redistribute(m, [Replicate(), Replicate()])
        x.redistribute(m, [Replicate(), Replicate()])
    hops = 6 * 8 * 4 + 12 * 8 * 4
    assert hlo_stats.comm_sources(comms) == {
        "all-gather weight outside the port": {"count": 2, "bytes": hops},
        "all-gather activation outside the port": {"count": 4, "bytes": 2 * hops}}


@pytest.mark.usefixtures("fake_world")
def test_collectives_by_source_sum_to_the_totals_and_extrapolate():
    """mamba2 smoke on (2, 2): each kind's sources sum to its totals, the
    FSDP gathers are the weights', the column-split in_proj output is
    gathered where ``_split_proj`` slices it; 5 microbatches extrapolated
    from 2 and 3 give the direct trace's sources."""
    cfg = get_smoke("mamba2-1.3b")
    m = mesh((2, 2))
    rec = dryrun._trace_cell(cfg, TRAIN, m, False, "")
    by_source = rec["collectives_by_source"]
    for kind, v in rec["collectives"].items():
        if isinstance(v, dict):
            rows = [r for k, r in by_source.items() if k.split()[0] == kind]
            assert (sum(r["count"] for r in rows), sum(r["bytes"] for r in rows)) == \
                (v["count"], v["bytes"])
    assert any(k.startswith("all-gather weight models/layers.py") and k.endswith(" matmul")
               for k in by_source)
    assert any(k.startswith("all-gather activation models/mamba2.py")
               and k.endswith(" _split_proj") for k in by_source)
    shape = ShapeConfig("t", 32, 10, "train")
    assert dryrun._extrapolated(cfg, shape, m, 5)["collectives_by_source"] == \
        dryrun._trace(cfg, shape, m, 5)["collectives_by_source"]


# ---------------------------------------------------------------------------
# the dry-run on small meshes
# ---------------------------------------------------------------------------

def jax_argument_bytes(cfg, shape: ShapeConfig, mesh_shape) -> int:
    """The sum of the reference's local shard bytes of the cell's arguments;
    its SSM decode state counted at the port's fp32."""
    rules = JS.default_rules(AbstractMesh(mesh_shape, ("data", "model"),
                                          axis_types=(AxisType.Auto,) * 2))
    kind = "decode" if shape.is_decode else "train"
    p, pa = _eval_shape_with_axes(lambda k: J.init_params(cfg, k), jax.random.PRNGKey(0))
    trees = [(p, pa), (jax_input_specs(cfg, shape), jax_batch_axes_for(cfg, kind))]
    if shape.is_decode:
        c, ca = _eval_shape_with_axes(
            lambda: J.init_decode_cache(cfg, shape.global_batch, shape.seq_len))
        if "ssm" in c:
            c["ssm"] = jax.ShapeDtypeStruct(c["ssm"].shape, np.float32)
        trees.append((c, ca))
    else:
        trees.append((jax.eval_shape(jax_init_opt_state, p), jax_opt_state_axes(pa)))
    total = 0
    for shapes, axes in trees:
        shardings = JS.shardings_for(rules, axes, shapes)
        for sh, s in zip(jax.tree.leaves(shardings), jax.tree.leaves(shapes)):
            total += math.prod(sh.shard_shape(s.shape)) * np.dtype(s.dtype).itemsize
    return total


@pytest.mark.usefixtures("fake_world")
@pytest.mark.parametrize("shape", [TRAIN, DECODE], ids=["train", "decode"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_argument_bytes_equal_the_references_shard_shapes(arch, shape):
    rec = dryrun._trace_cell(get_smoke(arch), shape, mesh((2, 2)), False, arch)
    assert rec["ok"]
    assert rec["memory"]["argument_size_in_bytes"] == jax_argument_bytes(
        jax_get_smoke(arch), shape, (2, 2))
    assert rec["memory"]["peak_bytes"] >= rec["memory"]["argument_size_in_bytes"]


@pytest.mark.usefixtures("fake_world")
@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "mamba2-1.3b", "granite-moe-3b-a800m"])
def test_fsdp_gathers_parameters_and_reduces_gradients(arch):
    coll = dryrun._trace_cell(get_smoke(arch), TRAIN, mesh((2, 2)), False, arch)["collectives"]
    assert coll["all-gather"]["count"] > 0 and coll["all-gather"]["bytes"] > 0
    assert coll["reduce-scatter"]["count"] + coll["all-reduce"]["count"] > 0


def plain_step_flops(cfg, shape, n_micro: int) -> int:
    """FlopCounterMode of the unsharded plain train step on real tensors."""
    state = TT.make_train_state(cfg, torch.Generator().manual_seed(0), "cpu")
    batch = {k: torch.zeros(v.shape, dtype=v.dtype) for k, v in input_specs(cfg, shape).items()}
    step = TT.build_train_step(cfg, n_micro=n_micro, kernels=False)
    with FlopCounterMode(display=False) as counter:
        step(state, batch)
    return counter.get_total_flops()


@pytest.mark.usefixtures("fake_world")
@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "mamba2-1.3b", "granite-moe-3b-a800m",
                                  "musicgen-large"])
def test_one_rank_flops_equal_flop_counter_and_no_collective_runs(arch):
    cfg = get_smoke(arch)
    rec = dryrun._trace_cell(cfg, TRAIN, mesh((1, 1)), False, arch)
    assert rec["n_micro"] == TRAIN.global_batch
    assert rec["cost"]["flops"] == plain_step_flops(cfg, TRAIN, rec["n_micro"]) > 0
    assert rec["collectives"]["total_count"] == 0


@pytest.mark.usefixtures("fake_world")
def test_extrapolated_microbatches_equal_the_direct_trace():
    cfg = get_smoke("tinyllama-1.1b")
    shape = ShapeConfig("t", 32, 10, "train")           # 5 microbatches on (2, 2)
    m = mesh((2, 2))
    got = dryrun._extrapolated(cfg, shape, m, 5)
    want = dryrun._trace(cfg, shape, m, 5)
    assert got["cost"] == want["cost"] and got["collectives"] == want["collectives"]
    # the peak is the last trace's: each further microbatch raises it by
    # under 1 KiB (the accumulated metrics' scalars)
    assert 0 <= want["memory"]["peak_bytes"] - got["memory"]["peak_bytes"] <= 1024 * (5 - 3)


def expert_flops(cfg, m, monkeypatch) -> int:
    """The FLOPs a rank of the expert products (``moe.expert_ffn``'s three
    ``torch.bmm``, forward and backward) in a 2-microbatch train step on
    ``m``, as the tracker counts them: the step's FLOPs less those of the
    same step with the products replaced by FLOP-free work."""
    whole = dryrun._trace(cfg, TRAIN, m, 2)["cost"]["flops"]
    with monkeypatch.context() as patch:
        patch.setattr(moe, "expert_ffn", lambda params, xe: xe * sum(
            params[k].sum() for k in ("w_gate", "w_up", "w_down")))
        rest = dryrun._trace(cfg, TRAIN, m, 2)["cost"]["flops"]
    return whole - rest


@pytest.mark.usefixtures("fake_world")
def test_expert_products_split_over_the_ffn_dimension(monkeypatch):
    """3 experts do not split over model=2, so "2d" gives the experts' ffn
    to model; the MoE site keeps that split, and each rank runs half of
    every expert's products (tokens gathered over data: one dispatch group)."""
    cfg = dataclasses.replace(get_smoke("granite-moe-3b-a800m"), n_experts=3)
    unsharded = expert_flops(cfg, mesh((1, 1)), monkeypatch)
    assert unsharded > 0
    assert 2 * expert_flops(cfg, mesh((2, 2)), monkeypatch) == unsharded


def test_cli_cell_in_a_fresh_process_starts_no_cuda(tmp_path):
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": "",
           "PYTHONPATH": os.pathsep.join([str(ROOT / "src"), os.environ.get("PYTHONPATH", "")])}
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                        "qwen3-0.6b", "--shape", "decode_32k", "--out-dir", str(tmp_path)],
                       capture_output=True, text=True, timeout=300, env=env)
    assert r.returncode == 0, r.stdout + r.stderr[-4000:]
    rec = json.loads((tmp_path / "qwen3-0.6b_decode_32k_pod16x16.json").read_text())
    assert rec["ok"] and rec["devices"] == 256 and rec["cuda_initialized"] is False
    assert rec["roofline"]["peak_flops"] == 989e12


@pytest.mark.usefixtures("fake_world")
def test_a_trace_starts_no_cuda_where_a_card_is_visible(monkeypatch):
    def no_cuda(*args, **kwargs):
        raise AssertionError("the dry-run started CUDA")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "_lazy_init", no_cuda)
    for shape in (TRAIN, DECODE):
        assert dryrun._trace_cell(get_smoke("zamba2-1.2b"), shape, mesh((2, 2)), False, "")["ok"]


@pytest.mark.usefixtures("fake_world")
def test_padded_head_bytes_are_reported_apart():
    """granite-moe with a 250-word vocabulary: its head is held 256 wide;
    the argument bytes stay the reference's, the padding is reported apart
    (the head split over data=2 and, 250 being even, over model=2: params
    bf16, mu and nu fp32)."""
    cfg = dataclasses.replace(get_smoke("granite-moe-3b-a800m"), vocab=250)
    jcfg = dataclasses.replace(jax_get_smoke("granite-moe-3b-a800m"), vocab=250)
    rec = dryrun._trace_cell(cfg, TRAIN, mesh((2, 2)), False, "")
    assert rec["memory"]["argument_size_in_bytes"] == jax_argument_bytes(jcfg, TRAIN, (2, 2))
    assert rec["memory"]["head_padding_bytes"] == cfg.d_model // 2 * (256 - 250) // 2 * (2 + 4 + 4)


@pytest.mark.usefixtures("fake_world")
def test_split_proj_gathers_the_in_proj_output_once():
    """One mamba2 block's forward on (2, 2): the column-split in_proj output
    is gathered once where ``_split_proj`` slices it (DTensor gathers the
    whole tensor for each slice of a split one: three gathers)."""
    cfg = dataclasses.replace(get_smoke("mamba2-1.3b"), n_layers=1)
    rec = dryrun._trace(cfg, ShapeConfig("p", 64, 4, "prefill"), mesh((2, 2)), 1)
    gathers = {k: v for k, v in rec["collectives_by_source"].items()
               if k.startswith("all-gather") and k.endswith(" _split_proj")}
    assert sum(v["count"] for v in gathers.values()) == 1, gathers
