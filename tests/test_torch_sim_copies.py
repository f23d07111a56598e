"""The port's copies of the JAX package's jax-free modules are copies.

Each copy under ``src/repro_torch/`` must be its original's text up to the
import rewrite (``repro.`` read as ``repro_torch.``) and its docstrings: the
test compares their syntax trees.  Beyond the text, the port's scalar event
engine must give the reference engine's and the golden oracle's results
field by field (the two packages' dataclasses differ, so ``asdict`` is
compared), on the Listing-1 pins and on the differential fuzz generators,
and the design points, workloads and compiled plans must be equal across
the packages.
"""
import ast
from dataclasses import asdict
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")

import test_sim_fuzz as fuzz  # noqa: E402
from test_sim_golden import LISTING1_BREAKDOWN, LISTING1_GOLDEN  # noqa: E402

import repro.core.plan_cache as ref_plan_cache  # noqa: E402
import repro.sim.batch as ref_batch  # noqa: E402
import repro.sim.designs as ref_designs  # noqa: E402
import repro.sim.engine as ref_engine  # noqa: E402
import repro.workloads as ref_workloads  # noqa: E402
from repro.sim.golden import golden_simulate  # noqa: E402

import repro_torch.core as port_core  # noqa: E402
import repro_torch.core.plan_cache as port_plan_cache  # noqa: E402
import repro_torch.sim.batch as port_batch  # noqa: E402
import repro_torch.sim.designs as port_designs  # noqa: E402
import repro_torch.sim.engine as port_engine  # noqa: E402
import repro_torch.workloads as port_workloads  # noqa: E402
from repro_torch.core.ir import parse_asm as port_parse_asm  # noqa: E402
from repro_torch.workloads.suite import Workload as PortWorkload  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
COPIES = [
    # earlier slices
    "core/ir", "core/intervals", "core/coloring", "core/plan",
    "serving/allocator", "serving/scheduler",
    # the simulator slice
    "core/liveness", "core/icg", "core/renumber", "core/prefetch",
    "core/plan_cache", "core/pipeline", "obs/attribution", "obs/trace",
    "workloads/synth", "workloads/suite", "sim/engine", "sim/designs",
]


class _Normalize(ast.NodeTransformer):
    """Drop docstrings; read ``repro_torch`` as ``repro`` in imports."""

    def _strip_doc(self, node):
        self.generic_visit(node)
        body = node.body
        if (body and isinstance(body[0], ast.Expr) and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            node.body = body[1:] or [ast.Pass()]
        return node

    visit_Module = visit_FunctionDef = visit_AsyncFunctionDef = visit_ClassDef = _strip_doc

    def visit_ImportFrom(self, node):
        if node.module and (node.module == "repro_torch" or node.module.startswith("repro_torch.")):
            node.module = "repro" + node.module[len("repro_torch"):]
        return node

    def visit_Import(self, node):
        for alias in node.names:
            if alias.name == "repro_torch" or alias.name.startswith("repro_torch."):
                alias.name = "repro" + alias.name[len("repro_torch"):]
        return node


def _tree(path: Path) -> str:
    return ast.dump(_Normalize().visit(ast.parse(path.read_text())))


@pytest.mark.parametrize("module", COPIES)
def test_copy_equals_original_up_to_imports_and_docstrings(module):
    original = ROOT / "src" / "repro" / f"{module}.py"
    copy = ROOT / "src" / "repro_torch" / f"{module}.py"
    assert _tree(copy) == _tree(original), f"{copy} drifted from {original}"


def test_copy_check_catches_a_changed_line(tmp_path):
    """The comparison is sharp: one changed constant is a different tree."""
    text = (ROOT / "src" / "repro_torch" / "sim" / "engine.py").read_text()
    assert "ENGINE_REV = 4\n" in text
    bad = tmp_path / "engine.py"
    bad.write_text(text.replace("ENGINE_REV = 4\n", "ENGINE_REV = 5\n"))
    assert _tree(bad) != _tree(ROOT / "src" / "repro" / "sim" / "engine.py")


def test_core_exports_what_the_reference_exports():
    import repro.core as ref_core
    assert set(ref_core.__all__) <= set(port_core.__all__)


# ------------------------------------------------------------- behaviour

def _port_config(cfg):
    return port_engine.SimConfig(**asdict(cfg))


def _listing1(workload_cls, program):
    return workload_cls(name="listing1", program=program, trips={"L1": 100},
                        register_sensitive=False, regs_per_thread=8, suite="paper")


@pytest.mark.parametrize("design", ref_engine.DESIGNS)
def test_port_engine_listing1_pins(design):
    w_ref = _listing1(ref_workloads.Workload, ref_workloads.listing1_program())
    w_port = _listing1(PortWorkload, port_workloads.listing1_program())
    cfg_ref = ref_designs.design_config(design, table2_config=7, num_warps=16)
    cfg_port = port_designs.design_config(design, table2_config=7, num_warps=16)
    assert asdict(cfg_port) == asdict(cfg_ref)
    got = port_engine.simulate(w_port, cfg_port)
    assert (got.cycles, got.instructions, got.mrf_accesses, got.rfc_hits,
            got.rfc_accesses) == LISTING1_GOLDEN[design]
    assert tuple(got.cycle_breakdown.values()) == LISTING1_BREAKDOWN[design]
    assert asdict(got) == asdict(ref_engine.simulate(w_ref, cfg_ref))
    assert asdict(got) == asdict(golden_simulate(w_ref, cfg_ref))


@pytest.mark.parametrize("seed", range(12))
def test_port_engine_matches_reference_and_golden_on_fuzz(seed, monkeypatch):
    w_ref, cfg_ref = fuzz.random_workload(seed), fuzz.random_config(seed)
    # the same generators, building the port's types
    monkeypatch.setattr(fuzz, "parse_asm", port_parse_asm)
    monkeypatch.setattr(fuzz, "Workload", PortWorkload)
    monkeypatch.setattr(fuzz, "SimConfig", port_engine.SimConfig)
    w_port, cfg_port = fuzz.random_workload(seed), fuzz.random_config(seed)
    assert isinstance(w_port, PortWorkload) and isinstance(cfg_port, port_engine.SimConfig)
    assert asdict(cfg_port) == asdict(cfg_ref)
    assert w_port.program.render() == w_ref.program.render()
    got = asdict(port_engine.simulate(w_port, cfg_port))
    assert got == asdict(ref_engine.simulate(w_ref, cfg_ref)), seed
    assert got == asdict(golden_simulate(w_ref, cfg_ref)), seed


@pytest.mark.parametrize("tc", sorted(ref_designs.TABLE2))
def test_design_points_equal(tc):
    for d in ref_engine.DESIGNS:
        assert asdict(port_designs.design_config(d, table2_config=tc)) == \
            asdict(ref_designs.design_config(d, table2_config=tc))
    assert asdict(port_designs.baseline_config()) == asdict(ref_designs.baseline_config())
    assert port_designs.TOLERANCE_MULTS == ref_designs.TOLERANCE_MULTS
    assert port_designs.TABLE2 == ref_designs.TABLE2


def test_workloads_equal():
    names = ref_workloads.workload_names()
    assert len(names) == 14 and port_workloads.workload_names() == names
    for name in names:
        a, b = port_workloads.get_workload(name), ref_workloads.get_workload(name)
        fields = ("name", "trips", "register_sensitive", "regs_per_thread", "suite", "l1_hit")
        assert [getattr(a, f) for f in fields] == [getattr(b, f) for f in fields], name
        assert a.program.render() == b.program.render(), name


@pytest.mark.parametrize("design", ref_engine.DESIGNS)
def test_compiled_plans_equal(design):
    for name in ("srad", "kmeans", "btree"):
        w_ref = ref_workloads.get_workload(name)
        w_port = port_workloads.get_workload(name)
        cfg = ref_designs.design_config(design, table2_config=7, num_warps=16)
        args = (design, cfg.interval_cap, cfg.num_banks)
        kw = dict(renumber=cfg.renumber, interval_strategy=cfg.interval_strategy,
                  rfc_per_warp=cfg.rfc_entries_per_warp)
        a = port_plan_cache.compile_for_sim(w_port.program, *args, **kw)
        b = ref_plan_cache.compile_for_sim(w_ref.program, *args, **kw)
        assert a.prog.render() == b.prog.render()
        assert a.block_interval == b.block_interval
        assert {k: asdict(v) for k, v in a.pf_ops.items()} == \
            {k: asdict(v) for k, v in b.pf_ops.items()}
        assert (a.live_sets, a.plus_fetch, a.order_index) == \
            (b.live_sets, b.plus_fetch, b.order_index)
        # and the batch engine's flat-PC encoding of the two plans
        ea = port_batch._encode_plan(w_port, _port_config(cfg))
        eb = ref_batch._encode_plan(w_ref, cfg)
        for f, va in vars(ea).items():
            vb = getattr(eb, f)
            if isinstance(va, np.ndarray):
                np.testing.assert_array_equal(va, vb, err_msg=f)
                assert va.dtype == vb.dtype, f
            else:
                assert va == vb, f
