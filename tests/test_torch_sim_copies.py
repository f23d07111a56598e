"""The port's copies of the JAX package's jax-free modules are copies.

Each copy under ``src/repro_torch/`` must be its original's text up to the
import rewrite (``repro.`` read as ``repro_torch.``) and its docstrings: the
test compares their syntax trees.  ``serving/sweep.py`` is a copy except for
the functions and constants it names in ``PORT_REWRITES``: those are left out
of the comparison, and each must exist in both modules and differ from its
original.  The graph lifter (``frontend/fx_lift.py``) is a rewrite of the
jaxpr lifter, but the parts named in ``LIFTER_VERBATIM`` are its text,
compared definition by definition; and the port's register allocator must
give the reference's pinned allocation on the JAX lifts' programs.  Beyond
the text, the port's scalar event
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
from test_frontend import REGALLOC_GOLDEN  # noqa: E402
from test_sim_golden import LISTING1_BREAKDOWN, LISTING1_GOLDEN  # noqa: E402

import repro.core.plan_cache as ref_plan_cache  # noqa: E402
import repro.frontend.jaxpr_lift as ref_jaxpr_lift  # noqa: E402
import repro.frontend.workloads as ref_traced  # noqa: E402
import repro.sim.batch as ref_batch  # noqa: E402
import repro.sim.designs as ref_designs  # noqa: E402
import repro.sim.engine as ref_engine  # noqa: E402
import repro.workloads as ref_workloads  # noqa: E402
from repro.sim.golden import golden_simulate  # noqa: E402

import repro_torch.core as port_core  # noqa: E402
import repro_torch.core.plan_cache as port_plan_cache  # noqa: E402
import repro_torch.frontend.regalloc as port_regalloc  # noqa: E402
import repro_torch.serving.sweep as port_sweep  # noqa: E402
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
    # the sweep service slice
    "obs/metrics", "sim/gpu", "sim/power", "sim/analytic", "serving/faults",
    "serving/sweep",
    # the graph lifter slice
    "frontend/regalloc", "sim/golden", "workloads/traced", "workloads/__init__",
]
# the parts of the graph lifter that are the jaxpr lifter's text
LIFTER_VERBATIM = ("_IR_RESERVED", "_opname", "_tile_trips", "_serial_trips",
                   "LiftedProgram", "_Emitter")
# what a copy rewrites or adds: left out of the comparison, held below to
# differ from the original or to be absent from it
REWRITES = {"serving/sweep": (*port_sweep.PORT_REWRITES, *port_sweep.PORT_ADDITIONS,
                              "PORT_REWRITES", "PORT_ADDITIONS")}


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


def _definitions(body: list, prefix: str = ""):
    """(qualified name, the body holding it, node) for each function, class
    and assignment to a name at module or class level."""
    for node in body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            yield prefix + node.name, body, node
            if isinstance(node, ast.ClassDef):
                yield from _definitions(node.body, prefix + node.name + ".")
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            for target in targets:
                if isinstance(target, ast.Name):
                    yield prefix + target.id, body, node


def _parse(path: Path) -> ast.Module:
    return _Normalize().visit(ast.parse(path.read_text()))


def _tree(path: Path, leave_out=()) -> str:
    tree = _parse(path)
    for name, body, node in list(_definitions(tree.body)):
        if name in leave_out:
            body.remove(node)
    return ast.dump(tree)


def _paths(module: str) -> tuple[Path, Path]:
    return (ROOT / "src" / "repro" / f"{module}.py",
            ROOT / "src" / "repro_torch" / f"{module}.py")


@pytest.mark.parametrize("module", COPIES)
def test_copy_equals_original_up_to_imports_and_docstrings(module):
    original, copy = _paths(module)
    leave_out = REWRITES.get(module, ())
    assert _tree(copy, leave_out) == _tree(original, leave_out), \
        f"{copy} drifted from {original}"


@pytest.mark.parametrize("name", LIFTER_VERBATIM)
def test_lifter_parts_equal_the_jaxpr_lifters(name):
    defs = [{n: ast.dump(node) for n, _, node in _definitions(_parse(p).body)}
            for p in (ROOT / "src" / "repro" / "frontend" / "jaxpr_lift.py",
                      ROOT / "src" / "repro_torch" / "frontend" / "fx_lift.py")]
    assert name in defs[0] and name in defs[1], name
    assert defs[1][name] == defs[0][name], f"fx_lift.{name} drifted from jaxpr_lift.{name}"


@pytest.mark.parametrize("name", port_sweep.PORT_REWRITES)
def test_sweep_rewrites_exist_and_differ(name):
    original, copy = _paths("serving/sweep")
    defs = [{n: ast.dump(node) for n, _, node in _definitions(_parse(p).body)}
            for p in (original, copy)]
    assert name in defs[0], f"{name} is not in the original"
    assert name in defs[1], f"{name} is not in the copy"
    assert defs[0][name] != defs[1][name], f"{name} is listed but not rewritten"


@pytest.mark.parametrize("name", port_sweep.PORT_ADDITIONS)
def test_sweep_additions_are_the_ports_own(name):
    original, copy = _paths("serving/sweep")
    defs = [{n for n, _, _ in _definitions(_parse(p).body)} for p in (original, copy)]
    assert name not in defs[0], f"{name} is in the original: list it in PORT_REWRITES"
    assert name in defs[1], f"{name} is not in the copy"


def test_sweep_copy_check_catches_a_changed_line(tmp_path):
    """Outside the listed rewrites, one changed line is a different tree."""
    original, copy = _paths("serving/sweep")
    text = copy.read_text()
    old = "        retry = kind in _RETRIABLE and st.attempts < self.cfg.max_attempts\n"
    assert text.count(old) == 1
    bad = tmp_path / "sweep.py"
    bad.write_text(text.replace(old, old.replace("<", "<=")))
    leave_out = REWRITES["serving/sweep"]
    assert _tree(bad, leave_out) != _tree(original, leave_out)


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


@pytest.mark.parametrize("name", ref_traced.TRACED_NAMES)
def test_port_regalloc_on_the_jax_lifts(name):
    """The port's allocator on the JAX lifter's programs (rendered, the
    blocks' generated labels dropped, and parsed by the port's ``parse_asm``)
    gives the reference's pinned allocation, at both register budgets."""
    spec = ref_traced.TRACED_SPECS[name]
    fn, args = spec.builder()
    lifted = ref_jaxpr_lift.lift_fn(fn, args, name=name, while_trips=spec.while_trips)
    text = "\n".join(ln for ln in lifted.prog.render().splitlines() if not ln.startswith("."))
    prog = port_parse_asm(text, name=name)
    assert prog.render() == lifted.prog.render()
    for mrc in (64, 24):
        a = port_regalloc.allocate_registers(prog, maxregcount=mrc)
        got = (a.regs_per_thread, a.spill_count, a.spill_loads, a.spill_stores)
        assert got == REGALLOC_GOLDEN[(name, mrc)], (name, mrc, got)
