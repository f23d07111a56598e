"""The port's graph lifter (``repro_torch.frontend``) against the JAX
package's jaxpr lifter, on the CPU, at the traced suite's shapes.

* ``traced_matmul`` lifts to the JAX lift's program text and trip table, and
  gives ``TRACED_MATMUL_GOLDEN`` on all 7 designs through the port's scalar
  engine and its golden copy.
* Small functions written in both ``jnp`` and ``torch`` lift to the same
  program text (the op-parity table), `_COMPOSITES` included.
* For each of the six workloads: the lift and its interval plans validate,
  the loops' trip counts above 1 equal the JAX lift's (the structural check:
  products, reductions and scans correspond one to one), the port's engines
  agree with each other and with the reference engine on the port's program,
  and the register allocation is pinned.
* The scan forms equal the port's loop versions and the JAX functions.
* The registry, the sweep service's store keys, and lifting without CUDA.
* Planted lift faults that these checks must catch.
"""
from __future__ import annotations

import os
import subprocess
import sys
from collections import Counter
from dataclasses import asdict
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch.nn.functional as F  # noqa: E402
from test_frontend import REGALLOC_GOLDEN  # noqa: E402
from test_sim_golden import TRACED_MATMUL_GOLDEN  # noqa: E402

import repro.core.ir as ref_ir  # noqa: E402
import repro.serving.sweep as ref_sweep  # noqa: E402
import repro.sim.designs as ref_designs  # noqa: E402
import repro.sim.engine as ref_engine  # noqa: E402
from repro.frontend import jaxpr_lift  # noqa: E402
from repro.frontend.workloads import TRACED_SPECS as REF_SPECS  # noqa: E402
from repro.kernels.ssd_scan.ref import ssd_ref as jax_ssd_ref  # noqa: E402
from repro.models.layers import causal_attention as jax_causal_attention  # noqa: E402
from repro.workloads.suite import Workload as RefWorkload  # noqa: E402

import repro_torch.core.plan_cache as port_plan_cache  # noqa: E402
import repro_torch.serving.sweep as port_sweep  # noqa: E402
from repro_torch.core.intervals import form_register_intervals  # noqa: E402
from repro_torch.core.ir import back_edges, reachable_blocks  # noqa: E402
from repro_torch.frontend import fx_lift  # noqa: E402
from repro_torch.frontend.regalloc import allocate_registers  # noqa: E402
from repro_torch.frontend.workloads import (  # noqa: E402
    TRACED_NAMES, TRACED_SPECS, build_traced_workload, causal_attention_scan_form,
    ssd_scan_form,
)
from repro_torch.kernels.ssd_scan.ref import ssd_ref  # noqa: E402
from repro_torch.models.layers import causal_attention  # noqa: E402
from repro_torch.sim import design_config, simulate  # noqa: E402
from repro_torch.sim.golden import golden_simulate  # noqa: E402
from repro_torch.workloads import Workload, get_workload, workload_names  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
DESIGNS = ("BL", "RFC", "SHRF", "LTRF", "LTRF_conf", "LTRF_plus", "Ideal")
KERNEL_NAMES = ("traced_matmul", "traced_attention", "traced_ssd")
FP32 = dict(rtol=2e-4, atol=1e-4)      # `_tol` of tests/test_kernels.py, fp32

# The port's lift at maxregcount 64 and 24, as REGALLOC_GOLDEN pins the JAX
# one: (regs_per_thread, spills, spill_loads, spill_stores).
PORT_REGALLOC_GOLDEN = {
    ("traced_matmul", 64): (29, 0, 0, 0),
    ("traced_matmul", 24): (22, 9, 19, 17),
    ("traced_attention", 64): (30, 0, 0, 0),
    ("traced_attention", 24): (22, 18, 37, 34),
    ("traced_ssd", 64): (22, 0, 0, 0),
    ("traced_ssd", 24): (22, 0, 0, 0),
    ("traced_rmsnorm", 64): (8, 0, 0, 0),
    ("traced_rmsnorm", 24): (8, 0, 0, 0),
    ("traced_mlp", 64): (32, 0, 0, 0),
    ("traced_mlp", 24): (22, 20, 44, 35),
    ("traced_attn_layer", 64): (38, 0, 0, 0),
    ("traced_attn_layer", 24): (23, 27, 48, 45),
}


def _jax_lift(name):
    spec = REF_SPECS[name]
    fn, args = spec.builder()
    return jaxpr_lift.lift_fn(fn, args, name=name, while_trips=spec.while_trips)


def _port_lift(name, fn=None):
    spec = TRACED_SPECS[name]
    traced, args = spec.builder()
    return fx_lift.lift_fn(fn or traced, args, name=name, while_trips=spec.while_trips)


def _long_trips(lifted) -> Counter:
    return Counter(t for t in lifted.trips.values() if t > 1)


def _ref_workload(w: Workload) -> RefWorkload:
    """The port's program as the reference's `Workload` (its text parsed by
    the reference's ``parse_asm``; the blocks' generated labels dropped)."""
    text = "\n".join(ln for ln in w.program.render().splitlines() if not ln.startswith("."))
    prog = ref_ir.parse_asm(text, name=w.name)
    assert prog.render() == w.program.render()
    return RefWorkload(name=w.name, program=prog, trips=dict(w.trips),
                       register_sensitive=w.register_sensitive,
                       regs_per_thread=w.regs_per_thread, suite=w.suite, l1_hit=w.l1_hit)


def _counters(r) -> tuple:
    return (r.cycles, r.instructions, r.mrf_accesses, r.rfc_hits, r.rfc_accesses)


# ------------------------------------------------------------ traced_matmul

def test_traced_matmul_is_the_jax_lift():
    port, ref = _port_lift("traced_matmul"), _jax_lift("traced_matmul")
    assert port.prog.render() == ref.prog.render()
    assert port.trips == ref.trips == {"T1": 11}
    assert port.num_virtual_regs == ref.num_virtual_regs


@pytest.mark.parametrize("design", DESIGNS)
def test_traced_matmul_counters_pinned(design):
    w = get_workload("traced_matmul")
    cfg = design_config(design, table2_config=7, num_warps=16)
    r = simulate(w, cfg)
    assert _counters(r) == TRACED_MATMUL_GOLDEN[design], design
    assert golden_simulate(w, cfg) == r


def test_planted_small_dot_tile_breaks_the_text(monkeypatch):
    """A 2x2 register tile where the 4x4 is due is a different program."""
    dot = fx_lift._Lifter._dot

    def small_tile(self, k_extent, out_extent, a_src, b_src):
        return dot(self, k_extent, min(out_extent, 1023), a_src, b_src)

    monkeypatch.setattr(fx_lift._Lifter, "_dot", small_tile)
    assert _port_lift("traced_matmul").prog.render() != _jax_lift("traced_matmul").prog.render()


# ------------------------------------------------------------- op parity

SD = jax.ShapeDtypeStruct((8, 64), jnp.float32)
SD_W = jax.ShapeDtypeStruct((64, 32), jnp.float32)

# name: (jnp function, torch function, example shapes); the same math
OP_PARITY = {
    "arith": (lambda x, y: (x * y + y) - x / y, lambda x, y: (x * y + y) - x / y, (SD, SD)),
    "exp": (jnp.exp, torch.exp, (SD,)),
    "rsqrt": (jax.lax.rsqrt, torch.rsqrt, (SD,)),
    "sum": (lambda x: jnp.sum(x, axis=-1), lambda x: x.sum(-1), (SD,)),
    "sum_keepdims": (lambda x: jnp.sum(x, axis=-1, keepdims=True),
                     lambda x: x.sum(-1, keepdim=True), (SD,)),
    "amax": (lambda x: jnp.max(x, axis=-1), lambda x: x.amax(-1), (SD,)),
    "mean": (lambda x: jnp.mean(x, axis=-1), lambda x: x.mean(-1), (SD,)),
    "mean_keepdims": (lambda x: jnp.mean(x, axis=-1, keepdims=True),
                      lambda x: x.mean(-1, keepdim=True), (SD,)),
    "where": (lambda x, y: jnp.where(x > 0, x, y), lambda x, y: torch.where(x > 0, x, y),
              (SD, SD)),
    "clamp": (lambda x: jnp.clip(x, -1.0, 1.0), lambda x: torch.clamp(x, -1.0, 1.0), (SD,)),
    "sigmoid": (jax.nn.sigmoid, torch.sigmoid, (SD,)),
    "silu": (jax.nn.silu, F.silu, (SD,)),
    "softmax": (lambda x: jax.nn.softmax(x, axis=-1), lambda x: torch.softmax(x, -1), (SD,)),
    "matmul": (lambda x, w: x @ w, lambda x, w: x @ w, (SD, SD_W)),
}


@pytest.mark.parametrize("name", OP_PARITY)
def test_op_lifts_to_the_jax_program(name):
    jfn, tfn, shapes = OP_PARITY[name]
    ref = jaxpr_lift.lift_fn(jfn, shapes, name=name)
    port = fx_lift.lift_fn(tfn, [torch.empty(s.shape, dtype=torch.float32) for s in shapes],
                           name=name)
    assert port.prog.render() == ref.prog.render(), name
    assert port.trips == ref.trips


# ------------------------------------------------------------- the suite

@pytest.mark.parametrize("name", TRACED_NAMES)
def test_lift_validates(name):
    w = get_workload(name)
    w.program.validate()
    assert w.suite == "traced" and w.program.num_instrs() > 15
    # the whole CFG is reachable and every loop resolves through the trip table
    assert reachable_blocks(w.program) == set(w.program.order)
    for (_u, header) in back_edges(w.program):
        assert header in w.trips, f"loop {header} missing a trip count"
    assert 0 < w.regs_per_thread <= 64
    for cap in (8, 16, 32):
        an = form_register_intervals(w.program, n_cap=cap)
        an.validate()
        assert len(an.intervals) >= 1, cap


def test_specs_are_the_references():
    assert TRACED_NAMES == tuple(REF_SPECS)
    for name in TRACED_NAMES:
        a, b = TRACED_SPECS[name], REF_SPECS[name]
        assert (a.l1_hit, a.while_trips) == (b.l1_hit, b.while_trips), name
        _, port_args = a.builder()
        _, ref_args = b.builder()
        if name == "traced_mlp":      # the params dict, flattened by its sorted keys
            params, x = ref_args
            ref_args = (*(params[k] for k in sorted(params)), x)
        assert [(tuple(t.shape), str(t.dtype).split(".")[-1]) for t in port_args] == \
            [(tuple(s.shape), s.dtype.name) for s in ref_args], name


@pytest.mark.parametrize("name", TRACED_NAMES)
def test_loop_trips_match_the_jax_lift(name):
    assert _long_trips(_port_lift(name)) == _long_trips(_jax_lift(name))


def test_planted_unrolled_ssd_breaks_the_trip_check():
    """Tracing the port's Python-loop `ssd_ref` unrolls the scan: 32 product
    loops and no serial loop, not the JAX lift's structure."""
    unrolled = _port_lift("traced_ssd", fn=ssd_ref)
    assert _long_trips(unrolled) != _long_trips(_jax_lift("traced_ssd"))
    assert unrolled.prog.num_instrs() > 1000


@pytest.mark.parametrize("design", DESIGNS)
def test_traced_kernels_match_golden_and_the_reference_engine(design):
    for name in KERNEL_NAMES:
        w = get_workload(name)
        cfg = design_config(design, table2_config=7, num_warps=8)
        r = simulate(w, cfg)
        assert r == golden_simulate(w, cfg), (design, name)
        ref_cfg = ref_designs.design_config(design, table2_config=7, num_warps=8)
        assert asdict(r) == asdict(ref_engine.simulate(_ref_workload(w), ref_cfg)), (design, name)


@pytest.mark.parametrize("name", sorted(set(TRACED_NAMES) - set(KERNEL_NAMES)))
def test_traced_layers_match_golden_and_the_reference_engine(name):
    w = get_workload(name)
    cfg = design_config("LTRF_plus", table2_config=6, num_warps=8)
    r = simulate(w, cfg)
    assert r == golden_simulate(w, cfg), name
    ref_cfg = ref_designs.design_config("LTRF_plus", table2_config=6, num_warps=8)
    assert asdict(r) == asdict(ref_engine.simulate(_ref_workload(w), ref_cfg)), name


@pytest.mark.parametrize("name", TRACED_NAMES)
def test_regalloc_pinned_on_the_port_lift(name):
    lifted = _port_lift(name)
    for mrc in (64, 24):
        a = allocate_registers(lifted.prog, maxregcount=mrc)
        got = (a.regs_per_thread, a.spill_count, a.spill_loads, a.spill_stores)
        assert got == PORT_REGALLOC_GOLDEN[(name, mrc)], (name, mrc, got)
        if name == "traced_matmul":
            assert got == REGALLOC_GOLDEN[(name, mrc)]
    assert build_traced_workload(name, maxregcount=24).regs_per_thread <= 24


# ------------------------------------------------------------- scan forms

def _randn(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _ssd_inputs(seed, B=1, S=32, H=2, P=8, N=8):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(np.float32)   # softplus
    A = -np.exp(rng.standard_normal((H,))).astype(np.float32)
    Bm = rng.standard_normal((B, S, N)).astype(np.float32)
    Cm = rng.standard_normal((B, S, N)).astype(np.float32)
    return x, dt, A, Bm, Cm


def test_ssd_scan_form_equals_the_loop_and_the_jax_function():
    args = _ssd_inputs(0)
    got = ssd_scan_form(*map(torch.from_numpy, args))
    loop = ssd_ref(*map(torch.from_numpy, args))
    ref = jax_ssd_ref(*map(jnp.asarray, args))
    for g, lo, r in zip(got, loop, ref):
        torch.testing.assert_close(g, lo, rtol=1e-6, atol=0)
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **FP32)


@pytest.mark.parametrize("sq", [64, 48])
def test_attention_scan_form_equals_the_loop_and_the_jax_function(sq):
    """At the traced shape (two whole blocks) and with a padded last block."""
    q, k, v = _randn(1, (1, sq, 4, 32)), _randn(2, (1, 64, 2, 32)), _randn(3, (1, 64, 2, 32))
    got = causal_attention_scan_form(*map(torch.from_numpy, (q, k, v)), q_block=32)
    loop = causal_attention(*map(torch.from_numpy, (q, k, v)), q_block=32)
    ref = jax_causal_attention(*map(jnp.asarray, (q, k, v)), q_block=32)
    torch.testing.assert_close(got, loop, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **FP32)


# ------------------------------------------------------------- control flow

def test_lift_cond_and_while():
    """Diamonds (`cond`) and default-trip loops (`while_loop`) lift and
    terminate."""
    from torch._higher_order_ops.while_loop import while_loop

    def f(x):
        y = torch.cond(x[0] > 0, lambda v: v * 2.0, lambda v: v - 1.0, (x,))

        def body(i, v):
            return i + 1, v * 1.1

        return while_loop(lambda i, v: i < 5, body, (torch.tensor(0), y[0]))[1]

    lifted = fx_lift.lift_fn(f, (torch.empty(4),), name="condwhile", while_trips=6)
    lifted.prog.validate()
    # the diamond's branches and join, then one loop of while_trips
    assert {"E1", "J2"} <= set(lifted.prog.order) and "bra E1" in lifted.prog.render()
    assert list(lifted.trips.values()) == [6]
    w = Workload(name="condwhile", program=lifted.prog, trips=lifted.trips,
                 register_sensitive=False, regs_per_thread=16, suite="test")
    cfg = design_config("LTRF", table2_config=7, num_warps=4)
    r = simulate(w, cfg)
    assert r.instructions > 0 and r.cycles > 0
    assert r == golden_simulate(w, cfg)


def test_reads_and_writes_lift_to_memory_ops():
    """A read (``index_select``) is a load through its table's register; a
    write (``scatter_add``) a store into its aggregate, then the updated
    aggregate's move, as the jaxpr lifter lowers ``gather`` and ``scatter``."""
    i = torch.zeros(3, dtype=torch.long)
    read = fx_lift.lift_fn(lambda x, i: torch.index_select(x, 0, i) * 2, (torch.empty(8, 4), i))
    assert read.prog.render().split() == (
        ".b0: mov r0 ld r1, r0 ld r2, r0 ld r3, r1 mul r4, r3 st r4, r0 exit").split()
    i = torch.zeros(2, 4, dtype=torch.long)
    write = fx_lift.lift_fn(lambda x, i, s: torch.scatter_add(x, 0, i, s),
                            (torch.empty(8, 4), i, torch.empty(2, 4)))
    assert write.prog.render().split() == (
        ".b0: mov r0 ld r1, r0 ld r2, r0 ld r3, r0 st r2, r1 mov r4, r1 st r4, r0 exit").split()


def test_call_wrappers_are_inlined():
    """A call-like higher-order op (``wrap``, as ``torch.export`` leaves it;
    ``make_fx`` inlines it itself) lifts as its body, inlined."""
    from torch.fx.experimental.proxy_tensor import make_fx

    x = torch.empty(4, 4)
    body = make_fx(lambda y: torch.exp(y) * 2, tracing_mode="fake")(x)
    g = torch.fx.Graph()
    root = torch.nn.Module()
    root.body = body
    ph = g.placeholder("x")
    ph.meta["val"] = x
    call = g.call_function(torch.ops.higher_order.wrap, (g.get_attr("body"), ph))
    call.meta["val"] = x
    g.output(call)
    wrapped = fx_lift.lift_graph(torch.fx.GraphModule(root, g), name="wrapped")
    assert wrapped.prog.render() == fx_lift.lift_graph(body, name="wrapped").prog.render()


# ------------------------------------------------------------- the registry

def test_lift_is_deterministic():
    a = build_traced_workload("traced_ssd")
    port_plan_cache.cache_clear()
    try:
        b = build_traced_workload("traced_ssd")
    finally:
        port_plan_cache.cache_clear()
    assert a is not b
    assert a.program.render() == b.program.render()
    assert a.trips == b.trips and a.regs_per_thread == b.regs_per_thread


def test_default_names_exclude_traced_even_after_loading():
    get_workload("traced_matmul")  # force the lazy suite in
    default = workload_names()
    assert len(default) == 14 and not any(n.startswith("traced_") for n in default)
    assert set(workload_names("traced")) == set(TRACED_NAMES)


def test_sweep_service_batches_a_traced_job_on_the_cpu(tmp_path):
    cfg = design_config("LTRF", table2_config=7, num_warps=4)
    runner = port_sweep.SimRunner(device="cpu", batch=True, processes=1, cache_dir=tmp_path)
    report = runner.prefill([("traced_rmsnorm", cfg)])
    assert report.ok and runner.stats["batched"] == 1
    assert runner.sim("traced_rmsnorm", cfg) == simulate(get_workload("traced_rmsnorm"), cfg)


def test_lift_in_a_process_without_cuda():
    script = ("import torch; from repro_torch.workloads import get_workload; "
              "w = get_workload('traced_rmsnorm'); "
              "print('LIFT_OK', w.regs_per_thread, torch.cuda.is_initialized())")
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": "",
           "PYTHONPATH": os.pathsep.join([str(ROOT / "src"), os.environ.get("PYTHONPATH", "")])}
    r = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                       timeout=300, env=env)
    assert "LIFT_OK 8 False" in r.stdout, r.stdout + r.stderr


@pytest.mark.parametrize("name", ["traced_ssd", "traced_attn_layer"])
def test_lift_starts_no_cuda_where_a_card_is_visible(name, monkeypatch):
    """As on a machine with a card: `is_available` says yes, and anything
    that would start CUDA (dynamo saving the CUDA RNG state, say) raises."""
    def no_cuda(*args, **kwargs):
        raise AssertionError("lifting started CUDA")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "_lazy_init", no_cuda)
    monkeypatch.setattr(torch.cuda, "get_rng_state", no_cuda)
    assert _long_trips(_port_lift(name)) == _long_trips(_jax_lift(name))


def test_traced_store_entries_are_keyed_apart(tmp_path):
    """A store entry of a traced workload written by either package is a
    miss for the other (another program under the same name); a synthetic
    workload's entry is a hit both ways."""
    cfg = design_config("LTRF", table2_config=7, num_warps=4)
    ref_cfg = ref_designs.design_config("LTRF", table2_config=7, num_warps=4)
    names = ("traced_rmsnorm", "kmeans")
    assert port_sweep.sim_key(names[0], cfg) != ref_sweep.sim_key(names[0], ref_cfg)
    assert port_sweep.sim_key(names[1], cfg) == ref_sweep.sim_key(names[1], ref_cfg)

    ref_writer = ref_sweep.SimRunner(processes=1, batch=False, cache_dir=tmp_path / "ref")
    assert ref_writer.prefill([(n, ref_cfg) for n in names]).computed == 2
    port_reader = port_sweep.SimRunner(device="cpu", batch=False, processes=1,
                                       cache_dir=tmp_path / "ref")
    report = port_reader.prefill([(n, cfg) for n in names])
    assert (report.cached, report.computed) == (1, 1)
    assert port_reader.stats["disk_hits"] == 1

    port_writer = port_sweep.SimRunner(device="cpu", batch=False, processes=1,
                                       cache_dir=tmp_path / "port")
    assert port_writer.prefill([(n, cfg) for n in names]).computed == 2
    ref_reader = ref_sweep.SimRunner(processes=1, batch=False, cache_dir=tmp_path / "port")
    report = ref_reader.prefill([(n, ref_cfg) for n in names])
    assert (report.cached, report.computed) == (1, 1)
    assert ref_reader.stats["disk_hits"] == 1
