"""The port's batch simulator (``repro_torch.sim.batch``) against the JAX
package's (``repro.sim.batch``), state for state, on the CPU.

The reference runs its jitted loop with 64-bit types on; under jax 0.9 its
``from jax.experimental import enable_x64`` fails (ROADMAP R1), so the
fixture below aliases ``jax.experimental.enable_x64`` to ``jax.enable_x64``
inside this test process only.  Jobs are small (at most ~1,300 ticks): eager
PyTorch on the CPU costs a few milliseconds a tick.
"""
from dataclasses import replace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.experimental  # noqa: E402

import repro.sim.batch as ref_batch  # noqa: E402
import repro.sim.designs as ref_designs  # noqa: E402
import repro.workloads as ref_workloads  # noqa: E402

import repro_torch.sim.batch as port_batch  # noqa: E402
import repro_torch.sim.designs as port_designs  # noqa: E402
import repro_torch.workloads as port_workloads  # noqa: E402

CPU = torch.device("cpu")

# (workload, design, num_warps) per lane; each entry is one chunk.  The
# reference's tick counts are 985, 1,310 and 206.
CHUNKS = {
    "kmeans_ltrf_2w": [("kmeans", "LTRF", 2)],
    "rfc_and_bl": [("btree", "RFC", 4), ("kmeans", "BL", 2)],
    "listing1_all_designs": [("listing1", d, 16) for d in
                             ("BL", "RFC", "SHRF", "LTRF", "LTRF_conf", "LTRF_plus", "Ideal")],
}


@pytest.fixture
def x64_alias(monkeypatch):
    monkeypatch.setattr(jax.experimental, "enable_x64", jax.enable_x64, raising=False)


def _lanes(pkg, chunk):
    batch, designs, workloads = pkg
    out = []
    for name, design, nw in chunk:
        w = _listing1(workloads) if name == "listing1" else workloads.get_workload(name)
        cfg = designs.design_config(design, table2_config=7, num_warps=nw)
        out.append(batch._Lane(w, cfg, batch._encode_plan(w, cfg), batch._occupancy(w, cfg)))
    return out


def _listing1(workloads):
    """The paper's Listing 1 (tests/test_sim_golden.py's pins: <= 206 ticks
    for all 7 designs at 16 warps)."""
    return workloads.Workload(name="listing1", program=workloads.listing1_program(),
                              trips={"L1": 100}, register_sensitive=False, regs_per_thread=8,
                              suite="paper")


REF = (ref_batch, ref_designs, ref_workloads)
PORT = (port_batch, port_designs, port_workloads)


def _ref_run(chunk):
    """The reference's jitted run: its final state dict (numpy)."""
    co, st = ref_batch._build(_lanes(REF, chunk))
    from jax.experimental import enable_x64
    with enable_x64():
        out = ref_batch._aot_compile(co, st)(co, st)
        return {k: np.asarray(v) for k, v in out.items()}


def _port_run(chunk, **opts):
    co, st = port_batch._build(_lanes(PORT, chunk))
    out = port_batch._run_torch(co, st, "cpu", **opts)
    return {k: v.numpy() for k, v in out.items()}


def _assert_same_state(got, want):
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        assert got[key].shape == want[key].shape, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_build_matches_reference():
    chunk = [lane for c in CHUNKS.values() for lane in c] + [("hotspot", "LTRF_conf", 4)]
    co_p, st_p = port_batch._build(_lanes(PORT, chunk))
    co_r, st_r = ref_batch._build(_lanes(REF, chunk))
    _assert_same_state(co_p, co_r)
    _assert_same_state(st_p, st_r)


@pytest.mark.parametrize("name", sorted(CHUNKS))
def test_final_state_and_ticks_match_reference(name, x64_alias):
    want = _ref_run(CHUNKS[name])
    got = _port_run(CHUNKS[name])
    _assert_same_state(got, want)
    assert not got["alive"].any()
    assert int(got["guard"]) == int(want["guard"])


def test_final_state_catches_a_planted_fault(x64_alias, monkeypatch):
    """The state comparison is sharp: the DRAM queue's interval one cycle
    longer (reference :855) changes the state."""
    chunk = CHUNKS["kmeans_ltrf_2w"]
    build = port_batch._build

    def late_dram(lanes):
        co, st = build(lanes)
        co["drint"] = co["drint"] + 1.0
        return co, st

    monkeypatch.setattr(port_batch, "_build", late_dram)
    with pytest.raises(AssertionError):
        _assert_same_state(_port_run(chunk), _ref_run(chunk))


def test_blocks_and_activation_bounds_give_the_same_state():
    """Blocks of T ticks equal T = 1.  An activation prefetch bound k that
    overflows (k = 0: every block in which an activation charges a prefetch
    is rolled back and rerun exactly) and one that cannot (k = 8, the
    lanes' active-slot cap) equal the exact run."""
    chunk = CHUNKS["listing1_all_designs"]
    exact = _port_run(chunk)
    runs = {}
    for k, block in ((None, 7), (0, 5), (8, 6)):
        co, st = port_batch._build(_lanes(PORT, chunk))
        run = runs[k] = port_batch._Chunk(co, st, CPU, block=block, act_k=k)
        while not run.done:
            run.launch()
            run.settle()
        _assert_same_state({key: v.numpy() for key, v in run.state().items()}, exact)
    assert runs[0].stats["reruns"] > 0
    assert runs[8].stats["reruns"] == 0


def test_ties_pick_the_first_index():
    """The collector and prefetch-slot argmin (reference :689, :798), the
    LRU victim (:836) and the first-set argmax (:718, :825) return the
    first index on ties, as ``jnp.argmin`` / ``jnp.argmax`` do."""
    col = torch.tensor([[7, 3, 3, 3], [0, 0, 0, 0], [9, 9, 2, 2]], dtype=torch.int64)
    assert torch.argmin(col, dim=1).tolist() == [1, 0, 2]
    cand = torch.tensor([[0, 1, 1, 0], [1, 1, 1, 1], [0, 0, 0, 0]], dtype=torch.bool)
    assert torch.argmax(cand.to(torch.uint8), dim=1).tolist() == [1, 0, 0]
    # and in the engine: at the first prefetch every slot is free (time 0),
    # so slot 0 takes it; the final slot array is held positionally above


def test_run_stats_keys_and_cpu_accounting():
    w = port_workloads.get_workload("kmeans")
    cfg = port_designs.design_config("LTRF", table2_config=7, num_warps=2)
    stats = port_batch.reset_run_stats()
    assert stats == {"compile_s": 0.0, "run_s": 0.0, "compiles": 0, "launches": 0, "ticks": 0}
    assert set(stats) == set(ref_batch.RUN_STATS)
    res, = port_batch.run_batch([(w, cfg)], fallback=False, device="cpu")
    assert stats["launches"] == 1 and stats["run_s"] > 0.0
    assert stats["compiles"] == 0 and stats["compile_s"] == 0.0   # no capture on the CPU
    assert stats["ticks"] == 985                                    # the reference's count
    assert port_batch.BLOCK_STATS["replays"] == 0
    assert res == port_batch.simulate(w, cfg)


def test_chunk_lanes_sub_chunk_size_is_per_device():
    """One shape group of 12 lanes: two chunks on the CPU (8 lanes at
    most, the reference's cut), one on the card."""
    names = port_workloads.workload_names()[:12]
    chunk = [(n, "LTRF", 8) for n in names]
    lanes, idxs = _lanes(PORT, chunk), list(range(12))
    cpu = list(port_batch._chunk_lanes(lanes, idxs, port_batch._SUB_LANES["cpu"]))
    card = list(port_batch._chunk_lanes(lanes, idxs, port_batch._SUB_LANES["cuda"]))
    assert [len(c) for c, _ in cpu] == [8, 4]
    assert [len(c) for c, _ in card] == [12]
    ref = list(ref_batch._chunk_lanes(_lanes(REF, chunk), idxs))
    assert [i for _, i in cpu] == [i for _, i in ref]
    assert sorted(card[0][1]) == idxs


def test_unsupported_config_falls_back_or_raises():
    w = port_workloads.get_workload("kmeans")
    cfg = replace(port_designs.design_config("LTRF", table2_config=7, num_warps=4),
                  scheduler="gto")
    assert not port_batch.batch_supported(cfg)
    assert port_batch.run_batch([(w, cfg)], device="cpu") == [port_batch.simulate(w, cfg)]
    with pytest.raises(ValueError):
        port_batch.run_batch([(w, cfg)], fallback=False, device="cpu")


# ------------------------------------------ the kernel path (csrc/sim_batch.cu)

from repro_torch.kernels import _build as kernel_build  # noqa: E402
from repro_torch.kernels.sim_batch import ops as kernel_ops  # noqa: E402

LANE_KINDS = {
    "cached": [("kmeans", "LTRF", 8), ("bfs", "SHRF", 4)],
    "rfc": [("btree", "RFC", 4)],
    "bl_and_ideal": [("kmeans", "BL", 2), ("pathfinder", "Ideal", 6)],
    "every_design": [("listing1", d, 16) for d in
                     ("BL", "RFC", "SHRF", "LTRF", "LTRF_conf", "LTRF_plus", "Ideal")],
}


def _cpu_planes(co, st):
    return port_batch._place(co, CPU), port_batch._place(port_batch._trash(st), CPU)


@pytest.mark.parametrize("kind", sorted(LANE_KINDS))
def test_kernel_args_agree_with_dims_and_planes(kind):
    """The struct the host fills for the kernel: its widths are ``_dims``'s
    and the planes' own, each plane's lane stride is its row's size, and
    each pointer is its plane's."""
    co, st = port_batch._build(_lanes(PORT, LANE_KINDS[kind]))
    c, s = _cpu_planes(co, st)
    dims = port_batch._dims(co, st)
    args = kernel_ops.kernel_args(c, s, dims)
    got = dict(zip(kernel_ops.DIMS, args.dims))
    assert tuple(args.dims)[:len(dims)] == dims
    assert got["K"] == st["wf"].shape[0] and got["W"] == st["wf"].shape[1]
    assert got["A"] == st["act"].shape[1] and got["E"] == st["rc"].shape[1]
    assert (got["PF"], got["C"], got["NCAT"]) == (st["pf"].shape[1], st["col"].shape[1],
                                                  st["bd"].shape[1])
    assert (got["GV"], got["MW"]) == (co["ivregs"].shape[2], co["meta"].shape[2])
    assert got["CW"] == 2 + got["S"] + got["PS"] == s["cf"].shape[2]
    assert got["RV1"] == got["RVW"] + 1 == s["rv"].shape[2]
    planes = {**c, **s}
    # every plane but the dummies whose shapes carry widths (in `dims`)
    assert set(kernel_ops.PLANES) == set(planes) - {"slots", "mdims", "rdims", "ldims"}
    for i, name in enumerate(kernel_ops.PLANES):
        t = planes[name]
        assert args.planes[i] == t.data_ptr(), name
        assert args.lane_stride[i] == (int(np.prod(t.shape[1:])) if t.dim() else 0), name
    bad = dict(c, seed=c["seed"].to(torch.int32))
    with pytest.raises(ValueError, match="seed"):
        kernel_ops.kernel_args(bad, s, dims)


class _StubStream:
    """A CUDA stream's stand-in: handle 0, waits on nothing."""
    cuda_stream = 0

    def wait_stream(self, other):
        pass


class _StubEvent:
    """A timing CUDA event's stand-in: records nothing, reads 0 ms."""

    def __init__(self, enable_timing=False):
        pass

    def record(self):
        pass

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return 0.0


@pytest.fixture
def fake_card(monkeypatch):
    """``cuda`` as the device with the planes left on the CPU, stub streams
    and events, and a library stub that records each launch (and runs
    nothing); the plain tick raises if it is ever built."""
    import contextlib
    place = port_batch._place
    launches = []

    def stub_launch(args, stream):
        launches.append((args, stream))
        return 0

    def no_plain_tick(*a, **k):
        raise AssertionError("the plain tick ran on the kernel path")

    monkeypatch.setattr(port_batch, "_place", lambda arrays, device: place(arrays, CPU))
    monkeypatch.setattr(port_batch, "_card_stream", lambda device: _StubStream())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: _StubStream())
    monkeypatch.setattr(torch.cuda, "stream", lambda stream: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "Event", _StubEvent)
    monkeypatch.setattr(port_batch, "resolve_device", torch.device)
    monkeypatch.setattr(port_batch, "_tick_fn", no_plain_tick)
    monkeypatch.setattr(kernel_ops, "_check_card", lambda co, s: None)
    monkeypatch.setattr(kernel_ops, "_library", lambda numbering: stub_launch)
    return launches


def test_run_chunks_on_the_card_launches_the_kernel_once_a_chunk(fake_card):
    chunks = [_lanes(PORT, LANE_KINDS[k]) for k in ("cached", "rfc", "bl_and_ideal")]
    before = kernel_ops.sim_batch.launches
    stats = port_batch.reset_run_stats()
    out = port_batch._run_chunks(chunks, torch.device("cuda"))
    assert len(fake_card) == len(chunks) == len(out)
    assert kernel_ops.sim_batch.launches - before == len(chunks)
    assert stats["launches"] == len(chunks) and stats["compiles"] == 0
    assert stats["compile_s"] == 0.0
    assert port_batch.BLOCK_STATS == {"blocks": 3, "eager_blocks": 0, "replays": 0, "reruns": 0}
    assert all(r["captures"] == 0 and r["blocks"] == 1 for _, r in out)
    with pytest.raises(TypeError, match="one launch"):
        port_batch._run_chunks(chunks[:1], torch.device("cuda"), block=4)


def test_the_kernel_path_needs_the_card():
    """``device="cpu"`` runs the plain tick; the kernel refuses it."""
    co, st = port_batch._build(_lanes(PORT, LANE_KINDS["rfc"]))
    with pytest.raises(ValueError, match="CUDA device"):
        port_batch._run_torch(co, st, "cpu", engine="kernel")
    with pytest.raises(ValueError, match="engine"):
        port_batch._run_torch(co, st, "cpu", engine="jit")


@pytest.mark.parametrize("fault", ["build", "launch"])
def test_a_kernel_that_fails_raises_out_of_run_batch(fake_card, monkeypatch, fault):
    """No fallback: a failed build or a refused launch raises, and no job
    is finished by the plain tick or the scalar engine instead."""
    def failed_build(name):
        raise RuntimeError(f"kernel build failed: {name} (planted)")

    if fault == "build":
        monkeypatch.setattr(kernel_ops, "_library",
                            lambda numbering: kernel_build.load("sim_batch"))
        monkeypatch.setattr(kernel_build, "load", failed_build)
    else:
        monkeypatch.setattr(kernel_ops, "_library", lambda numbering: lambda args, stream: 700)
    monkeypatch.setattr(port_batch, "simulate", fake_card.append)
    w = port_workloads.get_workload("kmeans")
    cfg = port_designs.design_config("LTRF", table2_config=7, num_warps=2)
    with pytest.raises(RuntimeError, match="planted" if fault == "build" else "cudaError 700"):
        port_batch.run_batch([(w, cfg)], device="cuda")
    assert not fake_card


# The kernel's source built for the host by a C++ compiler (one thread a
# lane, the same code as on the card) holds its logic to the plain tick on
# the CPU: every plane and `guard`, bit for bit.

def _host_compiler():
    import shutil
    return shutil.which("g++") or shutil.which("c++")


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    import ctypes
    import subprocess
    cxx = _host_compiler()
    if cxx is None:
        pytest.skip("needs a C++ compiler (g++ or c++) to build the kernel's source for the host")
    out = tmp_path_factory.mktemp("sim_batch_host") / "sim_batch_host.so"
    src = kernel_build.CSRC / "sim_batch.cu"
    subprocess.run([cxx, "-std=c++17", "-O2", "-ffp-contract=off", "-shared", "-fPIC",
                    "-x", "c++", str(src), "-o", str(out)], check=True)
    lib = ctypes.CDLL(str(out))
    lib.sim_batch_layout.restype = ctypes.c_char_p
    lib.sim_batch_run_host.argtypes = [ctypes.c_void_p]
    return lib


def _host_run(lib, co, st):
    import ctypes
    c, s = _cpu_planes(co, st)
    dims = port_batch._dims(co, st)
    args = kernel_ops.kernel_args(c, s, dims)       # held: the call reads it
    assert lib.sim_batch_run_host(ctypes.addressof(args)) == 0
    return {k: v.numpy() for k, v in port_batch._untrash(s, dims[1], dims[12], dims[4],
                                                          dims[3]).items()}


def test_host_built_kernel_has_the_wrappers_layout(host_kernel):
    assert (host_kernel.sim_batch_layout().decode()
            == kernel_ops.layout(port_batch._KERNEL_NUMBERING))


def _watchdog_chunk():
    """Listing 1's designs, each with a cycle budget (0: none) that stops
    most of them part way (SimBudgetExceeded outcomes)."""
    budgets = dict(zip(("BL", "RFC", "SHRF", "LTRF", "LTRF_conf", "LTRF_plus", "Ideal"),
                       (300, 900, 0, 150, 2000, 700, 1)))
    w = _listing1(port_workloads)
    out = []
    for d, m in budgets.items():
        cfg = replace(port_designs.design_config(d, table2_config=7, num_warps=16), max_cycles=m)
        out.append(port_batch._Lane(w, cfg, port_batch._encode_plan(w, cfg),
                                    port_batch._occupancy(w, cfg)))
    return out


@pytest.mark.parametrize("name", sorted(CHUNKS) + ["watchdog", "tmax_wedge"])
def test_host_built_kernel_gives_the_plain_tick_state(host_kernel, name):
    """Every plane and ``guard``: the CPU tests' jobs (985, 1,310 and 206
    ticks), a chunk whose lanes hit the ``maxc`` watchdog, and one cut by a
    tick cap (``tmax``) with lanes still alive."""
    lanes = _watchdog_chunk() if name == "watchdog" else _lanes(
        PORT, CHUNKS["listing1_all_designs" if name == "tmax_wedge" else name])
    co, st = port_batch._build(lanes)
    if name == "tmax_wedge":
        co["tmax"] = np.asarray(120, np.int64)
    plain = {k: v.numpy() for k, v in port_batch._run_torch(co, st, "cpu").items()}
    got = _host_run(host_kernel, co, st)
    _assert_same_state(got, plain)
    if name == "watchdog":
        assert plain["budget"].sum() == 3 and not plain["alive"].any()
    if name == "tmax_wedge":
        assert int(plain["guard"]) == 121 and plain["alive"].any()


def test_host_built_kernel_catches_a_planted_fault(host_kernel):
    """The DRAM queue's interval one cycle longer changes the kernel's state."""
    lanes = _lanes(PORT, CHUNKS["kmeans_ltrf_2w"])
    co, st = port_batch._build(lanes)
    want = _host_run(host_kernel, co, st)
    co["drint"] = co["drint"] + 1.0
    with pytest.raises(AssertionError):
        _assert_same_state(_host_run(host_kernel, co, st), want)
