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


def _rfc_evict_chunk():
    """Listing 1's RFC lanes at 16 and 4 warps with an 8-entry table
    (``rfc_size_kb=1``): the table fills, and the 16-warp lane evicts ~280
    times (206 ticks)."""
    w = _listing1(port_workloads)
    out = []
    for nw in (16, 4):
        cfg = replace(port_designs.design_config("RFC", table2_config=7, num_warps=nw),
                      rfc_size_kb=1)
        out.append(port_batch._Lane(w, cfg, port_batch._encode_plan(w, cfg),
                                    port_batch._occupancy(w, cfg)))
    return out


def _chunk_lanes_named(name):
    if name == "watchdog":
        return _watchdog_chunk()
    if name == "rfc_evict":
        return _rfc_evict_chunk()
    return _lanes(PORT, CHUNKS["listing1_all_designs" if name == "tmax_wedge" else name])


@pytest.mark.parametrize("name", sorted(CHUNKS) + ["watchdog", "tmax_wedge", "rfc_evict"])
def test_host_built_kernel_gives_the_plain_tick_state(host_kernel, name):
    """Every plane and ``guard``: the CPU tests' jobs (985, 1,310 and 206
    ticks), a chunk whose lanes hit the ``maxc`` watchdog, one cut by a
    tick cap (``tmax``) with lanes still alive, and RFC lanes whose table
    fills and evicts."""
    lanes = _chunk_lanes_named(name)
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
    if name == "rfc_evict":
        E = plain["rc"].shape[1]
        assert (plain["rcnt"] == E).all() and plain["cm"][0] > 10 * E and plain["ch"].all()


def _widths(co, st):
    c, s = _cpu_planes(co, st)
    return kernel_ops.widths(c, s, port_batch._dims(co, st))


def _fit_route(monkeypatch, co, st, route):
    """Shared memory cut to the image ``route`` takes, if it is not the
    first that fits: ``plan`` then takes ``route`` from the widths."""
    width = _widths(co, st)
    if kernel_ops.plan(width)[0] != route:
        monkeypatch.setattr(kernel_ops, "SHARED_BYTES", kernel_ops.image_bytes(width, route))
    assert kernel_ops.plan(width)[0] == route


@pytest.mark.parametrize("route", kernel_ops.ROUTES)
@pytest.mark.parametrize("name", ["listing1_all_designs", "rfc_evict"])
def test_host_built_kernel_routes_give_the_plain_tick_state(host_kernel, monkeypatch, name,
                                                            route):
    """Each route of the image (``rv`` and the tables in it, or left in
    their global planes, where shared memory holds less than the first)
    gives the plain tick's state."""
    co, st = port_batch._build(_chunk_lanes_named(name))
    _fit_route(monkeypatch, co, st, route)
    plain = {k: v.numpy() for k, v in port_batch._run_torch(co, st, "cpu").items()}
    _assert_same_state(_host_run(host_kernel, co, st), plain)


def _tied_rfc_state():
    """``_rfc_evict_chunk``'s lanes started with a full table of keys no
    operand has, every stamp 0: the first insert's victim is a tie."""
    co, st = port_batch._build(_rfc_evict_chunk())
    E = st["rc"].shape[1]
    st["rc"][:, :, 0] = 10 ** 9 + np.arange(E)
    st["rc"][:, :, 1] = 0
    st["rcnt"][:] = co["ecap"]
    assert (co["ecap"] == E).all()
    return co, st


def _wide_rfc_state():
    """Listing 1's RFC lanes with a 256-entry table (``rfc_size_kb=32``),
    full from the start: entries 0-127 (the kernel's registers) hold keys no
    operand has, stamped 100; entries 128-255 (its shared memory), stamped
    0-127, hold the keys of the lanes' even registers and then more keys no
    operand has, so hits (even registers) and evictions (odd ones) both land
    past the registers."""
    w = _listing1(port_workloads)
    lanes = []
    for nw in (16, 4):
        cfg = replace(port_designs.design_config("RFC", table2_config=7, num_warps=nw),
                      rfc_size_kb=32)
        lanes.append(port_batch._Lane(w, cfg, port_batch._encode_plan(w, cfg),
                                      port_batch._occupancy(w, cfg)))
    co, st = port_batch._build(lanes)
    E, R = st["rc"].shape[1], co["rdims"].shape[0] - 1
    assert E == 256
    st["rc"][:, :128, 0] = 10 ** 9 + np.arange(128)
    st["rc"][:, :128, 1] = 100
    keys = [wid * (R + 1) + r for wid in range(16) for r in range(0, 8, 2)]
    st["rc"][:, 128:, 0] = keys + [2 * 10 ** 9 + e for e in range(128 - len(keys))]
    st["rc"][:, 128:, 1] = np.arange(128)
    st["rcnt"][:] = co["ecap"]
    return co, st


def test_host_built_kernel_holds_a_table_past_its_registers(host_kernel):
    """A 256-entry RFC table, half of it in the kernel's shared memory:
    the plain tick's state."""
    co, st = _wide_rfc_state()
    plain = {k: v.numpy() for k, v in port_batch._run_torch(co, st, "cpu").items()}
    _assert_same_state(_host_run(host_kernel, co, st), plain)
    assert plain["ch"].all() and (plain["rc"][:, 128:, 0] != st["rc"][:, 128:, 0]).any()


def _host_library(src_text, out):
    import ctypes
    import subprocess
    src = out.with_suffix(".cu")
    src.write_text(src_text)
    subprocess.run([_host_compiler(), "-std=c++17", "-O2", "-ffp-contract=off", "-shared",
                    "-fPIC", "-x", "c++", str(src), "-o", str(out)], check=True)
    lib = ctypes.CDLL(str(out))
    lib.sim_batch_run_host.argtypes = [ctypes.c_void_p]
    return lib


# the LRU victim's tie rule, and the planted fault that takes the last index
VICTIM_FIRST = "if (L.rs[u] < oldest) {"
VICTIM_LAST = "if (L.rs[u] <= oldest) {"


def test_host_built_kernel_takes_the_first_lru_victim_on_ties(host_kernel, tmp_path):
    """A full table of tied stamps: the kernel evicts the first entry, as
    the plain tick's argmin does; a planted fault that evicts the last
    entry on ties changes the state."""
    co, st = _tied_rfc_state()
    plain = {k: v.numpy() for k, v in port_batch._run_torch(co, st, "cpu").items()}
    _assert_same_state(_host_run(host_kernel, co, st), plain)
    text = (kernel_build.CSRC / "sim_batch.cu").read_text()
    assert text.count(VICTIM_FIRST) == 1
    planted = _host_library(text.replace(VICTIM_FIRST, VICTIM_LAST), tmp_path / "planted.so")
    with pytest.raises(AssertionError):
        _assert_same_state(_host_run(planted, co, st), plain)


def _tracked_sweep_chunks(monkeypatch):
    """The tracked sweep's chunks on the card: ``chip_smoke.sim_sweep_jobs``
    (the default suite's 14 workloads x the §6 baseline and the 7 designs
    at Table-2 #6 and #7), cut as ``run_batch`` cuts them (256 lanes a chunk
    at most)."""
    import importlib.util
    from pathlib import Path
    # chip_smoke sets this variable for the card, unless it is set; the
    # test's own value is put back after it
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    lanes = []
    for name, cfg in chip_smoke.sim_sweep_jobs():
        w = chip_smoke.sim_workload(name)
        lanes.append(port_batch._Lane(w, cfg, port_batch._encode_plan(w, cfg),
                                      port_batch._occupancy(w, cfg)))
    return [c for c, _ in port_batch._chunk_lanes(lanes, list(range(len(lanes))),
                                                   port_batch._SUB_LANES["cuda"])]


def test_image_size_is_the_kernels_at_the_sweeps_widths(host_kernel, monkeypatch):
    """At the tracked sweep's widths: the host's image reckoning equals the
    kernel's (``sim_batch_image_bytes``) on every route, each section is its
    plane's lane row (``rv`` as float64 times and byte flags, without the
    trash slots; an RFC chunk's key index one int32 a key), the whole image
    fits two CTAs an SM (route ``shared``), and the kernel refuses a struct
    whose image size is not its own."""
    import ctypes
    host_kernel.sim_batch_image_bytes.restype = ctypes.c_longlong
    host_kernel.sim_batch_image_bytes.argtypes = [ctypes.c_void_p, ctypes.c_int]
    chunks = _tracked_sweep_chunks(monkeypatch)
    assert sorted(len(c) for c in chunks) == [2, 28, 54, 112]
    for lanes in chunks:
        co, st = port_batch._build(lanes)
        c, s = _cpu_planes(co, st)
        dims = port_batch._dims(co, st)
        width = kernel_ops.widths(c, s, dims)
        row = {k: v[0].nbytes for k, v in {**co, **st}.items() if np.ndim(v)}
        args = kernel_ops.kernel_args(c, s, dims)
        assert args.route == 0 and args.image_bytes == kernel_ops.image_bytes(width, "shared")
        for i, route in enumerate(kernel_ops.ROUTES):
            assert (host_kernel.sim_batch_image_bytes(ctypes.addressof(args), i)
                    == kernel_ops.image_bytes(width, route))
            sec = kernel_ops.image_sections(width, route)
            for name in ("wf", "cf", "pf", "col", "bd", "act", "res"):
                assert sec[name] == row[name], name
            assert sec["rc_keys"] == sec["rc_stamps"] == row["rc"] // 2
            if route == "shared":
                assert sec["rv_times"] == row["rv"] // 2 and sec["rv_flags"] == row["rv"] // 16
                assert (sec["meta"], sec["ivt"], sec["ivregs"]) == (row["meta"], row["ivt"],
                                                                   row["ivregs"])
            else:
                assert not {"rv_times", "rv_flags", "meta", "ivt", "ivregs"} & set(sec)
        keys = width["W"] * (width["R"] + 1) if width["E"] > 1 else 0   # the RFC key index
        assert kernel_ops.image_sections(width, "shared")["rc_index"] == 4 * keys
        route, nbytes = kernel_ops.plan(width)
        assert route == "shared" and 60_000 < nbytes <= kernel_ops.SHARED_BYTES // 2
    args = kernel_ops.kernel_args(c, s, dims)
    args.image_bytes += 16
    assert host_kernel.sim_batch_run_host(ctypes.addressof(args)) == 1


def test_a_width_too_large_takes_its_named_route_or_raises():
    """Wider than the sweeps: 4,096 pcs, or 512 registers, leave ``rv`` and
    the tables in global memory; warp rows that fit no route raise."""
    co, st = port_batch._build(_lanes(PORT, LANE_KINDS["every_design"]))
    c, s = _cpu_planes(co, st)
    base = kernel_ops.widths(c, s, port_batch._dims(co, st))
    assert base["E"] > 1 and kernel_ops.plan(base)[0] == "shared"
    long_program = dict(base, W=64, P=4096)
    assert kernel_ops.image_bytes(long_program, "shared") > kernel_ops.SHARED_BYTES
    assert kernel_ops.plan(long_program) == (
        "global", kernel_ops.image_bytes(long_program, "global"))
    rvw = 512 + 1 + base["PRS"] + 1
    many_registers = dict(base, W=64, R=512, RVW=rvw, RV1=rvw + 1)
    assert kernel_ops.plan(many_registers)[0] == "global"
    with pytest.raises(ValueError, match="shared memory"):
        kernel_ops.plan(dict(base, W=64, NWF=600))


def test_blocks_take_the_longest_lane_first(host_kernel):
    """``_chunk_lanes`` sorts a chunk's lanes shortest first; the kernel's
    blocks take them from the last, so block 0 onwards run the padding
    lanes (dead, they return at once) and then the lanes longest first."""
    lanes = _lanes(PORT, [(n, "LTRF", 8) for n in port_workloads.workload_names()])
    parts = list(port_batch._chunk_lanes(lanes, list(range(len(lanes))), 256))
    assert len(parts) == 1 and len(parts[0][0]) == len(lanes)
    part = parts[0][0]
    K = port_batch._bucket(len(part), 2)
    order = [host_kernel.sim_batch_lane_of_block(K, b) for b in range(K)]
    assert sorted(order) == list(range(K))
    pad = K - len(part)
    assert pad > 0 and all(k >= len(part) for k in order[:pad])
    hints = [port_batch._length_hint(part[k]) for k in order[pad:]]
    assert hints == sorted(hints, reverse=True) and hints[0] > hints[-1]


def test_host_built_kernel_catches_a_planted_fault(host_kernel):
    """The DRAM queue's interval one cycle longer changes the kernel's state."""
    lanes = _lanes(PORT, CHUNKS["kmeans_ltrf_2w"])
    co, st = port_batch._build(lanes)
    want = _host_run(host_kernel, co, st)
    co["drint"] = co["drint"] + 1.0
    with pytest.raises(AssertionError):
        _assert_same_state(_host_run(host_kernel, co, st), want)
