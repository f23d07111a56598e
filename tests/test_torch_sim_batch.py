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
