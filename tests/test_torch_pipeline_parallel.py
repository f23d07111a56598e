"""GPipe schedule of the port == the JAX package's sequential oracle.

Four stages on four gloo ranks, spawned as processes (the test process keeps
no group), with the reference test's stage function (``tanh(x @ w + b)``,
D=16, 6 microbatches x 8) on inputs made with numpy from a seed; rank 0's
outputs are held to ``repro.distributed.pipeline_parallel.sequential_reference``
on the same arrays within 1e-5.  A planted fault (the shift to the next stage
dropped) must fail.  One stage on a one-rank group gives the sequential
oracle's bits.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import torch.distributed as dist  # noqa: E402
from torch.distributed.device_mesh import init_device_mesh  # noqa: E402

from repro.distributed.pipeline_parallel import (  # noqa: E402
    sequential_reference as jax_sequential_reference,
)
from repro_torch.distributed.pipeline_parallel import (  # noqa: E402
    pipeline_forward, sequential_reference,
)
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from test_torch_mesh import run_ranks  # noqa: E402

STAGES, D, N_MICRO, MB = 4, 16, 6, 8


def inputs(seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    return {"w": (rng.standard_normal((STAGES, D, D)) * 0.5).astype(np.float32),
            "b": (np.linspace(-1, 1, STAGES)[:, None] * np.ones((STAGES, D))).astype(np.float32),
            "x": rng.standard_normal((N_MICRO, MB, D)).astype(np.float32)}


def torch_stage(p, x):
    return torch.tanh(x @ p["w"] + p["b"])


def jax_stage(p, x):
    return jnp.tanh(x @ p["w"] + p["b"])


def jax_want(a: dict) -> np.ndarray:
    return np.asarray(jax_sequential_reference(
        jax_stage, {"w": jnp.asarray(a["w"]), "b": jnp.asarray(a["b"])}, jnp.asarray(a["x"])))


SCRIPT = """
import os, sys
import numpy as np, torch, torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.distributed import pipeline_parallel as pp

rank, world, store = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
path, planted = sys.argv[4], sys.argv[5] == "1"
torch.set_num_threads(1)
if planted:     # the shift to the next stage dropped: every stage reads zeros
    pp._shift = lambda y, idx, n, group: torch.zeros_like(y)
dist.init_process_group("gloo", init_method=store, rank=rank, world_size=world)
mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("stage",))
a = np.load(path)
params = {"w": torch.from_numpy(a["w"]), "b": torch.from_numpy(a["b"])}
out = pp.pipeline_forward(lambda p, x: torch.tanh(x @ p["w"] + p["b"]), params,
                          torch.from_numpy(a["x"]), mesh)
if rank == 0:
    np.save(path + ".out.npy", out.numpy())
gathered = [torch.empty_like(out) for _ in range(world)]
dist.all_gather(gathered, out)
assert all(torch.equal(g, out) for g in gathered), "ranks returned different outputs"
dist.barrier()                  # no rank tears its group down while another still talks
dist.destroy_process_group()
sys.stdout.flush()
sys.stderr.flush()
os._exit(0)                     # the work is done: skip the interpreter's teardown
"""


def gpipe(tmp_path, planted=False) -> np.ndarray:
    path = str(tmp_path / "inputs.npz")
    np.savez(path, **inputs())
    run_ranks(SCRIPT, path, "1" if planted else "0", tmp=tmp_path, world=STAGES, timeout=300)
    return np.load(path + ".out.npy")


def test_gpipe_on_four_ranks_matches_jax_sequential(tmp_path):
    np.testing.assert_allclose(gpipe(tmp_path), jax_want(inputs()), rtol=1e-5, atol=1e-5)


def test_gpipe_check_catches_a_dropped_shift(tmp_path):
    assert not np.allclose(gpipe(tmp_path, planted=True), jax_want(inputs()),
                           rtol=1e-5, atol=1e-5)


def test_sequential_reference_matches_jax():
    a = inputs(1)
    got = sequential_reference(torch_stage, {"w": torch.from_numpy(a["w"]),
                                             "b": torch.from_numpy(a["b"])},
                               torch.from_numpy(a["x"]))
    np.testing.assert_allclose(got.numpy(), jax_want(a), rtol=1e-5, atol=1e-5)


def test_one_stage_gives_the_sequential_bits():
    make_host_mesh(device="cpu")
    try:
        mesh = init_device_mesh("cpu", (1,), mesh_dim_names=("stage",))
        a = inputs(2)
        params = {"w": torch.from_numpy(a["w"][:1]), "b": torch.from_numpy(a["b"][:1])}
        x = torch.from_numpy(a["x"])
        assert torch.equal(pipeline_forward(torch_stage, params, x, mesh),
                           sequential_reference(torch_stage, params, x))
    finally:
        dist.destroy_process_group()
