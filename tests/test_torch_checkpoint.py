"""Checkpoints and the fault-tolerant trainer of the port.

A checkpoint written by the port restores through the JAX package's
``Checkpointer.restore`` into the reference's ``make_train_state`` template,
and one written by the JAX package restores into the port's: both leaf for
leaf equal, bf16 leaves (stored as raw uint16 bits), the padded head (held
padded by the port, stored at the config's width) and the int32 step
included.  The port's ``train`` with injected failures replays to
bit-identical parameters (the port's analogue of
``tests/test_runtime.py:119-136``, which fails in the reference under jax
0.9).  Each check has a planted fault that must fail it.
"""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import ml_dtypes  # noqa: E402

from repro.checkpoint import Checkpointer as JaxCheckpointer  # noqa: E402
from repro.runtime import train_step as JT  # noqa: E402
from repro_torch.checkpoint import Checkpointer, ckpt  # noqa: E402
from repro_torch.configs import get_smoke, smoke_shape  # noqa: E402
from repro_torch.data import PrefetchingLoader  # noqa: E402
from repro_torch.distributed import FaultConfig, FaultTolerantTrainer  # noqa: E402
from repro_torch.launch.train import train  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models.convert import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.optim import CompressionConfig  # noqa: E402
from repro_torch.runtime import train_step as TT  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402
from test_torch_train_step import configs, flat, np_batch, params  # noqa: E402

# (arch, vocab): a dense model with a head that is held padded (253 -> 256),
# an MoE model, the hybrid (nested shared block) and audio ((K, V, D) table)
CASES = [("tinyllama-1.1b", 253), ("granite-moe-3b-a800m", None), ("zamba2-1.2b", None),
         ("musicgen-large", None)]


def case_configs(arch, vocab, dtype="bfloat16"):
    jcfg, tcfg = configs(arch, dtype)
    if vocab:
        jcfg, tcfg = (dataclasses.replace(c, vocab=vocab) for c in (jcfg, tcfg))
    return jcfg, tcfg


def port_state(arch, vocab, compress=False):
    """A port train state after one step (non-zero moments), and its config."""
    jcfg, tcfg = case_configs(arch, vocab)
    _, tp = params(jcfg, tcfg)
    state = {"params": tp, "opt": TT.make_train_state(tcfg, torch.Generator(), "cpu")["opt"]}
    step = TT.build_train_step(tcfg, compression=CompressionConfig() if compress else None)
    state, _ = step(state, np_batch(tcfg))
    return jcfg, tcfg, state


def host_leaves(state, tcfg):
    """The port state in the JAX layout, as sorted (path, float32) leaves."""
    return flat(ckpt._to_host(state, tcfg))


def jax_leaves(tree):
    return flat(jax.tree.map(np.asarray, tree))


@pytest.mark.parametrize("compress", [False, True])
@pytest.mark.parametrize("arch,vocab", CASES)
def test_port_checkpoint_restores_in_jax(tmp_path, arch, vocab, compress):
    jcfg, tcfg, state = port_state(arch, vocab, compress)
    Checkpointer(tmp_path, tcfg).save(1, state)
    like, _ = JT.make_train_state(jcfg, jax.random.PRNGKey(1))
    if compress:
        like["err"] = jax.tree.map(lambda p: np.zeros(p.shape, np.float32), like["params"])
    got = JaxCheckpointer(tmp_path).restore(1, like)
    assert jax.tree.structure(got) == jax.tree.structure(like)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(like)):
        assert a.shape == b.shape and a.dtype == b.dtype
    want = host_leaves(state, tcfg)
    assert [p for p, _ in jax_leaves(got)] == [p for p, _ in want]
    for (p, a), (_, b) in zip(jax_leaves(got), want):
        np.testing.assert_array_equal(a, b, err_msg=p)
    assert int(got["opt"]["step"]) == 1 and got["opt"]["step"].dtype == np.int32


@pytest.mark.parametrize("arch,vocab", CASES)
def test_jax_checkpoint_restores_in_port(tmp_path, arch, vocab):
    jcfg, tcfg = case_configs(arch, vocab)
    jstate, _ = JT.make_train_state(jcfg, jax.random.PRNGKey(2))
    rng = np.random.default_rng(0)
    for k in ("mu", "nu"):   # non-zero moments, as after some steps
        jstate["opt"][k] = jax.tree.map(
            lambda p: rng.standard_normal(p.shape).astype(np.float32), jstate["params"])
    jstate["opt"]["step"] = np.int32(7)
    JaxCheckpointer(tmp_path).save(7, jstate)
    like = TT.make_train_state(tcfg, torch.Generator().manual_seed(5), "cpu")
    got = Checkpointer(tmp_path, tcfg).restore(7, like)
    host = jax.tree.map(np.asarray, jstate)
    want = {"params": params_from_numpy(host["params"], tcfg, "cpu"),
            "opt": {"mu": params_from_numpy(host["opt"]["mu"], tcfg, "cpu"),
                    "nu": params_from_numpy(host["opt"]["nu"], tcfg, "cpu"),
                    "step": torch.tensor(7, dtype=torch.int32)}}

    def same(a, b, t):       # dict entries matched by key
        assert a.shape == t.shape and a.dtype == t.dtype
        assert torch.equal(a, b)

    tree_map(same, got, want, like)
    # the padding of a held head is zero in the restored params and moments
    if vocab:
        for tree in (got["params"], got["opt"]["mu"], got["opt"]["nu"]):
            assert not tree["lm_head"][:, vocab:].any()


def test_checkpoint_writes_jax_paths_and_raw_bf16(tmp_path):
    _, tcfg, state = port_state("tinyllama-1.1b", 253)
    path = Checkpointer(tmp_path, tcfg).save(3, state)
    leaves = json.loads((path / "manifest.json").read_text())["leaves"]
    by_path = {m["path"]: m for m in leaves}
    wq = by_path["['opt']['mu']['layers']['attn']['wq']"]
    assert wq["dtype"] == "float32" and wq["shape"] == [tcfg.n_layers, 64, 64]
    head = by_path["['params']['lm_head']"]
    assert head["dtype"] == "bfloat16" and head["shape"] == [64, 253]
    assert by_path["['opt']['step']"]["shape"] == [] and by_path["['opt']['step']"][
        "dtype"] == "int32"
    with np.load(path / "arrays.npz") as data:
        bits = data[head["key"]]
    assert bits.dtype == np.uint16
    want = state["params"]["lm_head"][:, :253].float().numpy()
    np.testing.assert_array_equal(bits.view(ml_dtypes.bfloat16).astype(np.float32), want)
    assert [m["path"] for m in leaves] == sorted(m["path"] for m in leaves)


def _unsorted_flatten(tree, prefix=""):
    if isinstance(tree, dict):
        for k in tree:
            yield from _unsorted_flatten(tree[k], f"{prefix}[{k!r}]")
    else:
        yield prefix, tree


def _head_not_cut(params, cfg):
    out = real_params_to_numpy(params, cfg)
    out["lm_head"] = convert.to_host(params["lm_head"])
    return out


real_params_to_numpy = params_to_numpy


@pytest.mark.parametrize("fault", ["insertion_order", "head_not_cut"])
def test_checkpoint_check_catches_planted_faults(tmp_path, monkeypatch, fault):
    jcfg, tcfg, state = port_state("tinyllama-1.1b", 253)
    if fault == "insertion_order":
        monkeypatch.setattr(ckpt, "_flatten", _unsorted_flatten)
    else:
        monkeypatch.setattr(ckpt, "params_to_numpy", _head_not_cut)
    Checkpointer(tmp_path, tcfg).save(1, state)
    like, _ = JT.make_train_state(jcfg, jax.random.PRNGKey(1))
    with pytest.raises((ValueError, AssertionError)):
        got = JaxCheckpointer(tmp_path).restore(1, like)
        for (_, a), (_, b) in zip(jax_leaves(got), host_leaves(state, tcfg)):
            np.testing.assert_array_equal(a, b)


def test_port_round_trip_async_and_gc(tmp_path):
    _, tcfg, state = port_state("tinyllama-1.1b", 253)
    ck = Checkpointer(tmp_path, tcfg, keep=2)
    for s in (1, 2, 3):
        ck.save_async(s, state)
    ck.wait()
    assert ck.all_steps() == [2, 3] and ck.latest_step() == 3
    meta = tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta"), state)
    got = ck.restore(3, meta, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(got), tree_leaves(state)))
    assert list(got["params"]) == list(state["params"])        # the like-tree's key order
    assert ck.timings["write_s"] > 0 and ck.timings["restore_s"] > 0
    with pytest.raises(ValueError, match="meta"):
        ck.restore(3, meta)


def test_port_restore_detects_corruption_and_mismatch(tmp_path):
    _, tcfg, state = port_state("tinyllama-1.1b", None)
    ck = Checkpointer(tmp_path, tcfg)
    path = ck.save(1, state)
    other = TT.make_train_state(dataclasses.replace(tcfg, vocab=128),
                                torch.Generator(), "cpu")
    with pytest.raises(ValueError):
        ck.restore(1, other)
    shallow = TT.make_train_state(dataclasses.replace(tcfg, n_layers=1), torch.Generator(), "cpu")
    with pytest.raises(ValueError, match="layers"):
        ck.restore(1, shallow)
    with np.load(path / "arrays.npz") as data:
        arrays = {k: np.array(data[k]) for k in data.files}
    arrays["a0"] = arrays["a0"] + 1
    np.savez(path / "arrays.npz", **arrays)
    with pytest.raises(IOError):
        ck.restore(1, state)


# ---------------------------------------------------------------------------
# the fault-tolerant trainer
# ---------------------------------------------------------------------------

def _train(tmp_path, name, **kw):
    return train("tinyllama-1.1b", steps=12, batch=4, seq=32, ckpt_dir=str(tmp_path / name),
                 ckpt_every=5, device="cpu", **kw)


def test_fault_tolerant_training_replays_exactly(tmp_path):
    a = _train(tmp_path, "a")
    b = _train(tmp_path, "b", inject_failures={7: 1, 9: 1})
    assert b["restarts"] == 2 and a["restarts"] == 0
    assert a["final_step"] == b["final_step"] == 12
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(a["state"]["params"]),
                                                 tree_leaves(b["state"]["params"])))
    assert a["losses"][-1] == b["losses"][-1] and np.isfinite(a["losses"]).all()


def test_replay_check_catches_a_stream_not_repositioned(tmp_path, monkeypatch):
    a = _train(tmp_path, "a")
    monkeypatch.setattr(PrefetchingLoader, "restore", lambda self, step: None)
    b = _train(tmp_path, "b", inject_failures={7: 1, 9: 1})
    assert not all(torch.equal(x, y) for x, y in zip(tree_leaves(a["state"]["params"]),
                                                     tree_leaves(b["state"]["params"])))


def test_training_resumes_from_its_last_checkpoint(tmp_path):
    a = _train(tmp_path, "a")
    first = train("tinyllama-1.1b", steps=6, batch=4, seq=32, ckpt_dir=str(tmp_path / "b"),
                  ckpt_every=5, device="cpu")
    rest = _train(tmp_path, "b")
    assert first["final_step"] == 6 and rest["final_step"] == 12 and len(rest["losses"]) == 6
    assert rest["losses"] == a["losses"][6:]


def test_compressed_training_stays_finite(tmp_path):
    a = _train(tmp_path, "c0")
    b = _train(tmp_path, "c1", compress=True)
    assert np.isfinite(b["losses"]).all()
    assert abs(a["losses"][-1] - b["losses"][-1]) < 0.5


def test_fault_trainer_gives_up_after_retries(tmp_path):
    cfg = get_smoke("tinyllama-1.1b")

    def bad_step(state, batch):
        raise RuntimeError("always broken")

    loader = PrefetchingLoader(cfg, smoke_shape())
    try:
        tr = FaultTolerantTrainer(step_fn=bad_step, checkpointer=Checkpointer(tmp_path, cfg),
                                  loader=loader, cfg=FaultConfig(max_retries=2))
        state = TT.make_train_state(cfg, torch.Generator(), "cpu")
        with pytest.raises(RuntimeError, match="always broken"):
            tr.run(state, 5)
        assert tr.restarts == 3
    finally:
        loader.close()


def test_train_on_cuda_without_a_card_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        train("tinyllama-1.1b", steps=1, ckpt_dir=str(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA card"):
        TT.make_train_state(get_smoke("tinyllama-1.1b"))


def test_train_without_a_ckpt_dir_starts_afresh_and_cleans_up(tmp_path, monkeypatch):
    """Two runs without ``ckpt_dir`` each run every step (neither resumes the
    other's checkpoints) and leave nothing in the temporary directory; a
    shared default directory would make the second resume at the end."""
    import tempfile
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    kw = dict(steps=6, batch=4, seq=32, ckpt_every=5, device="cpu")
    a = train("tinyllama-1.1b", **kw)
    b = train("tinyllama-1.1b", **kw)
    assert a["final_step"] == b["final_step"] == 6
    assert len(a["losses"]) == len(b["losses"]) == 6 and a["losses"] == b["losses"]
    assert a["ckpt_timings"] and not list(tmp_path.iterdir())


def test_train_cleans_up_in_a_fresh_process():
    """The test above in a process of its own, where nothing has imported
    ``torch._dynamo`` before ``train`` runs: neither ``param_shapes`` nor the
    mesh's DTensors may leave a ``torchinductor_<user>`` directory in the
    temporary directory."""
    import os
    import subprocess
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    env = {k: v for k, v in os.environ.items() if k != "TORCHINDUCTOR_CACHE_DIR"}
    env["PYTHONPATH"] = os.pathsep.join([str(root / "src"), env.get("PYTHONPATH", "")])
    name = "tests/test_torch_checkpoint.py::test_train_without_a_ckpt_dir_starts_afresh_and_cleans_up"
    run = subprocess.run([sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider", name],
                         cwd=root, env=env, capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stdout[-4000:] + run.stderr[-2000:]
    assert "1 passed" in run.stdout


def test_train_puts_the_inductor_cache_variable_back(tmp_path, monkeypatch):
    """``train`` keeps torch's inductor cache out of the temporary directory
    for its run only: the variable is set during the run unless the caller
    set it, and is as it was after."""
    import os
    from repro_torch.launch import train as T
    key = "TORCHINDUCTOR_CACHE_DIR"
    monkeypatch.delenv(key, raising=False)
    with T._inductor_cache(tmp_path / "a"):
        assert os.environ[key] == str(tmp_path / "a")
    assert key not in os.environ
    monkeypatch.setenv(key, str(tmp_path / "mine"))
    with T._inductor_cache(tmp_path / "a"):
        assert os.environ[key] == str(tmp_path / "mine")
    assert os.environ[key] == str(tmp_path / "mine")


def test_param_shapes_imports_no_dynamo():
    """``param_shapes`` makes its meta tensors without drawing (a draw or a
    stack on meta imports ``torch._dynamo``), for every family, in a fresh
    process."""
    import os
    import subprocess
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    env = {**os.environ,
           "PYTHONPATH": os.pathsep.join([str(root / "src"), os.environ.get("PYTHONPATH", "")])}
    code = ("import sys\n"
            "from repro_torch.configs import ARCH_IDS, get_arch\n"
            "from repro_torch.models.lm import param_shapes\n"
            "for a in ARCH_IDS:\n"
            "    param_shapes(get_arch(a))\n"
            "print('torch._dynamo' in sys.modules)\n")
    run = subprocess.run([sys.executable, "-c", code], cwd=root, env=env, capture_output=True,
                         text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-2000:]
    assert run.stdout.strip() == "False"


def test_train_main_reports_a_run_of_no_steps(tmp_path, monkeypatch, capsys):
    """``main`` after a run that resumed at its last step (no losses)."""
    import sys
    from repro_torch.launch import train as launch_train
    argv = ["train", "--steps", "5", "--batch", "2", "--seq", "16", "--device", "cpu",
            "--ckpt-dir", str(tmp_path)]
    monkeypatch.setattr(sys, "argv", argv)
    launch_train.main()
    launch_train.main()
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("steps=5 loss[0]=") and out[1].startswith("steps=5 no steps run")
