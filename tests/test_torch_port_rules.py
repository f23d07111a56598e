"""Rules the PyTorch port keeps: it imports neither jax nor the JAX package
(nor ``ml_dtypes``, which the card's machine does not have),
its entry points default to the CUDA card (and raise without one), and its
kernel wrappers take their plain path only for CPU tensors."""
import ast
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.kernels.flash_attention import attention_ref, flash_attention  # noqa: E402
from repro_torch.kernels.ltrf_matmul import ltrf_matmul, matmul_ref  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_chunk, ssd_chunk_ref, ssd_scan  # noqa: E402
from repro_torch.launch.serve import serve  # noqa: E402
from repro_torch.models.lm import init_decode_cache, init_params  # noqa: E402
from repro_torch.serving import ServingEngine  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            roots.add(str(node.args[0].value).split(".")[0])
    return roots


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_repro(path):
    bad = _imported_roots(path) & {"jax", "jaxlib", "repro", "flax", "optax", "ml_dtypes"}
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_port_has_no_silent_cpu_fallback():
    for path in PORT_FILES:
        assert "is_available() else" not in path.read_text(), path


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("entry", ["engine", "init_params", "decode_cache", "serve"])
def test_cuda_default_entry_points_raise_without_card(no_card, entry):
    cfg = get_smoke("tinyllama-1.1b")
    calls = {
        "engine": lambda: ServingEngine(cfg),
        "init_params": lambda: init_params(cfg),
        "decode_cache": lambda: init_decode_cache(cfg, 2, 8),
        "serve": lambda: serve("tinyllama-1.1b"),
    }
    with pytest.raises(RuntimeError, match="no CUDA card"):
        calls[entry]()


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "zamba2-1.2b"])
@pytest.mark.parametrize("entry", ["engine", "init_params", "decode_cache", "serve"])
def test_ssm_family_entry_points_raise_without_card(no_card, entry, arch):
    cfg = get_smoke(arch)
    calls = {
        "engine": lambda: ServingEngine(cfg),
        "init_params": lambda: init_params(cfg),
        "decode_cache": lambda: init_decode_cache(cfg, 2, 8),
        "serve": lambda: serve(arch),
    }
    with pytest.raises(RuntimeError, match="no CUDA card"):
        calls[entry]()


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "dbrx-132b", "musicgen-large",
                                  "llava-next-34b", "phi3-medium-14b", "granite-20b"])
@pytest.mark.parametrize("entry", ["engine", "init_params", "decode_cache", "serve"])
def test_new_family_entry_points_raise_without_card(no_card, entry, arch):
    cfg = get_smoke(arch)
    calls = {
        "engine": lambda: ServingEngine(cfg),
        "init_params": lambda: init_params(cfg),
        "decode_cache": lambda: init_decode_cache(cfg, 2, 8),
        "serve": lambda: serve(arch),
    }
    with pytest.raises(RuntimeError, match="no CUDA card"):
        calls[entry]()


def test_port_has_no_unported_family_guard():
    """Every family runs: nothing in the port raises NotImplementedError."""
    for path in PORT_FILES:
        assert "NotImplementedError" not in path.read_text(), path


def test_wrappers_take_plain_path_only_for_cpu_tensors():
    x, w = torch.randn(8, 16), torch.randn(16, 24)
    torch.testing.assert_close(ltrf_matmul(x, w), matmul_ref(x, w), rtol=0, atol=0)
    q, k = torch.randn(1, 4, 10, 32), torch.randn(1, 2, 10, 32)
    torch.testing.assert_close(flash_attention(q, k, k), attention_ref(q, k, k), rtol=0, atol=0)
    ssd_in = (torch.randn(1, 20, 2, 4), torch.rand(1, 20, 2), -torch.rand(2),
              torch.randn(1, 20, 8), torch.randn(1, 20, 8))
    for got, want in zip(ssd_chunk(*ssd_in, chunk=8), ssd_chunk_ref(*ssd_in, chunk=8)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    before = (ltrf_matmul.launches, flash_attention.launches, ssd_scan.launches)
    # a tensor that is not on the CPU never reaches the plain version
    for args in [(x.to("meta"), w.to("meta")), (x, w.to("meta"))]:
        with pytest.raises(ValueError):
            ltrf_matmul(*args)
    with pytest.raises(ValueError):
        flash_attention(q.to("meta"), k.to("meta"), k.to("meta"))
    with pytest.raises(ValueError):
        flash_attention(q, k, k.to("meta"))
    for args in [[t.to("meta") for t in ssd_in], [*ssd_in[:4], ssd_in[4].to("meta")]]:
        with pytest.raises(ValueError):
            ssd_scan(*args, chunk=8)
    assert (ltrf_matmul.launches, flash_attention.launches, ssd_scan.launches) == before


@pytest.mark.parametrize("entry", ["run_batch", "simulate_batch", "simulate_one"])
def test_sim_batch_entry_points_raise_without_card(no_card, entry):
    """The batch simulator defaults to the card like every entry point."""
    from repro_torch.sim import design_config, run_batch, simulate_batch, simulate_one
    from repro_torch.workloads import get_workload
    w, cfg = get_workload("kmeans"), design_config("LTRF", table2_config=7, num_warps=2)
    calls = {
        "run_batch": lambda: run_batch([(w, cfg)]),
        "simulate_batch": lambda: simulate_batch([(w, cfg)]),
        "simulate_one": lambda: simulate_one(w, cfg),
    }
    with pytest.raises(RuntimeError, match="no CUDA card"):
        calls[entry]()
