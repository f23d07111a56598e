"""The frozen plain reference held to the program's plain path at smoke
size on the CPU, both run in float32: decode logits step by step, and a
whole serving run through the driver."""
import dataclasses
import time

import pytest
import torch

from perfbench import harness, weights
from perfbench.reference import model as ref
from perfbench.tests.conftest import SMOKE_ARCH, SMOKE_SECONDS, smoke


# the port's smoke models of the other families the reference decodes
FAMILIES = ["zamba2-1.2b", "mamba2-1.3b", "tinyllama-1.1b"]


def _smoke_arch(name: str) -> dict:
    if name in SMOKE_ARCH:
        return {**harness.load_json(harness.HERE / "configs" / f"{name}.json")["arch"],
                **SMOKE_ARCH[name]}
    from repro_torch.configs import get_smoke
    return dataclasses.asdict(get_smoke(name))


@pytest.mark.parametrize("name", sorted(SMOKE_ARCH) + FAMILIES)
def test_decode_matches_the_program_in_fp32(name):
    from repro_torch.configs.base import ArchConfig
    from repro_torch.models.lm import decode_step, init_decode_cache
    a = {**_smoke_arch(name), "dtype": "float32"}
    cfg = ArchConfig(**a)
    p = weights.make(a, 3, "cpu")
    B, L = 6, 16
    cache = init_decode_cache(cfg, B, L, "cpu")
    dec = ref.Decoder(a, p, B, L, ref.Precision("fp32"))
    toks = torch.randint(0, a["vocab"], (B, 1), generator=torch.Generator().manual_seed(1))
    for n in range(24):
        got, cache = decode_step(p, cache, toks, min(n, L - 1), cfg, kernels=False)
        want = dec.step(toks[:, 0], min(n, L - 1))
        assert torch.allclose(got[:, 0], want, rtol=1e-4, atol=1e-4), n
        toks = got[:, -1].argmax(-1)[:, None]


@pytest.mark.parametrize("workload", [w["name"] for w in harness.benchmark()["workloads"]])
def test_serving_run_in_fp32_serves_the_reference_tokens(workload):
    sizes = smoke(workload)
    sizes = {**sizes, "arch": {**sizes["arch"], "dtype": "float32"}}
    r, rec = harness.run_cell(workload, 2**31 + 3, SMOKE_SECONDS, False, "cpu",
                              time.perf_counter(), sizes=sizes)
    stats = rec["gap_stats"]
    assert stats["not_first_pct"] == 0 and stats["max_logit_gap"] < 1e-4, stats
    assert r["correct"], r["checks"]


def test_reference_imports_nothing_of_the_program():
    src = (harness.HERE / "reference" / "model.py").read_text()
    assert "repro" not in src and "jax" not in src


def test_control_is_float8():
    x = torch.randn(8, 32)
    w = torch.randn(32, 16)
    exact = x @ w
    coarse = ref.Precision("fp8").mm(x, w)
    err = ((coarse - exact).norm() / exact.norm()).item()
    assert 1e-3 < err < 0.2
