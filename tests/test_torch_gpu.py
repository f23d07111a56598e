"""The port's Hopper kernels against their plain versions on the card.

Marked ``gpu``: each test skips with a reason where no CUDA card is present
(the decision is made inside the fixture, at run time).  On a machine with an
H100: ``PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py``.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.kernels.flash_attention import attention_ref, flash_attention  # noqa: E402
from repro_torch.kernels.ltrf_matmul import ltrf_matmul, matmul_ref  # noqa: E402
from repro_torch.models import lm  # noqa: E402

pytestmark = pytest.mark.gpu

# stated tolerances: bf16 outputs differ by sum order, at most ~1 bf16 ulp;
# fp32 runs FFMA (not TF32) against torch's full-fp32 product
TOL = {torch.bfloat16: dict(rtol=3e-2, atol=8e-2), torch.float32: dict(rtol=2e-4, atol=1e-4)}
# flash_attention and its plain version both compute in fp32 and round once,
# so in bf16 they differ by at most one ulp (< 8e-3 of the value); its
# outputs are averages over the keys, well below 1, so the atol is small
FLASH_TOL = {torch.bfloat16: dict(rtol=1e-2, atol=1e-3), torch.float32: TOL[torch.float32]}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (sm_90a); run on the H100")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1, 8, 8), (8, 2048, 256), (17, 136, 40), (64, 1024, 96),
                                   (65, 128, 264), (300, 504, 200), (256, 384, 128)])
def test_ltrf_matmul_matches_plain(dev, shape, dtype):
    M, K, N = shape
    g = torch.Generator(dev).manual_seed(0)
    x = torch.randn(M, K, device=dev, generator=g).to(dtype)
    w = (torch.randn(K, N, device=dev, generator=g) / K ** 0.5).to(dtype)
    got = ltrf_matmul(x, w)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), matmul_ref(x, w).float(), **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cfg", [(1, 2, 2, 128, 64, True), (2, 4, 2, 100, 64, True),
                                 (1, 8, 1, 256, 32, True), (1, 2, 1, 77, 128, True),
                                 (1, 2, 2, 130, 32, False)])
def test_flash_attention_matches_plain(dev, cfg, dtype):
    B, H, KV, S, d, causal = cfg
    g = torch.Generator(dev).manual_seed(1)
    q, k, v = (torch.randn(B, n, S, d, device=dev, generator=g).to(dtype) for n in (H, KV, KV))
    got = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), attention_ref(q, k, v, causal).float(),
                               **FLASH_TOL[dtype])


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    x = torch.randn(8, 10, device=dev)             # K not a multiple of 4 floats
    with pytest.raises(ValueError):
        ltrf_matmul(x, torch.randn(10, 16, device=dev))
    with pytest.raises(TypeError):
        ltrf_matmul(x.half(), torch.randn(10, 16, device=dev).half())
    q = torch.randn(1, 2, 16, 48, device=dev)      # head_dim 48 not built
    with pytest.raises(ValueError):
        flash_attention(q, q, q)


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "qwen3-0.6b"])
def test_smoke_model_kernel_path_matches_plain_path(dev, arch):
    cfg = dataclasses.replace(get_smoke(arch), dtype="float32")
    params = lm.init_params(cfg, torch.Generator(dev).manual_seed(0), dev)
    toks = torch.randint(0, cfg.vocab, (2, 40), device=dev,
                         generator=torch.Generator(dev).manual_seed(1))
    batch = {"tokens": toks, "labels": toks}
    before = ltrf_matmul.launches, flash_attention.launches
    got, _ = lm.logits_fn(params, batch, cfg)
    assert ltrf_matmul.launches - before[0] == 7 * cfg.n_layers + 1
    assert flash_attention.launches - before[1] == cfg.n_layers
    want, _ = lm.logits_fn(params, batch, cfg, kernels=False)
    torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-3)
