"""The yardstick: product shapes against the configuration's parameter
count, attention over the cached positions only, bytes that count each
operand once, and a roofline that refuses to pass 100 %."""
import dataclasses

import pytest

from perfbench import harness, readers, workcount

CONFIGS = {c["name"]: harness.load_json(harness.ROOT / c["file"])["arch"]
           for c in harness.benchmark()["configs"]}
# the port's full-size models of the families the yardstick also counts
FAMILIES = ["zamba2-1.2b", "mamba2-1.3b", "tinyllama-1.1b"]


def _arch(name: str) -> dict:
    if name in CONFIGS:
        return CONFIGS[name]
    from repro_torch.configs import get_arch
    return dataclasses.asdict(get_arch(name))


def _program_products(a: dict) -> int:
    """The weights in products by the program's own analytic count: its
    parameters less the embedding, norms and Mamba2's vectors and conv, the
    experts counted top_k times, the shared block once per call site."""
    from repro_torch.configs.base import ArchConfig
    cfg = ArchConfig(**a)
    D, V, L = cfg.d_model, cfg.vocab, cfg.n_layers
    if cfg.family == "moe":
        return cfg.active_param_count() - V * D - L * 2 * D
    if cfg.family == "dense":
        return cfg.param_count() - V * D - L * 2 * D - D
    di, N = cfg.ssm_expand * D, cfg.ssm_state
    nh = di // cfg.ssm_headdim
    n = cfg.param_count() - V * D - L * (4 * (di + 2 * N) + 3 * nh + di + D) - D
    if cfg.family == "ssm":
        return n
    shared = D * cfg.n_heads * cfg.hd + 2 * D * cfg.n_kv_heads * cfg.hd + cfg.n_heads * cfg.hd * D \
        + 3 * D * cfg.d_ff
    return n - 2 * D + (L // cfg.attn_every - 1) * shared


@pytest.mark.parametrize("name", sorted(CONFIGS) + FAMILIES)
def test_products_sum_to_the_weights_a_token_uses(name):
    a = _arch(name)
    n = workcount.params_per_token(a)
    assert n == _program_products(a)
    assert workcount.decode_step_flops(a, 1, 0) == pytest.approx(
        2 * n + workcount.attention_flops(a, 1))


@pytest.mark.parametrize("name", sorted(CONFIGS) + FAMILIES)
def test_decode_attention_counts_positions_up_to_cache_len(name):
    a = _arch(name)
    f = [workcount.decode_step_flops(a, 64, n) for n in (0, 1, 10, 1023)]
    per_position = f[1] - f[0]
    assert per_position == workcount.attention_flops(a, 64)
    assert (per_position > 0) == (workcount.attention_sites(a) > 0)
    assert f[2] - f[0] == pytest.approx(10 * per_position)
    assert f[3] - f[0] == pytest.approx(1023 * per_position)
    assert f[0] == pytest.approx(2 * 64 * workcount.params_per_token(a) + per_position)


def test_matmul_bytes_count_each_operand_once():
    flops, nbytes = workcount.matmul_work(64, 1536, 512)
    assert flops == 2 * 64 * 1536 * 512
    assert nbytes == 2 * (64 * 1536 + 1536 * 512 + 64 * 512)


def test_decode_launches_count_each_block_product_and_the_head():
    a = CONFIGS["granite-moe-3b-a800m"]
    _, launches = workcount.ltrf_bound_s(a, 64)
    # four attention projections a layer and the head (the experts run on bmm)
    assert launches == 4 * a["n_layers"] + 1 == 129


def test_roofline_share_over_100_percent_raises():
    rec = {"trace": {"spans": [("ltrf_matmul_decode", 1e-3), ("other", 5.0)]}}
    assert readers.roofline(rec, "ltrf_matmul", 0.5e-3, 1) == pytest.approx(50.0)
    with pytest.raises(RuntimeError, match="exceeds"):
        readers.roofline(rec, "ltrf_matmul", 2e-3, 1)
    assert readers.roofline({"trace": {"spans": []}}, "ltrf_matmul", 1e-3, 1) is None
