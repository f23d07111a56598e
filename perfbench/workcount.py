"""The yardstick: operations and bytes of the model's work, from shapes alone.

Peaks are the NVIDIA H100 SXM data sheet's: 989 TFLOP/s dense bf16 on the
tensor cores and 3.35 TB/s of HBM.  A kernel's bound is the larger of its
operations over the first and its bytes over the second.  Bytes count each
input read once and each output written once (bf16 products: 2 bytes an
element), whatever a kernel reads again.  Every bound is taken against the
bf16 peak, so no implementation can read above 100 % of it.

``ltrf_products`` lists the products the program runs on ``ltrf_matmul``
(the attention and MLP projections, the Mamba2 in/out projections and the
head, held at a width that is a multiple of 64); ``model_products`` lists
every parameter product a token's forward uses, the experts it is routed
to and the router included, at the true vocabulary: the base of ``mfu``.
"""
from __future__ import annotations

PEAK_FLOPS = 989e12            # bf16 dense, tensor cores
HBM_BYTES_PER_S = 3.35e12


def head_dim(a: dict) -> int:
    return a.get("head_dim") or a["d_model"] // a["n_heads"]


def held_width(n: int) -> int:
    return -(-n // 64) * 64


def attention_sites(a: dict) -> int:
    """Attention layers a token passes (the hybrid's shared block once per
    call site)."""
    if a["family"] == "hybrid":
        return a["n_layers"] // a["attn_every"]
    return 0 if a["family"] == "ssm" else a["n_layers"]


def _attn(a: dict) -> list:
    D, H, KV, hd = a["d_model"], a["n_heads"], a["n_kv_heads"], head_dim(a)
    return [("wq", D, H * hd), ("wk", D, KV * hd), ("wv", D, KV * hd), ("wo", H * hd, D)]


def _mlp(a: dict) -> list:
    D, F = a["d_model"], a["d_ff"]
    return [("w_gate", D, F), ("w_up", D, F), ("w_down", F, D)]


def _mamba(a: dict) -> list:
    D, N, P = a["d_model"], a["ssm_state"], a["ssm_headdim"]
    di = a["ssm_expand"] * D
    return [("in_proj", D, 2 * di + 2 * N + di // P), ("out_proj", di, D)]


def _products(a: dict, experts: bool, head: int) -> list:
    """[(name, K, N, count)] of one token's forward."""
    L = a["n_layers"]
    out = []
    if a["family"] in ("ssm", "hybrid"):
        out += [(n, k, m, L) for n, k, m in _mamba(a)]
        sites = attention_sites(a)
        if sites:
            out += [(n, k, m, sites) for n, k, m in _attn(a) + _mlp(a)]
    else:
        out += [(n, k, m, L) for n, k, m in _attn(a)]
        if a["family"] == "moe":
            if experts:
                D, E, F = a["d_model"], a["n_experts"], a["d_ff"]
                out += [("router", D, E, L)]
                out += [(n, k, m, L * a["top_k"]) for n, k, m in _mlp(a)]
        else:
            out += [(n, k, m, L) for n, k, m in _mlp(a)]
    return out + [("head", a["d_model"], head, 1)]


def ltrf_products(a: dict) -> list:
    return _products(a, experts=False, head=held_width(a["vocab"]))


def model_products(a: dict) -> list:
    return _products(a, experts=True, head=a["vocab"])


def params_per_token(a: dict) -> int:
    """Weights a token's forward multiplies by (each use counted)."""
    return sum(k * n * c for _, k, n, c in model_products(a))


def matmul_work(M: int, K: int, N: int, elem: int = 2) -> tuple[float, float]:
    """(flops, bytes) of an (M, K) x (K, N) product."""
    return 2.0 * M * K * N, float(elem * (M * K + K * N + M * N))


def bound_s(flops: float, nbytes: float) -> float:
    return max(flops / PEAK_FLOPS, nbytes / HBM_BYTES_PER_S)


def ltrf_bound_s(a: dict, M: int) -> tuple[float, int]:
    """(seconds, launches) of the ltrf_matmul work of one forward step at
    M token rows."""
    total, launches = 0.0, 0
    for _, K, N, c in ltrf_products(a):
        total += c * bound_s(*matmul_work(M, K, N))
        launches += c
    return total, launches


def attention_flops(a: dict, pairs: float) -> float:
    """QK^T and PV over ``pairs`` (query, key) pairs at every attention site."""
    sites = attention_sites(a)
    return 4.0 * a["n_heads"] * head_dim(a) * pairs * sites if sites else 0.0


def decode_step_flops(a: dict, slots: int, cache_len: int) -> float:
    """Model FLOPs of one decode step: every slot's products, and its
    attention over the positions up to and including ``cache_len``."""
    return (2.0 * slots * params_per_token(a)
            + attention_flops(a, slots * (cache_len + 1)))
