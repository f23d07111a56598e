"""Language model (port of ``repro.models.lm``): dense, ssm and hybrid families.

The math is the JAX package's unrolled path (``_forward_unrolled``): a Python
loop over layers.  Params are a dict whose ``"layers"`` entry is a list of
per-layer dicts (the JAX pytree stacks them on a leading axis; see
``convert.params_from_numpy``).  Every function takes ``kernels`` (default
True): on CUDA tensors the projections, the lm_head product, prefill
attention and the Mamba2 chunked scan then run on the hand-written kernels;
``kernels=False`` is the plain PyTorch path with the same math.

Entry points:
  init_params(cfg, generator, device)            -> params
  loss_fn(params, batch, cfg)                    -> (scalar loss, metrics)
  init_decode_cache(cfg, B, S_max, device)       -> cache dict
  decode_step(params, cache, tokens, cache_len, cfg) -> (logits, cache)
"""
from __future__ import annotations

import math

import torch

from .. import resolve_device
from ..configs.base import ArchConfig
from .layers import (
    _init, attention_block, attention_decode, cross_entropy, embed,
    init_attention, init_embedding, init_mlp, init_rms, matmul, mlp_block,
    rms_norm,
)
from .mamba2 import CONV_K, init_mamba2, mamba2_block, mamba2_decode

PORTED_FAMILIES = ("dense", "ssm", "hybrid")


def _require_ported(cfg: ArchConfig) -> None:
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported to repro_torch yet: ROADMAP "
            "queue 1 item 5 (moe, vlm, audio)")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _init_block(cfg: ArchConfig, gen, dev) -> dict:
    dt = cfg.torch_dtype
    if cfg.family in ("ssm", "hybrid"):
        return {"mixer": init_mamba2(gen, cfg.d_model, cfg.ssm_state, cfg.ssm_headdim,
                                     cfg.ssm_expand, dt, dev),
                "norm": init_rms(cfg.d_model, dev)}
    return {
        "attn": init_attention(gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                               cfg.hd, cfg.qk_norm, dt, dev),
        "norm1": init_rms(cfg.d_model, dev),
        "norm2": init_rms(cfg.d_model, dev),
        "mlp": init_mlp(gen, cfg.d_model, cfg.d_ff, dt, dev),
    }


def init_params(cfg: ArchConfig, generator: torch.Generator | None = None,
                device="cuda") -> dict:
    """Random weights with the JAX package's distributions (normal x scale,
    cast to the model dtype; norms all ones).  The draws differ from JAX's:
    to compare the two, carry JAX's weights across with ``params_from_numpy``.
    ``generator`` must live on ``device`` (default: seed 0 there)."""
    _require_ported(cfg)
    dev = resolve_device(device)
    gen = generator if generator is not None else torch.Generator(dev).manual_seed(0)
    dt = cfg.torch_dtype
    params = {
        "embed": init_embedding(gen, cfg.vocab, cfg.d_model, dt, dev),
        "lm_head": _init(gen, (cfg.d_model, cfg.vocab), 1.0 / math.sqrt(cfg.d_model), dt, dev),
        "layers": [_init_block(cfg, gen, dev) for _ in range(cfg.n_layers)],
        "final_norm": init_rms(cfg.d_model, dev),
    }
    if cfg.family == "hybrid":
        # one shared full transformer block (attention + MLP), re-entrant
        params["shared_attn"] = {
            "attn": init_attention(gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                                   cfg.hd, cfg.qk_norm, dt, dev),
            "mlp": init_mlp(gen, cfg.d_model, cfg.d_ff, dt, dev),
            "norm1": init_rms(cfg.d_model, dev),
            "norm2": init_rms(cfg.d_model, dev),
        }
    return params


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _dense_block(cfg: ArchConfig, p, x, positions, kernels):
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    h = attention_block(p["attn"], h, n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
                        head_dim=cfg.hd, positions=positions,
                        qk_norm=cfg.qk_norm, rope_theta=cfg.rope_theta,
                        norm_eps=cfg.norm_eps, q_block=cfg.q_block,
                        kernels=kernels)
    x = x + h
    h = rms_norm(x, p["norm2"], cfg.norm_eps)
    return x + mlp_block(p["mlp"], h, kernels)


def _ssm_block(cfg: ArchConfig, p, x, kernels):
    h = rms_norm(x, p["norm"], cfg.norm_eps)
    h = mamba2_block(p["mixer"], h, d_state=cfg.ssm_state,
                     headdim=cfg.ssm_headdim, expand=cfg.ssm_expand,
                     chunk=cfg.ssm_chunk, norm_eps=cfg.norm_eps, kernels=kernels)
    return x + h


def _shared_block(cfg: ArchConfig, p, x, positions, kernels):
    # as in the reference, the shared block's attention runs without qk_norm
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    h = attention_block(p["attn"], h, n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
                        head_dim=cfg.hd, positions=positions,
                        rope_theta=cfg.rope_theta, norm_eps=cfg.norm_eps,
                        q_block=cfg.q_block, kernels=kernels)
    x = x + h
    h = rms_norm(x, p["norm2"], cfg.norm_eps)
    return x + mlp_block(p["mlp"], h, kernels)


def forward(params, cfg: ArchConfig, x, positions, kernels: bool = True):
    """Backbone over embedded inputs x: (B, S, D) -> ((B, S, D), aux)."""
    _require_ported(cfg)
    for i, p in enumerate(params["layers"]):
        if cfg.family == "dense":
            x = _dense_block(cfg, p, x, positions, kernels)
            continue
        x = _ssm_block(cfg, p, x, kernels)
        if cfg.family == "hybrid" and (i + 1) % cfg.attn_every == 0:
            x = _shared_block(cfg, params["shared_attn"], x, positions, kernels)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return rms_norm(x, params["final_norm"], cfg.norm_eps), aux


def embed_inputs(params, cfg: ArchConfig, batch):
    """Token embedding.  Returns (x, positions)."""
    _require_ported(cfg)
    x = embed(params["embed"], batch["tokens"])
    B, S = x.shape[:2]
    positions = torch.arange(S, dtype=torch.int32, device=x.device).expand(B, S)
    return x, positions


def logits_fn(params, batch, cfg: ArchConfig, kernels: bool = True):
    """Full-sequence logits (B, S, vocab) and the aux loss."""
    x, positions = embed_inputs(params, cfg, batch)
    h, aux = forward(params, cfg, x, positions, kernels)
    return matmul(h, params["lm_head"], kernels), aux


def loss_fn(params, batch, cfg: ArchConfig, kernels: bool = True):
    """Causal LM loss over the batch.  Returns (loss, metrics)."""
    logits, aux = logits_fn(params, batch, cfg, kernels)
    loss = cross_entropy(logits[:, :-1], batch["labels"][:, 1:])
    return loss + 0.01 * aux, {"loss": loss, "aux_loss": aux}


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def init_decode_cache(cfg: ArchConfig, batch: int, max_len: int, device="cuda") -> dict:
    """Zeroed decode caches.

    dense: (L, B, S_max, kv, hd) K and V.  ssm and hybrid: the conv window
    (L, B, K-1, C) in the model dtype and the SSM state (L, B, H, P, N) in
    fp32; hybrid adds K and V caches for each of the n_layers // attn_every
    call sites of the shared block.  The reference makes the SSM state in the
    model dtype, but its first decode step returns it in fp32; zeros are exact
    in both, and holding fp32 from the start lets the steps update the cache
    in place without rounding it.
    """
    _require_ported(cfg)
    dev = resolve_device(device)
    dt = cfg.torch_dtype
    if cfg.family == "dense":
        kv_dt = getattr(torch, cfg.kv_dtype) if cfg.kv_dtype else dt
        shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.hd)
        return {"k": torch.zeros(shape, dtype=kv_dt, device=dev),
                "v": torch.zeros(shape, dtype=kv_dt, device=dev)}
    d_inner = cfg.ssm_expand * cfg.d_model
    nheads = d_inner // cfg.ssm_headdim
    L = cfg.n_layers
    cache = {
        "conv": torch.zeros((L, batch, CONV_K - 1, d_inner + 2 * cfg.ssm_state),
                            dtype=dt, device=dev),
        "ssm": torch.zeros((L, batch, nheads, cfg.ssm_headdim, cfg.ssm_state),
                           dtype=torch.float32, device=dev),
    }
    if cfg.family == "hybrid":
        shape = (L // cfg.attn_every, batch, max_len, cfg.n_kv_heads, cfg.hd)
        cache["k"] = torch.zeros(shape, dtype=dt, device=dev)
        cache["v"] = torch.zeros(shape, dtype=dt, device=dev)
    return cache


def _attention_decode_block(cfg: ArchConfig, p, x, cache_k, cache_v, cache_len, kernels,
                            qk_norm):
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    h, _, _ = attention_decode(
        p["attn"], h, cache_k, cache_v, cache_len, n_heads=cfg.n_heads,
        n_kv=cfg.n_kv_heads, head_dim=cfg.hd, qk_norm=qk_norm,
        rope_theta=cfg.rope_theta, norm_eps=cfg.norm_eps, kernels=kernels)
    x = x + h
    h = rms_norm(x, p["norm2"], cfg.norm_eps)
    return x + mlp_block(p["mlp"], h, kernels)


def decode_step(params, cache, tokens, cache_len: int, cfg: ArchConfig,
                kernels: bool = True):
    """One-token decode.  tokens: (B, 1) int.  Returns (logits, cache); the
    cache is updated in place.  The ssm family ignores ``cache_len``; the
    hybrid's shared block uses it for its KV caches."""
    _require_ported(cfg)
    x = embed(params["embed"], tokens)
    g = 0  # the hybrid's next shared-block call site
    for i, p in enumerate(params["layers"]):
        if cfg.family == "dense":
            x = _attention_decode_block(cfg, p, x, cache["k"][i], cache["v"][i],
                                        cache_len, kernels, cfg.qk_norm)
            continue
        h = rms_norm(x, p["norm"], cfg.norm_eps)
        h, new = mamba2_decode(p["mixer"], h, {"conv": cache["conv"][i], "ssm": cache["ssm"][i]},
                               d_state=cfg.ssm_state, headdim=cfg.ssm_headdim,
                               expand=cfg.ssm_expand, norm_eps=cfg.norm_eps,
                               kernels=kernels)
        x = x + h
        cache["conv"][i] = new["conv"]
        cache["ssm"][i] = new["ssm"]
        if (cfg.family == "hybrid" and (i + 1) % cfg.attn_every == 0
                and g < cache["k"].shape[0]):
            # the shared block, as in the reference, without qk_norm
            x = _attention_decode_block(cfg, params["shared_attn"], x, cache["k"][g],
                                        cache["v"][g], cache_len, kernels, False)
            g += 1
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return matmul(x, params["lm_head"], kernels), cache
