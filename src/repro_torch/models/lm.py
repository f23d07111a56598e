"""Language model (port of ``repro.models.lm``), dense family.

The math is the JAX package's unrolled path (``_forward_unrolled``): a Python
loop over layers.  Params are a dict whose ``"layers"`` entry is a list of
per-layer dicts (the JAX pytree stacks them on a leading axis; see
``convert.params_from_numpy``).  Every function takes ``kernels`` (default
True): on CUDA tensors the projections, the lm_head product and prefill
attention then run on the hand-written kernels; ``kernels=False`` is the
plain PyTorch path with the same math.

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


def _require_dense(cfg: ArchConfig) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported to repro_torch yet: ROADMAP "
            "queue 1 items 4 (ssm, hybrid) and 5 (moe, vlm, audio)")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_params(cfg: ArchConfig, generator: torch.Generator | None = None,
                device="cuda") -> dict:
    """Random weights with the JAX package's distributions (normal x scale,
    cast to the model dtype; norms all ones).  The draws differ from JAX's:
    to compare the two, carry JAX's weights across with ``params_from_numpy``.
    ``generator`` must live on ``device`` (default: seed 0 there)."""
    _require_dense(cfg)
    dev = resolve_device(device)
    gen = generator if generator is not None else torch.Generator(dev).manual_seed(0)
    dt = cfg.torch_dtype
    params = {
        "embed": init_embedding(gen, cfg.vocab, cfg.d_model, dt, dev),
        "lm_head": _init(gen, (cfg.d_model, cfg.vocab), 1.0 / math.sqrt(cfg.d_model), dt, dev),
        "layers": [],
        "final_norm": init_rms(cfg.d_model, dev),
    }
    for _ in range(cfg.n_layers):
        params["layers"].append({
            "attn": init_attention(gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                                   cfg.hd, cfg.qk_norm, dt, dev),
            "norm1": init_rms(cfg.d_model, dev),
            "norm2": init_rms(cfg.d_model, dev),
            "mlp": init_mlp(gen, cfg.d_model, cfg.d_ff, dt, dev),
        })
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


def forward(params, cfg: ArchConfig, x, positions, kernels: bool = True):
    """Backbone over embedded inputs x: (B, S, D) -> ((B, S, D), aux)."""
    _require_dense(cfg)
    for p in params["layers"]:
        x = _dense_block(cfg, p, x, positions, kernels)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return rms_norm(x, params["final_norm"], cfg.norm_eps), aux


def embed_inputs(params, cfg: ArchConfig, batch):
    """Token embedding.  Returns (x, positions)."""
    _require_dense(cfg)
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
    """Zeroed (L, B, S_max, kv, hd) K and V caches."""
    _require_dense(cfg)
    dev = resolve_device(device)
    kv_dt = getattr(torch, cfg.kv_dtype) if cfg.kv_dtype else cfg.torch_dtype
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=kv_dt, device=dev),
            "v": torch.zeros(shape, dtype=kv_dt, device=dev)}


def decode_step(params, cache, tokens, cache_len: int, cfg: ArchConfig,
                kernels: bool = True):
    """One-token decode.  tokens: (B, 1) int.  Returns (logits, cache); the
    cache is updated in place."""
    _require_dense(cfg)
    x = embed(params["embed"], tokens)
    for i, p in enumerate(params["layers"]):
        h = rms_norm(x, p["norm1"], cfg.norm_eps)
        h, _, _ = attention_decode(
            p["attn"], h, cache["k"][i], cache["v"][i], cache_len,
            n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, head_dim=cfg.hd,
            qk_norm=cfg.qk_norm, rope_theta=cfg.rope_theta,
            norm_eps=cfg.norm_eps, kernels=kernels)
        x = x + h
        h = rms_norm(x, p["norm2"], cfg.norm_eps)
        x = x + mlp_block(p["mlp"], h, kernels)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return matmul(x, params["lm_head"], kernels), cache
