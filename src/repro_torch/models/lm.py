"""Language model (port of ``repro.models.lm``): all six families (dense,
moe, vlm, audio, ssm, hybrid).

The math is the JAX package's unrolled path (``_forward_unrolled``): a Python
loop over layers.  Params are a dict whose ``"layers"`` entry is a list of
per-layer dicts (the JAX pytree stacks them on a leading axis; see
``convert.params_from_numpy``).  Every function takes ``kernels`` (default
True): on CUDA tensors the projections, the lm_head product, prefill
attention and the Mamba2 chunked scan then run on the hand-written kernels;
``kernels=False`` is the plain PyTorch path with the same math.  The MoE
router and expert products are plain PyTorch on both paths (``moe.py``).

Where a backward can reach a block (grad enabled, and its input or a weight
requiring grad), it runs under ``torch.utils.checkpoint`` (non-reentrant)
unless ``cfg.remat`` is ``"none"``: backward recomputes the block from its
input, kernels included (the reference's ``_maybe_remat``).  ``"full"``
saves nothing inside a block, as the reference's does; ``"block"``, which in
the reference keeps the block's products, recomputes them here too.
Otherwise (prefill, serving) the blocks run as they are.

An ``lm_head`` whose width (vocab, or n_codebooks * vocab) is not a multiple
of 8 is held with zero columns up to a multiple of 64 (``pad_head``), so its
rows are a multiple of 16 bytes, as the matmul kernel and TMA need; every
logits tensor is cut back to the true width before it is returned or used.

Activations are annotated with logical axes at the reference's seven sites
(``distributed.sharding.constrain``): a no-op without sharding rules, a
redistribution of a DTensor under them.  ``param_axes`` and
``decode_cache_axes`` give the logical axes of ``init_params``' and
``init_decode_cache``'s trees; the port holds layers as a list of per-layer
dicts where the reference stacks them, so its per-layer axes are the
reference's without the leading ``"layers"`` name (which every layout maps to
no mesh dimension).

Entry points:
  init_params(cfg, generator, device)            -> params
  loss_fn(params, batch, cfg)                    -> (scalar loss, metrics)
  init_decode_cache(cfg, B, S_max, device)       -> cache dict
  decode_step(params, cache, tokens, cache_len, cfg) -> (logits, cache)
"""
from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from .. import resolve_device
from ..configs.base import ArchConfig
from ..distributed import sites
from ..distributed.sharding import constrain
from ..tree import tree_leaves
from .layers import (
    EMBED_AXES, MLP_AXES, RMS_AXES, _init, attention_axes, attention_block,
    attention_decode, cross_entropy, embed, init_attention, init_embedding, init_mlp,
    init_rms, matmul, mlp_block, rms_norm,
)
from .mamba2 import CONV_K, MAMBA2_AXES, init_mamba2, mamba2_block, mamba2_decode
from .moe import MOE_AXES, init_moe, moe_block

ACT = ("act_batch", "act_seq", "act_embed")

ATTN_FAMILIES = ("dense", "moe", "vlm", "audio")


def head_width(cfg: ArchConfig) -> int:
    """The true width of the logits: vocab, or n_codebooks * vocab (audio)."""
    return cfg.vocab * (cfg.n_codebooks if cfg.family == "audio" else 1)


def held_width(n: int) -> int:
    """The width a head of true width n is held at: n if it is a multiple of
    8, else n rounded up to a multiple of 64."""
    return n if n % 8 == 0 else -(-n // 64) * 64


def pad_head(w: torch.Tensor) -> torch.Tensor:
    """``lm_head`` (D, n) as held: zero columns up to ``held_width(n)``."""
    n = w.shape[1]
    if held_width(n) == n:
        return w
    return torch.nn.functional.pad(w, (0, held_width(n) - n)).contiguous()


def _head(cfg: ArchConfig, params, x, kernels):
    """x @ lm_head, cut to the true width."""
    return matmul(x, params["lm_head"], kernels)[..., :head_width(cfg)]


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _init_block(cfg: ArchConfig, gen, dev) -> dict:
    dt = cfg.torch_dtype
    if cfg.family in ("ssm", "hybrid"):
        return {"mixer": init_mamba2(gen, cfg.d_model, cfg.ssm_state, cfg.ssm_headdim,
                                     cfg.ssm_expand, dt, dev),
                "norm": init_rms(cfg.d_model, dev)}
    p = {
        "attn": init_attention(gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                               cfg.hd, cfg.qk_norm, dt, dev),
        "norm1": init_rms(cfg.d_model, dev),
        "norm2": init_rms(cfg.d_model, dev),
    }
    if cfg.family == "moe":
        p["moe"] = init_moe(gen, cfg.d_model, cfg.d_ff, cfg.n_experts, dt, dev)
    else:
        p["mlp"] = init_mlp(gen, cfg.d_model, cfg.d_ff, dt, dev)
    return p


def init_params(cfg: ArchConfig, generator: torch.Generator | None = None,
                device="cuda") -> dict:
    """Random weights with the JAX package's distributions (normal x scale,
    cast to the model dtype; norms all ones).  The draws differ from JAX's:
    to compare the two, carry JAX's weights across with ``params_from_numpy``.
    ``generator`` must live on ``device`` (default: seed 0 there)."""
    dev = resolve_device(device)
    gen = generator if generator is not None else torch.Generator(dev).manual_seed(0)
    dt = cfg.torch_dtype
    if cfg.family == "audio":     # one table per codebook, stacked (K, V, D)
        emb = torch.stack([init_embedding(gen, cfg.vocab, cfg.d_model, dt, dev)
                           for _ in range(cfg.n_codebooks)])
    else:
        emb = init_embedding(gen, cfg.vocab, cfg.d_model, dt, dev)
    params = {
        "embed": emb,
        "lm_head": pad_head(_init(gen, (cfg.d_model, head_width(cfg)),
                                  1.0 / math.sqrt(cfg.d_model), dt, dev)),
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


def _block_axes(cfg: ArchConfig) -> dict:
    if cfg.family in ("ssm", "hybrid"):
        return {"mixer": dict(MAMBA2_AXES), "norm": RMS_AXES}
    axes = {"attn": attention_axes(cfg.qk_norm), "norm1": RMS_AXES, "norm2": RMS_AXES}
    if cfg.family == "moe":
        axes["moe"] = dict(MOE_AXES)
    else:
        axes["mlp"] = dict(MLP_AXES)
    return axes


def param_axes(cfg: ArchConfig) -> dict:
    """The logical axes of ``init_params(cfg)``'s tree (the reference's
    ``init_params`` axes, per layer)."""
    axes = {
        "embed": (None, *EMBED_AXES) if cfg.family == "audio" else EMBED_AXES,
        "lm_head": ("embed", "vocab"),
        "layers": [_block_axes(cfg) for _ in range(cfg.n_layers)],
        "final_norm": RMS_AXES,
    }
    if cfg.family == "hybrid":
        axes["shared_attn"] = {"attn": attention_axes(cfg.qk_norm), "mlp": dict(MLP_AXES),
                               "norm1": RMS_AXES, "norm2": RMS_AXES}
    return axes


def param_shapes(cfg: ArchConfig) -> dict:
    """Meta tensors shaped as ``init_params(cfg)``'s, the head at its true
    width (``head_width``), not the width it is held at: shardings are
    computed from these, so the padding never changes a spec."""
    params = init_params(cfg, torch.Generator(), "meta")
    params["lm_head"] = params["lm_head"][:, :head_width(cfg)]
    return params


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _ffn(cfg: ArchConfig, p, h, kernels, groups):
    """The block's MLP, or its MoE layer (with its aux loss)."""
    if cfg.family == "moe":
        return moe_block(p["moe"], h, top_k=cfg.top_k,
                         capacity_factor=cfg.capacity_factor, groups=groups)
    return mlp_block(p["mlp"], h, kernels), None


def _dense_block(cfg: ArchConfig, p, x, positions, kernels):
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    h = attention_block(p["attn"], h, n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
                        head_dim=cfg.hd, positions=positions,
                        qk_norm=cfg.qk_norm, rope_theta=cfg.rope_theta,
                        norm_eps=cfg.norm_eps, q_block=cfg.q_block,
                        kernels=kernels)
    x = constrain(x + h, ACT)
    h, aux = _ffn(cfg, p, rms_norm(x, p["norm2"], cfg.norm_eps), kernels, cfg.moe_groups)
    return constrain(x + h, ACT), aux


def _ssm_block(cfg: ArchConfig, p, x, kernels):
    h = rms_norm(x, p["norm"], cfg.norm_eps)
    h = mamba2_block(p["mixer"], h, d_state=cfg.ssm_state,
                     headdim=cfg.ssm_headdim, expand=cfg.ssm_expand,
                     chunk=cfg.ssm_chunk, norm_eps=cfg.norm_eps, kernels=kernels)
    return constrain(x + h, ACT)


def _shared_block(cfg: ArchConfig, p, x, positions, kernels):
    # as in the reference, the shared block's attention runs without qk_norm
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    h = attention_block(p["attn"], h, n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
                        head_dim=cfg.hd, positions=positions,
                        rope_theta=cfg.rope_theta, norm_eps=cfg.norm_eps,
                        q_block=cfg.q_block, kernels=kernels)
    x = x + h
    h = rms_norm(x, p["norm2"], cfg.norm_eps)
    return constrain(x + mlp_block(p["mlp"], h, kernels), ACT)


def _remat(cfg: ArchConfig, block, *args):
    """``block(*args)``, under ``checkpoint`` when ``cfg.remat`` asks for it
    and a backward can reach the block: grad enabled and one of its tensors
    (its input or a weight) requiring grad (see the module docstring)."""
    if cfg.remat == "none" or not torch.is_grad_enabled() or not any(
            t.requires_grad for t in tree_leaves(list(args)) if isinstance(t, torch.Tensor)):
        return block(*args)
    return checkpoint(block, *args, use_reentrant=False)


def forward(params, cfg: ArchConfig, x, positions, kernels: bool = True):
    """Backbone over embedded inputs x: (B, S, D) -> ((B, S, D), aux), aux
    the sum of the MoE layers' load-balance losses (0 for other families)."""
    if cfg.family not in ATTN_FAMILIES + ("ssm", "hybrid"):
        raise ValueError(cfg.family)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, p in enumerate(params["layers"]):
        if cfg.family in ATTN_FAMILIES:
            x, a = _remat(cfg, _dense_block, cfg, p, x, positions, kernels)
            if a is not None:
                aux = aux + a
            continue
        x = _remat(cfg, _ssm_block, cfg, p, x, kernels)
        if cfg.family == "hybrid" and (i + 1) % cfg.attn_every == 0:
            x = _remat(cfg, _shared_block, cfg, params["shared_attn"], x, positions, kernels)
    return rms_norm(x, params["final_norm"], cfg.norm_eps), aux


def _embed_codes(table: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """Audio: codes (B, K, S) -> the sum of the K codebooks' embeddings, in
    codebook order."""
    x = embed(table[0], codes[:, 0])
    for k in range(1, table.shape[0]):
        x = x + embed(table[k], codes[:, k])
    return x


def embed_inputs(params, cfg: ArchConfig, batch):
    """Family-specific input embedding.  Returns (x, positions).

    vlm: ``batch["patches"]`` (B, n_patches, D) ahead of the token
    embeddings; audio: ``batch["codes"]`` (B, K, S); else ``batch["tokens"]``.
    Positions run 0..S-1 over the whole sequence."""
    if cfg.family == "audio":
        x = _embed_codes(params["embed"], batch["codes"])
    else:
        x = embed(params["embed"], batch["tokens"])
        if cfg.family == "vlm":
            x = torch.cat([batch["patches"].to(x.dtype), x], dim=1)
    B, S = x.shape[:2]
    positions = torch.arange(S, dtype=torch.int32, device=x.device).expand(B, S)
    return constrain(x, ACT), positions


def logits_fn(params, batch, cfg: ArchConfig, kernels: bool = True):
    """Full-sequence logits (B, S, vocab) (audio: (B, S, K, vocab)) and the
    aux loss."""
    x, positions = embed_inputs(params, cfg, batch)
    h, aux = forward(params, cfg, x, positions, kernels)
    logits = _head(cfg, params, h, kernels)
    if cfg.family == "audio":
        logits = sites.unflatten_last(logits, cfg.n_codebooks, cfg.vocab)
    else:
        logits = constrain(logits, ("act_batch", "act_seq", "act_vocab"))
    return logits, aux


def loss_fn(params, batch, cfg: ArchConfig, kernels: bool = True):
    """Causal LM loss over the batch, plus 0.01 x the MoE aux loss.  Returns
    (loss, metrics).  Audio labels are (B, K, S); vlm labels cover the patch
    positions too (zeros there, as the data pipeline makes them)."""
    logits, aux = logits_fn(params, batch, cfg, kernels)
    labels = batch["labels"]
    if cfg.family == "audio":
        loss = cross_entropy(logits[:, :-1], labels[:, :, 1:].transpose(1, 2))
    else:
        loss = cross_entropy(logits[:, :-1], labels[:, 1:])
    return loss + 0.01 * aux, {"loss": loss, "aux_loss": aux}


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def init_decode_cache(cfg: ArchConfig, batch: int, max_len: int, device="cuda") -> dict:
    """Zeroed decode caches.

    dense, moe, vlm and audio: (L, B, S_max, kv, hd) K and V.  ssm and
    hybrid: the conv window (L, B, K-1, C) in the model dtype and the SSM
    state (L, B, H, P, N) in fp32; hybrid adds K and V caches for each of the n_layers // attn_every
    call sites of the shared block.  The reference makes the SSM state in the
    model dtype, but its first decode step returns it in fp32; zeros are exact
    in both, and holding fp32 from the start lets the steps update the cache
    in place without rounding it.
    """
    dev = resolve_device(device)
    dt = cfg.torch_dtype
    if cfg.family in ATTN_FAMILIES:
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


def decode_cache_axes(cfg: ArchConfig) -> dict:
    """The logical axes of ``init_decode_cache(cfg, ...)``'s tree (the
    reference's, whose caches are stacked as the port's are)."""
    if cfg.family in ATTN_FAMILIES:
        kv = ("layers", "act_batch", None, "act_kv", "act_hd")
        return {"k": kv, "v": kv}
    axes = {"conv": ("layers", "act_batch", None, "act_ffn"),
            "ssm": ("layers", "act_batch", None, None, None)}
    if cfg.family == "hybrid":
        axes["k"] = axes["v"] = (None, "act_batch", None, "act_kv", "act_hd")
    return axes


def _attention_decode_block(cfg: ArchConfig, p, x, cache_k, cache_v, cache_len, kernels,
                            qk_norm):
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    h, _, _ = attention_decode(
        p["attn"], h, cache_k, cache_v, cache_len, n_heads=cfg.n_heads,
        n_kv=cfg.n_kv_heads, head_dim=cfg.hd, qk_norm=qk_norm,
        rope_theta=cfg.rope_theta, norm_eps=cfg.norm_eps, kernels=kernels)
    x = x + h
    # the MoE layer dispatches the step's B tokens as one group, as the
    # reference's decode step does
    h, _ = _ffn(cfg, p, rms_norm(x, p["norm2"], cfg.norm_eps), kernels, 1)
    return x + h


def decode_step(params, cache, tokens, cache_len, cfg: ArchConfig,
                kernels: bool = True):
    """One-token decode.  tokens: (B, 1) int (audio: (B, K, 1)).  Returns
    (logits, cache): logits (B, 1, vocab) (audio: (B, 1, K, vocab)); the
    cache is updated in place.  ``cache_len`` is a Python int or a 0-d
    integer tensor on the cache's device (``attention_decode``): nothing on
    the step's path reads a tensor on the host, so the engine captures it
    once as a CUDA graph.  The ssm family ignores ``cache_len``; the
    hybrid's shared block uses it for its KV caches.  The vlm family decodes
    tokens only, as the reference does."""
    if cfg.family == "audio":
        x = _embed_codes(params["embed"], tokens)
    else:
        x = embed(params["embed"], tokens)
    x = constrain(x, ("act_batch", None, "act_embed"))
    g = 0  # the hybrid's next shared-block call site
    for i, p in enumerate(params["layers"]):
        if cfg.family in ATTN_FAMILIES:
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
    logits = _head(cfg, params, x, kernels)
    if cfg.family == "audio":
        logits = sites.unflatten_last(logits, cfg.n_codebooks, cfg.vocab)
    return logits, cache
