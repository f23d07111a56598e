"""Shared neural-net layers (port of ``repro.models.layers``).

Params are plain dicts of tensors.  Every dense projection goes through
``matmul``, and prefill attention in ``attention_block`` through
``flash_attention``: with ``kernels=True`` (the default) through the kernel
wrappers, which launch the Hopper kernels for CUDA tensors and run their plain
versions for CPU tensors; with ``kernels=False`` as plain PyTorch with the
same math as the JAX layer (``x @ W``, q-blocked softmax attention), the
yardstick the kernel path is held against on the card.

Layouts follow the JAX package: activations (B, S, D), heads (B, S, H, hd),
KV caches (B, S_max, KV, hd).
"""
from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from ..distributed import sites
from ..kernels.flash_attention.ops import flash_attention
from ..kernels.ltrf_matmul.ops import ltrf_matmul

NEG_INF = -1e30


def _init(gen: torch.Generator, shape, scale: float, dtype, device) -> torch.Tensor:
    """normal * scale, drawn in fp32 and cast (the JAX package's ``_init``).
    On the meta device only the shape and dtype exist: nothing is drawn (a
    draw or a product on meta tensors imports ``torch._dynamo``)."""
    if torch.device(device).type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (x * scale).to(dtype)


def _local_matmul(x: torch.Tensor, w: torch.Tensor, kernels: bool) -> torch.Tensor:
    if not kernels:
        return x @ w
    lead = x.shape[:-1]
    return ltrf_matmul(x.reshape(-1, x.shape[-1]).contiguous(), w).reshape(*lead, w.shape[1])


def matmul(x: torch.Tensor, w: torch.Tensor, kernels: bool = True) -> torch.Tensor:
    """x (..., K) @ w (K, N): through ``ltrf_matmul`` unless ``kernels`` is off;
    DTensors through their call site (``distributed.sites.matmul``)."""
    if isinstance(x, DTensor) or isinstance(w, DTensor):
        return sites.matmul(lambda xl, wl: _local_matmul(xl, wl, kernels), x, w)
    return _local_matmul(x, w, kernels)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    y = x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps)
    return (y * weight.float()).to(dt)


def init_rms(d: int, device, dtype=torch.float32) -> torch.Tensor:
    return torch.ones((d,), dtype=dtype, device=device)


RMS_AXES = ("embed",)          # the logical axes of an ``init_rms`` weight


# ---------------------------------------------------------------------------
# rotary position embeddings (half-split form, computed in fp32)
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float = 10000.0) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))


@lru_cache(maxsize=64)
def _rope_freqs_on(head_dim: int, theta: float, device: torch.device) -> torch.Tensor:
    """``rope_freqs`` as fp32 on ``device``, copied there once (a per-call
    host-to-device copy would synchronise every decode step's layers)."""
    return torch.as_tensor(rope_freqs(head_dim, theta), dtype=torch.float32, device=device)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq)."""
    freqs = _rope_freqs_on(x.shape[-1], float(theta), x.device)
    angles = positions[..., :, None].float() * freqs          # (..., seq, hd/2)
    cos = torch.cos(angles)[..., :, None, :]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention (GQA, causal)
# ---------------------------------------------------------------------------

def init_attention(gen, d_model, n_heads, n_kv, head_dim, qk_norm, dtype, device) -> dict:
    s = 1.0 / math.sqrt(d_model)
    params = {
        "wq": _init(gen, (d_model, n_heads * head_dim), s, dtype, device),
        "wk": _init(gen, (d_model, n_kv * head_dim), s, dtype, device),
        "wv": _init(gen, (d_model, n_kv * head_dim), s, dtype, device),
        "wo": _init(gen, (n_heads * head_dim, d_model), s / math.sqrt(2), dtype, device),
    }
    if qk_norm:
        params["q_norm"] = init_rms(head_dim, device)
        params["k_norm"] = init_rms(head_dim, device)
    return params


def attention_axes(qk_norm: bool) -> dict:
    """The logical axes of ``init_attention``'s params."""
    axes = {"wq": ("embed", "heads"), "wk": ("embed", "kv"), "wv": ("embed", "kv"),
            "wo": ("heads", "embed")}
    if qk_norm:
        axes["q_norm"] = (None,)
        axes["k_norm"] = (None,)
    return axes


def _qkv(params, x, n_heads, n_kv, head_dim, positions, qk_norm, rope_theta,
         norm_eps, kernels=True):
    q = sites.unflatten_last(matmul(x, params["wq"], kernels), n_heads, head_dim)
    k = sites.unflatten_last(matmul(x, params["wk"], kernels), n_kv, head_dim)
    v = sites.unflatten_last(matmul(x, params["wv"], kernels), n_kv, head_dim)
    if qk_norm:
        q = rms_norm(q, params["q_norm"], norm_eps)
        k = rms_norm(k, params["k_norm"], norm_eps)
    q = apply_rope(q, positions, rope_theta)
    k = apply_rope(k, positions, rope_theta)
    return q, k, v


def _repeat_kv(k: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(B,S,kv,hd) -> (B,S,H,hd): query head h reads kv head h // (H/kv)."""
    kv = k.shape[2]
    if n_heads % kv:
        rep = -(-n_heads // kv)
        return k.repeat_interleave(rep, dim=2)[:, :, :n_heads]
    return k.repeat_interleave(n_heads // kv, dim=2)


def causal_attention(q, k, v, q_block: int = 512, q_offset=None) -> torch.Tensor:
    """Causal attention, q-blocked so logits are O(q_block x Skv).

    q: (B,Sq,H,hd), k/v: (B,Skv,KV,hd).  ``q_offset`` shifts query positions
    (default Skv - Sq).
    """
    B, Sq, H, hd = q.shape
    Skv = k.shape[1]
    scale = 1.0 / math.sqrt(hd)
    offset = Skv - Sq if q_offset is None else q_offset
    kT = _repeat_kv(k, H).permute(0, 2, 3, 1).float()     # (B,H,hd,Skv)
    vT = _repeat_kv(v, H).permute(0, 2, 1, 3).float()     # (B,H,Skv,hd)
    kv_pos = torch.arange(Skv, device=q.device)
    q_block = min(q_block, Sq)
    outs = []
    for lo in range(0, Sq, q_block):
        qblk = q[:, lo:lo + q_block].permute(0, 2, 1, 3).float()   # (B,H,qb,hd)
        qpos = lo + torch.arange(qblk.shape[2], device=q.device) + offset
        logits = torch.matmul(qblk, kT) * scale
        mask = kv_pos[None, :] <= qpos[:, None]
        logits = torch.where(mask, logits, NEG_INF)
        outs.append(torch.matmul(torch.softmax(logits, dim=-1), vT))
    return torch.cat(outs, dim=2).permute(0, 2, 1, 3).to(q.dtype)


def attention_block(params, x, *, n_heads, n_kv, head_dim, positions,
                    qk_norm=False, rope_theta=10000.0, norm_eps=1e-5,
                    q_block=512, kernels=True):
    q, k, v = _qkv(params, x, n_heads, n_kv, head_dim, positions, qk_norm,
                   rope_theta, norm_eps, kernels)

    def attend(q, k, v):
        if kernels:
            # the kernel's layout is the TPU wrapper's: (B, H, S, d)
            return flash_attention(q.transpose(1, 2).contiguous(),
                                   k.transpose(1, 2).contiguous(),
                                   v.transpose(1, 2).contiguous()).transpose(1, 2)
        return causal_attention(q, k, v, q_block=q_block)

    out = sites.attention(attend, q, k, v) if isinstance(q, DTensor) else attend(q, k, v)
    B, S = out.shape[:2]
    return matmul(out.reshape(B, S, n_heads * head_dim), params["wo"], kernels)


def attention_decode(params, x, cache_k, cache_v, cache_len, *, n_heads,
                     n_kv, head_dim, qk_norm=False, rope_theta=10000.0,
                     norm_eps=1e-5, kernels=True):
    """One-token decode against a (B, S_max, kv, hd) KV cache.

    ``cache_len`` is a Python int or a 0-d integer tensor on x's device,
    with the same bits: the tensor is never read on the host, so the step
    can be captured once in a CUDA graph and replayed at every length.
    Writes the new K/V into the caches in place at row ``cache_len`` as
    ``dynamic_update_slice`` places it (a negative row counted from the end
    once, then clamped to the cache), and attends to positions
    ``<= cache_len`` of the zero-filled cache.  Returns (out, cache_k, cache_v).
    """
    B, S, _ = x.shape
    n = (cache_len if isinstance(cache_len, torch.Tensor)
         else torch.full((), cache_len, dtype=torch.long, device=x.device))
    positions = n.to(torch.int32).expand(B, S)
    q, k, v = _qkv(params, x, n_heads, n_kv, head_dim, positions, qk_norm,
                   rope_theta, norm_eps, kernels)
    S_max = cache_k.shape[1]
    if isinstance(cache_k, DTensor):
        # the mesh path runs eagerly with an int cache_len: DTensor has no
        # sharding rule for index_copy_
        start = int(cache_len)
        start = min(max(start + S_max if start < 0 else start, 0), S_max - S)
        cache_k[:, start:start + S] = k.to(cache_k.dtype)
        cache_v[:, start:start + S] = v.to(cache_v.dtype)
    else:
        start = torch.where(n < 0, n + S_max, n).long().clamp(0, S_max - S)
        rows = start + torch.arange(S, device=x.device)
        cache_k.index_copy_(1, rows, k.to(cache_k.dtype))
        cache_v.index_copy_(1, rows, v.to(cache_v.dtype))
    scale = 1.0 / math.sqrt(head_dim)

    def attend(q, cache_k, cache_v, reduce=None):
        # reduce: the sum of the logits' partial sums over head-width shards
        kk = _repeat_kv(cache_k, q.shape[2])
        vv = _repeat_kv(cache_v, q.shape[2])
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), kk.float())
        logits = (logits if reduce is None else reduce(logits)) * scale
        mask = torch.arange(S_max, device=q.device) <= n   # current token included
        logits = torch.where(mask, logits, NEG_INF)
        p = torch.softmax(logits, dim=-1)
        return torch.einsum("bhqk,bkhd->bqhd", p, vv.float()).to(x.dtype)

    out = (sites.decode_attention(attend, q, cache_k, cache_v) if isinstance(q, DTensor)
           else attend(q, cache_k, cache_v))
    out = matmul(out.reshape(B, S, n_heads * head_dim), params["wo"], kernels)
    return out, cache_k, cache_v


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------

def init_mlp(gen, d_model, d_ff, dtype, device) -> dict:
    s = 1.0 / math.sqrt(d_model)
    return {
        "w_gate": _init(gen, (d_model, d_ff), s, dtype, device),
        "w_up": _init(gen, (d_model, d_ff), s, dtype, device),
        "w_down": _init(gen, (d_ff, d_model), 1.0 / math.sqrt(d_ff), dtype, device),
    }


MLP_AXES = {"w_gate": ("embed", "ffn"), "w_up": ("embed", "ffn"), "w_down": ("ffn", "embed")}


def mlp_block(params, x, kernels=True):
    h = F.silu(matmul(x, params["w_gate"], kernels)) * matmul(x, params["w_up"], kernels)
    return matmul(h, params["w_down"], kernels)


# ---------------------------------------------------------------------------
# embeddings / heads
# ---------------------------------------------------------------------------

def init_embedding(gen, vocab, d_model, dtype, device) -> torch.Tensor:
    return _init(gen, (vocab, d_model), 1.0, dtype, device)


EMBED_AXES = ("vocab", "embed")


def embed(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``table[tokens]``; a DTensor table through its call site
    (``distributed.sites.embedding``)."""
    if isinstance(table, DTensor):
        return sites.embedding(table, tokens)
    return table[tokens]


def unembed(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    return x @ table.T


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean over tokens of logits (..., V) against labels (...); DTensors
    through their call site (``distributed.sites.cross_entropy``)."""
    if isinstance(logits, DTensor):
        return sites.cross_entropy(cross_entropy, logits, labels)
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return (logz - gold).mean()
