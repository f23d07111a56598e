"""Weights made from the seed, on the device, in the layout the program takes.

``make(arch, seed, device)`` draws every normal weight of one dtype in one
``torch.randn`` call on a generator that lives on the device, then scales
each weight's slice of that buffer in place: the same seed gives the same
bits.  The tree has the program's layout (a dict whose ``"layers"`` is a
list of per-layer dicts; the head held at a width that is a multiple of 64
with zero columns past the vocabulary) and the program's distributions
(normal times ``1/sqrt(fan_in)``, ones for norms, Mamba2's fixed ``A_log``).
The plain reference is given the same tree, made again from the seed.
"""
from __future__ import annotations

import math

import torch

CONV_K = 4


def held_width(n: int) -> int:
    return -(-n // 64) * 64


def _attention(a: dict) -> list:
    D, H, KV, hd = a["d_model"], a["n_heads"], a["n_kv_heads"], head_dim(a)
    s = 1.0 / math.sqrt(D)
    return [("wq", (D, H * hd), "normal", s), ("wk", (D, KV * hd), "normal", s),
            ("wv", (D, KV * hd), "normal", s), ("wo", (H * hd, D), "normal", s / math.sqrt(2))]


def _mlp(a: dict) -> list:
    D, F = a["d_model"], a["d_ff"]
    return [("w_gate", (D, F), "normal", 1 / math.sqrt(D)), ("w_up", (D, F), "normal", 1 / math.sqrt(D)),
            ("w_down", (F, D), "normal", 1 / math.sqrt(F))]


def _moe(a: dict) -> list:
    D, F, E = a["d_model"], a["d_ff"], a["n_experts"]
    return [("router", (D, E), "normal32", 1 / math.sqrt(D)),
            ("w_gate", (E, D, F), "normal", 1 / math.sqrt(D)),
            ("w_up", (E, D, F), "normal", 1 / math.sqrt(D)),
            ("w_down", (E, F, D), "normal", 1 / math.sqrt(F))]


def _mamba(a: dict) -> list:
    D, N, P = a["d_model"], a["ssm_state"], a["ssm_headdim"]
    di = a["ssm_expand"] * D
    nh = di // P
    return [("in_proj", (D, 2 * di + 2 * N + nh), "normal", 1 / math.sqrt(D)),
            ("conv", (CONV_K, di + 2 * N), "normal", 0.5),
            ("A_log", (nh,), "a_log", 0.0), ("dt_bias", (nh,), "zeros", 0.0),
            ("D", (nh,), "ones", 0.0), ("norm", (di,), "ones", 0.0),
            ("out_proj", (di, D), "normal", 1 / math.sqrt(di))]


def head_dim(a: dict) -> int:
    return a.get("head_dim") or a["d_model"] // a["n_heads"]


def spec(a: dict) -> list:
    """[(path, shape, kind, scale)] of every leaf, in the tree's order."""
    D, V = a["d_model"], a["vocab"]
    out = [(("embed",), (V, D), "normal", 1.0),
           (("lm_head",), (D, held_width(V)), "head", 1 / math.sqrt(D))]
    for i in range(a["n_layers"]):
        pre = ("layers", i)
        if a["family"] in ("ssm", "hybrid"):
            out += [(pre + ("mixer", k), s, kd, sc) for k, s, kd, sc in _mamba(a)]
            out.append((pre + ("norm",), (D,), "ones", 0.0))
            continue
        out += [(pre + ("attn", k), s, kd, sc) for k, s, kd, sc in _attention(a)]
        out += [(pre + ("norm1",), (D,), "ones", 0.0), (pre + ("norm2",), (D,), "ones", 0.0)]
        ffn = ("moe", _moe(a)) if a["family"] == "moe" else ("mlp", _mlp(a))
        out += [(pre + (ffn[0], k), s, kd, sc) for k, s, kd, sc in ffn[1]]
    out.append((("final_norm",), (D,), "ones", 0.0))
    if a["family"] == "hybrid":
        pre = ("shared_attn",)
        out += [(pre + ("attn", k), s, kd, sc) for k, s, kd, sc in _attention(a)]
        out += [(pre + ("mlp", k), s, kd, sc) for k, s, kd, sc in _mlp(a)]
        out += [(pre + ("norm1",), (D,), "ones", 0.0), (pre + ("norm2",), (D,), "ones", 0.0)]
    return out


def stored_dtype(kind: str, model_dtype: torch.dtype) -> torch.dtype:
    """The dtype a leaf of this kind is held in: the model's for the
    matrices, fp32 for the router, norms and Mamba2's per-head vectors."""
    return model_dtype if kind in ("normal", "head") else torch.float32


def _put(tree: dict, path: tuple, leaf) -> None:
    node = tree
    for k, nxt in zip(path[:-1], path[1:]):
        if isinstance(k, int):
            while len(node) <= k:
                node.append({})
            node = node[k]
        else:
            node = node.setdefault(k, [] if isinstance(nxt, int) else {})
    node[path[-1]] = leaf


def make(a: dict, seed: int, device) -> dict:
    """The weight tree for architecture ``a`` from ``seed``, on ``device``,
    its matrices in the configuration's dtype."""
    dev = torch.device(device)
    dtype = getattr(torch, a.get("dtype", "bfloat16"))
    leaves = spec(a)
    gen = torch.Generator(dev).manual_seed(seed)
    sizes = {dtype: 0, torch.float32: 0}
    for _, shape, kind, _ in leaves:
        if kind in ("normal", "head", "normal32"):
            sizes[stored_dtype(kind, dtype)] += math.prod(shape)
    pools = {dt: torch.randn(n, generator=gen, dtype=dt, device=dev) for dt, n in sizes.items() if n}
    used = dict.fromkeys(pools, 0)
    tree: dict = {}
    for path, shape, kind, scale in leaves:
        if kind in ("normal", "head", "normal32"):
            dt = stored_dtype(kind, dtype)
            n = math.prod(shape)
            leaf = pools[dt][used[dt]:used[dt] + n].view(shape)
            used[dt] += n
            leaf.mul_(scale)
            if kind == "head":
                leaf[:, a["vocab"]:] = 0
        elif kind == "a_log":
            leaf = torch.log(torch.linspace(1.0, 16.0, shape[0], dtype=torch.float32, device=dev))
        elif kind == "zeros":
            leaf = torch.zeros(shape, dtype=torch.float32, device=dev)
        else:
            leaf = torch.ones(shape, dtype=torch.float32, device=dev)
        _put(tree, path, leaf)
    return tree


def as_f32(tree):
    """A float32 copy of every leaf of ``tree`` (the plain reference's weights)."""
    if isinstance(tree, dict):
        return {k: as_f32(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [as_f32(v) for v in tree]
    return tree.detach().float().clone()
