"""Carry parameters between the JAX package's layout and the port's.

``params_from_numpy`` takes the JAX params pytree with every leaf converted
to a numpy array (layers stacked on a leading L axis) and returns the port's
params (a list of per-layer dicts, and nested dicts such as the hybrid's
``shared_attn`` as they are), each leaf in its original dtype: the MoE
expert stacks (L, E, D, F) become per-layer (E, D, F) and the fp32 router
stays fp32; the audio embedding stays a (K, V, D) stack; ``lm_head`` is
padded as ``init_params`` holds it (``lm.pad_head``).  bf16 leaves arrive
either as ``ml_dtypes.bfloat16`` arrays, which ``torch.from_numpy`` refuses
and which go through float32 (it holds every bf16 value exactly), or as the
pair (raw bits as uint16, ``"bfloat16"``) that ``to_host`` makes.

``params_to_numpy`` is its inverse: per-layer leaves stacked on L (the MoE
(E, D, F) stacks restacked to (L, E, D, F)), ``lm_head`` cut back to the
config's width, every leaf a host array made by ``to_host``.  The port does
not import ``ml_dtypes``: a bf16 leaf leaves as its raw bits beside its
dtype name, as the checkpoint format stores it.  Optimizer moments, which
mirror the params, convert the same way; the padding columns of a padded
head's moments are zero and stay zero under AdamW (g = 0, p = 0).
"""
from __future__ import annotations

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from .. import resolve_device
from ..configs.base import ArchConfig
from ..tree import tree_map
from .lm import head_width, pad_head

BF16 = "bfloat16"


def to_host(t: torch.Tensor):
    """A tensor as a host leaf: a numpy array, or for bf16 the pair (raw
    bits as uint16, ``"bfloat16"``)."""
    a, name = _host(t)
    return (a, name) if name == BF16 else a


def _host(t: torch.Tensor) -> tuple[np.ndarray, str]:
    if isinstance(t, DTensor):      # a sharded leaf is gathered whole
        t = t.full_tensor()
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), BF16
    a = t.numpy()
    return a, a.dtype.name


def from_host(a, device) -> torch.Tensor:
    """The inverse of ``to_host`` (also taking ``ml_dtypes.bfloat16`` arrays)."""
    if isinstance(a, tuple):
        bits, name = a
        if name != BF16:
            raise TypeError(f"raw-bits leaf of dtype {name!r}; only {BF16!r} is stored so")
        bits = np.ascontiguousarray(bits).view(np.int16)
        return torch.from_numpy(bits).view(torch.bfloat16).to(device)
    a = np.asarray(a)
    if a.dtype.name == BF16:
        return torch.from_numpy(a.astype(np.float32)).to(device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)  # a copy: JAX's buffers are read-only


def _layer(a, i):
    """Layer i of a stacked leaf (array or raw-bits pair)."""
    return (a[0][i], a[1]) if isinstance(a, tuple) else np.asarray(a)[i]


def params_from_numpy(tree: dict, cfg: ArchConfig, device="cuda") -> dict:
    dev = resolve_device(device)
    params = {k: tree_map(lambda a: from_host(a, dev), v) for k, v in tree.items()
              if k != "layers"}
    params["lm_head"] = pad_head(params["lm_head"])
    params["layers"] = [tree_map(lambda a, i=i: from_host(_layer(a, i), dev), tree["layers"])
                        for i in range(cfg.n_layers)]
    return params


def _stack(layers: list):
    """Per-layer dicts of tensors -> one dict of host leaves stacked on L."""
    if isinstance(layers[0], dict):
        return {k: _stack([d[k] for d in layers]) for k in layers[0]}
    parts = [_host(t) for t in layers]
    a, name = np.stack([p[0] for p in parts]), parts[0][1]
    return (a, name) if name == BF16 else a


def params_to_numpy(params: dict, cfg: ArchConfig) -> dict:
    tree = {k: tree_map(to_host, v) for k, v in params.items() if k not in ("layers", "lm_head")}
    tree["lm_head"] = to_host(params["lm_head"][:, :head_width(cfg)])
    tree["layers"] = _stack(params["layers"])
    return tree
