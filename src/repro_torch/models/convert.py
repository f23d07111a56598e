"""Carry the JAX package's parameters into the port.

``params_from_numpy`` takes the JAX params pytree with every leaf converted
to a numpy array (layers stacked on a leading L axis) and returns the port's
params (a list of per-layer dicts, and nested dicts such as the hybrid's
``shared_attn`` as they are), each leaf in its original dtype: the MoE
expert stacks (L, E, D, F) become per-layer (E, D, F) and the fp32 router
stays fp32; the audio embedding stays a (K, V, D) stack; ``lm_head`` is
padded as ``init_params`` holds it (``lm.pad_head``).  bf16
leaves arrive as ``ml_dtypes.bfloat16``, which ``torch.from_numpy`` refuses;
they go through float32, which holds every bf16 value exactly.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from ..configs.base import ArchConfig
from .lm import pad_head


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)  # a copy: JAX's buffers are read-only


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def params_from_numpy(tree: dict, cfg: ArchConfig, device="cuda") -> dict:
    dev = resolve_device(device)
    params = {k: _map(v, lambda a: _tensor(a, dev)) for k, v in tree.items() if k != "layers"}
    params["lm_head"] = pad_head(params["lm_head"])
    params["layers"] = [_map(tree["layers"], lambda a, i=i: _tensor(np.asarray(a)[i], dev))
                        for i in range(cfg.n_layers)]
    return params
