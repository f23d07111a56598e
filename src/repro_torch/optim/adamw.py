"""AdamW with decoupled weight decay, global-norm clipping and fp32 moments
(port of ``repro.optim.adamw``), in plain tensor code (no ``torch.optim``).

The state mirrors the parameter tree (``mu``, ``nu`` in fp32) plus an int32
``step``.  The arithmetic follows the reference's order: the clip scale
``min(1, clip / (gnorm + 1e-9))``, bias corrections from the fp32 step, the
update in fp32 cast back to each parameter's dtype.

``adamw_update`` writes the new parameters and moments into the tensors it
is given, leaf by leaf, where the reference's jitted step donates them: one
copy of the state (weights, fp32 moments) is held, not two.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ..tree import tree_leaves, tree_map


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def lr_schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup + cosine decay; ``step`` an int or an int tensor."""
    step = torch.as_tensor(step).float()
    warm = step / max(cfg.warmup_steps, 1)
    prog = (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1)
    prog = torch.clamp(prog, 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    decayed = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, decayed)


def init_opt_state(params) -> dict:
    """fp32 zeros shaped like every parameter, and step 0 (int32)."""
    leaf = tree_leaves(params)[0]
    return {
        "mu": tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                       params),
        "nu": tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                       params),
        "step": torch.zeros((), dtype=torch.int32, device=leaf.device),
    }


def opt_state_axes(param_axes):
    """Logical axes for the optimizer state (mirrors params)."""
    return {
        "mu": param_axes,
        "nu": param_axes,
        "step": (),
    }


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's fp32 sum of squares."""
    return torch.sqrt(torch.stack([torch.sum(torch.square(x.float()))
                                   for x in tree_leaves(tree)]).sum())


def adamw_update(cfg: AdamWConfig, params, grads, state):
    """Returns (params, new_state, metrics); params, mu and nu are updated in
    place (see the module docstring)."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    lr = lr_schedule(cfg, step)
    b1c = 1 - cfg.b1 ** step.float()
    b2c = 1 - cfg.b2 ** step.float()
    def upd_leaf(p, g, mu, nu):
        g = g.float() * scale
        m = cfg.b1 * mu + (1 - cfg.b1) * g
        v = cfg.b2 * nu + (1 - cfg.b2) * g * g
        mhat = m / b1c
        vhat = v / b2c
        delta = mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * p.float()
        p.copy_((p.float() - lr * delta).to(p.dtype))
        mu.copy_(m)
        nu.copy_(v)

    with torch.no_grad():   # leaves matched by key, whatever the dicts' orders
        tree_map(upd_leaf, params, grads, state["mu"], state["nu"])
    new_state = {"mu": state["mu"], "nu": state["nu"], "step": step}
    return params, new_state, {"grad_norm": gnorm, "lr": lr}
