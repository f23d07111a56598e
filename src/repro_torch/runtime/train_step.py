"""Train / eval / prefill / decode step builders (port of
``repro.runtime.train_step``).

``build_train_step(cfg, ...)`` returns ``step(state, batch) -> (state,
metrics)``.  The reference's builders also take sharding ``rules``: that is
a mesh concern (ROADMAP queue 1 item 6), and the port runs on one device, so
its builders take none.  The reference's step is jitted with its state
donated; the port's step consumes ``state`` the same way: parameters and
moments are updated in place (``optim.adamw``), so a caller that needs the
old state keeps a copy.

Batches may be numpy arrays, as the data pipeline makes them, or tensors;
each step moves them to the parameters' device (integer arrays as int64).
Gradients come from ``loss_fn`` on the kernel path (``grads_of``): on CUDA
tensors every projection, its two backward products and the attention and
SSD forwards run on the hand-written kernels.
"""
from __future__ import annotations

import numpy as np
import torch

from ..configs.base import ArchConfig
from ..models.lm import decode_step, init_params, loss_fn
from ..optim.adamw import AdamWConfig, adamw_update, init_opt_state
from ..optim.compression import CompressionConfig, compress_gradients
from ..tree import tree_leaves, tree_map, tree_unflatten


def to_device(batch: dict, device) -> dict:
    """numpy or tensor batch -> tensors on ``device``; integers as int64."""
    out = {}
    for k, v in batch.items():
        t = v if isinstance(v, torch.Tensor) else torch.from_numpy(np.asarray(v))
        out[k] = t.to(device) if t.is_floating_point() else t.to(device, torch.int64)
    return out


def _device(params) -> torch.device:
    return tree_leaves(params)[0].device


def make_train_state(cfg: ArchConfig, generator: torch.Generator | None = None,
                     device="cuda") -> dict:
    """{"params": ..., "opt": {"mu", "nu", "step"}}; ``generator`` as for
    ``init_params``."""
    params = init_params(cfg, generator, device)
    return {"params": params, "opt": init_opt_state(params)}


def grads_of(cfg: ArchConfig, params, batch: dict, kernels: bool = True):
    """(loss, metrics, grads) of ``loss_fn`` at ``params`` (a tree of
    tensors on the batch's device); grads has params' structure, zeros for a
    parameter the loss does not reach."""
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    with torch.enable_grad():
        loss, metrics = loss_fn(tree_unflatten(params, leaves), batch, cfg, kernels)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            tree_unflatten(params, grads))


def _microbatches(batch: dict, n_micro: int) -> list:
    B = next(iter(batch.values())).shape[0]
    if B % n_micro:
        raise ValueError(f"batch of {B} rows does not split into {n_micro} microbatches")
    m = B // n_micro
    return [{k: v[i * m:(i + 1) * m] for k, v in batch.items()} for i in range(n_micro)]


def build_train_step(cfg: ArchConfig, opt_cfg: AdamWConfig | None = None,
                     compression: CompressionConfig | None = None,
                     n_micro: int = 1, accum_dtype=torch.float32):
    """Returns step(state, batch) -> (state, metrics).

    ``n_micro > 1`` accumulates gradients over microbatches cut from the
    batch's leading axis, so activation memory scales with the microbatch;
    ``accum_dtype`` is the accumulation buffer's dtype.  Loss and aux loss
    are averaged over the microbatches, as the reference's scan does.
    """
    opt_cfg = opt_cfg or AdamWConfig()

    def step(state, batch):
        params = state["params"]
        batch = to_device(batch, _device(params))
        if n_micro > 1:
            grads = tree_map(lambda p: torch.zeros(p.shape, dtype=accum_dtype,
                                                   device=p.device), params)
            loss = torch.zeros((), dtype=torch.float32, device=_device(params))
            aux = torch.zeros_like(loss)
            for mb in _microbatches(batch, n_micro):
                mloss, mmetrics, g = grads_of(cfg, params, mb)
                grads = tree_map(lambda a, b: a + (b / n_micro).to(a.dtype), grads, g)
                loss = loss + mloss / n_micro
                aux = aux + mmetrics["aux_loss"] / n_micro
            metrics = {"loss": loss, "aux_loss": aux}
        else:
            loss, metrics, grads = grads_of(cfg, params, batch)
        if compression is not None and compression.enabled:
            grads, state_err, cstats = compress_gradients(grads, state.get("err"), compression)
            metrics.update(cstats)
        else:
            state_err = state.get("err")
        new_params, new_opt, opt_metrics = adamw_update(opt_cfg, params, grads, state["opt"])
        metrics.update(opt_metrics)
        metrics["loss_total"] = loss
        out = {"params": new_params, "opt": new_opt}
        if state_err is not None:
            out["err"] = state_err
        return out, metrics

    return step


def build_eval_step(cfg: ArchConfig):
    """step(params, batch) -> loss_fn's metrics, without gradients."""
    def step(params, batch):
        with torch.no_grad():
            _, metrics = loss_fn(params, to_device(batch, _device(params)), cfg)
        return metrics

    return step


def build_prefill_step(cfg: ArchConfig, n_micro: int = 1):
    """Forward-only step (inference prefill): the loss and, with one
    microbatch, loss_fn's metrics; ``n_micro`` runs the request batch in
    that many chunks and averages their losses."""
    def step(params, batch):
        batch = to_device(batch, _device(params))
        with torch.no_grad():
            if n_micro > 1:
                loss = torch.zeros((), dtype=torch.float32, device=_device(params))
                for mb in _microbatches(batch, n_micro):
                    loss = loss + loss_fn(params, mb, cfg)[0] / n_micro
                return {"loss": loss}
            loss, metrics = loss_fn(params, batch, cfg)
            return {"loss": loss, **metrics}

    return step


def build_decode_step(cfg: ArchConfig):
    """serve_step: one new token against the cache -> (next tokens, cache)."""
    def step(params, cache, tokens, cache_len):
        with torch.no_grad():
            logits, cache = decode_step(params, cache, tokens, cache_len, cfg)
        next_tok = torch.argmax(logits[..., -1, :] if cfg.family != "audio"
                                else logits[:, -1], dim=-1)
        return next_tok, cache

    return step
