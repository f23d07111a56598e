"""Train / eval / prefill / decode step builders (port of
``repro.runtime.train_step``).

``build_train_step(cfg, ...)`` returns ``step(state, batch) -> (state,
metrics)``.  Every builder takes sharding ``rules`` (``None``: the unsharded
path, today's bits).  With rules, the state is a tree of DTensors placed by
``shardings_for`` over ``train_state_axes`` (``launch.train`` does so;
``distributed.elastic.reshard_state`` from host arrays), the step places
each batch by ``batch_axes_for``, and the model runs under ``use_rules`` and
``implicit_replication``: the tensors the model makes from shapes alone in
mid-step (positions, the RoPE table, masks, the MoE dispatch's indices) are
the same on every rank, so they are read as replicated where they meet a
DTensor, and the model code stays free of mesh code.  On a one-rank mesh
every step gives the unsharded step's bits.  The reference's step is jitted
with its state donated; the port's step consumes ``state`` the same way:
parameters and moments are updated in place (``optim.adamw``), so a caller
that needs the old state keeps a copy.

Batches may be numpy arrays, as the data pipeline makes them, or tensors;
each step moves them to the parameters' device (integer arrays as int64).
Gradients come from ``loss_fn`` on the kernel path (``grads_of``): on CUDA
tensors every projection, its two backward products and the attention and
SSD forwards run on the hand-written kernels.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch
from torch.distributed.tensor import DTensor, Replicate
from torch.distributed.tensor.experimental import implicit_replication

from ..configs.base import ArchConfig
from ..distributed import sites
from ..distributed.sharding import (
    ShardingRules, Sharding, logical_to_spec, place, shardings_for, use_rules,
)
from ..models.lm import decode_step, init_params, loss_fn, param_axes, param_shapes
from ..optim.adamw import AdamWConfig, adamw_update, init_opt_state, opt_state_axes
from ..optim.compression import CompressionConfig, compress_gradients
from ..tree import tree_leaves, tree_map, tree_unflatten


def batch_shardings(rules: ShardingRules, batch_axes: dict) -> dict:
    return {k: Sharding(rules.mesh, logical_to_spec(rules, v)) for k, v in batch_axes.items()}


def batch_axes_for(cfg: ArchConfig, kind: str) -> dict:
    if kind == "decode":
        ax = {"tokens": ("act_batch", None, None) if cfg.family == "audio"
              else ("act_batch", None),
              "cache_len": ()}
        return ax
    if cfg.family == "vlm":
        return {"tokens": ("act_batch", "act_seq"),
                "patches": ("act_batch", "act_seq", None),
                "labels": ("act_batch", "act_seq")}
    if cfg.family == "audio":
        return {"codes": ("act_batch", None, "act_seq"),
                "labels": ("act_batch", None, "act_seq")}
    return {"tokens": ("act_batch", "act_seq"),
            "labels": ("act_batch", "act_seq")}


def train_state_axes(cfg: ArchConfig) -> dict:
    """The logical axes of ``make_train_state(cfg)``'s tree."""
    axes = param_axes(cfg)
    return {"params": axes, "opt": opt_state_axes(axes)}


def train_state_shapes(cfg: ArchConfig) -> dict:
    """Meta tensors of the train state's shapes at the config's widths
    (``param_shapes``): what its shardings are computed from."""
    params = param_shapes(cfg)
    return {"params": params, "opt": {"mu": params, "nu": params,
                                      "step": torch.empty((), dtype=torch.int32, device="meta")}}


@contextlib.contextmanager
def _under(rules: ShardingRules | None):
    """The model's context: ``rules`` active, and with rules the tensors made
    in mid-step read as replicated (see the module docstring)."""
    with use_rules(rules), (implicit_replication() if rules is not None
                            else contextlib.nullcontext()):
        yield


def _gathered(t):
    """A replicated scalar metric as a local tensor (a plain one as it is)."""
    return t.full_tensor() if isinstance(t, DTensor) else t


def to_device(batch: dict, device) -> dict:
    """numpy or tensor batch -> tensors on ``device``; integers as int64."""
    out = {}
    for k, v in batch.items():
        t = v if isinstance(v, torch.Tensor) else torch.from_numpy(np.asarray(v))
        out[k] = t.to(device) if t.is_floating_point() else t.to(device, torch.int64)
    return out


def _device(params) -> torch.device:
    return tree_leaves(params)[0].device


def _placed(batch: dict, cfg: ArchConfig, rules: ShardingRules | None, kind: str) -> dict:
    """The batch as DTensors by ``batch_axes_for`` under rules (a batch
    already placed is kept as it is)."""
    if rules is None or all(isinstance(v, DTensor) for v in batch.values()):
        return batch
    axes = batch_axes_for(cfg, kind)
    return place(batch, shardings_for(rules, {k: axes[k] for k in batch}, batch))


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
        if isinstance(loss, DTensor):     # one loss, the same on every rank
            loss = loss.redistribute(placements=[Replicate()] * loss.device_mesh.ndim)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else _like(g, p) for p, g in zip(leaves, grads)]
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            tree_unflatten(params, grads))


def _like(g, p):
    """A DTensor gradient on its parameter's placements (the gradients'
    reduce-scatter or all-reduce over the ranks that shared the work)."""
    if isinstance(g, DTensor) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def _rows(v, lo: int, hi: int):
    """Rows lo..hi-1 of v; of each rank's rows where v is a DTensor, so a
    batch-sharded microbatch is cut where it lies."""
    if not isinstance(v, DTensor):
        return v[lo:hi]
    return DTensor.from_local(v.to_local()[lo:hi], v.device_mesh, v.placements, run_check=False)


def _microbatches(batch: dict, n_micro: int) -> list:
    first = next(iter(batch.values()))
    B = first.to_local().shape[0] if isinstance(first, DTensor) else first.shape[0]
    if B % n_micro:
        raise ValueError(f"batch of {B} rows does not split into {n_micro} microbatches")
    m = B // n_micro
    return [{k: _rows(v, i * m, (i + 1) * m) for k, v in batch.items()}
            for i in range(n_micro)]


def build_train_step(cfg: ArchConfig, opt_cfg: AdamWConfig | None = None,
                     compression: CompressionConfig | None = None,
                     n_micro: int = 1, accum_dtype=torch.float32,
                     rules: ShardingRules | None = None, kernels: bool = True):
    """Returns step(state, batch) -> (state, metrics).

    ``n_micro > 1`` accumulates gradients over microbatches cut from the
    batch's leading axis (each rank's rows, under rules), so activation
    memory scales with the microbatch; ``accum_dtype`` is the accumulation
    buffer's dtype.  Loss and aux loss are averaged over the microbatches, as
    the reference's scan does.  Metrics are local tensors.  ``kernels``:
    as for ``loss_fn`` (the dry-run's meta tensors take the plain path).
    """
    opt_cfg = opt_cfg or AdamWConfig()

    def step(state, batch):
        with _under(rules):
            state, metrics = _step(state, batch)
        return state, {k: _gathered(v) for k, v in metrics.items()}

    def _step(state, batch):
        params = state["params"]
        batch = _placed(to_device(batch, _device(params)), cfg, rules, "train")
        if n_micro > 1:
            grads = tree_map(lambda p: torch.zeros_like(p, dtype=accum_dtype), params)
            loss = torch.zeros((), dtype=torch.float32, device=_device(params))
            aux = torch.zeros_like(loss)
            for mb in _microbatches(batch, n_micro):
                mloss, mmetrics, g = grads_of(cfg, params, mb, kernels)
                grads = tree_map(lambda a, b: a + (b / n_micro).to(a.dtype), grads, g)
                loss = loss + mloss / n_micro
                aux = aux + mmetrics["aux_loss"] / n_micro
            metrics = {"loss": loss, "aux_loss": aux}
        else:
            loss, metrics, grads = grads_of(cfg, params, batch, kernels)
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


def build_eval_step(cfg: ArchConfig, rules: ShardingRules | None = None):
    """step(params, batch) -> loss_fn's metrics, without gradients."""
    def step(params, batch):
        with torch.no_grad(), _under(rules):
            batch = _placed(to_device(batch, _device(params)), cfg, rules, "train")
            _, metrics = loss_fn(params, batch, cfg)
        return {k: _gathered(v) for k, v in metrics.items()}

    return step


def build_prefill_step(cfg: ArchConfig, n_micro: int = 1, rules: ShardingRules | None = None,
                       kernels: bool = True):
    """Forward-only step (inference prefill): the loss and, with one
    microbatch, loss_fn's metrics; ``n_micro`` runs the request batch in
    that many chunks and averages their losses."""
    def step(params, batch):
        with torch.no_grad(), _under(rules):
            batch = _placed(to_device(batch, _device(params)), cfg, rules, "prefill")
            if n_micro > 1:
                loss = torch.zeros((), dtype=torch.float32, device=_device(params))
                for mb in _microbatches(batch, n_micro):
                    loss = loss + loss_fn(params, mb, cfg, kernels)[0] / n_micro
                return {"loss": _gathered(loss)}
            loss, metrics = loss_fn(params, batch, cfg, kernels)
            return {k: _gathered(v) for k, v in {"loss": loss, **metrics}.items()}

    return step


def build_decode_step(cfg: ArchConfig, rules: ShardingRules | None = None,
                      kernels: bool = True):
    """serve_step: one new token against the cache -> (next tokens, cache)."""
    def step(params, cache, tokens, cache_len):
        with torch.no_grad(), _under(rules):
            logits, cache = decode_step(params, cache, tokens, cache_len, cfg, kernels)
            logits = sites.gather_last(logits)       # the argmax reads the whole vocabulary
            next_tok = torch.argmax(logits[..., -1, :] if cfg.family != "audio"
                                    else logits[:, -1], dim=-1)
        return next_tok, cache

    return step
