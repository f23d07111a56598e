"""Mixture-of-Experts layer (port of ``repro.models.moe``): top-k routing,
sort-based capacity dispatch.

The reference's sort/gather formulation, step for step: an fp32 router, the
top-k experts of each token with their gates renormalised, the (token,
expert) assignments stably sorted by expert, each expert's first C of them
kept (the rest dropped), the expert SwiGLU products over (E, C, D) in
capacity chunks, and the outputs gathered back through the inverse
permutation and weighted by the gates.  Every shape follows from the input's
shape alone: no ``.item()``, ``nonzero`` or boolean-mask indexing, so a
decode step has no host synchronisation here.

Two choices keep the reference's results exactly:
- top-k is a stable descending sort cut to k, so tied probabilities take the
  lowest expert index first, as ``jax.lax.top_k`` does (``torch.topk``
  orders ties otherwise; with a zeroed router every probability ties);
- the counts are a ``scatter_add`` into zeros (``torch.bincount`` on CUDA
  reads its maximum back to the host).

The router product is a plain fp32 ``torch.matmul`` and the expert products
are ``torch.bmm``: the JAX package computes both outside any Pallas kernel.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from ..distributed import sites
from .layers import _init

CHUNK = 8192          # capacity rows a chunk of the expert products takes


def init_moe(gen, d_model, d_ff, n_experts, dtype, device) -> dict:
    s = 1.0 / math.sqrt(d_model)
    return {
        "router": _init(gen, (d_model, n_experts), s, torch.float32, device),
        "w_gate": _init(gen, (n_experts, d_model, d_ff), s, dtype, device),
        "w_up": _init(gen, (n_experts, d_model, d_ff), s, dtype, device),
        "w_down": _init(gen, (n_experts, d_ff, d_model), 1.0 / math.sqrt(d_ff), dtype, device),
    }


MOE_AXES = {"router": ("embed", None), "w_gate": ("experts", "embed", "ffn"),
            "w_up": ("experts", "embed", "ffn"), "w_down": ("experts", "ffn", "embed")}


def capacity(n_assign: int, n_experts: int, capacity_factor: float) -> int:
    """Slots per expert: a Python int from the shapes alone."""
    return max(1, int(capacity_factor * n_assign / n_experts))


def top_k_gates(probs: torch.Tensor, top_k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(gates, expert ids), each (T, k): the k largest probabilities, ties to
    the lowest index, renormalised to sum to 1."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    vals, idx = vals[:, :top_k], idx[:, :top_k]
    return vals / (vals.sum(-1, keepdim=True) + 1e-9), idx


def inverse_permutation(order: torch.Tensor) -> torch.Tensor:
    """``argsort(order)`` of a permutation, by one scatter."""
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.numel(), device=order.device)
    return inv


def expert_ffn(params, xe: torch.Tensor) -> torch.Tensor:
    """The experts' SwiGLU over their slots: (E, c, D) -> (E, c, D)."""
    h = F.silu(torch.bmm(xe, params["w_gate"])) * torch.bmm(xe, params["w_up"])
    return torch.bmm(h, params["w_down"])


def moe_block(params, x: torch.Tensor, *, top_k: int, capacity_factor: float = 1.25,
              groups: int = 1) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> ((B, S, D), aux_loss).

    ``groups > 1`` dispatches each of ``groups`` equal runs of the B*S tokens
    on its own (its own capacity), as the reference's ``vmap`` does, and
    averages their aux losses.  DTensors go through their call site
    (``distributed.sites.moe``: expert parallelism)."""
    if isinstance(x, DTensor):
        return sites.moe(lambda p, xl, g, experts: dispatch(p, xl, top_k, capacity_factor, g,
                                                            experts), params, x, groups)
    return dispatch(params, x, top_k, capacity_factor, groups)


def dispatch(params, x, top_k: int, capacity_factor: float, groups: int,
             experts: tuple[int, int] | None = None):
    """``moe_block`` on local tensors.  ``experts`` (e0, n): the expert
    weights hold experts e0..e0+n-1 of the router's E, and the output sums
    only their products (the rest is zero); the routing, capacity and aux
    loss are the whole layer's."""
    B, S, D = x.shape
    T = B * S
    if groups > 1:
        if T % groups:
            raise ValueError(f"moe_block: {T} tokens do not split into {groups} groups")
        outs = [dispatch(params, g[None], top_k, capacity_factor, 1, experts)
                for g in x.reshape(groups, T // groups, D)]
        y = torch.cat([o for o, _ in outs]).reshape(B, S, D)
        return y, torch.stack([a for _, a in outs]).mean()
    E = params["router"].shape[1]
    N = T * top_k
    xt = x.reshape(T, D)
    dev = x.device

    probs = torch.softmax(torch.matmul(xt.float(), params["router"]), dim=-1)   # (T, E)
    gate_vals, gate_idx = top_k_gates(probs, top_k)

    flat_e = gate_idx.reshape(-1)                                              # (N,)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    sorted_tok = torch.div(torch.arange(N, device=dev), top_k, rounding_mode="floor")[order]
    counts = torch.zeros(E, dtype=torch.long, device=dev).scatter_add_(
        0, flat_e, torch.ones_like(flat_e))
    starts = torch.cumsum(counts, 0) - counts

    C = capacity(N, E, capacity_factor)
    slot = starts[:, None] + torch.arange(C, device=dev)[None, :]              # (E, C)
    valid = torch.arange(C, device=dev)[None, :] < counts[:, None]
    slot_tok = sorted_tok[slot.clamp(0, N - 1)]                                # (E, C)
    pos = torch.arange(N, device=dev) - starts[sorted_e]
    kept = pos < C
    row = sorted_e
    if experts is not None:       # this rank's experts only
        e0, n = experts
        slot_tok, valid = slot_tok[e0:e0 + n], valid[e0:e0 + n]
        kept = kept & (sorted_e >= e0) & (sorted_e < e0 + n)
        row = (sorted_e - e0).clamp(0, n - 1)

    # the expert products in capacity chunks of at most CHUNK slots, which
    # bounds the (E, chunk, d_ff) hidden working set whatever C is
    ye = torch.cat([expert_ffn(params, xt[slot_tok[:, lo:lo + CHUNK]]
                               * valid[:, lo:lo + CHUNK, None].to(x.dtype))
                    for lo in range(0, C, CHUNK)], dim=1)                      # (E, C, D)

    ye_n = ye[row, pos.clamp(0, C - 1)] * kept[:, None].to(x.dtype)            # (N, D)
    y = (ye_n[inverse_permutation(order)].reshape(T, top_k, D)
         * gate_vals[..., None].to(x.dtype)).sum(dim=1)

    # auxiliary load-balance loss (Switch-style)
    aux = E * torch.sum(probs.mean(0) * (counts.float() / max(N, 1)))
    return y.reshape(B, S, D), aux


def moe_flops_per_token(d_model: int, d_ff: int, top_k: int) -> int:
    """Active FLOPs per token for the expert MLPs (fwd): 3 matmuls x top_k."""
    return 2 * 3 * d_model * d_ff * top_k
