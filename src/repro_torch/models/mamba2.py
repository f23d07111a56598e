"""Mamba2 (SSD, state-space duality) blocks (port of ``repro.models.mamba2``).

The chunked scan ``ssd_chunked`` computes, within chunks of Q rows, the output
with dense products and carries chunk-final states with a sequential loop
over chunks.  ``mamba2_block`` runs its SSD through ``ssd_scan`` (the
hand-written kernel on CUDA tensors) with ``kernels=True`` and through the
plain ``ssd_chunked`` with ``kernels=False``; its two projections go through
``layers.matmul``, so they run on ``ltrf_matmul``.

Shapes follow the minimal Mamba2 formulation with n_groups=1:
  x:  (B, S, H, P)    per-head inputs (P = head dim)
  dt: (B, S, H)       softplus-positive step sizes
  B,C:(B, S, N)       input/output projections (shared across heads)
  A:  (H,)            negative decay rates
State: (B, H, P, N).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from ..distributed import sites
from ..kernels.ssd_scan.ops import ssd_scan
from ..kernels.ssd_scan.ref import chunk_carry, decay
from .layers import _init, matmul, rms_norm

CONV_K = 4  # depthwise conv kernel width


def init_mamba2(gen, d_model, d_state, headdim, expand, dtype, device) -> dict:
    d_inner = expand * d_model
    nheads = d_inner // headdim
    s = 1.0 / math.sqrt(d_model)
    d_in_proj = 2 * d_inner + 2 * d_state + nheads  # z, x, B, C, dt
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "in_proj": _init(gen, (d_model, d_in_proj), s, dtype, device),
        "conv": _init(gen, (CONV_K, d_inner + 2 * d_state), 0.5, dtype, device),
        "A_log": (torch.empty((nheads,), **f32) if torch.device(device).type == "meta"
                  else torch.log(torch.linspace(1.0, 16.0, nheads, **f32))),
        "dt_bias": torch.zeros((nheads,), **f32),
        "D": torch.ones((nheads,), **f32),
        "norm": torch.ones((d_inner,), **f32),
        "out_proj": _init(gen, (d_inner, d_model), 1.0 / math.sqrt(d_inner), dtype, device),
    }


MAMBA2_AXES = {"in_proj": ("embed", "ffn"), "conv": (None, "ffn"), "A_log": (None,),
               "dt_bias": (None,), "D": (None,), "norm": ("ffn",), "out_proj": ("ffn", "embed")}


def _split_proj(zxbcdt, d_inner, d_state):
    """z, xBC and dt of the in_proj output.  A column-split DTensor is
    gathered once here: DTensor would gather the whole tensor for each
    slice."""
    zxbcdt = sites.gather_last(zxbcdt)
    z = zxbcdt[..., :d_inner]
    xBC = zxbcdt[..., d_inner:2 * d_inner + 2 * d_state]
    dt = zxbcdt[..., 2 * d_inner + 2 * d_state:]
    return z, xBC, dt


def _causal_conv(xBC, conv_w, state=None):
    """Depthwise causal conv along seq.  xBC: (B,S,C); conv_w: (K,C).

    With ``state`` (B, K-1, C) performs streaming conv (decode).  The sum of
    the K shifted products runs in the activation dtype, in the reference's
    order (not ``conv1d``, which rounds elsewhere in bf16 and goes through
    cuDNN, in TF32 for fp32, on the card)."""
    S = xBC.shape[1]
    if state is not None:
        xBC = torch.cat([state, xBC], dim=1)
    else:
        xBC = F.pad(xBC, (0, 0, CONV_K - 1, 0))
    new_state = xBC[:, -(CONV_K - 1):]
    out = sum(xBC[:, k:k + S] * conv_w[k][None, None] for k in range(CONV_K))
    return F.silu(out), new_state


def causal_conv(xBC, conv_w, state=None):
    """``_causal_conv``; DTensors through their call site
    (``distributed.sites.conv``)."""
    if isinstance(xBC, DTensor):
        return sites.conv(_causal_conv, xBC, conv_w, state)
    return _causal_conv(xBC, conv_w, state)


def _causal_mask(Q: int, device) -> torch.Tensor:
    """(Q, Q) bool, True on and below the diagonal."""
    idx = torch.arange(Q, device=device)
    return idx[:, None] >= idx[None, :]


def ssd_chunked(x, dt, A, Bm, Cm, chunk: int):
    """SSD forward over a full sequence (training / prefill).

    x: (B,S,H,P) dt: (B,S,H) A: (H,) Bm/Cm: (B,S,N).
    Returns (y: (B,S,H,P), final_state: (B,H,P,N)).
    """
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    Q = min(chunk, S)
    nc = -(-S // Q)
    pad = nc * Q - S
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))

    xc = x.reshape(Bsz, nc, Q, H, P)
    dtc = dt.reshape(Bsz, nc, Q, H)
    Bc = Bm.reshape(Bsz, nc, Q, N)
    Cc = Cm.reshape(Bsz, nc, Q, N)

    dA = dtc * A[None, None, None, :]          # (B,nc,Q,H)  (negative)
    cum = torch.cumsum(dA, dim=2)              # within-chunk cumulative
    seg_end = cum[:, :, -1:, :] - cum          # (B,nc,Q,H): end-of-chunk decay
    # intra-chunk causal kernel L[i,j] = exp(cum_i - cum_j) for i >= j
    L = decay(cum[:, :, :, None, :] - cum[:, :, None, :, :])
    L = L * _causal_mask(Q, x.device)[None, None, :, :, None]

    xdt = xc * dtc[..., None]                  # dt-weighted inputs
    # intra-chunk: y[i] = C_i . sum_j L[i,j] B_j x_j dt_j
    G = torch.einsum("bcin,bcjn->bcij", Cc, Bc)  # (B,nc,Q,Q)
    M = G[..., None] * L                       # (B,nc,Q,Q,H)
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", M, xdt)

    # chunk-final states: sum_j exp(cum_end - cum_j) B_j x_j dt_j
    chunk_state = torch.einsum("bcjn,bcjh,bcjhp->bchpn", Bc, decay(seg_end), xdt)
    final, prev_states = chunk_carry(chunk_state, decay(cum[:, :, -1, :]))

    # inter-chunk contribution: y[i] += (C_i . h_prev) * exp(cum_i)
    y_inter = torch.einsum("bcin,bchpn,bcih->bcihp", Cc, prev_states, decay(cum))
    y = (y_intra + y_inter).reshape(Bsz, nc * Q, H, P)
    return y[:, :S], final


def ssd_decode_step(state, x, dt, A, Bm, Cm):
    """One-token SSD update.  state: (B,H,P,N); x: (B,H,P); dt: (B,H);
    Bm/Cm: (B,N).  Returns (y, new_state)."""
    dA = decay(dt * A[None, :])                   # (B,H)
    xdt = x * dt[..., None]
    upd = torch.einsum("bhp,bn->bhpn", xdt, Bm)
    new_state = state * dA[..., None, None] + upd
    y = torch.einsum("bhpn,bn->bhp", new_state, Cm)
    return y, new_state


def mamba2_block(params, x, *, d_state, headdim, expand, chunk, norm_eps=1e-5,
                 initial=None, return_state=False, kernels=True):
    """Full Mamba2 mixer over a sequence.  x: (B,S,D)."""
    B, S, D = x.shape
    d_inner = expand * D
    nheads = d_inner // headdim
    zxbcdt = matmul(x, params["in_proj"], kernels)
    z, xBC, dt = _split_proj(zxbcdt, d_inner, d_state)
    dt = F.softplus(dt.float() + params["dt_bias"])
    conv_state = None if initial is None else initial.get("conv")
    xBC, new_conv = causal_conv(xBC, params["conv"], conv_state)
    xs = sites.unflatten_last(xBC[..., :d_inner], nheads, headdim)
    Bm = xBC[..., d_inner:d_inner + d_state]
    Cm = xBC[..., d_inner + d_state:]
    A = -torch.exp(params["A_log"])
    ssm_state = None if initial is None else initial.get("ssm")
    # the kernel reads its inputs in place, so they are made contiguous
    scan = ssd_scan if kernels else ssd_chunked
    args = (xs.float().contiguous(), dt.contiguous(), A,
            Bm.float().contiguous(), Cm.float().contiguous(), chunk)
    y, final = sites.ssd(scan, *args) if isinstance(xs, DTensor) else scan(*args)
    if ssm_state is not None:
        # carry-in state contribution (decode prefill continuation): add
        # C_t . (decay from t=0) h_in
        cumdA = torch.cumsum(dt * A[None, None, :], dim=1)
        y = y + torch.einsum("bsn,bhpn,bsh->bshp", Cm.float(), ssm_state.float(),
                             decay(cumdA))
        final = final + ssm_state * decay(cumdA[:, -1])[..., None, None]
    y = y + xs.float() * params["D"][None, None, :, None]
    y = y.reshape(B, S, d_inner).to(x.dtype)
    y = rms_norm(y * F.silu(z), params["norm"], norm_eps)
    out = matmul(y, params["out_proj"], kernels)
    if return_state:
        return out, {"conv": new_conv, "ssm": final}
    return out


def mamba2_decode(params, x, cache, *, d_state, headdim, expand, norm_eps=1e-5,
                  kernels=True):
    """One-token decode.  x: (B,1,D); cache: {'conv': (B,K-1,C), 'ssm': (B,H,P,N)}.

    Returns (out, {'conv', 'ssm'}); the new ssm state is fp32, whatever the
    cache held (as in the reference)."""
    B, S, D = x.shape
    d_inner = expand * D
    nheads = d_inner // headdim
    zxbcdt = matmul(x, params["in_proj"], kernels)
    z, xBC, dt = _split_proj(zxbcdt, d_inner, d_state)
    dt = F.softplus(dt.float() + params["dt_bias"])[:, 0]  # (B,H)
    xBC, new_conv = causal_conv(xBC, params["conv"], cache["conv"])
    xs = sites.unflatten_last(xBC[:, 0, :d_inner], nheads, headdim)
    Bm = xBC[:, 0, d_inner:d_inner + d_state]
    Cm = xBC[:, 0, d_inner + d_state:]
    A = -torch.exp(params["A_log"])
    y, new_ssm = ssd_decode_step(cache["ssm"].float(), xs.float(), dt, A,
                                 Bm.float(), Cm.float())
    y = y + xs.float() * params["D"][None, :, None]
    y = y.reshape(B, 1, d_inner).to(x.dtype)
    y = rms_norm(y * F.silu(z), params["norm"], norm_eps)
    return matmul(y, params["out_proj"], kernels), {"conv": new_conv, "ssm": new_ssm}
