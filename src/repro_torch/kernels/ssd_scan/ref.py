"""Plain PyTorch versions of the Mamba2 SSD scan.

``ssd_ref`` is the per-token recurrence (the oracle); ``ssd_chunk_ref`` is the
intra-chunk dual form that ``csrc/ssd_scan.cu`` computes, in the kernel's
output layout; ``chunk_carry`` is the inter-chunk recurrence over the chunks'
states.
"""
import torch
import torch.nn.functional as F


def decay(v: torch.Tensor) -> torch.Tensor:
    """exp(clip(v, -60, 0)): the clip every decay of the reference applies."""
    return torch.exp(torch.clamp(v, -60.0, 0.0))


def chunk_carry(states: torch.Tensor, chunk_decay: torch.Tensor):
    """The inter-chunk recurrence.  states: (B,nc,H,P,N), each chunk's own
    outgoing state; chunk_decay: (B,nc,H).  Returns (final (B,H,P,N),
    prev (B,nc,H,P,N)), where prev[:, c] is the state entering chunk c."""
    h = torch.zeros_like(states[:, 0])
    prev = []
    for c in range(states.shape[1]):
        prev.append(h)
        h = h * chunk_decay[:, c, :, None, None] + states[:, c]
    return h, torch.stack(prev, dim=1)


def ssd_ref(x, dt, A, Bm, Cm):
    """Sequential state-space recurrence.

    x: (B,S,H,P); dt: (B,S,H); A: (H,); Bm/Cm: (B,S,N).
    Returns (y: (B,S,H,P) in x's dtype, final_state: (B,H,P,N) fp32)."""
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    xf, dtf, bf, cf = x.float(), dt.float(), Bm.float(), Cm.float()
    h = torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(S):
        dA = decay(dtf[:, t] * A[None, :])
        upd = torch.einsum("bhp,bn->bhpn", xf[:, t] * dtf[:, t, :, None], bf[:, t])
        h = h * dA[..., None, None] + upd
        ys.append(torch.einsum("bhpn,bn->bhp", h, cf[:, t]))
    return torch.stack(ys, dim=1).to(x.dtype), h


def ssd_chunk_ref(x, dt, A, Bm, Cm, chunk: int):
    """The TPU kernel's four outputs, all fp32, for chunks of ``chunk`` rows.

    x: (B,S,H,P); dt: (B,S,H); A: (H,); Bm/Cm: (B,S,N).  S is padded with
    zeros to a multiple of ``chunk`` (dt = 0 there, so nothing is added).
    Returns (y_intra (B,nc,H,Q,P), states (B,nc,H,P,N), in_decay (B,nc,H,Q),
    chunk_decay (B,nc,H,1)).
    """
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    Q = chunk
    nc = -(-S // Q)
    pad = nc * Q - S
    x, dt, Bm, Cm = (t.float() for t in (x, dt, Bm, Cm))
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
    xc = x.reshape(Bsz, nc, Q, H, P).transpose(2, 3)        # (B,nc,H,Q,P)
    dtc = dt.reshape(Bsz, nc, Q, H).transpose(2, 3)         # (B,nc,H,Q)
    Bc = Bm.reshape(Bsz, nc, 1, Q, N)
    Cc = Cm.reshape(Bsz, nc, 1, Q, N)

    cum = torch.cumsum(dtc * A.float()[:, None], dim=-1)    # (B,nc,H,Q)
    seg = cum[..., :, None] - cum[..., None, :]             # (B,nc,H,Q,Q)
    causal = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    L = torch.where(causal, decay(seg), 0.0)

    xdt = xc * dtc[..., None]                                # (B,nc,H,Q,P)
    G = Cc @ Bc.transpose(-1, -2)                            # (B,nc,1,Q,Q)
    y = (G * L) @ xdt                                        # (B,nc,H,Q,P)
    decay_end = decay(cum[..., -1:] - cum)                  # (B,nc,H,Q)
    states = (xdt * decay_end[..., None]).transpose(-1, -2) @ Bc   # (B,nc,H,P,N)
    return y, states, decay(cum), decay(cum[..., -1:])
