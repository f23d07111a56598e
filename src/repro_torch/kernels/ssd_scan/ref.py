"""Plain PyTorch versions of the Mamba2 SSD scan.

``ssd_ref`` is the per-token recurrence (the oracle); ``ssd_chunk_ref`` is the
intra-chunk dual form that ``csrc/ssd_scan.cu`` computes, in the kernel's
output layout, and ``ssd_chunk_bwd_ref`` its gradient in explicit formulas,
which ``csrc/ssd_scan_bwd.cu`` computes; ``chunk_carry`` is the inter-chunk
recurrence over the chunks' states.
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


def _chunked(x, dt, Bm, Cm, Q: int, dtype=torch.float32):
    """The inputs in ``dtype``, padded with zeros to whole chunks of Q rows,
    in the chunk layouts: x (B,nc,H,Q,P), dt (B,nc,H,Q), Bm and Cm
    (B,nc,1,Q,N)."""
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    nc = -(-S // Q)
    pad = nc * Q - S
    x, dt, Bm, Cm = (t.to(dtype) for t in (x, dt, Bm, Cm))
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
    return (x.reshape(Bsz, nc, Q, H, P).transpose(2, 3), dt.reshape(Bsz, nc, Q, H).transpose(2, 3),
            Bm.reshape(Bsz, nc, 1, Q, N), Cm.reshape(Bsz, nc, 1, Q, N))


def ssd_chunk_ref(x, dt, A, Bm, Cm, chunk: int):
    """The TPU kernel's four outputs, all fp32, for chunks of ``chunk`` rows.

    x: (B,S,H,P); dt: (B,S,H); A: (H,); Bm/Cm: (B,S,N).  S is padded with
    zeros to a multiple of ``chunk`` (dt = 0 there, so nothing is added).
    Returns (y_intra (B,nc,H,Q,P), states (B,nc,H,P,N), in_decay (B,nc,H,Q),
    chunk_decay (B,nc,H,1)).
    """
    Q = chunk
    xc, dtc, Bc, Cc = _chunked(x, dt, Bm, Cm, Q)

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


def _clamp_grad(v):
    """The gradient of clamp(v, -60, 0), as torch's clamp backward gives it:
    1 inside the bounds, the bounds included, 0 outside."""
    return ((v >= -60.0) & (v <= 0.0)).to(v.dtype)


def ssd_chunk_bwd_ref(x, dt, A, Bm, Cm, chunk: int, grads):
    """The gradients of (x, dt, A, Bm, Cm), each in its input's dtype, for
    the gradients ``grads`` of ``ssd_chunk_ref``'s four outputs (None where
    an output has none), in explicit formulas.  With M = (C B^T) o L and
    xdt = x dt, per (b, chunk, head):
      y_intra:     dM = dy xdt^T; dxdt = M^T dy; dG = dM o L (summed over
                   heads, then dC = dG B, dB = dG^T C); dseg = dM o G o L
                   inside the clip, added to dcum_i and taken from dcum_j
      states:      st = B dS^T; dxdt += decay_end st; dB += (xdt decay_end) dS
                   summed over heads; d decay_end = rowsum(xdt o st)
      in_decay, chunk_decay: through exp(clip(cum)) and exp(clip(cum_end))
    then dx = dxdt dt, ddt = rowsum(dxdt o x) + A d(dt A), and d(dt A) and dA
    from the reverse cumsum of dcum.  Rows past S (the zero padding) are
    dropped.  In fp32, or in float64 where every input is float64 (a
    reference for the fp32 versions' rounding).
    """
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    Q = chunk
    f = (torch.float64 if all(t.dtype == torch.float64 for t in (x, dt, A, Bm, Cm))
         else torch.float32)
    xc, dtc, Bc, Cc = _chunked(x, dt, Bm, Cm, Q, f)
    nc = xc.shape[1]
    gy, gst, gin, gcd = (None if g is None else g.to(f) for g in grads)
    a = A.to(f)[:, None]
    cum = torch.cumsum(dtc * a, dim=-1)                      # (B,nc,H,Q)
    cend = cum[..., -1:]
    seg = cum[..., :, None] - cum[..., None, :]
    L = torch.where(torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril(),
                    decay(seg), 0.0)
    xdt = xc * dtc[..., None]
    G = Cc @ Bc.transpose(-1, -2)                            # (B,nc,1,Q,Q)
    de = decay(cend - cum)                                   # decay_end
    gcum = torch.zeros_like(cum)
    gxdt = torch.zeros_like(xdt)
    gB = torch.zeros_like(Bc[:, :, 0])
    gC = torch.zeros_like(Cc[:, :, 0])
    if gy is not None:
        gM = gy @ xdt.transpose(-1, -2)                     # (B,nc,H,Q,Q)
        gxdt = gxdt + (G * L).transpose(-1, -2) @ gy
        gG = (gM * L).sum(2)                                 # (B,nc,Q,Q)
        gC = gC + gG @ Bc[:, :, 0]
        gB = gB + gG.transpose(-1, -2) @ Cc[:, :, 0]
        gseg = gM * G * L * _clamp_grad(seg)
        gcum = gcum + gseg.sum(-1) - gseg.sum(-2)
    if gst is not None:
        st = Bc @ gst.transpose(-1, -2)                      # (B,nc,H,Q,P)
        gxdt = gxdt + de[..., None] * st
        gB = gB + ((xdt * de[..., None]) @ gst).sum(2)
        t = (xdt * st).sum(-1) * de * _clamp_grad(cend - cum)
        gcum = gcum - t
        gcum[..., -1] += t.sum(-1)
    if gin is not None:
        gcum = gcum + gin * decay(cum) * _clamp_grad(cum)
    if gcd is not None:
        gcum[..., -1] += gcd[..., 0] * decay(cend[..., 0]) * _clamp_grad(cend[..., 0])
    gdta = torch.flip(torch.cumsum(torch.flip(gcum, (-1,)), -1), (-1,))
    gdtc = (gxdt * xc).sum(-1) + gdta * a
    gA = (gdta * dtc).sum((0, 1, 3))
    gx = (gxdt * dtc[..., None]).transpose(2, 3).reshape(Bsz, nc * Q, H, P)[:, :S]
    gdt = gdtc.transpose(2, 3).reshape(Bsz, nc * Q, H)[:, :S]
    gB, gC = (g.reshape(Bsz, nc * Q, N)[:, :S] for g in (gB, gC))
    return (gx.to(x.dtype), gdt.to(dt.dtype), gA.to(A.dtype), gB.to(Bm.dtype),
            gC.to(Cm.dtype))
