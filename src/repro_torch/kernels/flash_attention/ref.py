"""Plain PyTorch (naive softmax) versions of blocked causal GQA attention:
the forward, the forward with its row log-sum-exp, the backward in
explicit formulas, and the bf16 kernel's pre-pass on V."""
import math

import torch


def _repeat_kv(q, *kv):
    """k and/or v repeated over each group of q's heads."""
    return [t.repeat_interleave(q.shape[1] // t.shape[1], dim=1) for t in kv]


def _logits(q, k, causal: bool):
    """fp32 scores q k^T / sqrt(d) (k with q's heads), masked to -1e30 above
    the diagonal when ``causal``: (B, H, S, S)."""
    S, d = q.shape[2], q.shape[3]
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) / math.sqrt(d)
    if causal:
        mask = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
        logits = logits.masked_fill(~mask, -1e30)
    return logits


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True) -> torch.Tensor:
    """q: (B, H, S, d); k/v: (B, KV, S, d); KV divides H."""
    k, v = _repeat_kv(q, k, v)
    logits = _logits(q, k, causal)
    p = torch.exp(logits - logits.amax(-1, keepdim=True))
    p = p / p.sum(-1, keepdim=True)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


def attention_lse_ref(q, k, v, causal: bool = True):
    """``attention_ref``'s output and the fp32 row log-sum-exp (B, H, S) of
    the scaled, masked scores."""
    lse = torch.logsumexp(_logits(q, *_repeat_kv(q, k), causal), -1)
    return attention_ref(q, k, v, causal), lse


def flash_bwd_ref(q, k, v, o, lse, do, causal: bool = True):
    """(dq, dk, dv) of attention at output gradient ``do``, from the
    forward's output ``o`` and row log-sum-exp ``lse``, in fp32 and in
    explicit formulas: D = rowsum(dO o O), P = exp(S scale - lse),
    dV = sum over the group of P^T dO, dP = dO V^T, dS = P o (dP - D),
    dQ = scale dS K, dK = scale sum over the group of dS^T Q.  Each
    gradient comes back in its input's dtype."""
    B, H, S, d = q.shape
    KV = k.shape[1]
    scale = 1.0 / math.sqrt(d)
    f = {n: t.float() for n, t in dict(q=q, k=k, v=v, o=o, do=do).items()}
    kr, vr = _repeat_kv(q, f["k"], f["v"])
    p = torch.exp(_logits(q, kr, causal) - lse.float()[..., None])   # 0 where masked
    dd = (f["do"] * f["o"]).sum(-1, keepdim=True)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, f["do"])
    dp = torch.einsum("bhqd,bhkd->bhqk", f["do"], vr)
    ds = p * (dp - dd)
    dq = scale * torch.einsum("bhqk,bhkd->bhqd", ds, kr)
    dk = scale * torch.einsum("bhqk,bhqd->bhkd", ds, f["q"])

    def group_sum(t):
        return t.reshape(B, KV, H // KV, S, d).sum(2)

    return dq.to(q.dtype), group_sum(dk).to(k.dtype), group_sum(dv).to(v.dtype)


def v_to_f16_ref(v: torch.Tensor):
    """The bf16 kernel's pre-pass on V: v (B, KV, S, d) bf16 -> (v16, e),
    v16 = v 2^-e in fp16 and e int32 (B, KV), per (b, KV head) the least
    exponent that puts the largest finite |v| times 2^-e at or below 2^15
    (fp16 reaches 65504); e = 0 for a head with no finite nonzero value.
    inf and NaN go through as they are.  Exact for every value that lands in
    fp16's normal range (2^-14 and above)."""
    a = v.double().abs().flatten(2)
    mx = torch.where(torch.isfinite(a), a, 0.0).amax(-1)
    frac, x = torch.frexp(mx)                      # mx = frac 2^x, frac in [0.5, 1)
    e = torch.where(mx > 0, x - 15 - (frac == 0.5).int(), 0).int()
    return (v.double() * torch.exp2(-e.double())[..., None, None]).half(), e
