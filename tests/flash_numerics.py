"""The bf16 flash kernel's arithmetic emulated in fp32 torch, for studying
how it rounds P (no kernel runs it; neither JAX nor the JAX package is
needed, so the scripts under experiments/numerics/ run it on the card too).
Used by tests/test_torch_flash_attention.py."""
import torch

from repro_torch.kernels.flash_attention.ref import v_to_f16_ref

# how the bf16 kernel rounds P before P V: name -> (P's rounding, whether V
# goes in as the pre-pass's fp16 times 2^e)
P_FORMS = {
    "split": (lambda p: (hi := p.bfloat16().float()) + (p - hi).bfloat16().float(), False),
    "fp16": (lambda p: p.half().float(), True),
    "bf16": (lambda p: p.bfloat16().float(), False),   # FA2/FA3's one bf16 P
}


def wgmma_numerics(q, k, v, causal, p_form, block=128, l_sums_rounded=False):
    """The bf16 kernel's arithmetic in fp32 torch: S = Q K^T summed in fp32
    (products of bf16 values are exact), an online softmax over 128-key
    tiles in the log2 domain, the row sum of the unrounded P (of the rounded
    one with ``l_sums_rounded``), P V with P as ``P_FORMS[p_form]`` rounds
    it -- "split" into bf16 hi + lo, each through P V (the kernel's forward
    that writes the LSE), "fp16" against V per KV head as fp16 times 2^e,
    the output scaled back by 2^e (its forward without the LSE), "bf16"
    once -- and one rounding of the output."""
    B, H, S, d = q.shape
    rep = H // k.shape[1]
    round_p, v_in_fp16 = P_FORMS[p_form]
    back = torch.ones(B, H, 1, 1, dtype=torch.float64, device=q.device)
    if v_in_fp16:
        v, e = v_to_f16_ref(v)
        back = torch.exp2(e.double()).repeat_interleave(rep, 1)[..., None, None]
    q, k, v = q.float(), k.repeat_interleave(rep, 1).float(), v.repeat_interleave(rep, 1).float()
    scale = 1.4426950408889634 / d ** 0.5
    m = torch.full((B, H, S, 1), -1e30, device=q.device)
    l = torch.zeros(B, H, S, 1, device=q.device)
    o = torch.zeros(B, H, S, d, device=q.device)
    qp = torch.arange(S, device=q.device).view(S, 1)
    for k0 in range(0, S, block):
        s = torch.einsum("bhqd,bhkd->bhqk", q, k[:, :, k0:k0 + block])
        if causal:
            kp = torch.arange(k0, min(k0 + block, S), device=q.device).view(1, -1)
            s = s.masked_fill(kp > qp, -1e30)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp2((m - m_new) * scale)
        p = torch.exp2(s * scale - m_new * scale)
        p_used = round_p(p)
        l = l * alpha + (p_used if l_sums_rounded else p).sum(-1, keepdim=True)
        o = o * alpha + torch.einsum("bhqk,bhkd->bhqd", p_used, v[:, :, k0:k0 + block])
        m = m_new
    return ((o / l.clamp_min(1e-30)).double() * back).float().bfloat16()
