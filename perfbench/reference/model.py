"""The plain reference: the decode step of the benchmark's model families in float32 PyTorch.

Nothing here imports the program.  Every layer is written out from its
equations, as the configuration file describes the model:

- embedding, RMSNorm (weight times x / rms), rotary embeddings in the
  half-split form at positions 0.. (frequencies in float64, cast once);
- grouped-query attention (query head h reads KV head h // (H / KV)) over
  every cache row up to the step's position, the new row written at that
  position first (clamped to the last row, as a cache of ``max_len`` rows
  holds it);
- SwiGLU MLP; the MoE layer: a float32 router, the top-k experts of each
  token (ties to the lower index) with renormalised gates, each expert
  keeping the first ``C = int(capacity_factor * tokens * k / experts)`` of
  its assignments in (token, rank) order and dropping the rest;
- the Mamba2 mixer with one group: in_proj into (z, x, B, C, dt), a width-4
  causal depthwise conv and SiLU over (x, B, C), dt = softplus(dt + bias),
  A = -exp(A_log), the SSD recurrence h = exp(dt A) h + dt x B^T, y = C h +
  D x (every decay exp(clip(v, -60, 0))), the gated RMSNorm y * silu(z), and
  out_proj;
- the hybrid's one shared attention + MLP block after every
  ``attn_every``-th Mamba2 layer, each call site with its own KV cache;
- the final norm and an untied head over the true vocabulary.

``Precision`` holds the products: ``x @ w`` in float32 with TF32 off, or the
control's float8 (e4m3 operands and results, a scale per matrix for weights
and per row for activations).
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

CONV_K = 4


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# ---------------------------------------------------------------------------
# precision of the products
# ---------------------------------------------------------------------------

def _fp8(x: torch.Tensor, fmt, dims: tuple) -> torch.Tensor:
    """x rounded to ``fmt`` under a scale that maps the largest magnitude
    over ``dims`` (a row, or a whole matrix) to the format's largest value."""
    amax = x.abs().amax(dim=dims, keepdim=True).clamp_min(1e-30)
    scale = amax / torch.finfo(fmt).max
    return (x / scale).to(fmt).float() * scale


ROW, MATRIX = (-1,), (-2, -1)


class Precision:
    """The reference's products: ``"fp32"`` (the reference) or ``"fp8"``
    (the control, one precision below the configuration's bfloat16)."""

    def __init__(self, name: str = "fp32"):
        if name not in ("fp32", "fp8"):
            raise ValueError(name)
        self.name = name

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        if self.name == "fp32":
            return x @ w
        # e4m3 operands (activations per row, weights per matrix), and the
        # result rounded to e4m3 per row, as every activation a layer passes
        # on is held in the precision it computes in
        xq, wq = _fp8(x, torch.float8_e4m3fn, ROW), _fp8(w, torch.float8_e4m3fn, MATRIX)
        return _fp8(xq @ wq, torch.float8_e4m3fn, ROW)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def rms_norm(x, w, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w


def decay(v):
    return torch.exp(torch.clamp(v, -60.0, 0.0))


def head_dim(a):
    return a.get("head_dim") or a["d_model"] // a["n_heads"]


def mlp(p, x, pr):
    return pr.mm(F.silu(pr.mm(x, p["w_gate"])) * pr.mm(x, p["w_up"]), p["w_down"])


def moe(p, x, a, pr):
    """x (T, D) -> (T, D): top-k routing with per-expert capacity."""
    T, D = x.shape
    E, k = a["n_experts"], a["top_k"]
    N = T * k
    C = max(1, int(a["capacity_factor"] * N / E))
    probs = torch.softmax(pr.mm(x, p["router"]), dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    vals, idx = vals[:, :k], idx[:, :k]
    gates = vals / (vals.sum(-1, keepdim=True) + 1e-9)
    flat = idx.reshape(-1)
    # an assignment's rank among its expert's assignments, in (token, rank) order
    onehot = F.one_hot(flat, E)
    rank = ((torch.cumsum(onehot, 0) - 1) * onehot).sum(-1)
    kept = rank < C
    slot = torch.where(kept, flat * C + rank, E * C)            # E * C: the dropped bin
    xs = torch.zeros((E * C + 1, D), dtype=x.dtype, device=x.device)
    xs = xs.index_copy(0, slot, x.repeat_interleave(k, 0))[:E * C].view(E, C, D)
    h = F.silu(pr.mm(xs, p["w_gate"])) * pr.mm(xs, p["w_up"])
    ye = torch.cat([pr.mm(h, p["w_down"]).reshape(E * C, D),
                    torch.zeros((1, D), dtype=x.dtype, device=x.device)])
    return (ye[slot].view(T, k, D) * (gates * kept.view(T, k))[..., None]).sum(1)


def _split(zxbcdt, a):
    di, N = a["ssm_expand"] * a["d_model"], a["ssm_state"]
    return zxbcdt[..., :di], zxbcdt[..., di:2 * di + 2 * N], zxbcdt[..., 2 * di + 2 * N:]


# ---------------------------------------------------------------------------
# decode: one token for every slot against the caches
# ---------------------------------------------------------------------------

class Decoder:
    """The decode step of ``slots`` rows against caches of ``max_len`` rows,
    from zeroed caches, as a serving engine that feeds each slot one token
    a step at one shared position runs it."""

    def __init__(self, a: dict, params: dict, slots: int, max_len: int, pr: Precision):
        self.a, self.p, self.pr = a, params, pr
        dev = params["embed"].device
        f32 = dict(dtype=torch.float32, device=dev)
        self.max_len = max_len
        if a["family"] in ("ssm", "hybrid"):
            di, N, P = a["ssm_expand"] * a["d_model"], a["ssm_state"], a["ssm_headdim"]
            L = a["n_layers"]
            self.conv = torch.zeros((L, slots, CONV_K - 1, di + 2 * N), **f32)
            self.ssm = torch.zeros((L, slots, di // P, P, N), **f32)
            sites = L // a["attn_every"] if a["family"] == "hybrid" else 0
        else:
            sites = a["n_layers"]
        if sites:
            kv, hd = a["n_kv_heads"], head_dim(a)
            freqs = torch.as_tensor(1.0 / (a["rope_theta"] ** (np.arange(0, hd, 2) / hd)),
                                    dtype=torch.float32, device=dev)
            ang = torch.arange(max_len, dtype=torch.float32, device=dev)[:, None] * freqs
            self.cos, self.sin = torch.cos(ang), torch.sin(ang)       # (max_len, hd/2)
            self.k = torch.zeros((sites, slots, max_len, kv, hd), **f32)
            self.v = torch.zeros_like(self.k)

    def _attention(self, p, x, site, n):
        a, pr = self.a, self.pr
        B = x.shape[0]
        H, KV, hd = a["n_heads"], a["n_kv_heads"], head_dim(a)
        row = min(max(n, 0), self.max_len - 1)
        q = self._rope(pr.mm(x, p["wq"]).view(B, H, hd), n)
        k = self._rope(pr.mm(x, p["wk"]).view(B, KV, hd), n)
        self.k[site, :, row] = k
        self.v[site, :, row] = pr.mm(x, p["wv"]).view(B, KV, hd)
        kk, vv = self.k[site, :, :n + 1], self.v[site, :, :n + 1]               # (B,T,KV,hd)
        qg = q.view(B, KV, H // KV, hd)
        logits = torch.einsum("bkgd,btkd->bkgt", qg, kk) / math.sqrt(hd)
        o = torch.einsum("bkgt,btkd->bkgd", torch.softmax(logits, dim=-1), vv)
        return pr.mm(o.reshape(B, H * hd), p["wo"])

    def _rope(self, x, n):
        """x (B, heads, hd) at position n < ``max_len``."""
        cos, sin = self.cos[n], self.sin[n]
        x1, x2 = x.chunk(2, dim=-1)
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)

    def _attn_block(self, p, x, site, n):
        a = self.a
        x = x + self._attention(p["attn"], rms_norm(x, p["norm1"], a["norm_eps"]), site, n)
        h = rms_norm(x, p["norm2"], a["norm_eps"])
        return x + (moe(p["moe"], h, a, self.pr) if "moe" in p else mlp(p["mlp"], h, self.pr))

    def _mamba(self, p, x, i):
        a, pr = self.a, self.pr
        B = x.shape[0]
        di, N, P = a["ssm_expand"] * a["d_model"], a["ssm_state"], a["ssm_headdim"]
        z, xBC, dt = _split(pr.mm(x, p["in_proj"]), a)
        dt = F.softplus(dt + p["dt_bias"])                                        # (B,H)
        window = torch.cat([self.conv[i], xBC[:, None]], dim=1)                  # (B,K,C)
        self.conv[i] = window[:, 1:]
        xBC = F.silu((window * p["conv"][None]).sum(1))
        xs = xBC[:, :di].view(B, di // P, P)
        Bm, Cm = xBC[:, di:di + N], xBC[:, di + N:]
        A = -torch.exp(p["A_log"])
        h = self.ssm[i] * decay(dt * A)[..., None, None] + torch.einsum(
            "bhp,bn->bhpn", xs * dt[..., None], Bm)
        self.ssm[i] = h
        y = torch.einsum("bhpn,bn->bhp", h, Cm) + xs * p["D"][:, None]
        return pr.mm(rms_norm(y.reshape(B, di) * F.silu(z), p["norm"], a["norm_eps"]), p["out_proj"])

    @torch.no_grad()
    def step(self, tokens: torch.Tensor, n: int) -> torch.Tensor:
        """tokens (B,) fed at position ``n``: the logits (B, vocab)."""
        a, p = self.a, self.p
        x = p["embed"][tokens]
        site = 0
        for i, lp in enumerate(p["layers"]):
            if a["family"] in ("ssm", "hybrid"):
                x = x + self._mamba(lp["mixer"], rms_norm(x, lp["norm"], a["norm_eps"]), i)
                if a["family"] == "hybrid" and (i + 1) % a["attn_every"] == 0:
                    x = self._attn_block(p["shared_attn"], x, site, n)
                    site += 1
            else:
                x = self._attn_block(lp, x, i, n)
        x = rms_norm(x, p["final_norm"], a["norm_eps"])
        return self.pr.mm(x, p["lm_head"][:, :a["vocab"]])
