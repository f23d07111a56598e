"""Architecture and shape configuration (port of ``repro.configs.base``).

``ArchConfig`` carries the same fields as the JAX package's, with the same
analytic parameter counts; its dtype glue is ``torch_dtype`` in place of
``jdtype``.  ``ShapeConfig``, ``SHAPES``, ``cell_is_runnable`` and
``smoke_shape`` are copies; the dry-run's ``input_specs`` gives meta tensors
where the reference gives ``ShapeDtypeStruct``s.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                 # dense | moe | vlm | audio | ssm | hybrid
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0           # 0 -> d_model // n_heads
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    moe_groups: int = 1
    # SSM (mamba2)
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    # hybrid (zamba2)
    attn_every: int = 0
    # frontends
    n_codebooks: int = 0
    n_patches: int = 0
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    kv_dtype: str = ""          # decode KV-cache dtype ("" -> dtype)
    remat: str = "full"         # none | block | full: recompute each block in backward
    scan_layers: bool = True    # JAX compile-time choice; unused by the port
    q_block: int = 512          # plain attention's q-block
    source: str = ""

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def torch_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        return self.family in ("ssm", "hybrid")

    def param_count(self) -> int:
        """Analytic parameter count (embeddings + blocks + head)."""
        D, F, L, V = self.d_model, self.d_ff, self.n_layers, self.vocab
        H, KV, hd = self.n_heads, self.n_kv_heads, self.hd
        n = V * D  # embed
        if self.n_codebooks:
            n = self.n_codebooks * V * D
        attn = D * H * hd + 2 * D * KV * hd + H * hd * D
        mlp = 3 * D * F
        if self.family == "moe":
            per_layer = attn + self.n_experts * mlp + D * self.n_experts + 2 * D
            n += L * per_layer
        elif self.family == "ssm":
            n += L * self._mamba_params() + L * D
        elif self.family == "hybrid":
            n += L * self._mamba_params() + L * D
            n += attn + mlp + 2 * D  # one shared block
        else:
            n += L * (attn + mlp + 2 * D)
        n += D  # final norm
        n += D * V * max(self.n_codebooks, 1)  # head
        return n

    def _mamba_params(self) -> int:
        D = self.d_model
        d_inner = self.ssm_expand * D
        nheads = d_inner // self.ssm_headdim
        d_in_proj = 2 * d_inner + 2 * self.ssm_state + nheads
        return (D * d_in_proj + 4 * (d_inner + 2 * self.ssm_state)
                + 3 * nheads + d_inner + d_inner * D)

    def active_param_count(self) -> int:
        """MoE: params touched per token (top-k experts only)."""
        if self.family != "moe":
            return self.param_count()
        D, F, L = self.d_model, self.d_ff, self.n_layers
        H, KV, hd = self.n_heads, self.n_kv_heads, self.hd
        attn = D * H * hd + 2 * D * KV * hd + H * hd * D
        mlp = 3 * D * F
        n = self.vocab * D * 2
        n += L * (attn + self.top_k * mlp + D * self.n_experts + 2 * D)
        return n


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                   # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def cell_is_runnable(arch: ArchConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """Whether (arch x shape) is a defined dry-run cell."""
    if shape.name == "long_500k" and not arch.sub_quadratic:
        return False, "full quadratic attention at 524k context: skipped per assignment"
    return True, ""


def input_specs(arch: ArchConfig, shape: ShapeConfig) -> dict:
    """Meta-tensor stand-ins for every model input of this cell, with the
    reference's dtypes (int32 tokens, labels and ``cache_len``; the arch's
    dtype for patches)."""
    B, S = shape.global_batch, shape.seq_len
    i32 = torch.int32

    def spec(shp, dtype=i32):
        return torch.empty(shp, dtype=dtype, device="meta")

    if shape.kind in ("train", "prefill"):
        if arch.family == "vlm":
            n_img = arch.n_patches
            return {
                "tokens": spec((B, S - n_img)),
                "patches": spec((B, n_img, arch.d_model), arch.torch_dtype),
                "labels": spec((B, S)),
            }
        if arch.family == "audio":
            K = arch.n_codebooks
            return {"codes": spec((B, K, S)), "labels": spec((B, K, S))}
        return {"tokens": spec((B, S)), "labels": spec((B, S))}
    # decode: one new token against a seq_len-deep cache
    if arch.family == "audio":
        tok = spec((B, arch.n_codebooks, 1))
    else:
        tok = spec((B, 1))
    return {"tokens": tok, "cache_len": spec(())}


def smoke_shape(kind: str = "train") -> ShapeConfig:
    if kind == "decode":
        return ShapeConfig("smoke_decode", 64, 2, "decode")
    return ShapeConfig("smoke_train", 64, 2, "train")
