"""Architecture configuration (port of ``repro.configs.base``).

``ArchConfig`` carries the same fields as the JAX package's; its dtype glue is
``torch_dtype`` in place of ``jdtype``.  The dry-run's shapes, ``input_specs``
and the analytic parameter counts are not needed by the serving slice and
are not part of this package yet (see ROADMAP queue 1 item 10).
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
    remat: str = "full"         # JAX compile-time choice; unused by the port
    scan_layers: bool = True    # JAX compile-time choice; unused by the port
    q_block: int = 512          # plain attention's q-block
    source: str = ""

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def torch_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32
