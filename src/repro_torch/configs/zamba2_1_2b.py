"""zamba2-1.2b — hybrid: Mamba2 backbone + one shared attention block applied
every 6 layers (re-entrant weights, per-call-site KV caches).
[arXiv:2411.15242; hf]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-1.2b", family="hybrid",
    n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab=32000,
    ssm_state=64, ssm_headdim=64, ssm_expand=2, ssm_chunk=256,
    attn_every=6,
    source="arXiv:2411.15242 (Zamba2); hf tier",
)


def smoke() -> ArchConfig:
    return ArchConfig(
        name="zamba2-1.2b-smoke", family="hybrid",
        n_layers=5, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab=256, ssm_state=16, ssm_headdim=16, ssm_expand=2,
        ssm_chunk=16, attn_every=2, remat="none",
        source="reduced smoke variant",
    )
