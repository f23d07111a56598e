"""mamba2-1.3b — attention-free SSD (state-space duality).  [arXiv:2405.21060; unverified]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=0, n_kv_heads=0,
    d_ff=0, vocab=50280,
    ssm_state=128, ssm_headdim=64, ssm_expand=2, ssm_chunk=256,
    source="arXiv:2405.21060 (Mamba-2 / SSD); unverified tier",
)


def smoke() -> ArchConfig:
    return ArchConfig(
        name="mamba2-1.3b-smoke", family="ssm",
        n_layers=2, d_model=64, n_heads=0, n_kv_heads=0,
        d_ff=0, vocab=256, ssm_state=16, ssm_headdim=16, ssm_expand=2,
        ssm_chunk=16, remat="none",
        source="reduced smoke variant",
    )
