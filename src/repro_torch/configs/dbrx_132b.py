"""dbrx-132b — MoE 16 experts top-4, fine-grained.  [hf:databricks/dbrx-base; unverified]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="dbrx-132b", family="moe",
    n_layers=40, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=10752, vocab=100352,
    n_experts=16, top_k=4,
    source="hf:databricks/dbrx-base; unverified tier",
)


def smoke() -> ArchConfig:
    return ArchConfig(
        name="dbrx-132b-smoke", family="moe",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=96, vocab=256, n_experts=4, top_k=2, remat="none",
        source="reduced smoke variant",
    )
