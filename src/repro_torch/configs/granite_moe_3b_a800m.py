"""granite-moe-3b-a800m — fine-grained MoE, 40 experts top-8.
[hf:ibm-granite/granite-3.0-*-base family; hf]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="granite-moe-3b-a800m", family="moe",
    n_layers=32, d_model=1536, n_heads=24, n_kv_heads=8,
    d_ff=512, vocab=49155,
    n_experts=40, top_k=8,
    source="hf:ibm-granite/granite-3.0-3b-a800m-base; hf tier",
)


def smoke() -> ArchConfig:
    return ArchConfig(
        name="granite-moe-3b-a800m-smoke", family="moe",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=64, vocab=256, n_experts=8, top_k=2, remat="none",
        source="reduced smoke variant",
    )
