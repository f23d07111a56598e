"""granite-20b — dense llama-arch code model, MQA (kv=1).  [arXiv:2405.04324; hf]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="granite-20b", family="dense",
    n_layers=52, d_model=6144, n_heads=48, n_kv_heads=1,
    d_ff=24576, vocab=49152,
    source="arXiv:2405.04324 (Granite Code Models); hf tier",
)


def smoke() -> ArchConfig:
    return ArchConfig(
        name="granite-20b-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=1,
        d_ff=256, vocab=256, remat="none",
        source="reduced smoke variant",
    )
