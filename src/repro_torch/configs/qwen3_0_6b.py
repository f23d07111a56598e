"""qwen3-0.6b — dense with qk-norm, GQA, 151936 vocab.  [hf:Qwen/Qwen3-8B family; hf]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-0.6b", family="dense",
    n_layers=28, d_model=1024, n_heads=16, n_kv_heads=8,
    d_ff=3072, vocab=151936, head_dim=128, qk_norm=True,
    source="hf:Qwen/Qwen3-0.6B (qk_norm, head_dim 128); hf tier",
)


def smoke() -> ArchConfig:
    return ArchConfig(
        name="qwen3-0.6b-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=192, vocab=512, head_dim=32, qk_norm=True, remat="none",
        source="reduced smoke variant",
    )
