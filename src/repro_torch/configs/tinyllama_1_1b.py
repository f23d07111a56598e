"""tinyllama-1.1b — dense llama2-arch small.  [arXiv:2401.02385; hf]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="tinyllama-1.1b", family="dense",
    n_layers=22, d_model=2048, n_heads=32, n_kv_heads=4,
    d_ff=5632, vocab=32000,
    source="arXiv:2401.02385 / hf:TinyLlama/TinyLlama-1.1B; hf tier",
)


def smoke() -> ArchConfig:
    return ArchConfig(
        name="tinyllama-1.1b-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=176, vocab=256, remat="none",
        source="reduced smoke variant",
    )
