"""phi3-medium-14b — dense, RoPE+SwiGLU+GQA.  [arXiv:2404.14219; unverified]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="phi3-medium-14b", family="dense",
    n_layers=40, d_model=5120, n_heads=40, n_kv_heads=10,
    d_ff=17920, vocab=100352,
    source="arXiv:2404.14219 (Phi-3 Technical Report); unverified tier",
)


def smoke() -> ArchConfig:
    return ArchConfig(
        name="phi3-medium-14b-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=1,
        d_ff=160, vocab=256, remat="none",
        source="reduced smoke variant",
    )
