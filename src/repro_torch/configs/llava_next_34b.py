"""llava-next-34b — VLM backbone (anyres tiling frontend is a stub:
``input_specs`` supplies precomputed patch embeddings).
[hf:llava-hf/llava-v1.6-*; unverified]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="llava-next-34b", family="vlm",
    n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8,
    d_ff=20480, vocab=64000,
    n_patches=576,  # 24x24 anyres base grid (stubbed frontend)
    source="hf:llava-hf/llava-v1.6 family backbone; unverified tier",
)


def smoke() -> ArchConfig:
    return ArchConfig(
        name="llava-next-34b-smoke", family="vlm",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=192, vocab=256, n_patches=16, remat="none",
        source="reduced smoke variant",
    )
