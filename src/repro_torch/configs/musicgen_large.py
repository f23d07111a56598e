"""musicgen-large — decoder-only over EnCodec tokens (4 codebooks).
The EnCodec frontend is a stub: inputs are codebook token ids, embedded and
summed (delay-pattern handling happens in the data pipeline).
[arXiv:2306.05284; hf]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-large", family="audio",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab=2048,
    n_codebooks=4,
    source="arXiv:2306.05284 (MusicGen); hf tier",
)


def smoke() -> ArchConfig:
    return ArchConfig(
        name="musicgen-large-smoke", family="audio",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=192, vocab=128, n_codebooks=4, remat="none",
        source="reduced smoke variant",
    )
