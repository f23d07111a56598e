"""Architecture registry: ``--arch <id>`` resolution + smoke variants.

Every architecture id of the JAX package resolves, to the same full config
(``get_arch``) and reduced smoke config (``get_smoke``).
"""
from __future__ import annotations

import importlib

from .base import SHAPES, ArchConfig, cell_is_runnable

ARCH_IDS = [
    "phi3-medium-14b",
    "tinyllama-1.1b",
    "granite-20b",
    "qwen3-0.6b",
    "granite-moe-3b-a800m",
    "dbrx-132b",
    "llava-next-34b",
    "musicgen-large",
    "mamba2-1.3b",
    "zamba2-1.2b",
]


def _module(arch_id: str):
    if arch_id not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    name = arch_id.replace("-", "_").replace(".", "_")
    return importlib.import_module(f"{__package__}.{name}")


def get_arch(arch_id: str) -> ArchConfig:
    return _module(arch_id).CONFIG


def get_smoke(arch_id: str) -> ArchConfig:
    return _module(arch_id).smoke()


def all_cells() -> list[tuple[str, str, bool, str]]:
    """[(arch_id, shape_name, runnable, skip_reason)] for all 40 cells."""
    out = []
    for a in ARCH_IDS:
        cfg = get_arch(a)
        for s in SHAPES.values():
            ok, why = cell_is_runnable(cfg, s)
            out.append((a, s.name, ok, why))
    return out
