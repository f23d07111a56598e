"""Architecture registry: ``--arch <id>`` resolution + smoke variants.

The registry knows every architecture id of the JAX package.  Only the ids in
``PORTED_ARCH_IDS`` resolve; the others raise ``NotImplementedError`` naming
the ROADMAP item that ports them.
"""
from __future__ import annotations

import importlib

from .base import ArchConfig

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

PORTED_ARCH_IDS = ("tinyllama-1.1b", "qwen3-0.6b", "mamba2-1.3b", "zamba2-1.2b")

_NOT_PORTED = {
    "phi3-medium-14b": "ROADMAP queue 1 item 5 (remaining dense configs)",
    "granite-20b": "ROADMAP queue 1 item 5 (remaining dense configs)",
    "granite-moe-3b-a800m": "ROADMAP queue 1 item 5 (moe family)",
    "dbrx-132b": "ROADMAP queue 1 item 5 (moe family)",
    "llava-next-34b": "ROADMAP queue 1 item 5 (vlm family)",
    "musicgen-large": "ROADMAP queue 1 item 5 (audio family)",
}


def _module(arch_id: str):
    if arch_id in _NOT_PORTED:
        raise NotImplementedError(
            f"{arch_id} is not ported to repro_torch yet: {_NOT_PORTED[arch_id]}")
    if arch_id not in PORTED_ARCH_IDS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    name = arch_id.replace("-", "_").replace(".", "_")
    return importlib.import_module(f"{__package__}.{name}")


def get_arch(arch_id: str) -> ArchConfig:
    return _module(arch_id).CONFIG


def get_smoke(arch_id: str) -> ArchConfig:
    return _module(arch_id).smoke()
