from .base import ArchConfig
from .registry import ARCH_IDS, get_arch, get_smoke

__all__ = ["ArchConfig", "ARCH_IDS", "get_arch", "get_smoke"]
