from .base import SHAPES, ArchConfig, ShapeConfig, cell_is_runnable, smoke_shape
from .registry import ARCH_IDS, get_arch, get_smoke

__all__ = ["ArchConfig", "ARCH_IDS", "SHAPES", "ShapeConfig", "cell_is_runnable",
           "get_arch", "get_smoke", "smoke_shape"]
