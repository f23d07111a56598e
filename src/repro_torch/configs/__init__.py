from .base import SHAPES, ArchConfig, ShapeConfig, cell_is_runnable, input_specs, smoke_shape
from .registry import ARCH_IDS, all_cells, get_arch, get_smoke

__all__ = ["ArchConfig", "ARCH_IDS", "SHAPES", "ShapeConfig", "all_cells", "cell_is_runnable",
           "get_arch", "get_smoke", "input_specs", "smoke_shape"]
