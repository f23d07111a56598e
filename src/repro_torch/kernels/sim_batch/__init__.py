from .ops import DIMS, PLANES, kernel_args, layout, sim_batch

__all__ = ["DIMS", "PLANES", "kernel_args", "layout", "sim_batch"]
