from .ops import ltrf_matmul, matmul_plan, pick_blocks, split_k
from .ref import matmul_ref

__all__ = ["ltrf_matmul", "matmul_plan", "matmul_ref", "pick_blocks", "split_k"]
