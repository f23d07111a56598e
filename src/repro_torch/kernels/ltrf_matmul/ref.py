"""Plain PyTorch version of the LTRF-planned matmul."""
import torch


def matmul_ref(x: torch.Tensor, w: torch.Tensor, out_dtype=None) -> torch.Tensor:
    """``x @ w`` with fp32 accumulation, one rounding to ``out_dtype``."""
    out_dtype = out_dtype or x.dtype
    return (x.float() @ w.float()).to(out_dtype)
