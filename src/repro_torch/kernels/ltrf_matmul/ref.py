"""Plain PyTorch version of the LTRF-planned matmul."""
import torch


def matmul_ref(x: torch.Tensor, w: torch.Tensor, out_dtype=None) -> torch.Tensor:
    """``x @ w`` with fp32 accumulation (fp64 for fp64 operands, as a
    float64 ``gradcheck`` needs), one rounding to ``out_dtype``."""
    out_dtype = out_dtype or x.dtype
    acc = torch.promote_types(x.dtype, torch.float32)
    return (x.to(acc) @ w.to(acc)).to(out_dtype)
