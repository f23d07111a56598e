"""PyTorch/CUDA port of the LTRF model stack for one NVIDIA H100.

Mirrors the layout of the JAX package ``repro`` (``configs/``, ``core/``,
``kernels/<name>/``, ``models/``, ``serving/``, ``launch/``) so each module's
counterpart is found by path.  The port imports ``torch`` and ``numpy`` only;
the modules it shares in spirit with ``repro`` (the LTRF compiler core, the
request scheduler and the page allocator) are kept here as copies.

Entry points (``models.lm.init_params``, ``serving.ServingEngine``,
``launch.serve.serve``) run on ``device="cuda"`` unless the caller passes
``device="cpu"``.  On a CUDA tensor every dense projection goes through the
hand-written ``ltrf_matmul`` kernel, prefill attention through the
``flash_attention`` kernel and the Mamba2 chunked scan through the
``ssd_scan`` kernel (``csrc/``); on a CPU tensor the same wrappers run their
plain PyTorch versions.
"""
import torch


def resolve_device(device) -> torch.device:
    """``torch.device`` for ``device``; a CUDA device with no card raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but no CUDA card is available; "
            "pass device='cpu' to run the plain PyTorch path")
    return dev
