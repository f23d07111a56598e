"""PyTorch/CUDA port of the LTRF model stack for one NVIDIA H100.

Mirrors the layout of the JAX package ``repro`` (``configs/``, ``core/``,
``kernels/<name>/``, ``models/``, ``optim/``, ``runtime/``, ``checkpoint/``,
``data/``, ``distributed/``, ``serving/``, ``launch/``) so each module's
counterpart is found by path.  The port imports ``torch`` and ``numpy`` only;
the modules it shares in spirit with ``repro`` (the LTRF compiler core, the
request scheduler, the page allocator and the data pipeline) are kept here
as copies.

Entry points (``models.lm.init_params``, ``runtime.make_train_state``,
``serving.ServingEngine``, ``launch.serve.serve``, ``launch.train.train``)
run on ``device="cuda"`` unless the caller passes ``device="cpu"``.  On a
CUDA tensor every dense projection goes through the hand-written
``ltrf_matmul`` kernel, prefill attention through the ``flash_attention``
kernel and the Mamba2 chunked scan through the ``ssd_scan`` kernel
(``csrc/``), each differentiable through an autograd Function; on a CPU
tensor the same wrappers run their plain PyTorch versions.
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
