"""Hand-written Hopper kernels (``csrc/``) with their ctypes wrappers:
``ltrf_matmul``, ``flash_attention`` and ``ssd_scan``.

Each ``kernels/<name>/`` holds ``ref.py`` (the plain PyTorch version, run for
CPU tensors and used as the yardstick on the card) and ``ops.py`` (the
wrapper: checks, launch on the current stream, launch count, and the
``torch.autograd.Function`` that gives it a backward).
"""
