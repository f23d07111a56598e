"""Hand-written Hopper kernels (``csrc/``) with their ctypes wrappers:
``ltrf_matmul``, ``flash_attention`` and ``ssd_scan``, and ``sim_batch``, the
batch simulator's run loop (its plain version is the tick in
``repro_torch.sim.batch``).

Each ``kernels/<name>/`` holds ``ref.py`` (the plain PyTorch version, run for
CPU tensors and used as the yardstick on the card) and ``ops.py`` (the
wrapper: checks, launch on the current stream, launch count, and the
``torch.autograd.Function`` that gives it a backward).
"""
