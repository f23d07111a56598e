"""Build the port's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own into
``build/kernels/<name>-<hash>.so`` under the repository root (the hash covers
its ``nvcc`` flags, the source and every ``csrc/*.cuh`` header it includes),
at first use (or all at once, in parallel, through ``build``, which may
return before the compiles end).  Nothing here runs at import time: the CPU
tests import every module and have no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# flags a source needs beyond NVCC_FLAGS: the batch simulator's float64
# sites must never contract a product into an FMA (csrc/sim_batch.cu)
SOURCE_FLAGS = {"sim_batch": ("-fmad=false",)}

_LOADED: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.path.join(home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin and PATH)")


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+\.cuh)"', re.M)


def _sources(name: str) -> list[Path]:
    """``csrc/<name>.cu`` and the ``csrc`` headers it includes, transitively."""
    paths, todo = [], [CSRC / f"{name}.cu"]
    while todo:
        path = todo.pop()
        if path in paths:
            continue
        paths.append(path)
        todo += [CSRC / inc.decode() for inc in _INCLUDE.findall(path.read_bytes())
                 if (CSRC / inc.decode()).exists()]
    return paths


def flags(name: str) -> tuple:
    """``nvcc``'s flags for ``csrc/<name>.cu``."""
    return (*NVCC_FLAGS, *SOURCE_FLAGS.get(name, ()))


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(flags(name)).encode() + b"\0")
    for path in _sources(name):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:12]}.so"


_PENDING: dict[str, tuple] = {}   # name -> (nvcc process, temporary file, library path)


def build(names, wait: bool = True) -> dict[str, str]:
    """Compile every named source not built yet, all ``nvcc``s at once.

    Returns ``{name: compiler output}`` (``-Xptxas -v``: registers, shared
    memory and spills per kernel) for the sources compiled by this call.
    With ``wait=False`` it returns at once, and ``load`` (or a later
    ``build``) finishes each compile when its library is first needed.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    for name in names:
        out = library_path(name)
        if out.exists() or name in _PENDING:
            continue
        tmp = out.with_suffix(f".tmp{os.getpid()}")
        cmd = [_nvcc(), *flags(name), "-o", str(tmp), str(CSRC / f"{name}.cu")]
        _PENDING[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT, text=True), tmp, out)
    if not wait:
        return {}
    logs, failed = {}, []
    for name in [n for n in names if n in _PENDING]:
        try:
            logs[name] = _finish(name)
        except RuntimeError as err:
            failed.append(str(err))
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return logs


def _finish(name: str) -> str:
    """Wait for ``name``'s compile, keep its log, and put its library in
    place; raise with the compiler's output if it failed."""
    proc, tmp, out = _PENDING.pop(name)
    log, _ = proc.communicate()
    (BUILD_DIR / f"{name}.log").write_text(log)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{name} (nvcc exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)
    return log


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        if name in _PENDING:
            try:
                _finish(name)
            except RuntimeError as err:
                raise RuntimeError(f"kernel build failed: {err}") from None
        else:
            build([name])
        lib = _LOADED[name] = ctypes.CDLL(str(library_path(name)))
    return lib
