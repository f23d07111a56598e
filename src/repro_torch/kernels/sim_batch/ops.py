"""Wrapper: a chunk of the batch simulator run to completion in one launch.

``sim_batch(co, s, dims, stream, numbering)`` launches
``csrc/sim_batch.cu`` once over a chunk's planes (``repro_torch.sim.batch``'s constants ``co`` and state
``s``, the latter with its trash slots, both as that module places them on
the card): every lane ticks until it ends, in place, and ``s["guard"]``
(which must hold 0) becomes the longest lane's tick count.  The kernel
replaces no TPU kernel: it is the counterpart of the reference's compiled
``lax.while_loop`` (``repro.sim.batch._run_jax``).  Its plain version is the
PyTorch tick ``repro_torch.sim.batch._tick_fn``, which the CPU runs, and
which the card runs only where a caller asks for it (``engine="plain"``).

The kernel takes one struct (``Args``): a pointer and a lane stride for
each plane, in ``PLANES`` order, and the chunk's widths, in ``DIMS`` order.
``kernel_args`` fills it and checks every plane's dtype, shape and
contiguity; the library's own ``layout`` string must equal ``layout``'s
(plane and width order, then the status, opcode, column and category
numbering that ``repro_torch.sim.batch`` passes), or loading it raises.
``sim_batch.launches`` counts the launches.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build

_I32, _I64, _F64, _B = torch.int32, torch.int64, torch.float64, torch.bool

# the chunk's planes in the kernel's order (csrc/sim_batch.cu, SB_PLANES),
# each with its dtype: the constants, then the state
CONSTANTS = {
    "meta": _I32, "ivt": _I32, "ivregs": _I32, "endpc": _I32,
    **dict.fromkeys(("mrfc", "rfcc", "brf_f", "wlat", "rate", "l1h", "xbar", "banksf",
                     "aluf", "memf", "drint"), _F64),
    **dict.fromkeys(("brf_i", "l1c", "thr", "seed", "maxc", "tmax"), _I64),
    **dict.fromkeys(("iw", "nw", "rcap", "acap", "tcap", "ecap"), _I32),
    **dict.fromkeys(("cached", "edge", "bl", "rfc", "ideal", "fam"), _B),
}
STATE = {
    "cycle": _I64, "guard": _I64, "alive": _B, "budget": _B, "wf": _I64, "cf": _F64,
    "rv": _F64, "act": _I32, "na": _I32, "res": _B, "nr": _I32, "ptr": _I32, "pf": _I64,
    "col": _I64, "tok": _F64, "mlast": _I64, "dnext": _F64, "rc": _I64, "rcnt": _I32,
    "rstamp": _I64, "bd": _I64,
    **dict.fromkeys(("ch", "ca", "cm", "cpo", "cpc", "cps", "cwb", "cact"), _I64),
}
PLANES = tuple(CONSTANTS) + tuple(STATE)
# ``_dims`` of repro_torch.sim.batch, then the widths it leaves implicit:
# prefetch slots, collectors, cycle categories, interval register width,
# meta row width, readiness row width, rv rows with the trash slot
DIMS = ("K", "W", "NWF", "A", "E", "P", "S", "PS", "DD", "G", "R", "PRS", "RVW", "LS",
        "DS", "IVS", "IW", "PF", "C", "NCAT", "GV", "MW", "CW", "RV1")
MAX_WARPS = 64          # W and A the kernel takes (one warp's 32 threads, two rounds)
MAX_OPERANDS = 16       # G


class Args(ctypes.Structure):
    _fields_ = [("planes", ctypes.c_void_p * len(PLANES)),
                ("lane_stride", ctypes.c_longlong * len(PLANES)),
                ("dims", ctypes.c_int * len(DIMS))]


def layout(numbering: str) -> str:
    """The layout the kernel is compiled with, as its ``sim_batch_layout``
    gives it: plane and width order, then ``numbering``, the simulator's own
    (``repro_torch.sim.batch``'s warp status, opcode, warp row and meta
    columns, and cycle categories)."""
    return ("planes=" + "".join(p + "," for p in PLANES) + ";dims="
            + "".join(d + "," for d in DIMS) + ";" + numbering)


def _library(numbering: str):
    lib = _build.load("sim_batch")
    fn = lib.sim_batch_launch
    if fn.argtypes is None:
        lib.sim_batch_layout.restype = ctypes.c_char_p
        got, want = lib.sim_batch_layout().decode(), layout(numbering)
        if got != want:
            raise RuntimeError(f"sim_batch: the kernel's layout\n{got}\ndiffers from\n{want}")
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def kernel_args(co: dict, s: dict, dims: tuple) -> Args:
    """The kernel's argument struct for a chunk: ``dims`` is ``_dims``'s
    tuple; ``co`` and ``s`` hold every plane of ``PLANES`` (``s`` with its
    trash slots), contiguous, of the listed dtypes, with one row per lane."""
    planes = {**co, **s}
    want = {**CONSTANTS, **STATE}
    K = dims[0]
    for name in PLANES:
        t = planes[name]
        if t.dtype != want[name] or not t.is_contiguous():
            raise ValueError(f"sim_batch: plane {name} is {t.dtype} "
                             f"{'' if t.is_contiguous() else 'not '}contiguous; "
                             f"the kernel takes contiguous {want[name]}")
        if name not in ("guard", "tmax") and (t.dim() == 0 or t.shape[0] != K):
            raise ValueError(f"sim_batch: plane {name} has shape {tuple(t.shape)}, "
                             f"not one row for each of the {K} lanes")
    extra = (planes["pf"].shape[1], planes["col"].shape[1], planes["bd"].shape[1],
             planes["ivregs"].shape[2], planes["meta"].shape[2], planes["cf"].shape[2],
             planes["rv"].shape[2])
    width = dict(zip(DIMS, (*dims, *extra)))
    if not (width["W"] <= MAX_WARPS and width["A"] <= MAX_WARPS
            and width["G"] <= MAX_OPERANDS):
        raise ValueError(f"sim_batch: W {width['W']}, A {width['A']}, G {width['G']}; the "
                         f"kernel takes W and A up to {MAX_WARPS}, G up to {MAX_OPERANDS}")
    args = Args()
    for i, name in enumerate(PLANES):
        t = planes[name]
        args.planes[i] = t.data_ptr()
        args.lane_stride[i] = t.stride(0) if t.dim() else 0
    for i, name in enumerate(DIMS):
        args.dims[i] = int(width[name])
    return args


def _check_card(co: dict, s: dict) -> None:
    devices = {t.device for t in (*co.values(), *s.values())}
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise ValueError(f"sim_batch: planes on {sorted(map(str, devices))}; the kernel takes "
                         "planes on one CUDA device (the CPU runs the plain tick)")


def sim_batch(co: dict, s: dict, dims: tuple, stream: int, numbering: str) -> None:
    """One launch on the CUDA stream ``stream`` (its handle) runs every lane
    of the chunk to completion, in place; a refused launch raises.
    ``numbering`` is the caller's part of ``layout``, which the library's
    must equal."""
    _check_card(co, s)
    args = kernel_args(co, s, dims)
    launch = _library(numbering)
    err = launch(ctypes.addressof(args), stream)
    if err:
        raise RuntimeError(f"sim_batch kernel launch failed: cudaError {err}")
    sim_batch.launches += 1


sim_batch.launches = 0
