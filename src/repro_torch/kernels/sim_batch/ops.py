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
each plane, in ``PLANES`` order, the chunk's widths, in ``DIMS`` order, and
the route and size of a lane's image.  ``kernel_args`` fills it and checks
every plane's dtype, shape and contiguity; the library's own ``layout``
string must equal ``layout``'s (plane and width order, then the status,
opcode, column and category numbering that ``repro_torch.sim.batch``
passes), or loading it raises.

Each CTA (one warp, one lane) ticks its lane in an image of the lane's
planes in shared memory.  ``image_bytes`` reckons its size from the widths
as the kernel's ``image_of`` lays it out, and ``plan`` takes the first of
``ROUTES`` whose image fits a CTA's shared memory: ``shared`` (the lane's
mutable planes, its register times ``rv`` and its read-only tables) or
``global`` (``rv`` and the tables left in their global planes).  A width
that fits neither raises.
``sim_batch.launches`` counts the launches and ``sim_batch.launches_by_route``
each route's.
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
NCAT = 7                # cycle categories
# the image's routes, in the kernel's `Route` order: ``rv`` and the tables in
# the image, or left in global memory
ROUTES = ("shared", "global")
SHARED_BYTES = 227 * 1024   # the dynamic shared memory a CTA may take on sm_90


class Args(ctypes.Structure):
    _fields_ = [("planes", ctypes.c_void_p * len(PLANES)),
                ("lane_stride", ctypes.c_longlong * len(PLANES)),
                ("dims", ctypes.c_int * len(DIMS)),
                ("route", ctypes.c_int),
                ("image_bytes", ctypes.c_longlong)]


def image_sections(width: dict, route: str) -> dict:
    """A lane's image on ``route`` as the kernel lays it out (``image_of``
    in csrc/sim_batch.cu): each imaged section's bytes, in order, each
    padded to 16 bytes.  ``width`` maps ``DIMS`` to the chunk's widths."""
    if route not in ROUTES:
        raise ValueError(f"sim_batch: route {route!r}; one of {ROUTES}")
    w = width
    out = {"wf": w["W"] * w["NWF"] * 8, "cf": w["W"] * w["CW"] * 8, "pf": w["PF"] * 8,
           "col": w["C"] * 8, "rc_keys": w["E"] * 8, "rc_stamps": w["E"] * 8,
           "bd": NCAT * 8}
    if route == "shared":
        out.update(rv_times=w["W"] * w["RVW"] * 8, rv_flags=w["W"] * w["RVW"])
    out.update(act=w["A"] * 4, res=w["W"],
               rc_index=w["W"] * (w["R"] + 1) * 4 if w["E"] > 1 else 0)
    if route == "shared":
        out.update(meta=(w["P"] + 1) * w["MW"] * 4, ivt=(w["IVS"] + 1) * 16,
                   ivregs=(w["IVS"] + 1) * w["GV"] * 4)
    out.update(iv_latency=(w["IVS"] + 1) * 8)
    return out


def image_bytes(width: dict, route: str) -> int:
    """A lane's image's bytes on ``route`` (sections padded to 16 bytes)."""
    return sum(-(-n // 16) * 16 for n in image_sections(width, route).values())


def plan(width: dict) -> tuple[str, int]:
    """``(route, image bytes)`` for a chunk: the first of ``ROUTES`` whose
    image fits ``SHARED_BYTES``; raises if none does."""
    for r in ROUTES:
        n = image_bytes(width, r)
        if n <= SHARED_BYTES:
            return r, n
    raise ValueError(f"sim_batch: a lane's image takes {n} bytes on route {ROUTES[-1]!r}, "
                     f"more than the {SHARED_BYTES} bytes of shared memory a CTA may take; "
                     f"widths {width}")


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


def widths(co: dict, s: dict, dims: tuple) -> dict:
    """The chunk's widths by ``DIMS`` name: ``dims`` (``_dims``'s tuple),
    then those the planes' shapes carry."""
    extra = (s["pf"].shape[1], s["col"].shape[1], s["bd"].shape[1],
             co["ivregs"].shape[2], co["meta"].shape[2], s["cf"].shape[2], s["rv"].shape[2])
    return {k: int(v) for k, v in zip(DIMS, (*dims, *extra))}


def kernel_args(co: dict, s: dict, dims: tuple) -> Args:
    """The kernel's argument struct for a chunk: ``dims`` is ``_dims``'s
    tuple; ``co`` and ``s`` hold every plane of ``PLANES`` (``s`` with its
    trash slots), contiguous, of the listed dtypes, with one row per lane;
    the route ``plan``'s."""
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
    width = widths(co, s, dims)
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
        args.dims[i] = width[name]
    route, nbytes = plan(width)
    args.route = ROUTES.index(route)
    args.image_bytes = nbytes
    return args


def _check_card(co: dict, s: dict) -> None:
    devices = {t.device for t in (*co.values(), *s.values())}
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise ValueError(f"sim_batch: planes on {sorted(map(str, devices))}; the kernel takes "
                         "planes on one CUDA device (the CPU runs the plain tick)")


def sim_batch(co: dict, s: dict, dims: tuple, stream: int, numbering: str) -> dict:
    """One launch on the CUDA stream ``stream`` (its handle) runs every lane
    of the chunk to completion, in place; a refused launch raises.
    ``numbering`` is the caller's part of ``layout``, which the library's
    must equal.  Returns the launch's ``route`` (``plan``'s) and
    ``image_bytes`` (a lane's)."""
    _check_card(co, s)
    args = kernel_args(co, s, dims)
    launch = _library(numbering)
    err = launch(ctypes.addressof(args), stream)
    if err:
        raise RuntimeError(f"sim_batch kernel launch failed: cudaError {err}")
    sim_batch.launches += 1
    sim_batch.launches_by_route[ROUTES[args.route]] += 1
    return {"route": ROUTES[args.route], "image_bytes": args.image_bytes}


sim_batch.launches = 0
sim_batch.launches_by_route = dict.fromkeys(ROUTES, 0)


def ctas_per_sm(route: str, image_bytes: int) -> int:
    """The CTAs (lanes) of ``route`` with a lane's image of ``image_bytes``
    that one SM of the current card holds at once (the CUDA occupancy
    calculator on the kernel's registers and shared memory)."""
    n = ctypes.c_int(0)
    err = _build.load("sim_batch").sim_batch_ctas_per_sm(
        ROUTES.index(route), ctypes.c_longlong(image_bytes), ctypes.byref(n))
    if err:
        raise RuntimeError(f"sim_batch occupancy query failed: cudaError {err}")
    return n.value


def waves(route: str, image_bytes: int, lanes: int) -> int:
    """The waves a launch of ``lanes`` CTAs takes alone on the current card."""
    sms = torch.cuda.get_device_properties(torch.cuda.current_device()).multi_processor_count
    return -(-lanes // (ctas_per_sm(route, image_bytes) * sms))
