"""Multi-pod dry-run on meta DTensors (port of ``repro.launch.dryrun``).

``python -m repro_torch.launch.dryrun --arch A [A ...] --shape S [S ...] [--multi-pod] [--out-dir D]``
``python -m repro_torch.launch.dryrun --all [--multi-pod]``

Per (arch x shape) cell this:
  1. builds the 16x16 (single-pod) or 2x16x16 (multi-pod) production mesh
     over a fake process group (``make_production_mesh``: its collectives
     move nothing), and ``default_rules`` over it;
  2. places the step's arguments (``input_specs``; the params, the optimizer
     state or the decode cache) as DTensors of meta local tensors, split by
     ``shardings_for`` over their logical axes: nothing is allocated (meta
     tensors stand in for the reference's ``ShapeDtypeStruct``s; they
     dispatch faster than ``FakeTensorMode``'s fake tensors);
  3. runs the port's own step on the plain path (``kernels=False``: meta
     tensors launch no kernel, as the JAX models never call Pallas): train
     ``build_train_step`` and prefill ``build_prefill_step`` with the
     reference's ``n_micro`` (beyond ``TRACED_MICRO``, extrapolated from
     traces at those counts), decode ``build_decode_step``;
  4. records per-rank FLOPs of the local work, the collectives each rank
     runs (``CommTracker``: by kind, and by what they move, a weight or an
     activation, and the line of the port that moves it), per-device memory
     (the arguments' bytes from their local shard shapes, exactly, and the
     peak of live local tensors), the seconds the step took to run, and the
     parameter counts;
  5. writes JSON to experiments/dryrun_torch/<arch>_<shape>_<mesh>.json.

Everything runs on the CPU; CUDA is never started.  The roofline constants
are one H100 SXM's data-sheet figures.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import pathlib
import time
import traceback

import torch
from torch.distributed.tensor import DTensor

from ..configs import ARCH_IDS, SHAPES, cell_is_runnable, get_arch, input_specs
from ..distributed.sharding import default_rules, mesh_shape, shardings_for
from ..models.lm import decode_cache_axes, init_decode_cache, init_params, param_axes
from ..optim.adamw import init_opt_state, opt_state_axes
from ..runtime.train_step import (
    batch_axes_for, build_decode_step, build_prefill_step, build_train_step,
    train_state_shapes,
)
from ..tree import tree_leaves, tree_map
from .hlo_stats import (
    CommTracker, WorkTracker, _cost_analysis, _eval_shape_with_axes, _mem_analysis, comm_sources,
    comm_stats,
)
from .mesh import make_production_mesh

OUT_DIR = pathlib.Path(__file__).resolve().parents[3] / "experiments" / "dryrun_torch"

# H100 SXM data-sheet constants (per card) for the roofline terms
PEAK_FLOPS = 989e12      # bf16 FLOP/s, dense
HBM_BW = 3.35e12         # bytes/s
HBM_BYTES = 80e9


def _bytes(shape, dtype) -> int:
    return math.prod(shape) * dtype.itemsize


def _meta_dtensor(shape, dtype, sharding):
    """A DTensor of global ``shape`` whose local tensor is on the meta
    device, split by ``sharding``."""
    shape = tuple(shape)
    local = torch.empty(sharding.shard_shape(shape), dtype=dtype, device="meta")
    stride = tuple(math.prod(shape[i + 1:]) for i in range(len(shape)))
    return DTensor.from_local(local, sharding.mesh, list(sharding.placements),
                              run_check=False, shape=torch.Size(shape), stride=stride)


def _place_meta(held, shapes, shardings):
    """Meta DTensors shaped as ``held`` (the port's tensors, e.g. a head held
    wider than its vocabulary), split as ``shardings`` were computed from
    ``shapes``; and the local bytes of ``shapes`` (the arguments'
    reference-comparable bytes)."""
    placed = tree_map(lambda h, s, sh: _meta_dtensor(h.shape, s.dtype, sh), held, shapes,
                      shardings)
    nbytes = sum(_bytes(sh.shard_shape(s.shape), s.dtype)
                 for s, sh in zip(tree_leaves(shapes), tree_leaves(shardings)))
    return placed, nbytes


def _local_bytes(tree) -> int:
    return sum(t.to_local().numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, DTensor))


def run_cell(arch_id: str, shape_name: str, multi_pod: bool, verbose: bool = True) -> dict:
    """One cell's record."""
    cfg = get_arch(arch_id)
    shape = SHAPES[shape_name]
    ok, why = cell_is_runnable(cfg, shape)
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    rec: dict = {"arch": arch_id, "shape": shape_name, "mesh": mesh_name,
                 "runnable": ok, "skip_reason": why, "ok": False}
    if not ok:
        rec["ok"] = True  # a defined skip counts as pass
        return rec
    mesh = make_production_mesh(multi_pod=multi_pod)
    rec.update(_trace_cell(cfg, shape, mesh, verbose, f"{arch_id} x {shape_name} x {mesh_name}"))
    return rec


def _trace_cell(cfg, shape, mesh, verbose: bool, label: str) -> dict:
    """Steps 2-4 of the module docstring on ``mesh`` (a production mesh, or
    a smaller one in tests)."""
    sizes = mesh_shape(mesh)
    n_dev = math.prod(sizes.values())
    rec: dict = {"devices": n_dev}
    if shape.is_decode:
        rec.update(_trace(cfg, shape, mesh, None))
    else:
        n_micro = max(1, shape.global_batch // (n_dev // sizes["model"]))
        rec["n_micro"] = n_micro
        if n_micro <= TRACED_MICRO[-1]:
            rec.update(_trace(cfg, shape, mesh, n_micro))
        else:
            rec.update(_extrapolated(cfg, shape, mesh, n_micro))
    mem, cost, coll = rec["memory"], rec["cost"], rec["collectives"]
    rec.update({
        "ok": True,
        "param_count": cfg.param_count(),
        "active_param_count": cfg.active_param_count(),
        "roofline": {"peak_flops": PEAK_FLOPS, "hbm_bw": HBM_BW, "hbm_bytes": HBM_BYTES,
                     "compute_s": cost["flops"] / PEAK_FLOPS,
                     "fits_hbm": mem["total_hbm_bytes"] <= HBM_BYTES},
    })
    if verbose:
        print(f"[{label}] trace={rec['trace_s']:.1f}s flops={cost['flops']:.3g} "
              f"args/dev={mem['argument_size_in_bytes'] / 2**30:.3f}GiB "
              f"peak/dev={mem['peak_bytes'] / 2**30:.3f}GiB "
              f"coll={coll['total_bytes'] / 2**20:.1f}MiB/{coll['total_count']}ops", flush=True)
    return rec


# a train or prefill step of more microbatches than the last of these is
# traced at each of them: its microbatches repeat the same ops, so FLOPs and
# collectives grow by the same amount with each one from the first of these
# on, and the step's at n_micro are extrapolated (``_extrapolated``)
TRACED_MICRO = (2, 3)


def _extrapolated(cfg, shape, mesh, n_micro: int) -> dict:
    """The step at ``n_micro`` microbatches of the cell's size from traces
    at ``TRACED_MICRO``: FLOPs and collectives extrapolated linearly; the
    memory is the last trace's (the accumulators and one microbatch's
    activations, which further microbatches do not raise)."""
    a, b = TRACED_MICRO
    rows = shape.global_batch // n_micro
    ra, rb = (_trace(cfg, dataclasses.replace(shape, global_batch=rows * m), mesh, m)
              for m in (a, b))

    def at_n(x, y):
        return x + (y - x) // (b - a) * (n_micro - a)

    coll = {k: ({f: at_n(v[f], rb["collectives"][k][f]) for f in v} if isinstance(v, dict)
                else at_n(v, rb["collectives"][k]))
            for k, v in ra["collectives"].items()}
    sa, sb = ra["collectives_by_source"], rb["collectives_by_source"]
    none = {"count": 0, "bytes": 0}
    by_source = {k: {f: at_n(sa.get(k, none)[f], sb.get(k, none)[f]) for f in none}
                 for k in sorted(sa.keys() | sb.keys())}
    return {"traced_micro": list(TRACED_MICRO), "trace_s": ra["trace_s"] + rb["trace_s"],
            "setup_s": ra["setup_s"] + rb["setup_s"], "memory": rb["memory"],
            "cost": {"flops": at_n(ra["cost"]["flops"], rb["cost"]["flops"])},
            "collectives": coll, "collectives_by_source": by_source}


def _trace(cfg, shape, mesh, n_micro: int | None) -> dict:
    """One run of the cell's step (``n_micro`` None: decode) on DTensors of
    meta local tensors: the trackers' readings and the arguments' bytes."""
    t0 = time.perf_counter()
    rules = default_rules(mesh)
    specs = input_specs(cfg, shape)
    b_sh = shardings_for(rules, batch_axes_for(cfg, "decode" if n_micro is None else "train"),
                         specs)
    p_shapes = train_state_shapes(cfg)["params"]
    p_held, p_axes = _eval_shape_with_axes(
        lambda: (init_params(cfg, torch.Generator(), "meta"), param_axes(cfg)))
    params, args_bytes = _place_meta(p_held, p_shapes, shardings_for(rules, p_axes, p_shapes))
    batch, b_bytes = _place_meta(specs, specs, b_sh)
    args_bytes += b_bytes
    if n_micro is None:
        c_shapes, c_axes = _eval_shape_with_axes(lambda: (
            init_decode_cache(cfg, shape.global_batch, shape.seq_len, "meta"),
            decode_cache_axes(cfg)))
        cache, c_bytes = _place_meta(c_shapes, c_shapes, shardings_for(rules, c_axes, c_shapes))
        args_bytes += c_bytes
        step = build_decode_step(cfg, rules, kernels=False)
        trees = (params, cache, batch)
        # the port's decode step takes cache_len as an int; its work does
        # not depend on the value (the whole cache is attended, masked)
        run = lambda: step(params, cache, batch["tokens"], shape.seq_len // 2)  # noqa: E731
    elif shape.kind == "prefill":
        step = build_prefill_step(cfg, n_micro=n_micro, rules=rules, kernels=False)
        trees = (params, batch)
        run = lambda: step(params, batch)  # noqa: E731
    else:
        o_shapes = init_opt_state(p_shapes)
        opt, o_bytes = _place_meta(init_opt_state(p_held), o_shapes,
                                   shardings_for(rules, opt_state_axes(p_axes), o_shapes))
        args_bytes += o_bytes
        state = {"params": params, "opt": opt}
        step = build_train_step(cfg, n_micro=n_micro, rules=rules, kernels=False)
        trees = (state, batch)
        run = lambda: step(state, batch)  # noqa: E731
    held_bytes = sum(_local_bytes(t) for t in trees)
    work = WorkTracker()
    work.track(tree_leaves(list(trees)))
    comms = CommTracker()
    comms.weights(tree_leaves(params))
    t1 = time.perf_counter()
    with comms, work:
        run()
    mem = _mem_analysis(args_bytes, work)
    mem["head_padding_bytes"] = held_bytes - args_bytes
    return {"setup_s": t1 - t0, "trace_s": time.perf_counter() - t1, "memory": mem,
            "cost": _cost_analysis(work), "collectives": comm_stats(comms),
            "collectives_by_source": comm_sources(comms)}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", nargs="+", choices=ARCH_IDS)
    ap.add_argument("--shape", nargs="+", choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out-dir", default=str(OUT_DIR))
    args = ap.parse_args()

    out_dir = pathlib.Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)

    if args.all:
        cells = [(a, s) for a in ARCH_IDS for s in SHAPES]
    elif args.arch and args.shape:
        cells = [(a, s) for a in args.arch for s in args.shape]
    else:
        ap.error("--arch/--shape or --all required")

    failures = 0
    mesh_name = "pod2x16x16" if args.multi_pod else "pod16x16"
    for arch_id, shape_name in cells:
        path = out_dir / f"{arch_id}_{shape_name}_{mesh_name}.json"
        try:
            rec = run_cell(arch_id, shape_name, args.multi_pod)
        except Exception as e:  # noqa: BLE001 - record the failure, go on to the next cell
            rec = {"arch": arch_id, "shape": shape_name, "mesh": mesh_name,
                   "ok": False, "error": f"{type(e).__name__}: {e}",
                   "traceback": traceback.format_exc()[-4000:]}
            print(f"[{arch_id} x {shape_name} x {mesh_name}] FAILED: {e}", flush=True)
            failures += 1
        rec["cuda_initialized"] = torch.cuda.is_initialized()
        path.write_text(json.dumps(rec, indent=2))
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
