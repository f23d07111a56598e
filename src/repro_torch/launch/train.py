"""Training driver: the fault-tolerant trainer on the local mesh (port of
``repro.launch.train``).

``python -m repro_torch.launch.train --arch tinyllama-1.1b --full --steps 6``

Data (the deterministic pipeline) -> sharded train step (AdamW, optional
int8 gradient compression and microbatches) -> periodic checkpoints ->
restore and replay on a failure.  As in the reference, the state is placed
on ``make_host_mesh()`` by ``default_rules`` (``shardings_for`` over the
state's logical axes, then ``place``) and the step is built with those
rules; a process group that ``train`` starts for the mesh (one rank, when
none is up) it also ends, and the final state it returns is gathered into
plain tensors.  On the CUDA card, which is the default device, the step's
gradients run through the hand-written kernels; asked for ``cuda`` without a
card it raises, as ``resolve_device`` does, and never carries on on the CPU
(``--device cpu`` runs the plain path there).  ``layers`` cuts the config's
depth, keeping its widths.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import logging
import os
import shutil
import tempfile
import time

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from .. import resolve_device
from ..checkpoint import Checkpointer
from ..configs import get_arch, get_smoke
from ..configs.base import ShapeConfig
from ..data import DataConfig, PrefetchingLoader
from ..distributed.fault import FaultConfig, FaultTolerantTrainer
from ..distributed.sharding import default_rules, place, shardings_for
from ..kernels._build import BUILD_DIR
from ..optim.adamw import AdamWConfig
from ..optim.compression import CompressionConfig
from ..runtime.train_step import (
    build_train_step, make_train_state, train_state_axes, train_state_shapes,
)
from ..tree import tree_map
from .mesh import make_host_mesh

log = logging.getLogger("repro_torch.train")


def train(arch_id: str, smoke: bool = True, steps: int = 50,
          batch: int = 8, seq: int = 64, ckpt_dir: str | None = None,
          ckpt_every: int = 20, compress: bool = False,
          inject_failures: dict[int, int] | None = None,
          n_micro: int = 1, seed: int = 0, device="cuda",
          layers: int | None = None) -> dict:
    cfg = get_smoke(arch_id) if smoke else get_arch(arch_id)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    dev = resolve_device(device)
    shape = ShapeConfig("driver", seq, batch, "train")
    own_group = not dist.is_initialized()
    with _inductor_cache(BUILD_DIR.parent / "torchinductor"):
        mesh = make_host_mesh(device=dev)
        try:
            rules = default_rules(mesh)
            state = make_train_state(cfg, torch.Generator(dev).manual_seed(seed), dev)
            state = place(state, shardings_for(rules, train_state_axes(cfg),
                                               train_state_shapes(cfg)))
            opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=max(steps, 1))
            comp = CompressionConfig(enabled=True) if compress else None
            step_fn = build_train_step(cfg, opt_cfg, comp, n_micro=n_micro, rules=rules)
            out = _run(cfg, arch_id, shape, state, step_fn, steps, ckpt_dir, ckpt_every,
                       inject_failures, seed, dev)
        finally:
            if own_group:
                dist.destroy_process_group()
    return out


@contextlib.contextmanager
def _inductor_cache(directory):
    """Keep torch's inductor cache in ``directory`` for a run, unless the
    caller set ``TORCHINDUCTOR_CACHE_DIR``, and put the variable back after.
    The first DTensor a process builds imports ``torch._dynamo``, which makes
    that cache, by default ``<tempdir>/torchinductor_<user>``: a run leaves
    nothing in the temporary directory."""
    key = "TORCHINDUCTOR_CACHE_DIR"
    if key in os.environ:
        yield
        return
    os.environ[key] = str(directory)
    try:
        yield
    finally:
        os.environ.pop(key, None)


def _run(cfg, arch_id, shape, state, step_fn, steps, ckpt_dir, ckpt_every, inject_failures,
         seed, dev) -> dict:
    loader = PrefetchingLoader(cfg, shape, DataConfig(seed=seed + 1))
    # without a ckpt_dir, the run's checkpoints live in a directory of its own,
    # removed when it ends: a later run never resumes from them
    own_dir = None if ckpt_dir else tempfile.mkdtemp(prefix=f"repro_torch_ckpt_{arch_id}_")
    ckpt = Checkpointer(ckpt_dir or own_dir, cfg, keep=2)
    trainer = FaultTolerantTrainer(
        step_fn=step_fn, checkpointer=ckpt, loader=loader,
        cfg=FaultConfig(ckpt_every=ckpt_every, inject_failures=inject_failures or {}))
    t0 = time.time()
    try:
        state, final_step, metrics = trainer.run(state, steps)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    finally:
        loader.close()
        if own_dir:
            ckpt.wait()
            shutil.rmtree(own_dir, ignore_errors=True)
    dt = time.time() - t0
    return {
        "final_step": final_step,
        "losses": [float(m["loss"]) for m in metrics],
        "restarts": trainer.restarts,
        "straggler_fallbacks": loader.straggler_fallbacks,
        "wall_s": dt,
        "ckpt_timings": dict(ckpt.timings),
        "state": tree_map(lambda t: t.full_tensor() if isinstance(t, DTensor) else t, state),
    }


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--full", action="store_true", help="full (non-smoke) config")
    ap.add_argument("--compress", action="store_true")
    ap.add_argument("--n-micro", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    logging.basicConfig(level=logging.INFO)
    out = train(args.arch, smoke=not args.full, steps=args.steps,
                batch=args.batch, seq=args.seq, ckpt_dir=args.ckpt_dir,
                compress=args.compress, n_micro=args.n_micro, seed=args.seed,
                device=args.device)
    losses = (f"loss[0]={out['losses'][0]:.4f} loss[-1]={out['losses'][-1]:.4f} "
              if out["losses"] else "no steps run (resumed at the last step) ")
    print(f"steps={out['final_step']} {losses}wall={out['wall_s']:.1f}s "
          f"restarts={out['restarts']}")


if __name__ == "__main__":
    main()
