"""Checkpointing (port of ``repro.checkpoint.ckpt``) in the JAX package's
on-disk format: a checkpoint written by either package restores in the
other, leaf for leaf equal.

Layout (one directory per step, written to ``.tmp_step_*`` and renamed):
    <dir>/step_000123/
        manifest.json      # step; per leaf: key, path, shape, dtype, sha256
        arrays.npz         # the leaves a0, a1, ...
        COMMIT             # written last: a checkpoint without it is partial

A state is written in the JAX package's layout.  Each params-shaped subtree
(a dict whose ``"layers"`` is a list: the params, the AdamW moments, the
error-feedback buffers) goes through ``convert.params_to_numpy``: layers
stacked on a leading L axis, ``lm_head`` cut back to the config's width.
Leaves are written in JAX's flatten order (dict keys sorted, list items by
index); ``path`` is the string ``jax.tree_util.keystr`` gives, e.g.
``['opt']['mu']['layers']['attn']['wq']``; a bf16 leaf is stored as its raw
uint16 bits with ``"dtype": "bfloat16"``; the int32 step has shape [].

``restore`` rebuilds the tree from the manifest's paths, verifies each
leaf's sha256, converts params-shaped subtrees back to the port's layout
(``convert.params_from_numpy``: layers unstacked, the head padded as held)
and checks the result against a like-tree (structure, shapes, dtypes; the
like-tree's leaves may be meta tensors).  ``save_async`` copies the state to
the host at once and writes it on a background thread, one write in flight.
``timings`` accumulates the seconds spent copying to the host, writing and
restoring.
"""
from __future__ import annotations

import hashlib
import json
import pathlib
import re
import shutil
import threading
import time

import numpy as np
import torch

from ..configs.base import ArchConfig
from ..models.convert import BF16, from_host, params_from_numpy, params_to_numpy, to_host

_KEY = re.compile(r"\['((?:[^'\\]|\\.)*)'\]|\[(\d+)\]")


def _is_params(tree) -> bool:
    return isinstance(tree, dict) and isinstance(tree.get("layers"), list)


def _to_host(tree, cfg: ArchConfig):
    """A port tree (tensors) -> host leaves in the JAX package's layout."""
    if _is_params(tree):
        return params_to_numpy(tree, cfg)
    if isinstance(tree, dict):
        return {k: _to_host(v, cfg) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_host(v, cfg) for v in tree]
    return to_host(tree)


def _flatten(tree, prefix: str = ""):
    """(path, leaf) in JAX's flatten order, path as ``jax.tree_util.keystr``."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten(tree[k], f"{prefix}[{k!r}]")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _flatten(v, f"{prefix}[{i}]")
    else:
        yield prefix, tree


def _insert(tree: dict, path: str, leaf) -> None:
    """Put ``leaf`` at ``path`` (dict keys only: the trees written here hold
    no lists once params are stacked)."""
    keys = [m.group(1) for m in _KEY.finditer(path)]
    if not keys or "".join(f"[{k!r}]" for k in keys) != path:
        raise ValueError(f"checkpoint path {path!r} is not a path of dict keys")
    for k in keys[:-1]:
        tree = tree.setdefault(k, {})
    tree[keys[-1]] = leaf


def _to_port(host, like, cfg: ArchConfig, device):
    """Host leaves in the JAX layout -> tensors in the port's layout, in
    ``like``'s key order; raises ValueError where the two differ."""
    if _is_params(like):
        if not isinstance(host, dict) or set(host) != set(like):
            raise ValueError(f"checkpoint params {sorted(host)} != target {sorted(like)}")
        depths = {(a[0] if isinstance(a, tuple) else a).shape[0]
                  for _, a in _flatten(host["layers"])}
        if depths != {len(like["layers"])} or cfg.n_layers != len(like["layers"]):
            raise ValueError(f"checkpoint layers {sorted(depths)} != target "
                             f"{len(like['layers'])} (config {cfg.n_layers})")
        host = params_from_numpy(host, cfg, device)
    if isinstance(like, dict):
        if not isinstance(host, dict) or set(host) != set(like):
            got = sorted(host) if isinstance(host, dict) else type(host).__name__
            raise ValueError(f"checkpoint keys {got} != target keys {sorted(like)}")
        return {k: _to_port(host[k], v, cfg, device) for k, v in like.items()}
    if isinstance(like, list):
        if not isinstance(host, list) or len(host) != len(like):
            raise ValueError(f"checkpoint list does not match a target list of {len(like)}")
        return [_to_port(h, v, cfg, device) for h, v in zip(host, like)]
    t = host if isinstance(host, torch.Tensor) else from_host(host, device)
    if tuple(t.shape) != tuple(like.shape) or t.dtype != like.dtype:
        raise ValueError(f"checkpoint leaf {tuple(t.shape)} {t.dtype} != target "
                         f"{tuple(like.shape)} {like.dtype}")
    return t


def _device(like, device):
    if device is not None:
        return torch.device(device)
    for leaf in _flatten(like):
        if leaf[1].device.type != "meta":
            return leaf[1].device
    raise ValueError("restore onto meta tensors needs a device")


class Checkpointer:
    def __init__(self, directory: str | pathlib.Path, cfg: ArchConfig, keep: int = 3):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.cfg = cfg
        self.keep = keep
        self._inflight: threading.Thread | None = None
        self.timings = {"to_host_s": 0.0, "write_s": 0.0, "restore_s": 0.0}

    # ------------------------------------------------------------------ save
    def _snapshot(self, tree):
        t0 = time.perf_counter()
        host = _to_host(tree, self.cfg)
        self.timings["to_host_s"] += time.perf_counter() - t0
        return host

    def save(self, step: int, tree) -> pathlib.Path:
        return self._write(step, self._snapshot(tree))

    def save_async(self, step: int, tree) -> None:
        """Copy to the host now; write on a background thread."""
        self.wait()  # bounded in-flight: one writer
        host = self._snapshot(tree)
        self._inflight = threading.Thread(target=self._write, args=(step, host), daemon=True)
        self._inflight.start()

    def wait(self) -> None:
        if self._inflight is not None:
            self._inflight.join()
            self._inflight = None

    def _write(self, step: int, host_tree) -> pathlib.Path:
        t0 = time.perf_counter()
        leaves = list(_flatten(host_tree))
        out = self.dir / f"step_{step:09d}"
        tmp = self.dir / f".tmp_step_{step:09d}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        stored = [(p, x[0], x[1]) if isinstance(x, tuple) else (p, x, x.dtype.name)
                  for p, x in leaves]
        np.savez(tmp / "arrays.npz", **{f"a{i}": a for i, (_, a, _) in enumerate(stored)})
        manifest = {
            "step": step,
            "leaves": [
                {"key": f"a{i}", "path": p, "shape": list(a.shape), "dtype": name,
                 "sha256": hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()}
                for i, (p, a, name) in enumerate(stored)
            ],
        }
        (tmp / "manifest.json").write_text(json.dumps(manifest, indent=1))
        (tmp / "COMMIT").write_text("ok")
        if out.exists():
            shutil.rmtree(out)
        tmp.rename(out)
        self._gc()
        self.timings["write_s"] += time.perf_counter() - t0
        return out

    # --------------------------------------------------------------- restore
    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def all_steps(self) -> list[int]:
        out = []
        for p in self.dir.glob("step_*"):
            if (p / "COMMIT").exists():
                m = re.match(r"step_(\d+)", p.name)
                if m:
                    out.append(int(m.group(1)))
        return sorted(out)

    def restore(self, step: int, like_tree, device=None, verify: bool = True):
        """Load checkpoint ``step`` shaped like ``like_tree`` (the port's
        layout; leaves may be meta tensors) onto ``device`` (default: the
        like-tree's)."""
        t0 = time.perf_counter()
        path = self.dir / f"step_{step:09d}"
        manifest = json.loads((path / "manifest.json").read_text())
        host: dict = {}
        with np.load(path / "arrays.npz") as data:
            for meta in manifest["leaves"]:
                arr = data[meta["key"]]
                if verify:
                    h = hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()
                    if h != meta["sha256"]:
                        raise IOError(f"checkpoint corruption at leaf {meta['path']}")
                leaf = (arr, BF16) if meta["dtype"] == BF16 else arr.view(np.dtype(meta["dtype"]))
                _insert(host, meta["path"], leaf)
        tree = _to_port(host, like_tree, self.cfg, _device(like_tree, device))
        self.timings["restore_s"] += time.perf_counter() - t0
        return tree

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(self.dir / f"step_{s:09d}", ignore_errors=True)
