"""Fault tolerance: checkpoint/restart training supervisor (port of
``repro.distributed.fault``).

``FaultTolerantTrainer`` wraps a step function with:
  * periodic async checkpoints (bounded in-flight, content-hashed);
  * failure recovery -- on any step exception it restores the last committed
    checkpoint, repositions the deterministic data stream and replays;
  * an injectable failure schedule for testing (``inject_failures``).

Restart-from-zero and restart-mid-run are the same code path: ``resume()``
finds the newest committed checkpoint or initializes fresh.  The step
function consumes its state (the port's train step updates it in place), so
restores take their template from the live state's shapes and dtypes (meta
tensors), never from buffers a step has already consumed.
"""
from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Any, Callable

import torch
from torch.distributed.tensor import DTensor, distribute_tensor

from ..tree import tree_leaves, tree_map

if TYPE_CHECKING:      # the checkpoint package imports the models, which import this one
    from ..checkpoint import Checkpointer

log = logging.getLogger("repro_torch.fault")


@dataclass
class FaultConfig:
    ckpt_every: int = 50
    max_retries: int = 3
    inject_failures: dict[int, int] = field(default_factory=dict)
    # {step: n_times} -> raise simulated failure at `step`, n times


class SimulatedFailure(RuntimeError):
    pass


@dataclass
class FaultTolerantTrainer:
    step_fn: Callable[[Any, Any], tuple[Any, Any]]
    checkpointer: Checkpointer
    loader: Any                      # PrefetchingLoader-compatible
    cfg: FaultConfig = field(default_factory=FaultConfig)
    restarts: int = 0
    _injected: dict[int, int] = field(default_factory=dict)

    def resume(self, init_state) -> tuple[Any, int]:
        last = self.checkpointer.latest_step()
        if last is None:
            # commit the initial state synchronously: a failure before the
            # first periodic checkpoint must never fall back to `init_state`,
            # which the step function has already consumed
            self.checkpointer.save(0, init_state)
            return init_state, 0
        state = _relayout(self.checkpointer.restore(last, init_state), init_state)
        self.loader.restore(last)
        log.info("resumed from checkpoint step %d", last)
        return state, last

    def run(self, init_state, num_steps: int):
        # shape/dtype template for restores (never holds live buffers)
        device = tree_leaves(init_state)[0].device
        template = tree_map(lambda x: torch.empty(x.shape, dtype=x.dtype, device="meta"),
                            init_state)
        layout = tree_map(_layout, init_state)
        state, start = self.resume(init_state)
        step = start
        metrics_log = []
        retries = 0
        while step < num_steps:
            batch = self.loader.get()
            try:
                self._maybe_inject(step)
                state, metrics = self.step_fn(state, batch)
            except Exception as e:  # noqa: BLE001 - supervisor catches all
                retries += 1
                self.restarts += 1
                if retries > self.cfg.max_retries:
                    raise
                log.warning("step %d failed (%s); restoring", step, e)
                self.checkpointer.wait()  # let any in-flight write commit
                last = self.checkpointer.latest_step()
                assert last is not None  # step-0 checkpoint always exists
                state = _relayout(self.checkpointer.restore(last, template, device), layout)
                step = last
                self.loader.restore(step)
                continue
            retries = 0
            step += 1
            metrics_log.append(metrics)
            if step % self.cfg.ckpt_every == 0:
                self.checkpointer.save_async(step, state)
        self.checkpointer.wait()
        self.checkpointer.save(step, state)
        return state, step, metrics_log

    def _maybe_inject(self, step: int) -> None:
        want = self.cfg.inject_failures.get(step, 0)
        done = self._injected.get(step, 0)
        if done < want:
            self._injected[step] = done + 1
            raise SimulatedFailure(f"injected failure at step {step}")


def _layout(x):
    """A DTensor leaf's (mesh, placements); None for a plain tensor."""
    return (x.device_mesh, x.placements) if isinstance(x, DTensor) else None


def _relayout(state, like):
    """A restored state (plain tensors) placed as ``like``'s DTensor leaves
    are (``like``: a state, or a tree of ``_layout``s)."""
    def one(t, ref):
        lay = _layout(ref) if isinstance(ref, torch.Tensor) else ref
        return t if lay is None else distribute_tensor(t, *lay)

    return tree_map(one, state, like)
