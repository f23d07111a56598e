"""Batched serving engine (port of ``repro.serving.engine``).

Continuous batching over ``decode_step``: the two-level request scheduler
(paged KV via the Address Allocation Unit) decides which requests own the
``active_slots`` rows of the decode cache (a dense (L, B_slots, S_max, kv, hd)
KV cache, or the Mamba2 families' conv window and SSM state).  As in the
reference, all slots share one ``cache_len`` (clamped to ``max_len - 1``;
the ssm family ignores it), each slot is fed its previous greedy token (zeros
at first; prompts only set ``prompt_len`` for paging), the step's tokens map
onto the active requests in order, and a slot's SSM state is not reset when
a new request takes the slot.  Audio models are fed each slot's token on
every codebook and emit codebook 0's greedy token.  The slot order is part of
a MoE model's result: capacity drops depend on which tokens share a step.

On a CUDA device the step runs as one ``torch.cuda.CUDAGraph``, as the
reference compiles it once with ``jax.jit``: the constructor warms the step
on a side stream, captures it once at the engine's fixed ``active_slots`` and
``max_len`` with ``cache_len`` in a device scalar, and zeroes the caches that
warm-up and capture wrote.  Each step then copies the slots' tokens in,
writes ``cache_len`` into the scalar, replays, and brings the greedy tokens
(computed inside the graph) to the host.  The kernel wrappers count their
launches at capture; the engine puts the counters back after capture and adds
the step's launches once per replay, so they read as the eager step's.
``graphs=False``, the CPU and a DTensor parameter tree (the mesh path) run the
step eagerly.  A capture that fails raises.
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from .. import resolve_device
from ..configs.base import ArchConfig
from ..kernels import counts
from ..models.lm import decode_step, init_decode_cache, init_params
from ..tree import tree_leaves
from .allocator import AddressAllocationUnit
from .scheduler import Request, TwoLevelScheduler


@dataclass
class ServeConfig:
    max_len: int = 512
    active_slots: int = 8
    total_pages: int = 64


class ServingEngine:
    def __init__(self, cfg: ArchConfig, params=None, sc: ServeConfig | None = None,
                 generator: torch.Generator | None = None, device="cuda",
                 graphs: bool = True):
        self.cfg = cfg
        self.sc = sc or ServeConfig()
        self.device = resolve_device(device)
        self.params = (params if params is not None
                       else init_params(cfg, generator, self.device))
        self.aau = AddressAllocationUnit(self.sc.total_pages)
        self.sched = TwoLevelScheduler(self.aau, active_slots=self.sc.active_slots)
        self.cache = init_decode_cache(cfg, self.sc.active_slots, self.sc.max_len,
                                       self.device)
        self.tokens = np.zeros((self.sc.active_slots, 1), np.int64)
        self.generated: dict[int, list[int]] = {}
        self.steps = 0
        self.graph: torch.cuda.CUDAGraph | None = None
        self.step_launches: dict = {}       # the kernel launches one replay makes
        self.capture_s = 0.0
        if (graphs and self.device.type == "cuda"
                and not any(isinstance(t, DTensor) for t in tree_leaves(self.params))):
            self._capture()

    def _step(self, toks: torch.Tensor, cache_len) -> torch.Tensor:
        """The decode step of every slot: the greedy tokens (B,) on the device."""
        with torch.no_grad():
            if self.cfg.family == "audio":       # (B, 1) -> (B, K, 1)
                toks = toks[:, None, :].expand(-1, self.cfg.n_codebooks, 1)
            logits, self.cache = decode_step(self.params, self.cache, toks, cache_len,
                                             self.cfg)
            nxt = logits[:, -1].argmax(dim=-1)
            return nxt[:, 0] if self.cfg.family == "audio" else nxt   # codebook 0's token

    def _capture(self) -> None:
        """Warm the step up on a side stream (everything made at first use is
        made there: the kernels' libraries, the split products' workspace, the
        RoPE frequencies), capture it on that stream, then zero the caches and
        put the launch counters back: warm-up and capture are set-up, not
        steps."""
        t0 = time.perf_counter()
        dev = self.device
        before = counts.read()
        self._toks = torch.zeros((self.sc.active_slots, 1), dtype=torch.long, device=dev)
        self._len = torch.zeros((), dtype=torch.long, device=dev)
        with torch.cuda.device(dev):
            stream = torch.cuda.Stream(dev)
            stream.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(stream):
                self._step(self._toks, self._len)
            torch.cuda.current_stream(dev).wait_stream(stream)
            warmed = counts.read()
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, stream=stream):
                self._next = self._step(self._toks, self._len)
            self.step_launches = counts.since(warmed)
            counts.write(before)
            for t in tree_leaves(self.cache):
                t.zero_()
            torch.cuda.synchronize(dev)
        self.graph = graph
        self.capture_s = time.perf_counter() - t0

    def decode(self, cache_len: int) -> torch.Tensor:
        """One step of every slot, fed ``self.tokens``, at ``cache_len`` (the
        caller clamps it to ``max_len - 1``): the greedy tokens (B,) on the
        device.  A replayed step returns the graph's output buffer, which the
        next step overwrites."""
        if self.graph is None:
            return self._step(torch.from_numpy(self.tokens).to(self.device), cache_len)
        self._toks.copy_(torch.from_numpy(self.tokens))
        self._len.fill_(cache_len)
        self.graph.replay()
        counts.add(self.step_launches)
        return self._next

    def submit(self, prompt: list[int], max_new_tokens: int = 16) -> Request:
        r = self.sched.submit(len(prompt), max_new_tokens)
        self.generated[r.rid] = []
        return r

    def run(self, max_steps: int = 4096) -> dict[int, list[int]]:
        """Greedy-decode all submitted requests to completion."""
        self.sched.admit()
        cache_len = 0
        steps = 0
        while (self.sched.active or self.sched.waiting) and steps < max_steps:
            steps += 1
            nxt = self.decode(min(cache_len, self.sc.max_len - 1)).cpu().numpy()
            for i, r in enumerate(list(self.sched.active)):
                if i >= self.tokens.shape[0]:
                    break
                tok = int(nxt[i])
                self.generated[r.rid].append(tok)
                self.tokens[i, 0] = tok
            cache_len = min(cache_len + 1, self.sc.max_len - 1)
            self.sched.step()
        self.steps += steps
        return self.generated
