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
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import resolve_device
from ..configs.base import ArchConfig
from ..models.lm import decode_step, init_decode_cache, init_params
from .allocator import AddressAllocationUnit
from .scheduler import Request, TwoLevelScheduler


@dataclass
class ServeConfig:
    max_len: int = 512
    active_slots: int = 8
    total_pages: int = 64


class ServingEngine:
    def __init__(self, cfg: ArchConfig, params=None, sc: ServeConfig | None = None,
                 generator: torch.Generator | None = None, device="cuda"):
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
            toks = torch.from_numpy(self.tokens).to(self.device)
            if self.cfg.family == "audio":       # (B, 1) -> (B, K, 1)
                toks = toks[:, None, :].expand(-1, self.cfg.n_codebooks, 1)
            logits, self.cache = decode_step(
                self.params, self.cache, toks,
                min(cache_len, self.sc.max_len - 1), self.cfg)
            nxt = logits[:, -1].argmax(dim=-1)
            if self.cfg.family == "audio":       # codebook 0's token
                nxt = nxt[:, 0]
            nxt = nxt.cpu().numpy()
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
