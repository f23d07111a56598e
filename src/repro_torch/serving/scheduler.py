"""Two-level request scheduler (the paper's warp scheduler, for serving).

Requests mirror warps:
  * a bounded **active set** (the paper's 8 active warps) holds requests with
    KV pages resident ("register cache" space);
  * **inactive** requests wait in an admission queue; when a request finishes
    or is preempted, the scheduler *activates* a waiting one — paying the
    page-allocation (prefetch) cost then, not on the decode critical path;
  * preemption on page exhaustion writes nothing back (pages are the source
    of truth), matching LTRF+'s "only live state moves".
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field

from .allocator import AddressAllocationUnit

PAGE_TOKENS = 256


@dataclass
class Request:
    rid: int
    prompt_len: int
    max_new_tokens: int
    generated: int = 0
    pages: list[int] = field(default_factory=list)
    state: str = "waiting"  # waiting | active | finished | preempted

    @property
    def tokens(self) -> int:
        return self.prompt_len + self.generated

    def pages_needed(self) -> int:
        return -(-max(self.tokens, 1) // PAGE_TOKENS)


@dataclass
class TwoLevelScheduler:
    aau: AddressAllocationUnit
    active_slots: int = 8
    active: list[Request] = field(default_factory=list)
    waiting: list[Request] = field(default_factory=list)
    finished: list[Request] = field(default_factory=list)
    preemptions: int = 0
    _ids: itertools.count = field(default_factory=itertools.count)

    def submit(self, prompt_len: int, max_new_tokens: int) -> Request:
        r = Request(rid=next(self._ids), prompt_len=prompt_len,
                    max_new_tokens=max_new_tokens)
        self.waiting.append(r)
        return r

    # -- page management ------------------------------------------------------
    def _grow(self, r: Request) -> bool:
        """Ensure ``r`` owns enough pages; False if the pool is exhausted."""
        while len(r.pages) < r.pages_needed():
            slot = self.aau.alloc(owner=r.rid)
            if slot is None:
                return False
            r.pages.append(slot)
        return True

    def _release(self, r: Request) -> None:
        for p in r.pages:
            self.aau.free(p)
        r.pages = []

    # -- scheduling ------------------------------------------------------------
    def admit(self) -> list[Request]:
        """Activate waiting requests while slots + pages allow."""
        admitted = []
        while self.waiting and len(self.active) < self.active_slots:
            r = self.waiting[0]
            if not self._grow(r):
                self._release(r)
                break  # page pool exhausted; try again after completions
            self.waiting.pop(0)
            r.state = "active"
            self.active.append(r)
            admitted.append(r)
        return admitted

    def step(self) -> list[Request]:
        """One decode step for the active batch; returns finished requests."""
        done = []
        for r in list(self.active):
            r.generated += 1
            if not self._grow(r):
                # page exhaustion mid-flight: preempt the *youngest* request
                victim = max(self.active, key=lambda q: q.rid)
                victim.state = "preempted"
                self.preemptions += 1
                self._release(victim)
                self.active.remove(victim)
                self.waiting.insert(0, victim)
                victim.generated = 0  # will re-prefill on activation
                if victim is r:
                    continue
            if r.generated >= r.max_new_tokens:
                r.state = "finished"
                self._release(r)
                self.active.remove(r)
                self.finished.append(r)
                done.append(r)
        self.admit()
        return done

    def run_to_completion(self, max_steps: int = 100_000) -> int:
        self.admit()
        steps = 0
        while (self.active or self.waiting) and steps < max_steps:
            self.step()
            steps += 1
            if not self.active and self.waiting:
                # nothing admissible: a single waiting request larger than
                # the pool would deadlock; fail loudly instead
                if not self.admit():
                    raise RuntimeError("page pool too small for request")
        return steps
