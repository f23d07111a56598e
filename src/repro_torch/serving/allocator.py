"""Address Allocation Unit (paper Fig. 13) applied to paged KV-cache slots.

The paper's AAU is two queues — *unused* (free banks) and *occupied* — used
to hand register-cache banks to prefetched registers.  The identical
structure manages KV-cache pages in the serving engine: allocation pops the
head of the unused queue; deallocation returns the entry.  O(1), fragment-
free, and trivially auditable — exactly why the paper chose it.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field


@dataclass
class AddressAllocationUnit:
    capacity: int
    unused: deque = field(default_factory=deque)
    occupied: dict[int, object] = field(default_factory=dict)

    def __post_init__(self) -> None:
        self.unused = deque(range(self.capacity))

    def alloc(self, owner=None) -> int | None:
        """Pop the head of the unused queue (None if exhausted)."""
        if not self.unused:
            return None
        slot = self.unused.popleft()
        self.occupied[slot] = owner
        return slot

    def free(self, slot: int) -> None:
        owner = self.occupied.pop(slot, _MISSING)
        if owner is _MISSING:
            raise KeyError(f"slot {slot} not allocated")
        self.unused.append(slot)

    def owner_of(self, slot: int):
        return self.occupied.get(slot)

    @property
    def free_count(self) -> int:
        return len(self.unused)

    @property
    def used_count(self) -> int:
        return len(self.occupied)

    def check_invariants(self) -> None:
        assert self.free_count + self.used_count == self.capacity
        assert set(self.unused).isdisjoint(self.occupied.keys())


class _Missing:
    pass


_MISSING = _Missing()
