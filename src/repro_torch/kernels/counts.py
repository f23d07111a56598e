"""The kernel wrappers' launch counters, read, put back and added as one record.

Each wrapper adds one to its counters (``launches``, and per route or layout
where it has them) where it launches its kernel, on the host.  A CUDA graph
replays its launches without the host: whoever replays one adds the launches
its capture counted (``add``), so the counters read as if every replay had
launched eagerly.
"""
from __future__ import annotations

from .flash_attention.ops import flash_attention, flash_bwd
from .ltrf_matmul.ops import ltrf_matmul
from .sim_batch.ops import sim_batch
from .ssd_scan.ops import ssd_chunk_bwd, ssd_scan

WRAPPERS = (ltrf_matmul, flash_attention, ssd_scan, flash_bwd, ssd_chunk_bwd, sim_batch)
COUNTERS = ("launches", "launches_by_route", "launches_by_layout")


def read() -> dict:
    """Every counter, copied: {(wrapper, attribute): int, or {key: int}}."""
    return {(fn, name): (dict(v) if isinstance(v, dict) else v)
            for fn in WRAPPERS for name in COUNTERS
            if (v := getattr(fn, name, None)) is not None}


def since(before: dict) -> dict:
    """What every counter gained since ``read()`` gave ``before``."""
    return {key: ({k: n - before[key][k] for k, n in v.items()} if isinstance(v, dict)
                  else v - before[key])
            for key, v in read().items()}


def write(counts: dict) -> None:
    """Set every counter to ``counts`` (a ``read()``)."""
    for (fn, name), v in counts.items():
        setattr(fn, name, dict(v) if isinstance(v, dict) else v)


def add(delta: dict) -> None:
    """Add ``delta`` (a ``since()``) to every counter."""
    for (fn, name), v in delta.items():
        if isinstance(v, dict):
            counter = getattr(fn, name)
            for k, n in v.items():
                counter[k] += n
        else:
            setattr(fn, name, getattr(fn, name) + v)
