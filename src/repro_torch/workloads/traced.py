"""The lazy ``traced`` suite: in-repo kernels lifted through the frontend.

Importing this module only registers the suite's *names*; tracing (the
port's graph lifter, `repro_torch.frontend`) runs the first time a traced
workload is requested via `get_workload` / `load_suite` /
`workload_names("traced")`.  Copy of ``repro.workloads.traced``.
"""
from __future__ import annotations

from repro_torch.frontend.workloads import TRACED_NAMES

from .suite import register_suite


def _load():
    from repro_torch.frontend.workloads import traced_suite

    return traced_suite().values()


register_suite("traced", _load, names=TRACED_NAMES)
