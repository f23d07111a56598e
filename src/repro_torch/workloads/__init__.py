"""The simulator's workloads: a copy of ``repro.workloads``' registry and
synthetic suite.  The ``traced`` suite (kernels lifted through the frontend)
is not registered here: it comes with the port's graph lifter."""
from .suite import (WORKLOADS, Workload, get_workload, listing1_program,
                    load_suite, register_suite, register_workload,
                    workload_names)

__all__ = ["WORKLOADS", "Workload", "get_workload", "listing1_program",
           "load_suite", "register_suite", "register_workload",
           "workload_names"]
