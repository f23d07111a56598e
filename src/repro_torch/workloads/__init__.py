from .suite import (WORKLOADS, Workload, get_workload, listing1_program,
                    load_suite, register_suite, register_workload,
                    workload_names)
from . import traced as _traced  # noqa: F401  (registers the lazy traced suite)

__all__ = ["WORKLOADS", "Workload", "get_workload", "listing1_program",
           "load_suite", "register_suite", "register_workload",
           "workload_names"]
