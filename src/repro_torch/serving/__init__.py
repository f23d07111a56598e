"""The port's serving layer: the model server (``engine``, with copies of
the request scheduler and page allocator) and the simulator's fault-tolerant
sweep service (``sweep``, ``faults``)."""
from .allocator import AddressAllocationUnit
from .engine import ServeConfig, ServingEngine
from .scheduler import PAGE_TOKENS, Request, TwoLevelScheduler
from .sweep import (
    FAILURE_KINDS, FailureRecord, ResultStore, SimRunner, SweepConfig,
    SweepReport, default_processes, default_runner, job_label, sim_key,
)

__all__ = ["AddressAllocationUnit", "PAGE_TOKENS", "Request",
           "TwoLevelScheduler", "ServeConfig", "ServingEngine",
           "FAILURE_KINDS", "FailureRecord", "ResultStore", "SimRunner",
           "SweepConfig", "SweepReport", "default_processes",
           "default_runner", "job_label", "sim_key"]
