"""The port's simulators: copies of ``repro.sim``'s scalar event engine and
design points, and the batch engine rewritten in PyTorch (``batch``).  The
whole-GPU model (``gpu``) and the analytic tier come with the sweep service."""
from .engine import (
    BANK_MODELS, DESIGNS, INTERVAL_STRATEGIES, RENUMBER_MODES, SCHEDULERS,
    SimBudgetExceeded, SimConfig, SimResult, Simulator, simulate,
)
from .designs import (
    TABLE2, TOLERANCE_MULTS, baseline_config, design_config,
    max_tolerable_latency, normalized_ipc, run,
)
from .batch import (
    BATCH_REV, RUN_STATS, batch_supported, reset_run_stats, run_batch,
    simulate_batch, simulate_one,
)

__all__ = [
    "SimBudgetExceeded",
    "SimConfig", "SimResult", "Simulator", "simulate", "DESIGNS",
    "SCHEDULERS", "BANK_MODELS", "RENUMBER_MODES", "INTERVAL_STRATEGIES",
    "BATCH_REV", "RUN_STATS", "batch_supported", "reset_run_stats", "run_batch",
    "simulate_batch", "simulate_one",
    "TABLE2", "TOLERANCE_MULTS", "baseline_config", "design_config",
    "max_tolerable_latency", "normalized_ipc", "run",
]
