"""The port's simulators: copies of ``repro.sim``'s scalar event engine,
design points, whole-GPU model (``gpu``), power model (``power``) and
analytic tier (``analytic``), and the batch engine rewritten in PyTorch
(``batch``)."""
from .engine import (
    BANK_MODELS, DESIGNS, INTERVAL_STRATEGIES, RENUMBER_MODES, SCHEDULERS,
    SimBudgetExceeded, SimConfig, SimResult, Simulator, simulate,
)
from .designs import (
    TABLE2, TOLERANCE_MULTS, baseline_config, design_config,
    max_tolerable_latency, normalized_ipc, run,
)
from .gpu import GpuResult, simulate_gpu
from .batch import (
    BATCH_REV, RUN_STATS, batch_supported, reset_run_stats, run_batch,
    simulate_batch, simulate_one,
)
from .analytic import (
    ANALYTIC_REV, CALIB_REV, TIERS, AnalyticModelError, AnalyticResult,
    Calibration, CalibrationError, analytic_supported, estimate,
    fit_calibration, load_calibration, pareto_frontier, save_calibration,
    spearman_rho,
)

__all__ = [
    "SimBudgetExceeded",
    "SimConfig", "SimResult", "Simulator", "simulate", "DESIGNS",
    "SCHEDULERS", "BANK_MODELS", "RENUMBER_MODES", "INTERVAL_STRATEGIES",
    "GpuResult", "simulate_gpu",
    "BATCH_REV", "RUN_STATS", "batch_supported", "reset_run_stats", "run_batch",
    "simulate_batch", "simulate_one",
    "TABLE2", "TOLERANCE_MULTS", "baseline_config", "design_config",
    "max_tolerable_latency", "normalized_ipc", "run",
    "ANALYTIC_REV", "CALIB_REV", "TIERS", "AnalyticModelError",
    "AnalyticResult", "Calibration", "CalibrationError",
    "analytic_supported", "estimate", "fit_calibration", "load_calibration",
    "pareto_frontier", "save_calibration", "spearman_rho",
]
