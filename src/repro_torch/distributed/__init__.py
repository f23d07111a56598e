from .fault import FaultConfig, FaultTolerantTrainer, SimulatedFailure

__all__ = ["FaultConfig", "FaultTolerantTrainer", "SimulatedFailure"]
