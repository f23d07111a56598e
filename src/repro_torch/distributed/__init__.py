from .elastic import degraded_mesh, reshard_state
from .fault import FaultConfig, FaultTolerantTrainer, SimulatedFailure
from .pipeline_parallel import pipeline_forward, sequential_reference
from .sharding import (
    Sharding, ShardingRules, constrain, default_rules, logical_to_spec, param_shardings,
    place, shardings_for, use_rules,
)

__all__ = [
    "ShardingRules", "Sharding", "constrain", "default_rules", "logical_to_spec",
    "param_shardings", "place", "shardings_for", "use_rules",
    "FaultConfig", "FaultTolerantTrainer", "SimulatedFailure",
    "degraded_mesh", "reshard_state",
    "pipeline_forward", "sequential_reference",
]
