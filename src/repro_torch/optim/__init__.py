from .adamw import (
    AdamWConfig, adamw_update, global_norm, init_opt_state, lr_schedule, opt_state_axes,
)
from .compression import CompressionConfig, compress_gradients

__all__ = ["AdamWConfig", "CompressionConfig", "adamw_update", "compress_gradients",
           "global_norm", "init_opt_state", "lr_schedule", "opt_state_axes"]
