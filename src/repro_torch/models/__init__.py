from .convert import params_from_numpy, params_to_numpy
from .lm import (
    decode_step, forward, init_decode_cache, init_params, logits_fn, loss_fn,
)

__all__ = ["decode_step", "forward", "init_decode_cache", "init_params",
           "logits_fn", "loss_fn", "params_from_numpy", "params_to_numpy"]
