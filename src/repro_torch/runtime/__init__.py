from .train_step import (
    build_decode_step, build_eval_step, build_prefill_step, build_train_step, grads_of,
    make_train_state, to_device,
)

__all__ = ["build_decode_step", "build_eval_step", "build_prefill_step", "build_train_step",
           "grads_of", "make_train_state", "to_device"]
