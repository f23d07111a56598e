from .ckpt import Checkpointer

__all__ = ["Checkpointer"]
