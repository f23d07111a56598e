from .pipeline import DataConfig, PrefetchingLoader, batch_for_step

__all__ = ["DataConfig", "PrefetchingLoader", "batch_for_step"]
