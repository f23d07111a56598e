from .ops import ssd_chunk, ssd_scan
from .ref import ssd_chunk_ref, ssd_ref

__all__ = ["ssd_chunk", "ssd_chunk_ref", "ssd_ref", "ssd_scan"]
