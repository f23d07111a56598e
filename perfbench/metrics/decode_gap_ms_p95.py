"""decode_gap_ms_p95: the 95th percentile, over every step of the window, of
the time between successive entries to the engine's decode step."""
import numpy as np


def read(rec):
    if rec["kind"] != "serve" or len(rec["starts"]) < 2:
        return None
    return float(np.percentile(np.diff(rec["starts"]), 95) * 1e3)
