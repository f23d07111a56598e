"""Helpers the metric readers share: the traced slice's kernel time, a
roofline share that refuses to pass 100 %, and the device's idle share."""
from __future__ import annotations

import sys


def kernel_time(rec: dict, pattern: str) -> tuple[float, int]:
    """(seconds, spans) of the traced slice's device spans whose kernel name
    holds ``pattern``."""
    spans = [d for n, d in rec["trace"]["spans"] if pattern in n]
    return sum(spans), len(spans)


def roofline(rec: dict, pattern: str, bound_s: float, launches: int,
             counted: str = "") -> float | None:
    """100 x the slice's bound over the device time of its ``pattern``
    kernels; the launches the trace shows are printed beside those the work
    count expects and ``counted`` (the program's own counters).  A share
    over 100 % means the count is wrong: it raises."""
    if "trace" not in rec:
        return None
    t, n = kernel_time(rec, pattern)
    print(f"{pattern}: {n} launches in the traced slice, {launches} expected by the work count"
          f"{counted}; {t * 1e3:.3f} ms on the device against a bound of {bound_s * 1e3:.3f} ms",
          file=sys.stderr)
    if n == 0:
        return None
    share = 100.0 * bound_s / t
    if share > 100.0:
        raise RuntimeError(f"{pattern}: its bound {bound_s} s exceeds its device time {t} s")
    return share


def idle_share(rec: dict) -> float | None:
    if "trace" not in rec or rec["trace"]["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - rec["trace"]["busy_s"] / rec["trace"]["window_s"])


def counters(rec: dict, names: tuple, slice_steps: int) -> str:
    """The program's launch counters over the window, scaled to the slice."""
    per = {k: rec["launches"].get(k, 0) * slice_steps / max(rec["steps"], 1) for k in names}
    return "; the program's counters " + ", ".join(f"{k} {v:g}" for k, v in per.items())


def traced_decode_steps(rec: dict) -> int:
    k0, k1 = rec["traced"]
    return k1 - k0
