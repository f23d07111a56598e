"""A profiler over a bounded slice of the window, and what its trace says.

``Slice`` starts ``torch.profiler`` (host ops and CUDA activity) at one step
and stops it some steps later; ``read`` takes the device spans (kernels,
copies, memsets) from its Chrome trace: their time by kernel, the union of
their intervals (the device's busy seconds), and the idle gaps between them,
each named by the innermost host op that was running at its middle.  The
trace file lives in the temporary directory while it is read, then goes.
"""
from __future__ import annotations

import bisect
import json
import os
import re
import tempfile
import time

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
SHORT_GAP_US = 10.0             # gaps shorter than this are summed, not named
SHORT_GAP = "between kernels (under 10 us)"


def short_name(name: str) -> str:
    """A kernel's name without its return type, template and arguments."""
    name = re.sub(r"^void ", "", name)
    depth, out = 0, []
    for ch in name:
        if ch in "<(":
            if depth == 0 and ch == "(":
                break
            depth += 1
        elif ch in ">)":
            depth -= 1
        elif depth == 0:
            out.append(ch)
    return "".join(out).strip()[:96] or name[:96]


class Slice:
    def __init__(self):
        self.prof = None
        self.window_s = 0.0

    def _new(self):
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        return profile(activities=acts)

    def warm(self) -> None:
        """Start and stop a profiler once in set-up, so the slice does not
        pay for the tracer's first start."""
        p = self._new()
        p.start()
        torch.zeros(1, device="cuda" if torch.cuda.is_available() else "cpu").add_(1)
        _sync()
        p.stop()

    def start(self) -> None:
        _sync()
        self.prof = self._new()
        self.prof.start()
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        _sync()
        self.window_s = time.perf_counter() - self.t0
        self.prof.stop()

    def read(self) -> dict:
        """{"spans": [(short name, seconds)], "busy_s", "window_s",
        "device_ops": [[name, s]] (top 10), "idle_gaps": [[host op, s]]
        (top 10 by their summed length)}."""
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        self.prof = None
        dev = [e for e in events if e.get("cat") in DEVICE_CATS and "dur" in e]
        host = [e for e in events if e.get("cat") in HOST_CATS and "dur" in e]
        spans = [(short_name(e["name"]), e["dur"] * 1e-6) for e in dev]
        by_name: dict = {}
        for n, d in spans:
            by_name[n] = by_name.get(n, 0.0) + d
        intervals = sorted((e["ts"], e["ts"] + e["dur"]) for e in dev)
        merged = []
        for lo, hi in intervals:
            if merged and lo <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], hi)
            else:
                merged.append([lo, hi])
        busy = sum(hi - lo for lo, hi in merged) * 1e-6
        gaps: dict = {}
        host.sort(key=lambda e: e["ts"])
        starts = [e["ts"] for e in host]
        for (_, a), (b, _) in zip(merged, merged[1:]):
            if b - a < SHORT_GAP_US:
                gaps[SHORT_GAP] = gaps.get(SHORT_GAP, 0.0) + (b - a) * 1e-6
                continue
            mid = 0.5 * (a + b)
            i = bisect.bisect_right(starts, mid)
            inner = [e for e in host[max(0, i - 4000):i] if e["ts"] + e["dur"] >= mid]
            label = min(inner, key=lambda e: e["dur"])["name"] if inner else "host (no op)"
            gaps[label] = gaps.get(label, 0.0) + (b - a) * 1e-6
        top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]
        return {"spans": spans, "busy_s": busy, "window_s": self.window_s,
                "device_ops": top(by_name), "idle_gaps": top(gaps)}


def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()
