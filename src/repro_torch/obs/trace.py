"""Per-warp event tracing with Chrome trace-event export.

`TraceSink` collects simulator events (instruction issue, interval
prefetches, warp swap-in/swap-out, bank conflicts, per-cycle stall
attribution) and serializes them as Chrome trace-event JSON — the format
chrome://tracing and https://ui.perfetto.dev load directly.  Mapping:

* one **process** per SM (``pid`` = SM index),
* one **track** (thread) per warp (``tid`` = warp id) plus a synthetic
  ``scheduler`` track (`SCHED_TID`) carrying the zero-issue stall spans
  labelled with their `repro.obs.attribution` category,
* simulated cycles are reported as microseconds (``ts``/``dur``), so one
  trace second = one megacycle and Perfetto's zoom/measure tools read
  directly in cycles.

Tracing is strictly opt-in (``SimConfig.trace``): the engine's hooks are
guarded by a single ``is not None`` test and the disabled path is
fuzz-pinned bit-identical to the frozen golden oracle, which never traces.

Use `trace_simulation` for the one-call version, or pass a trace-enabled
config to ``repro.sim.engine.Simulator`` and read its ``trace`` attribute.

Copy of ``repro.obs.trace`` for the PyTorch port: the same text, with its
imports of ``repro`` read as ``repro_torch``.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib

# tid of the synthetic per-SM scheduler track (far above any real warp id).
SCHED_TID = 1_000_000


class TraceSink:
    """Accumulates trace events for one simulated SM.

    Methods are deliberately tiny — they run inside the simulator's hot
    loop when tracing is enabled — and record plain dicts in the Chrome
    trace-event schema (ph "X" complete spans, ph "i" instants).
    """

    def __init__(self, sm: int = 0) -> None:
        self.sm = sm
        self.events: list[dict] = []
        self._tids: set[int] = set()

    # ------------------------------------------------------------------ record
    def span(self, tid: int, name: str, start: int, dur: int,
             args: dict | None = None) -> None:
        ev = {"ph": "X", "pid": self.sm, "tid": tid, "name": name,
              "ts": start, "dur": max(dur, 1)}
        if args:
            ev["args"] = args
        self.events.append(ev)
        self._tids.add(tid)

    def instant(self, tid: int, name: str, ts: int,
                args: dict | None = None) -> None:
        ev = {"ph": "i", "pid": self.sm, "tid": tid, "name": name,
              "ts": ts, "s": "t"}
        if args:
            ev["args"] = args
        self.events.append(ev)
        self._tids.add(tid)

    # ------------------------------------------------------------------ export
    def to_chrome(self) -> dict:
        """The complete Chrome trace-event document (metadata + events)."""
        meta = [{"ph": "M", "pid": self.sm, "tid": tid,
                 "name": "thread_name",
                 "args": {"name": "scheduler" if tid == SCHED_TID
                          else f"warp {tid}"}}
                for tid in sorted(self._tids)]
        meta.append({"ph": "M", "pid": self.sm, "name": "process_name",
                     "args": {"name": f"SM {self.sm}"}})
        return {"traceEvents": meta + self.events,
                "displayTimeUnit": "ms",
                "otherData": {"time_unit": "1 ts = 1 simulated cycle"}}

    def write(self, path) -> pathlib.Path:
        path = pathlib.Path(path)
        path.write_text(json.dumps(self.to_chrome()))
        return path


def trace_simulation(workload, cfg):
    """Run the fast engine with tracing on; returns ``(SimResult, TraceSink)``.

    ``cfg.trace`` is forced on (via ``dataclasses.replace``) so callers can
    hand in any existing sweep config unchanged.  Import is deferred:
    ``repro.sim.engine`` imports this module for `TraceSink`, so the
    top-level dependency must stay one-directional.
    """
    from repro_torch.sim.engine import Simulator

    if not cfg.trace:
        cfg = dataclasses.replace(cfg, trace=True)
    sim = Simulator(cfg, workload)
    result = sim.run()
    return result, sim.trace
