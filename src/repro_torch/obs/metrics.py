"""Process-local metrics registry: counters, gauges, histograms.

Backs the sweep service's operational telemetry (`repro.serving.sweep`):
job latency, queue wait, cache hits/misses, retries, pool recycles,
quarantines.  Two export formats:

* `MetricsRegistry.snapshot()` — a plain-JSON dict (folded into
  ``BENCH_sim.json`` meta and the ``run.py --strict`` report);
* `MetricsRegistry.to_prometheus()` — Prometheus text exposition
  (counters/gauges as samples, histograms as summaries with
  ``quantile=\"0.5|0.95|0.99\"`` plus ``_sum``/``_count``), so a scrape
  endpoint or textfile collector can ship the same numbers.

Histograms keep raw samples and compute **nearest-rank** percentiles at
snapshot time — exact, deterministic, and cheap at sweep scale (thousands
of jobs, not millions).  No locking: the sweep dispatcher records results
from its single collector thread; one registry belongs to one runner.

Copy of ``repro.obs.metrics`` for the PyTorch port: the same text, with its
imports of ``repro`` read as ``repro_torch``.
"""
from __future__ import annotations

import dataclasses
import json
import math
import pathlib

# Canonical sweep-service metric names (docs/observability.md documents every
# one of these; tests/test_docs.py enforces it).  The registry itself is
# generic — these are the names `SimRunner` wires up.
SWEEP_METRICS = (
    "sweep_jobs_total",
    "sweep_jobs_cached",
    "sweep_jobs_computed",
    "sweep_jobs_failed",
    "sweep_retries_total",
    "sweep_pool_recycles_total",
    "sweep_quarantined_total",
    "sweep_cache_hits_total",
    "sweep_cache_misses_total",
    "sweep_job_latency_s",
    "sweep_queue_wait_s",
)

_QUANTILES = (("p50", 0.50), ("p95", 0.95), ("p99", 0.99))


@dataclasses.dataclass
class Counter:
    """Monotonically increasing count (resets only with its registry)."""
    name: str
    help: str = ""
    value: float = 0

    def inc(self, n: float = 1) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name} cannot decrease (n={n})")
        self.value += n


@dataclasses.dataclass
class Gauge:
    """A value that can go up and down (e.g. pool size, inflight jobs)."""
    name: str
    help: str = ""
    value: float = 0

    def set(self, v: float) -> None:
        self.value = v

    def inc(self, n: float = 1) -> None:
        self.value += n

    def dec(self, n: float = 1) -> None:
        self.value -= n


class Histogram:
    """Raw-sample distribution with exact nearest-rank percentiles."""

    def __init__(self, name: str, help: str = "") -> None:
        self.name = name
        self.help = help
        self.samples: list[float] = []

    def observe(self, v: float) -> None:
        self.samples.append(v)

    @staticmethod
    def _nearest_rank(sorted_samples: list[float], q: float) -> float:
        # nearest-rank: ceil(q*N)-th smallest sample (1-indexed).  The old
        # int-scaling trick (-(-int(q*n*100) // 100)) truncated q*n*100 to an
        # int *before* ceiling, so e.g. (q=0.95, n=20) -> 19 instead of 20.
        n = len(sorted_samples)
        rank = max(1, math.ceil(q * n))
        return sorted_samples[min(rank, n) - 1]

    def summary(self) -> dict:
        if not self.samples:
            return {"count": 0, "sum": 0.0}
        s = sorted(self.samples)
        out = {"count": len(s), "sum": sum(s), "min": s[0], "max": s[-1]}
        for label, q in _QUANTILES:
            out[label] = self._nearest_rank(s, q)
        return out


class MetricsRegistry:
    """Get-or-create registry; one per sweep runner."""

    def __init__(self) -> None:
        self._metrics: dict[str, Counter | Gauge | Histogram] = {}

    def _get(self, name: str, kind, help: str):
        m = self._metrics.get(name)
        if m is None:
            m = kind(name, help)
            self._metrics[name] = m
        elif not isinstance(m, kind):
            raise TypeError(f"metric {name!r} already registered as "
                            f"{type(m).__name__}, not {kind.__name__}")
        return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(name, Counter, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(name, Gauge, help)

    def histogram(self, name: str, help: str = "") -> Histogram:
        return self._get(name, Histogram, help)

    # ------------------------------------------------------------------ export
    def snapshot(self, **meta) -> dict:
        """JSON-ready dict: scalar metrics as numbers, histograms as their
        summary dicts; ``meta`` keys (e.g. ``run_id=...``) ride along."""
        out: dict = dict(meta)
        for name in sorted(self._metrics):
            m = self._metrics[name]
            out[name] = m.summary() if isinstance(m, Histogram) else m.value

        return out

    def to_prometheus(self, **labels) -> str:
        """Prometheus text exposition (histograms as summaries)."""
        lbl = ""
        if labels:
            lbl = "{" + ",".join(f'{k}="{v}"' for k, v in sorted(labels.items())) + "}"
        lines: list[str] = []
        for name in sorted(self._metrics):
            m = self._metrics[name]
            if m.help:
                lines.append(f"# HELP {name} {m.help}")
            if isinstance(m, Histogram):
                lines.append(f"# TYPE {name} summary")
                s = m.summary()
                for label, q in _QUANTILES:
                    if label in s:
                        ql = (lbl[:-1] + "," if lbl else "{") \
                            + f'quantile="{q}"' + "}"
                        lines.append(f"{name}{ql} {s[label]:g}")
                lines.append(f"{name}_sum{lbl} {s['sum']:g}")
                lines.append(f"{name}_count{lbl} {s['count']}")
            else:
                kind = "counter" if isinstance(m, Counter) else "gauge"
                lines.append(f"# TYPE {name} {kind}")
                lines.append(f"{name}{lbl} {m.value:g}")
        return "\n".join(lines) + "\n"

    def write_snapshot(self, path, **meta) -> pathlib.Path:
        path = pathlib.Path(path)
        path.write_text(json.dumps(self.snapshot(**meta), indent=2,
                                   sort_keys=True))
        return path
