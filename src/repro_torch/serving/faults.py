"""Deterministic fault injection for the sweep service (chaos harness).

The sweep dispatcher (`repro.serving.sweep`) is fault-*tolerant* code; this
module makes its failure paths *testable* without flaky timing tricks: a
fault plan designates specific jobs (by label substring) and makes them
raise, kill their worker process, hang, or corrupt their cache entry — all
deterministically, so the chaos suite (`tests/test_sweep_faults.py`) and
the CI ``bench_sim --chaos-smoke`` step can assert exact `SweepReport`
contents.

Plans cross the process-pool boundary through the environment: set
``REPRO_FAULT_PLAN`` to the path of a JSON plan file before the pool is
created and every worker consults it at each fault point.  With the
variable unset (production), `fault_point` is a near-free no-op.

Plan format::

    {"faults": [
        {"match": "kmeans/BL/seed3", "stage": "run",   "action": "raise",
         "times": 2},
        {"match": "bfs/LTRF/seed0",  "stage": "run",   "action": "exit"},
        {"match": "nw/BL/seed1",     "stage": "run",   "action": "hang",
         "seconds": 60},
        {"match": "srad/LTRF/seed2", "stage": "store", "action": "corrupt"}
    ]}

* ``match``   — substring of the job label (``workload/design/seed<N>``)
  or of the store key, depending on the stage.
* ``stage``   — ``run`` (inside the worker, before simulating) or
  ``store`` (in the writer, after the cache tmp file is written but
  before it is atomically published — a crashed-mid-write torn entry).
* ``action``  — ``raise`` (a transient `InjectedFault`), ``exit``
  (``os._exit``: the worker dies, the pool breaks), ``hang``
  (sleep ``seconds``, default 3600 — exercises the wall-clock timeout),
  ``corrupt`` (truncate the just-written file to half its bytes).
* ``times``   — fire at most N times per plan file (default: unlimited).
  Attempt counting is cross-process: each firing atomically claims a
  marker file under ``<plan>.state/`` via ``O_CREAT|O_EXCL``, so retried
  jobs in fresh pool workers see a consistent countdown.

Copy of ``repro.serving.faults`` for the PyTorch port: the same text, with its
imports of ``repro`` read as ``repro_torch``.
"""
from __future__ import annotations

import json
import os
import pathlib
import time
from dataclasses import dataclass, field

ENV_PLAN = "REPRO_FAULT_PLAN"

STAGES = ("run", "store")
ACTIONS = ("raise", "exit", "hang", "corrupt")

EXIT_CODE = 17      # the injected worker-crash exit status
HANG_S = 3600.0     # default hang duration (killed by the pool recycler)


class InjectedFault(RuntimeError):
    """A deliberately injected transient job failure."""


@dataclass
class FaultSpec:
    match: str
    action: str
    stage: str = "run"
    times: int | None = None     # None = unlimited
    seconds: float = HANG_S
    fault_id: str = ""

    def __post_init__(self) -> None:
        if self.stage not in STAGES:
            raise ValueError(f"unknown fault stage {self.stage!r}")
        if self.action not in ACTIONS:
            raise ValueError(f"unknown fault action {self.action!r}")


@dataclass
class FaultPlan:
    """A parsed fault plan + its cross-process firing-state directory."""
    specs: list[FaultSpec] = field(default_factory=list)
    state_dir: pathlib.Path | None = None

    @classmethod
    def parse(cls, doc: dict, state_dir: pathlib.Path | None) -> "FaultPlan":
        specs = []
        for i, raw in enumerate(doc.get("faults", ())):
            raw = dict(raw)
            raw.setdefault("fault_id", f"f{i}")
            specs.append(FaultSpec(**raw))
        return cls(specs=specs, state_dir=state_dir)

    def _claim(self, spec: FaultSpec) -> bool:
        """Atomically claim one firing of ``spec`` (False once exhausted)."""
        if spec.times is None:
            return True
        if self.state_dir is None:
            return False
        self.state_dir.mkdir(parents=True, exist_ok=True)
        for n in range(spec.times):
            marker = self.state_dir / f"{spec.fault_id}.hit{n}"
            try:
                os.close(os.open(marker, os.O_CREAT | os.O_EXCL | os.O_WRONLY))
                return True
            except FileExistsError:
                continue  # this firing already happened (possibly elsewhere)
        return False

    def fire(self, stage: str, label: str, path=None) -> None:
        for spec in self.specs:
            if spec.stage != stage or spec.match not in label:
                continue
            if not self._claim(spec):
                continue
            if spec.action == "raise":
                raise InjectedFault(
                    f"injected fault at {stage}: {label}")
            if spec.action == "exit":
                os._exit(EXIT_CODE)
            if spec.action == "hang":
                time.sleep(spec.seconds)
            elif spec.action == "corrupt" and path is not None:
                _truncate(pathlib.Path(path))


def _truncate(path: pathlib.Path) -> None:
    """Tear the file in half — a crashed-mid-write cache entry."""
    data = path.read_bytes()
    path.write_bytes(data[: len(data) // 2])


# Plan cache: keyed by (path, mtime_ns) so tests rewriting the plan file in
# place are picked up, while the common no-plan case stays one getenv call.
_CACHE: dict[tuple[str, int], FaultPlan] = {}


def active_plan() -> FaultPlan | None:
    """The plan named by ``REPRO_FAULT_PLAN``, or None (the default)."""
    path = os.environ.get(ENV_PLAN)
    if not path:
        return None
    p = pathlib.Path(path)
    try:
        key = (path, p.stat().st_mtime_ns)
    except OSError:
        return None
    plan = _CACHE.get(key)
    if plan is None:
        plan = FaultPlan.parse(json.loads(p.read_text()),
                               state_dir=p.with_suffix(p.suffix + ".state"))
        _CACHE.clear()  # one live plan at a time; drop stale mtimes
        _CACHE[key] = plan
    return plan


def fault_point(stage: str, label: str, path=None) -> None:
    """Consult the active fault plan at a named execution point.

    No-op unless ``REPRO_FAULT_PLAN`` is set.  ``path`` is the file a
    ``store``-stage ``corrupt`` action mutilates."""
    plan = active_plan()
    if plan is not None:
        plan.fire(stage, label, path=path)
