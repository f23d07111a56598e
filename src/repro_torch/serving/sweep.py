"""Fault-tolerant sweep service: the orchestration layer behind the sweeps.

The paper's subject is latency *tolerance* — overlapping long-latency
operations instead of stalling on them — and this module applies the same
discipline to the sweep infrastructure itself.  The original
``benchmarks.orchestrator`` died on its first fault: one crashed pool
worker aborted a whole ``prefill`` with `BrokenProcessPool`, a hung
simulation blocked a sweep forever, and a corrupt cache entry was silently
recomputed with no record.  This layer survives all of them:

* **future-per-job dispatch** — every job is its own future; a broken
  process pool is recycled and only the jobs that were actually in flight
  are re-examined (each suspect is then probed *serially*, so a genuine
  crasher is charged its attempt while innocent bystanders are retried for
  free — the `SweepReport` names exactly the faulty jobs);
* **bounded retries with exponential backoff** — transient failures
  (exceptions, worker crashes, timeouts) are retried up to
  `SweepConfig.max_attempts` times, waiting
  ``backoff_base_s * backoff_factor**(attempt-1)`` (capped at
  ``backoff_max_s``) between attempts;
* **per-job wall-clock timeouts** — a job that exceeds
  `SweepConfig.job_timeout_s` has its pool recycled (the hung worker is
  killed) and is charged a ``timeout`` attempt.  The in-band counterpart is
  the `SimConfig.max_cycles` watchdog (`SweepConfig.watchdog_max_cycles`
  applies it sweep-wide): runaway configs raise a structured
  `repro.sim.SimBudgetExceeded` instead of spinning;
* **a checksummed, content-addressed result store** — cache entries are
  ``{"v", "key", "sha256", "payload"}`` envelopes; truncated, torn,
  wrong-schema, or bit-rotted entries are detected on load, *quarantined*
  under ``simcache/quarantine/`` next to a structured ``*.failure.json``
  record, and recomputed — never silently trusted or silently dropped;
* **graceful degradation** — `SimRunner.prefill` returns a `SweepReport`
  (completed / retried / failed / quarantined, per job) instead of raising,
  so `benchmarks.bench_sim` and `benchmarks.paper_figs` can finish a sweep
  with annotated missing points rather than crashing.

The deterministic chaos harness that exercises all of this lives in
`repro_torch.serving.faults`.

Copy of ``repro.serving.sweep`` for the PyTorch port: the same text, with its
imports of ``repro`` read as ``repro_torch``, except for the names in
`PORT_REWRITES`.  Those run the batch-supported misses through the port's
`repro_torch.sim.batch.run_batch` on the runner's device (the CUDA card
unless the caller passes ``device="cpu"``), with no handler around it: a
whole-batch failure of the engine raises out of `SimRunner.prefill` instead
of quietly finishing the sweep on the host pool.  Store entries are
interchangeable with the reference's: `sim_key` and the on-disk envelope are
the same, and so are the engines' results.
"""
from __future__ import annotations

import heapq
import json
import hashlib
import os
import pathlib
import time
from concurrent.futures import (
    FIRST_COMPLETED, Future, ProcessPoolExecutor, wait,
)
from concurrent.futures.process import BrokenProcessPool
from dataclasses import asdict, dataclass, field, replace

from repro_torch.core.pipeline import PIPELINE_REV
from repro_torch.core.plan_cache import PLAN_REV
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.serving import faults
from repro_torch.sim import SimBudgetExceeded, SimConfig, SimResult, simulate
from repro_torch.sim.analytic import (
    ANALYTIC_REV, CALIB_REV, DEFAULT_CALIBRATION, TIERS, AnalyticResult,
    Calibration, CalibrationError, analytic_supported,
    estimate as analytic_estimate, load_calibration, pareto_frontier,
)
from repro_torch.sim.engine import ENGINE_REV
from repro_torch.sim.gpu import GpuResult, aggregate, per_sm_configs
from repro_torch.workloads import get_workload

ROOT = pathlib.Path(__file__).resolve().parents[3]
SIMCACHE = pathlib.Path(os.environ.get(
    "REPRO_SIMCACHE", ROOT / "experiments" / "paper" / "simcache"))

Job = tuple[str, SimConfig]

# In 'auto' batch mode the vectorized engine only engages once a prefill
# has this many supported misses: below that, graph capture costs more than
# it saves and per-job latency histograms lose their meaning.  Explicit
# opt-in (batch=True or REPRO_SIM_BATCH=1) batches everything it can, on
# either device.  On the card the bar is low.  On the CPU 'auto' never
# batches: the eager PyTorch tick costs milliseconds, so the event-heap
# engine in the process pool is faster at every sweep size.
_MIN_AUTO_BATCH = 8
_MIN_AUTO_BATCH_CPU = float("inf")

# The functions and constants that are not copies of the reference's (the
# copies test compares the rest of this module with the original).
PORT_REWRITES = ("_MIN_AUTO_BATCH_CPU", "_auto_batch_threshold",
                 "_Dispatcher._fresh_pool", "SimRunner.__init__",
                 "SimRunner._prefill_engine", "SimRunner._prefill_batch")


def _auto_batch_threshold(device) -> int | float:
    """Supported-miss count at which 'auto' mode engages the batch engine
    on ``device`` (a ``torch.device``): the low bar on the card, and a bar
    no prefill reaches on the CPU."""
    if device.type == "cpu":
        return _MIN_AUTO_BATCH_CPU
    return _MIN_AUTO_BATCH


def _auto_batch_ok() -> bool:
    """Back-compat shim: 'auto' mode now always consults
    `_auto_batch_threshold` (CPU hosts batch too, at a higher bar)."""
    return True

# Failure/retry classification (FailureRecord.kind):
#   transient - the job raised an ordinary exception (incl. injected faults)
#   crash     - the job's worker process died (BrokenProcessPool)
#   timeout   - the job exceeded SweepConfig.job_timeout_s wall-clock
#   budget    - the simulation raised SimBudgetExceeded (deterministic:
#               never retried, retrying cannot change the outcome)
#   corrupt   - a cache entry failed validation and was quarantined
FAILURE_KINDS = ("transient", "crash", "timeout", "budget", "corrupt")
_RETRIABLE = frozenset({"transient", "crash", "timeout"})

STORE_VERSION = 1


def job_label(job: Job) -> str:
    """Human-stable job identity used in reports and fault-plan matching."""
    name, cfg = job
    return f"{name}/{cfg.design}/seed{cfg.seed}"


def sim_key(workload: str, cfg: SimConfig) -> str:
    """Stable on-disk key for one simulation job.

    The full revision triple is part of the key — ENGINE_REV for the
    engine's counters, PLAN_REV/PIPELINE_REV for the compiler passes that
    shape what the engine simulates — so a behavioral change on *either*
    side makes old cache entries unreachable instead of silently mixing two
    behaviors into one sweep.  ``max_cycles`` is excluded: the watchdog can
    only abort a simulation (raising `SimBudgetExceeded`), never change a
    completed result, so budgeted and unbudgeted runs share entries.
    ``trace`` is excluded for the same reason: the event tracer observes a
    run without changing any counter, so traced and untraced runs share
    entries."""
    cfg_payload = asdict(cfg)
    cfg_payload.pop("max_cycles", None)
    cfg_payload.pop("trace", None)
    payload = json.dumps([[ENGINE_REV, PLAN_REV, PIPELINE_REV],
                          workload, cfg_payload], sort_keys=True)
    return hashlib.sha1(payload.encode()).hexdigest()[:20]


def analytic_sim_key(workload: str, cfg: SimConfig,
                     calib: Calibration) -> str:
    """Stable on-disk key for one *analytical* estimate.

    Deliberately a different namespace from `sim_key`: the payload leads
    with an ``"analytic"`` tag plus `ANALYTIC_REV`/`CALIB_REV` and the
    calibration coefficient fingerprint, so a fast-tier estimate can never
    collide with (or be replayed as) an engine verdict, and re-fitting the
    calibration invalidates exactly the estimates it would change."""
    cfg_payload = asdict(cfg)
    cfg_payload.pop("max_cycles", None)
    cfg_payload.pop("trace", None)
    payload = json.dumps(
        [["analytic", ANALYTIC_REV, CALIB_REV, ENGINE_REV, PLAN_REV,
          PIPELINE_REV], calib.fingerprint(), workload, cfg_payload],
        sort_keys=True)
    return "an" + hashlib.sha1(payload.encode()).hexdigest()[:18]


# Calibration constants live in the result store root under this key so the
# store's quarantine machinery covers a corrupt calibration file exactly
# like a corrupt result entry.
CALIBRATION_KEY = "analytic_calib"

# Hybrid tier: engine-confirm the analytic Pareto frontier plus this many
# best-estimated-cycles points per workload group.
DEFAULT_TOP_K = 3


def sweep_run_id(jobs: list[Job]) -> str:
    """Deterministic run identity for one sweep: the sorted `sim_key` set
    plus the revision triple, hashed to 12 hex chars.

    Two sweeps over the same jobs under the same engine/compiler revisions
    share a ``run_id`` (re-runs of a sweep are the *same* run for artifact
    joining); any change to the job set or the code revisions yields a new
    one.  Stamped on `SweepReport`, on every sweep `FailureRecord`, on
    quarantine ``*.failure.json`` records, and on metrics snapshots, so the
    artifacts of one sweep are joinable."""
    keys = sorted(sim_key(name, cfg) for name, cfg in jobs)
    payload = json.dumps([[ENGINE_REV, PLAN_REV, PIPELINE_REV], keys])
    return hashlib.sha1(payload.encode()).hexdigest()[:12]


def default_processes() -> int:
    env = os.environ.get("REPRO_SIM_PROCS")
    if env:
        return max(1, int(env))
    return max(1, os.cpu_count() or 1)


# --------------------------------------------------------------------------
# Sweep configuration + report

@dataclass(frozen=True)
class SweepConfig:
    """Fault-tolerance knobs for one sweep (see docs/serving.md)."""
    max_attempts: int = 3          # total tries per job (1 = no retry)
    backoff_base_s: float = 0.05   # wait before attempt 2
    backoff_factor: float = 2.0    # growth per further attempt
    backoff_max_s: float = 2.0     # backoff ceiling
    job_timeout_s: float | None = None   # per-job wall clock (None = off)
    watchdog_max_cycles: int = 0   # SimConfig.max_cycles applied sweep-wide
                                   # to jobs that don't set their own


@dataclass
class FailureRecord:
    """One structured failure event (a job's final failure, or a
    quarantined cache entry)."""
    job: str
    workload: str
    design: str
    kind: str                      # one of FAILURE_KINDS
    detail: str = ""
    attempts: int = 0
    key: str = ""
    run_id: str = ""               # sweep identity (sweep_run_id); empty for
                                   # failures outside a prefill sweep

    def to_dict(self) -> dict:
        return asdict(self)


@dataclass
class SweepReport:
    """What happened to every job of one `SimRunner.prefill` call."""
    run_id: str = ""               # deterministic sweep identity (sweep_run_id)
    total: int = 0                 # unique jobs requested
    cached: int = 0                # served from memo/disk before dispatch
    computed: int = 0              # simulated this call
    completed: int = 0             # jobs with a result available at the end
    retried: dict[str, int] = field(default_factory=dict)  # label -> retries
    retry_kinds: dict[str, list[str]] = field(default_factory=dict)
    failed: list[FailureRecord] = field(default_factory=list)
    quarantined: list[FailureRecord] = field(default_factory=list)
    pool_recycles: int = 0
    tmp_files_removed: int = 0
    wall_s: float = 0.0
    tier: str = "engine"           # which tier actually ran ("engine" |
                                   # "analytic" | "hybrid"; a degraded
                                   # analytic/hybrid sweep reports "engine")
    analytic_points: int = 0       # jobs priced by the analytical fast tier
    frontier_confirmed: int = 0    # hybrid: frontier jobs engine-confirmed
    frontier_jobs: list[str] = field(default_factory=list)  # their labels

    @property
    def ok(self) -> bool:
        return not self.failed

    def failed_jobs(self) -> list[str]:
        return [r.job for r in self.failed]

    def to_dict(self) -> dict:
        d = asdict(self)
        d["ok"] = self.ok
        return d


# --------------------------------------------------------------------------
# Content-addressed result store (checksums + quarantine + tmp GC)

class ResultStore:
    """On-disk result store with integrity checking.

    Entries are JSON envelopes ``{"v": 1, "key": ..., "sha256": ...,
    "payload": {...}}`` written atomically (tmp file + rename).  ``load``
    never returns questionable data: any entry that is unreadable,
    truncated, mis-keyed, checksum-mismatched, or schema-invalid is moved
    to ``<root>/quarantine/`` with a ``<key>.failure.json`` record and
    reported as a miss, so the caller recomputes *and* the corruption is
    visible in `SimRunner.stats` / `SweepReport.quarantined`."""

    def __init__(self, root: pathlib.Path) -> None:
        self.root = pathlib.Path(root)
        self.quarantine_dir = self.root / "quarantine"
        self.quarantines: list[FailureRecord] = []
        self.run_id = ""  # current sweep identity; stamped on quarantines
        self.stats = {"hits": 0, "misses": 0, "stores": 0,
                      "quarantined": 0, "tmp_gc": 0}

    def path(self, key: str) -> pathlib.Path:
        return self.root / f"{key}.json"

    # -- write -------------------------------------------------------------
    @staticmethod
    def _digest(payload: dict) -> str:
        canon = json.dumps(payload, sort_keys=True).encode()
        return hashlib.sha256(canon).hexdigest()

    def store(self, key: str, payload: dict, label: str = "") -> None:
        entry = {"v": STORE_VERSION, "key": key,
                 "sha256": self._digest(payload), "payload": payload}
        self.root.mkdir(parents=True, exist_ok=True)
        p = self.path(key)
        tmp = p.with_suffix(f".tmp{os.getpid()}")
        tmp.write_text(json.dumps(entry))
        faults.fault_point("store", label or key, path=tmp)
        tmp.replace(p)  # atomic: concurrent runs race benignly
        self.stats["stores"] += 1

    # -- read --------------------------------------------------------------
    def load(self, key: str, label: str = "") -> dict | None:
        """The validated payload for ``key``, or None (miss/quarantined)."""
        p = self.path(key)
        if not p.exists():
            self.stats["misses"] += 1
            return None
        reason = None
        entry = None
        try:
            entry = json.loads(p.read_text())
        except (ValueError, OSError) as e:
            reason = f"unparseable JSON ({e})"
        if reason is None:
            reason = self._validate(entry, key)
        if reason is not None:
            self.quarantine(key, reason, label=label)
            self.stats["misses"] += 1
            return None
        self.stats["hits"] += 1
        return entry["payload"]

    @classmethod
    def _validate(cls, entry, key: str) -> str | None:
        if not isinstance(entry, dict):
            return f"entry is {type(entry).__name__}, not an envelope"
        missing = {"v", "key", "sha256", "payload"} - entry.keys()
        if missing:
            return f"envelope missing fields {sorted(missing)}"
        if entry["v"] != STORE_VERSION:
            return f"unknown store version {entry['v']!r}"
        if entry["key"] != key:
            return f"entry is keyed {entry['key']!r}, expected {key!r}"
        if not isinstance(entry["payload"], dict):
            return "payload is not an object"
        if cls._digest(entry["payload"]) != entry["sha256"]:
            return "payload checksum mismatch"
        return None

    # -- quarantine --------------------------------------------------------
    def quarantine(self, key: str, reason: str, label: str = "") -> None:
        """Move ``key``'s entry out of the cache and record why."""
        p = self.path(key)
        self.quarantine_dir.mkdir(parents=True, exist_ok=True)
        size = p.stat().st_size if p.exists() else 0
        if p.exists():
            p.replace(self.quarantine_dir / p.name)
        record = {"key": key, "job": label, "reason": reason,
                  "size_bytes": size, "quarantined_at": time.time(),
                  "quarantined_from": str(p), "run_id": self.run_id}
        (self.quarantine_dir / f"{key}.failure.json").write_text(
            json.dumps(record, indent=1))
        workload, _, rest = label.partition("/")
        design, _, _ = rest.partition("/")
        self.quarantines.append(FailureRecord(
            job=label or key, workload=workload, design=design,
            kind="corrupt", detail=reason, key=key, run_id=self.run_id))
        self.stats["quarantined"] += 1

    # -- tmp-file GC -------------------------------------------------------
    def gc_stale_tmp(self, max_age_s: float = 3600.0) -> int:
        """Remove tmp files abandoned by crashed writers.

        Writers publish via ``<key>.tmp<pid>`` + rename; a writer that dies
        mid-write leaks its tmp file forever.  A tmp file is stale when its
        writer pid no longer exists, or (pid unparseable / recycled) when it
        is older than ``max_age_s``.  Called at sweep startup."""
        removed = 0
        if not self.root.is_dir():
            return 0
        now = time.time()
        for tmp in self.root.glob("*.tmp*"):
            pid_s = tmp.suffix[len(".tmp"):]
            stale = False
            if pid_s.isdigit() and int(pid_s) != os.getpid():
                stale = not _pid_alive(int(pid_s))
            if not stale:
                try:
                    stale = now - tmp.stat().st_mtime > max_age_s
                except OSError:
                    continue  # raced with a concurrent publish
            if stale:
                try:
                    tmp.unlink()
                    removed += 1
                except OSError:
                    pass
        self.stats["tmp_gc"] += removed
        return removed


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except (PermissionError, OverflowError):
        return True  # exists (another user's), or out of range: be cautious
    return True


# --------------------------------------------------------------------------
# Pool worker entry point (module-level: must pickle by reference)

def _run_job(job: Job, watchdog_max_cycles: int = 0) -> tuple[str, SimConfig, dict]:
    name, cfg = job
    faults.fault_point("run", job_label(job))
    run_cfg = cfg
    if watchdog_max_cycles and not cfg.max_cycles:
        run_cfg = replace(cfg, max_cycles=watchdog_max_cycles)
    # get_workload resolves lazy suites (e.g. traced kernels) in pool workers
    res = simulate(get_workload(name), run_cfg)
    return name, cfg, asdict(res)


# --------------------------------------------------------------------------
# The dispatcher

@dataclass
class _JobState:
    job: Job
    attempts: int = 0
    retries: list[str] = field(default_factory=list)
    failure: FailureRecord | None = None
    done: bool = False
    enqueued_at: float = 0.0       # when the job (re-)entered the ready heap
    submitted_at: float = 0.0      # when its latest attempt hit the pool


class _Dispatcher:
    """Future-per-job process-pool dispatcher with retry/timeout/recycle."""

    def __init__(self, processes: int, sweep: SweepConfig, on_success,
                 metrics: MetricsRegistry | None = None) -> None:
        self.processes = processes
        self.cfg = sweep
        self.on_success = on_success
        self.metrics = metrics or MetricsRegistry()
        self.pool: ProcessPoolExecutor | None = None
        self.pool_recycles = 0

    # -- telemetry ---------------------------------------------------------
    def _mark_submit(self, st: _JobState) -> None:
        st.submitted_at = time.monotonic()
        self.metrics.histogram(
            "sweep_queue_wait_s",
            "seconds jobs waited between ready and pool submit").observe(
            max(st.submitted_at - st.enqueued_at, 0.0))

    # -- pool lifecycle ----------------------------------------------------
    def _fresh_pool(self) -> ProcessPoolExecutor:
        """The pool, made on first use.  Workers start by ``fork`` (the
        reference's default) unless this process has started CUDA: the CUDA
        runtime's threads and state do not survive a fork, so a runner that
        has run a batch on the card spawns its workers instead."""
        import multiprocessing

        import torch

        if self.pool is None:
            ctx = (multiprocessing.get_context("spawn")
                   if torch.cuda.is_initialized() else None)
            self.pool = ProcessPoolExecutor(max_workers=self.processes,
                                            mp_context=ctx)
        return self.pool

    def _kill_pool(self) -> None:
        """Tear the pool down even if workers are hung or dead."""
        pool = self.pool
        self.pool = None
        if pool is None:
            return
        self.pool_recycles += 1
        procs = list(getattr(pool, "_processes", {}).values())
        try:
            pool.shutdown(wait=False, cancel_futures=True)
        except Exception:
            pass
        for p in procs:
            try:
                p.terminate()
            except Exception:
                pass
        for p in procs:
            try:
                p.join(timeout=5)
            except Exception:
                pass

    # -- bookkeeping -------------------------------------------------------
    def _backoff(self, attempts: int) -> float:
        c = self.cfg
        return min(c.backoff_max_s,
                   c.backoff_base_s * c.backoff_factor ** max(attempts - 1, 0))

    def _charge(self, st: _JobState, kind: str, detail: str) -> bool:
        """Record one failed attempt; True if the job will be retried."""
        st.attempts += 1
        retry = kind in _RETRIABLE and st.attempts < self.cfg.max_attempts
        if retry:
            st.retries.append(kind)
            return True
        name, cfg = st.job
        st.failure = FailureRecord(
            job=job_label(st.job), workload=name, design=cfg.design,
            kind=kind, detail=detail, attempts=st.attempts,
            key=sim_key(name, cfg))
        st.done = True
        return False

    def _classify(self, exc: BaseException) -> tuple[str, str]:
        if isinstance(exc, BrokenProcessPool):
            return "crash", "worker process died (BrokenProcessPool)"
        if isinstance(exc, SimBudgetExceeded):
            return "budget", str(exc)
        return "transient", f"{type(exc).__name__}: {exc}"

    def _succeed(self, st: _JobState, payload: dict) -> None:
        self.metrics.histogram(
            "sweep_job_latency_s",
            "seconds from pool submit to completed simulation").observe(
            max(time.monotonic() - st.submitted_at, 0.0))
        self.on_success(st.job, payload)
        st.done = True

    # -- serial suspect probe ---------------------------------------------
    def _probe(self, st: _JobState, ready, now_seq) -> None:
        """Run one pool-break suspect alone to attribute the crash exactly.

        When a worker dies, every in-flight job fails with
        `BrokenProcessPool` — the culprit is unknown.  Probing each suspect
        serially (one job in flight in a fresh pool) makes the next break
        unambiguous: only the actual crasher is charged a ``crash``
        attempt; innocent bystanders complete here for free."""
        deadline = (time.monotonic() + self.cfg.job_timeout_s
                    if self.cfg.job_timeout_s else None)
        try:
            fut = self._fresh_pool().submit(
                _run_job, st.job, self.cfg.watchdog_max_cycles)
        except BrokenProcessPool:
            self._kill_pool()
            if self._charge(st, "crash", "pool broke on submit"):
                self._requeue(st, ready, now_seq)
            return
        self._mark_submit(st)
        timeout = None if deadline is None else max(
            deadline - time.monotonic(), 0.0)
        done, _ = wait([fut], timeout=timeout)
        if not done:  # the suspect hangs: kill it, charge a timeout
            self._kill_pool()
            if self._charge(st, "timeout",
                            f"exceeded job_timeout_s="
                            f"{self.cfg.job_timeout_s}s (serial probe)"):
                self._requeue(st, ready, now_seq)
            return
        exc = fut.exception()
        if exc is None:
            self._succeed(st, fut.result()[2])
            return
        kind, detail = self._classify(exc)
        if kind == "crash":
            self._kill_pool()
        if self._charge(st, kind, detail):
            self._requeue(st, ready, now_seq)

    def _requeue(self, st: _JobState, ready, now_seq) -> None:
        seq = next(now_seq)
        st.enqueued_at = time.monotonic()
        heapq.heappush(
            ready, (st.enqueued_at + self._backoff(st.attempts), seq, st))

    # -- main loop ---------------------------------------------------------
    def run(self, jobs: list[Job]) -> tuple[list[_JobState], int]:
        t0 = time.monotonic()
        states = [_JobState(job=j, enqueued_at=t0) for j in jobs]
        seq_counter = iter(range(1, 1 << 30))
        ready: list[tuple[float, int, _JobState]] = [
            (0.0, -len(states) + i, st) for i, st in enumerate(states)]
        heapq.heapify(ready)
        inflight: dict[Future, tuple[_JobState, float]] = {}

        try:
            while ready or inflight:
                now = time.monotonic()
                # submit ready jobs, at most one per worker (so a submit
                # time approximates a start time for the timeout clock,
                # and a pool break loses at most `processes` jobs)
                while ready and ready[0][0] <= now \
                        and len(inflight) < self.processes:
                    _, _, st = heapq.heappop(ready)
                    deadline = (now + self.cfg.job_timeout_s
                                if self.cfg.job_timeout_s else float("inf"))
                    try:
                        fut = self._fresh_pool().submit(
                            _run_job, st.job, self.cfg.watchdog_max_cycles)
                    except BrokenProcessPool:
                        self._kill_pool()
                        if self._charge(st, "crash", "pool broke on submit"):
                            self._requeue(st, ready, seq_counter)
                        continue
                    self._mark_submit(st)
                    inflight[fut] = (st, deadline)
                if not inflight:
                    if ready:
                        time.sleep(max(ready[0][0] - time.monotonic(), 0.0))
                    continue

                next_deadline = min(dl for _, dl in inflight.values())
                next_ready = ready[0][0] if ready else float("inf")
                timeout = min(next_deadline, next_ready) - time.monotonic()
                done, _ = wait(
                    inflight,
                    timeout=None if timeout == float("inf")
                    else max(timeout, 0.01),
                    return_when=FIRST_COMPLETED)

                pool_broke = False
                for fut in done:
                    st, _ = inflight.pop(fut)
                    exc = fut.exception()
                    if exc is None:
                        self._succeed(st, fut.result()[2])
                        continue
                    kind, detail = self._classify(exc)
                    if kind == "crash":
                        # suspect: attribution happens in the serial probes
                        pool_broke = True
                        inflight[fut] = (st, float("inf"))
                        continue
                    if self._charge(st, kind, detail):
                        self._requeue(st, ready, seq_counter)

                now = time.monotonic()
                overdue = {fut for fut, (st, dl) in inflight.items()
                           if dl <= now and not fut.done()}
                if pool_broke or overdue:
                    suspects = sorted((st for st, _ in inflight.values()),
                                      key=lambda st: job_label(st.job))
                    timed_out = {id(st) for fut, (st, _) in inflight.items()
                                 if fut in overdue}
                    inflight.clear()
                    self._kill_pool()
                    for st in suspects:
                        if id(st) not in timed_out:
                            continue
                        if self._charge(
                                st, "timeout",
                                f"exceeded job_timeout_s="
                                f"{self.cfg.job_timeout_s}s"):
                            self._requeue(st, ready, seq_counter)
                    for st in suspects:
                        if st.done or id(st) in timed_out:
                            continue
                        if pool_broke:
                            # this job re-executes because a worker died; the
                            # re-run is visible in the report (an uncharged
                            # "crash" retry) whether or not this job was the
                            # culprit — the serial probe below settles blame.
                            st.retries.append("crash")
                            self._probe(st, ready, seq_counter)
                        else:
                            # innocent casualty of a timeout recycle: its
                            # worker was killed through no fault of its own.
                            # Requeue without charging an attempt.
                            self._requeue(st, ready, seq_counter)
        finally:
            if self.pool is not None:
                self.pool.shutdown(wait=True, cancel_futures=True)
                self.pool = None
        return states, self.pool_recycles


# --------------------------------------------------------------------------
# The runner

class SimRunner:
    """Memoizing, disk-backed, fault-tolerant simulation runner."""

    def __init__(self, processes: int | None = None,
                 disk_cache: bool = True,
                 cache_dir: pathlib.Path | None = None,
                 sweep: SweepConfig | None = None,
                 batch: bool | None = None,
                 tier: str = "engine", device="cuda") -> None:
        """``device`` is where the batch engine runs: the CUDA card unless
        the caller passes ``device="cpu"`` (without a card, the default
        raises)."""
        from repro_torch import resolve_device

        if tier not in TIERS:
            raise ValueError(f"unknown tier {tier!r}; expected one of {TIERS}")
        self.device = resolve_device(device)
        self.processes = processes if processes is not None else default_processes()
        self.disk_cache = disk_cache
        self.cache_dir = pathlib.Path(cache_dir) if cache_dir else SIMCACHE
        self.store = ResultStore(self.cache_dir)
        self.sweep_config = sweep or SweepConfig()
        # Batch-engine policy: True/False force it, None defers to the
        # REPRO_SIM_BATCH env var ("1"/"0"), else auto — batch cache-miss
        # sweeps of `_MIN_AUTO_BATCH` or more jobs on the card, never on the
        # CPU (`_auto_batch_threshold`).
        self.batch = batch
        # Default tier for `prefill` (a per-call override wins).  The
        # analytical tier has its own memo + disk keys (`analytic_sim_key`)
        # so estimates can never shadow engine results.
        self.tier = tier
        self._analytic_memo: dict[Job, AnalyticResult] = {}
        self._calibration: Calibration | None = None
        self._calib_degraded = False
        self._calib_failure: FailureRecord | None = None
        self._calib_reported = False
        self._memo: dict[Job, SimResult] = {}
        self.failures: dict[Job, FailureRecord] = {}
        # Operational telemetry (repro.obs.metrics): counters/histograms
        # accumulated across every prefill/sim of this runner's lifetime;
        # snapshot with `metrics_snapshot` (JSON) or `metrics.to_prometheus`.
        self.metrics = MetricsRegistry()
        self.last_run_id = ""
        self.stats = {"memo_hits": 0, "disk_hits": 0, "computed": 0,
                      "batched": 0, "retried": 0, "failed": 0,
                      "quarantined": 0, "pool_recycles": 0, "tmp_gc": 0,
                      "analytic_memo_hits": 0, "analytic_disk_hits": 0,
                      "analytic_computed": 0, "calib_degraded": 0}
        if self.disk_cache:
            # sweep startup garbage-collects tmp files leaked by writers
            # that crashed mid-publish
            self.stats["tmp_gc"] += self.store.gc_stale_tmp()

    # -- cache layers ------------------------------------------------------
    def _disk_path(self, job: Job) -> pathlib.Path:
        return self.store.path(sim_key(*job))

    def _disk_load(self, job: Job) -> SimResult | None:
        if not self.disk_cache:
            return None
        key = sim_key(*job)
        label = job_label(job)
        payload = self.store.load(key, label=label)
        if payload is None:
            self._sync_quarantines()
            return None
        try:
            return SimResult(**payload)
        except TypeError as e:
            # checksummed envelope, but the payload is not a SimResult
            # (wrong-schema entry): quarantine, recompute
            self.store.quarantine(key, f"payload schema mismatch ({e})",
                                  label=label)
            self._sync_quarantines()
            return None

    def _disk_store(self, job: Job, res: SimResult) -> None:
        if not self.disk_cache:
            return
        self.store.store(sim_key(*job), asdict(res), label=job_label(job))

    def _sync_quarantines(self) -> None:
        self.stats["quarantined"] = self.store.stats["quarantined"]

    def _lookup(self, job: Job) -> SimResult | None:
        res = self._memo.get(job)
        if res is not None:
            self.stats["memo_hits"] += 1
            self.metrics.counter("sweep_cache_hits_total",
                                 "memo/disk cache hits").inc()
            return res
        res = self._disk_load(job)
        if res is not None:
            self.stats["disk_hits"] += 1
            self.metrics.counter("sweep_cache_hits_total",
                                 "memo/disk cache hits").inc()
            self._memo[job] = res
        else:
            self.metrics.counter("sweep_cache_misses_total",
                                 "memo/disk cache misses").inc()
        return res

    # -- analytical fast tier ----------------------------------------------
    def calibration(self) -> Calibration:
        """The calibration the analytical tier prices with.

        Loads ``<cache_dir>/analytic_calib.json`` once per runner; a missing
        file falls back to the built-in fit, a *corrupt* file is quarantined
        through the ResultStore machinery and flips the runner into degraded
        mode (analytic/hybrid prefills run engine-only from then on)."""
        if self._calibration is not None:
            return self._calibration
        path = self.store.path(CALIBRATION_KEY)
        try:
            calib = load_calibration(path) if self.disk_cache else None
        except CalibrationError as e:
            self.store.quarantine(CALIBRATION_KEY, f"calibration: {e}",
                                  label=CALIBRATION_KEY)
            self._sync_quarantines()
            self._calib_degraded = True
            self.stats["calib_degraded"] = 1
            self._calib_failure = self.store.quarantines[-1]
            calib = None
        self._calibration = calib or DEFAULT_CALIBRATION
        return self._calibration

    def _analytic_key(self, job: Job) -> str:
        return analytic_sim_key(*job, self.calibration())

    def estimate(self, workload, cfg: SimConfig) -> AnalyticResult:
        """One analytical estimate through its own memo/disk cache.

        Estimates are keyed by `analytic_sim_key` (tagged with
        `ANALYTIC_REV`/`CALIB_REV` and the calibration fingerprint), so they
        can never collide with engine `sim_key` entries."""
        name = workload if isinstance(workload, str) else workload.name
        job = (name, cfg)
        res = self._analytic_memo.get(job)
        if res is not None:
            self.stats["analytic_memo_hits"] += 1
            return res
        key = self._analytic_key(job)
        if self.disk_cache:
            payload = self.store.load(key, label="analytic:" + job_label(job))
            if payload is not None:
                payload.pop("ipc", None)   # derived, re-exposed as a property
                try:
                    res = AnalyticResult(**payload)
                except TypeError as e:
                    self.store.quarantine(
                        key, f"analytic payload schema mismatch ({e})",
                        label="analytic:" + job_label(job))
                    self._sync_quarantines()
                    res = None
                else:
                    self.stats["analytic_disk_hits"] += 1
                    self._analytic_memo[job] = res
                    return res
        res = analytic_estimate(get_workload(name), cfg,
                                calib=self.calibration())
        self.stats["analytic_computed"] += 1
        self._analytic_memo[job] = res
        if self.disk_cache:
            self.store.store(key, res.to_dict(),
                             label="analytic:" + job_label(job))
        return res

    # -- public API --------------------------------------------------------
    def sim(self, workload, cfg: SimConfig) -> SimResult:
        """One simulation through the memo/disk cache (inline on miss)."""
        name = workload if isinstance(workload, str) else workload.name
        job = (name, cfg)
        res = self._lookup(job)
        if res is None:
            self.stats["computed"] += 1
            _, _, payload = _run_job(job, self.sweep_config.watchdog_max_cycles)
            res = SimResult(**payload)
            self._memo[job] = res
            self._disk_store(job, res)
        return res

    def try_sim(self, workload, cfg: SimConfig) -> SimResult | None:
        """`sim`, degraded: None for jobs that already failed this sweep or
        fail inline — the caller annotates the missing point and goes on."""
        name = workload if isinstance(workload, str) else workload.name
        job = (name, cfg)
        if job in self.failures:
            return None
        try:
            return self.sim(name, cfg)
        except Exception as e:  # noqa: BLE001 - degrade, don't crash sweeps
            self.failures[job] = FailureRecord(
                job=job_label(job), workload=name, design=cfg.design,
                kind="budget" if isinstance(e, SimBudgetExceeded)
                else "transient",
                detail=f"{type(e).__name__}: {e}", attempts=1,
                key=sim_key(name, cfg))
            self.stats["failed"] = len(self.failures)
            return None

    def sim_gpu(self, workload, cfg: SimConfig) -> GpuResult:
        """One whole-GPU simulation: the per-SM jobs go through the memo /
        disk cache (and the pool, if several SMs miss), then aggregate."""
        name = workload if isinstance(workload, str) else workload.name
        jobs = [(name, c) for c in per_sm_configs(cfg)]
        self.prefill(jobs, tier="engine")   # aggregation needs real results
        return aggregate(cfg, [self.sim(*job) for job in jobs], name)

    def prefill_gpu(self, jobs: list[Job]) -> SweepReport:
        """Expand whole-GPU jobs into their per-SM jobs and prefill those."""
        return self.prefill([(name, c) for name, cfg in jobs
                             for c in per_sm_configs(cfg)], tier="engine")

    def prefill(self, jobs: list[Job], tier: str | None = None,
                top_k: int = DEFAULT_TOP_K) -> SweepReport:
        """Execute a sweep at the requested tier (default: the runner's).

        * ``"engine"`` — classic path: every cache-missing job is
          cycle-accurately simulated across the process pool.
        * ``"analytic"`` — every supported job is priced by the closed-form
          model in `repro.sim.analytic` (microseconds/point, own cache
          keys); unsupported jobs fall through to the engine.
        * ``"hybrid"`` — analytic screening pass, then the per-workload
          Pareto frontier (est. cycles × est. MRF accesses) plus the
          ``top_k`` best-cycle points are *confirmed* by the engine, so
          every frontier verdict is a real `SimResult`.

        A corrupt calibration file degrades analytic/hybrid to engine-only
        (the quarantine is attached to the report).  Never raises on job
        failure: check ``report.ok``."""
        tier = tier or self.tier
        if tier not in TIERS:
            raise ValueError(f"unknown tier {tier!r}; expected one of {TIERS}")
        if tier != "engine":
            self.calibration()          # may flip the degraded flag
            if self._calib_degraded:
                report = self._prefill_engine(jobs)
                report.tier = "engine"
                if not self._calib_reported and self._calib_failure:
                    report.quarantined.insert(0, self._calib_failure)
                    self._calib_reported = True
                return report
        if tier == "analytic":
            return self._prefill_analytic(jobs)
        if tier == "hybrid":
            return self._prefill_hybrid(jobs, top_k=top_k)
        return self._prefill_engine(jobs)

    def _prefill_engine(self, jobs: list[Job]) -> SweepReport:
        """Execute all cache-missing jobs across the process pool.

        Never raises on job failure: faults are retried/recorded per
        `SweepConfig` and the returned `SweepReport` says exactly what
        completed, what was retried, what was quarantined, and what is
        missing.  Callers that need hard failure check ``report.ok``."""
        t0 = time.time()
        q_before = self.store.stats["quarantined"]
        run_id = sweep_run_id(jobs)
        self.last_run_id = self.store.run_id = run_id
        misses: list[Job] = []
        seen: set[Job] = set()
        for job in jobs:
            if job in seen:
                continue
            seen.add(job)
            if self._lookup(job) is None:
                misses.append(job)
        report = SweepReport(run_id=run_id, total=len(seen),
                             cached=len(seen) - len(misses))
        batch_states: list[_JobState] = []
        if misses:
            mode = self._batch_mode()
            if mode in ("on", "auto"):
                misses, batch_states = self._prefill_batch(
                    misses,
                    min_jobs=(_auto_batch_threshold(self.device)
                              if mode == "auto" else 1))
            if misses:
                if self.processes <= 1 or len(misses) == 1:
                    self._prefill_inline(misses, report)
                else:
                    self._prefill_pool(misses, report)
        # the classic backends reset report.computed before recording their
        # own outcomes, so batch outcomes are folded in afterwards
        self._record_outcomes(batch_states, report)
        report.quarantined = list(
            self.store.quarantines[q_before:])
        report.completed = report.cached + report.computed
        report.tmp_files_removed = self.stats["tmp_gc"]
        report.wall_s = round(time.time() - t0, 3)
        self._sync_quarantines()
        self.stats["retried"] += sum(report.retried.values())
        self.stats["failed"] = len(self.failures)
        self.stats["pool_recycles"] += report.pool_recycles
        m = self.metrics
        m.counter("sweep_jobs_total", "unique jobs requested").inc(report.total)
        m.counter("sweep_jobs_cached",
                  "jobs served from memo/disk cache").inc(report.cached)
        m.counter("sweep_jobs_computed",
                  "jobs simulated").inc(report.computed)
        m.counter("sweep_jobs_failed",
                  "jobs with no result after retries").inc(len(report.failed))
        m.counter("sweep_retries_total",
                  "retried job attempts").inc(sum(report.retried.values()))
        m.counter("sweep_pool_recycles_total",
                  "process-pool teardowns").inc(report.pool_recycles)
        m.counter("sweep_quarantined_total",
                  "cache entries quarantined").inc(len(report.quarantined))
        return report

    def _split_supported(self, jobs: list[Job]) -> tuple[list[Job], list[Job]]:
        """Dedup, then split into (analytic-supported, engine-only) jobs."""
        seen: set[Job] = set()
        supported: list[Job] = []
        engine_only: list[Job] = []
        for job in jobs:
            if job in seen:
                continue
            seen.add(job)
            (supported if analytic_supported(job[1]) else engine_only).append(job)
        return supported, engine_only

    @staticmethod
    def _merge_nested(report: SweepReport, nested: SweepReport,
                      count_jobs: bool = True) -> None:
        """Fold an engine sub-sweep's outcomes into a tiered report.

        ``count_jobs=False`` merges only the engine *activity* (cache hits,
        compute, retries, faults) — used for hybrid confirmation sweeps,
        whose jobs were already counted once as analytic estimates."""
        if count_jobs:
            report.total += nested.total
            report.completed += nested.completed
        report.cached += nested.cached
        report.computed += nested.computed
        for label, n in nested.retried.items():
            report.retried[label] = report.retried.get(label, 0) + n
        report.retry_kinds.update(nested.retry_kinds)
        report.failed.extend(nested.failed)
        report.quarantined.extend(nested.quarantined)
        report.pool_recycles += nested.pool_recycles

    def _estimate_jobs(self, jobs: list[Job],
                       report: SweepReport) -> dict[Job, AnalyticResult]:
        """Price `jobs` analytically; failures degrade per-job, like
        `try_sim` — a structured FailureRecord, not a crashed sweep."""
        q_before = len(self.store.quarantines)
        out: dict[Job, AnalyticResult] = {}
        for job in jobs:
            try:
                out[job] = self.estimate(*job)
            except Exception as e:  # noqa: BLE001 - degrade, don't crash
                report.failed.append(FailureRecord(
                    job=job_label(job), workload=job[0], design=job[1].design,
                    kind="transient",
                    detail=f"analytic {type(e).__name__}: {e}", attempts=1,
                    key=self._analytic_key(job)))
        report.quarantined.extend(self.store.quarantines[q_before:])
        report.analytic_points = len(out)
        report.completed += len(out)
        return out

    def _prefill_analytic(self, jobs: list[Job]) -> SweepReport:
        """Screen every supported job with the closed-form model; jobs the
        model cannot price (multi-SM, unknown designs) go to the engine."""
        t0 = time.time()
        supported, engine_only = self._split_supported(jobs)
        run_id = sweep_run_id(jobs)
        self.last_run_id = self.store.run_id = run_id
        report = SweepReport(run_id=run_id, total=len(supported),
                             tier="analytic")
        self._estimate_jobs(supported, report)
        if engine_only:
            self._merge_nested(report, self._prefill_engine(engine_only))
        self.last_run_id = self.store.run_id = run_id
        report.wall_s = round(time.time() - t0, 3)
        return report

    def _prefill_hybrid(self, jobs: list[Job],
                        top_k: int = DEFAULT_TOP_K) -> SweepReport:
        """Analytic screening, engine confirmation of the interesting points.

        Per workload, the engine confirms the analytic Pareto frontier over
        (estimated cycles, estimated MRF accesses) plus the `top_k` lowest
        estimated-cycle points; everything else keeps its fast estimate.
        Confirmed results come from `_prefill_engine`, i.e. the ordinary
        cache/retry machinery — `sim()` replays them bit-identically."""
        t0 = time.time()
        supported, engine_only = self._split_supported(jobs)
        run_id = sweep_run_id(jobs)
        self.last_run_id = self.store.run_id = run_id
        report = SweepReport(run_id=run_id, total=len(supported),
                             tier="hybrid")
        ests = self._estimate_jobs(supported, report)
        by_workload: dict[str, list[Job]] = {}
        for job in ests:
            by_workload.setdefault(job[0], []).append(job)
        confirm: list[Job] = []
        for group in by_workload.values():
            pts = [(float(ests[j].cycles), float(ests[j].est_mrf_accesses))
                   for j in group]
            picked = set(pareto_frontier(pts))
            for i in sorted(range(len(group)), key=lambda i: pts[i][0])[:top_k]:
                picked.add(i)
            confirm.extend(group[i] for i in sorted(picked))
        if confirm:
            nested = self._prefill_engine(confirm)
            self._merge_nested(report, nested, count_jobs=False)
            report.frontier_jobs = sorted(job_label(j) for j in confirm)
            report.frontier_confirmed = sum(
                1 for j in confirm if self._lookup(j) is not None)
        if engine_only:
            self._merge_nested(report, self._prefill_engine(engine_only))
        self.last_run_id = self.store.run_id = run_id
        report.wall_s = round(time.time() - t0, 3)
        return report

    def metrics_snapshot(self) -> dict:
        """JSON-ready metrics snapshot, stamped with the last sweep's
        ``run_id`` and the runner's layered-cache stats."""
        return self.metrics.snapshot(run_id=self.last_run_id,
                                     runner_stats=dict(self.stats))

    # -- dispatch backends -------------------------------------------------
    def _batch_mode(self) -> str:
        """'on' | 'auto' | 'off'.  Fault-injection plans force 'off': the
        chaos harness targets the per-job classic paths (fault points,
        retries, pool recycles), which the vectorized engine bypasses.

        'auto' engages the batch engine above a device-dependent
        supported-miss threshold (`_auto_batch_threshold`): a low bar on the
        card, and never on the CPU, where the eager tick is slower than the
        event-heap engine."""
        if faults.active_plan() is not None:
            return "off"
        if self.batch is True:
            return "on"
        if self.batch is False:
            return "off"
        env = os.environ.get("REPRO_SIM_BATCH", "")
        if env == "1":
            return "on"
        if env == "0":
            return "off"
        return "auto"

    def _prefill_batch(self, misses: list[Job],
                       min_jobs: int = 1) -> tuple[list[Job], list[_JobState]]:
        """Run the batch-supported misses through the vectorized engine on
        the runner's device.

        Returns (jobs left for the classic backends, completed job states).
        Per-job budget outcomes (`SimBudgetExceeded` instances) are recorded
        as ``budget`` failures, as in the reference.  This is the port's one
        change of behaviour on a failure: the reference catches any whole-batch failure
        and finishes the sweep on the classic backends, which hid its batch
        engine's failure to start (every job then ran on the host, with
        nothing in the report).  Here a whole-batch failure of the engine
        raises out of `prefill`: a sweep that was asked to run on the card
        either runs there or fails."""
        from repro_torch.sim.batch import batch_supported, run_batch

        supported = [j for j in misses if batch_supported(j[1])]
        if len(supported) < min_jobs:
            return misses, []
        rest = [j for j in misses if not batch_supported(j[1])]
        wd = self.sweep_config.watchdog_max_cycles
        t0 = time.monotonic()
        run_jobs = []
        for name, cfg in supported:
            run_cfg = cfg
            if wd and not cfg.max_cycles:
                run_cfg = replace(cfg, max_cycles=wd)
            run_jobs.append((get_workload(name), run_cfg))
        outcomes = run_batch(run_jobs, device=self.device)
        per_job = max(time.monotonic() - t0, 0.0) / len(supported)
        states: list[_JobState] = []
        for job, out in zip(supported, outcomes):
            st = _JobState(job=job, attempts=1, done=True)
            if isinstance(out, SimBudgetExceeded):
                name, cfg = job
                # deterministic, like the classic budget outcome: no retry
                st.failure = FailureRecord(
                    job=job_label(job), workload=name, design=cfg.design,
                    kind="budget", detail=f"SimBudgetExceeded: {out}",
                    attempts=1, key=sim_key(name, cfg))
            else:
                self._memo[job] = out
                self._disk_store(job, out)
                self.stats["computed"] += 1
                self.stats["batched"] += 1
                self.metrics.histogram(
                    "sweep_job_latency_s",
                    "seconds from pool submit to completed simulation"
                ).observe(per_job)
                self.metrics.histogram(
                    "sweep_queue_wait_s",
                    "seconds jobs waited between ready and pool submit"
                ).observe(0.0)
            states.append(st)
        return rest, states

    def _record_outcomes(self, states, report: SweepReport) -> None:
        for st in states:
            if st.retries:
                report.retried[job_label(st.job)] = len(st.retries)
                report.retry_kinds[job_label(st.job)] = list(st.retries)
            if st.failure is not None:
                st.failure.run_id = report.run_id
                report.failed.append(st.failure)
                self.failures[st.job] = st.failure
            else:
                report.computed += 1

    def _prefill_inline(self, misses: list[Job], report: SweepReport) -> None:
        """Serial fallback (processes <= 1): retries transient/budget-style
        exceptions in-process; crash/hang protection needs the pool path."""
        cfgd = self.sweep_config
        states = []
        for job in misses:
            st = _JobState(job=job, enqueued_at=time.monotonic())
            states.append(st)
            while not st.done:
                st.submitted_at = time.monotonic()
                self.metrics.histogram(
                    "sweep_queue_wait_s",
                    "seconds jobs waited between ready and pool submit"
                ).observe(max(st.submitted_at - st.enqueued_at, 0.0))
                try:
                    _, _, payload = _run_job(job, cfgd.watchdog_max_cycles)
                except Exception as e:  # noqa: BLE001 - classified below
                    kind = ("budget" if isinstance(e, SimBudgetExceeded)
                            else "transient")
                    retry = kind in _RETRIABLE \
                        and st.attempts + 1 < cfgd.max_attempts
                    st.attempts += 1
                    if retry:
                        st.retries.append(kind)
                        time.sleep(min(cfgd.backoff_max_s,
                                       cfgd.backoff_base_s
                                       * cfgd.backoff_factor
                                       ** (st.attempts - 1)))
                        continue
                    name, cfg = job
                    st.failure = FailureRecord(
                        job=job_label(job), workload=name, design=cfg.design,
                        kind=kind, detail=f"{type(e).__name__}: {e}",
                        attempts=st.attempts, key=sim_key(name, cfg))
                    st.done = True
                else:
                    self.metrics.histogram(
                        "sweep_job_latency_s",
                        "seconds from pool submit to completed simulation"
                    ).observe(max(time.monotonic() - st.submitted_at, 0.0))
                    res = SimResult(**payload)
                    self._memo[job] = res
                    self._disk_store(job, res)
                    self.stats["computed"] += 1
                    st.done = True
        report.computed = 0
        self._record_outcomes(states, report)

    def _prefill_pool(self, misses: list[Job], report: SweepReport) -> None:
        def on_success(job: Job, payload: dict) -> None:
            res = SimResult(**payload)
            self._memo[job] = res
            self._disk_store(job, res)
            self.stats["computed"] += 1

        dispatcher = _Dispatcher(self.processes, self.sweep_config, on_success,
                                 metrics=self.metrics)
        states, recycles = dispatcher.run(misses)
        report.pool_recycles = recycles
        report.computed = 0
        self._record_outcomes(states, report)


_DEFAULT: SimRunner | None = None


def default_runner() -> SimRunner:
    """Process-wide shared runner (memo survives across figure functions)."""
    global _DEFAULT
    if _DEFAULT is None:
        _DEFAULT = SimRunner()
    return _DEFAULT
