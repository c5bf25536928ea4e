"""Fault-tolerant model serving (counterpart of
lightgbm_tpu/runtime/serving.py; `task=serve` / `ServingRuntime`).

The long-lived server over the port's device predictor
(models/device_predictor.py: power-of-two row buckets, each captured as a
CUDA graph), the stage watchdog and the publish / subscribe contract:

* **Admission and backpressure.**  A bounded queue with per-request
  deadlines; overload sheds at admission with a machine-readable,
  retryable rejection (`ServeRejected.to_dict()`), and a request whose
  deadline expires before its batch forms is shed the same way.
  Priority classes shed the lowest class first (per-class reservations),
  per-model `quotas` bound a tenant's share, and an optional
  `policy.AutoscaleShedPolicy` retunes the gather window and flips
  load-shed mode from the queue depth.
* **Micro-batching.**  Concurrent requests for one model coalesce (bounded
  rows, bounded gather window) into one device predict.
* **One thread owns the card.**  Every predictor call (the prewarms, the
  manifest prewarm, the breaker's recovery probe and the batches) runs on
  the single executor thread, so no capture ever begins while another
  thread replays: a capture on one thread is invalidated by work another
  thread issues on the legacy default stream.  A dispatch that blows its
  deadline is abandoned (its thread may be wedged) and a fresh executor
  takes over; the predictor's own lock keeps the abandoned call and the
  new executor out of each other's buffers, and the breaker does not
  probe the device while an abandoned call still runs.
* **The breaker stays loud.**  A failed or hung device batch
  (`LGBM_TPU_FAULT=die_at_predict|slow_predict` stand in for it) trips the
  circuit: the batch is re-served from the exact f64 host predictor, the
  response says ``served_by="host"``, the batch counts in
  ``stats()["batches_host"]`` and ``lgbm_serve_batches_total{path="host"}``
  and a ``serving_degradation`` event enters the trail; later batches stay
  on the host until a probe succeeds after the cooldown.  A prewarm that
  fails is counted (``stats()["prewarm_failures"]``); at start-up only
  the injected faults are tolerated there, so a device program that does
  not build or launch raises out of `start()`.
* **Zero-drop hot swap.**  A `ModelSubscriber` poller picks up new
  generations from a publish dir and swaps the model between batches: an
  in-flight batch finishes on the generation it started with, and every
  response names the generation that produced it.  Several models ride
  one queue (multi-tenancy, with bounded residency); a canary fraction
  routes new generations through `policy.CanaryPolicy` with automatic
  rollback.

The device path is `Booster.predict(..., device=True)` on the card, or on
the CPU when the parameters say ``device_type=cpu``; nothing here lands
on the CPU on its own (`resilience.resolve_backend` raises on a failed
probe).  `Booster` is imported lazily.
"""
from __future__ import annotations

import collections
import json
import os
import socketserver
import sys
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from . import policy as policy_mod
from . import graph_obs, publish, resilience, telemetry, tracing, warmup
from ..utils.log import Log

__all__ = ["ServingRuntime", "ServingServer", "ServeRejected",
           "ServeResult", "retry_delay"]

#: the least deadline of a prewarm dispatch (a capture's eager warm-up
#: run and capture can take longer than a steady batch)
PREWARM_DEADLINE_S = 120.0


class ServeRejected(RuntimeError):
    """A request the server explicitly refused (admission control,
    deadline, shutdown).  Machine-readable via `to_dict()`; `retryable`
    tells the client whether backing off and retrying can succeed."""

    def __init__(self, reason: str, retryable: bool = True,
                 detail: str = "", queue_depth: Optional[int] = None,
                 priority: Optional[int] = None,
                 retry_after_s: Optional[float] = None):
        super().__init__("request rejected (%s%s)%s"
                         % (reason, ", retryable" if retryable else "",
                            ": " + detail if detail else ""))
        self.reason = reason
        self.retryable = bool(retryable)
        self.detail = detail
        self.queue_depth = queue_depth
        # the priority class the shed applies to: every shed
        # is machine-readable WITH its class, so a client and the sim's
        # per-class shed-rate ledger never have to guess
        self.priority = priority
        # Retry-After-style backoff hint in seconds: rides
        # both the JSON rejection dict and the binary rejection frame;
        # `predict()` and the wire client raise their jittered delay to
        # it, so the server can slow a thundering herd without a new
        # round trip.  None = no hint.
        self.retry_after_s = retry_after_s

    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {"error": "rejected", "reason": self.reason,
                             "retryable": self.retryable,
                             "wallclock": resilience.wallclock()}
        if self.detail:
            d["detail"] = self.detail
        if self.queue_depth is not None:
            d["queue_depth"] = self.queue_depth
        if self.priority is not None:
            d["priority"] = self.priority
        if self.retry_after_s is not None:
            d["retry_after_s"] = self.retry_after_s
        return d


def retry_delay(base_delay: float, hint: Optional[float]) -> float:
    """The client-side sleep for one retryable rejection: the jittered
    backoff schedule's delay, raised to the server's Retry-After hint
    when the rejection carries a larger one (never lowered — the jitter
    is what breaks retry synchronization)."""
    return max(float(base_delay), float(hint or 0.0))


class ServeResult:
    """One completed prediction: the values, the generation that
    produced them, and how they were served."""

    __slots__ = ("values", "generation", "model_id", "served_by",
                 "latency_s", "compiled", "stages", "model_trace")

    def __init__(self, values: np.ndarray, generation: int, model_id: str,
                 served_by: str, latency_s: float, compiled: bool = False,
                 stages: Optional[Dict[str, float]] = None,
                 model_trace: Optional[str] = None):
        self.values = values
        self.generation = generation
        self.model_id = model_id
        self.served_by = served_by          # "device" | "host"
        self.latency_s = latency_s
        # True when this request's batch captured a predictor program
        # (the program ledger's builds at the predictor's site moved
        # during the dispatch): first-batch latency outliers become
        # attributable
        self.compiled = compiled
        # per-request latency decomposition: queue_wait /
        # batch_gather / device / drain seconds, measured on the SAME
        # clock as latency_s so the stage sum is pinned against the
        # client-observed number (tests + the sim artifact gate on it)
        self.stages = stages or {}
        # traceparent of the training cycle that produced the serving
        # generation (from the publish meta footer) — the response's
        # backlink into the trainer's timeline
        self.model_trace = model_trace


class _Request:
    """Queued unit of work; doubles as the caller's future."""

    __slots__ = ("model_id", "X", "n_rows", "deadline", "enqueued",
                 "done", "result", "rejection", "error", "priority",
                 "label", "trace", "t_batched")

    def __init__(self, model_id: str, X: np.ndarray, deadline: float,
                 priority: int = 0, label: Optional[np.ndarray] = None,
                 trace: Optional[Tuple[str, str]] = None):
        self.model_id = model_id
        self.X = X
        self.n_rows = int(X.shape[0])
        self.deadline = deadline            # absolute time.monotonic()
        self.priority = int(priority)
        # optional ground-truth outcome the client already knows (the
        # online feedback loop): per-row labels feed the canary policy's
        # live error signal — never the prediction itself
        self.label = label
        # parsed client traceparent: requests that carry one
        # get their queue/gather/device/drain stages recorded as trace
        # events under the CLIENT's trace id
        self.trace = trace
        self.t_batched: Optional[float] = None
        self.enqueued = time.monotonic()
        self.done = threading.Event()
        self.result: Optional[ServeResult] = None
        self.rejection: Optional[ServeRejected] = None
        self.error: Optional[BaseException] = None

    def wait(self, timeout: Optional[float] = None) -> ServeResult:
        """Block for the outcome.  Raises the rejection/error the server
        recorded; a wait past `timeout` raises a retryable rejection
        (the server itself bounds every path, so this is belt-and-
        braces for a stopped runtime)."""
        if not self.done.wait(timeout):
            raise ServeRejected("result_timeout", retryable=True,
                                detail="no outcome within %.1fs"
                                % (timeout or -1.0))
        if self.rejection is not None:
            raise self.rejection
        if self.error is not None:
            raise self.error
        assert self.result is not None
        return self.result


class _ModelEntry:
    """One loaded generation of one model lineage.  Immutable after
    construction — the swap replaces the whole entry, so an in-flight
    batch holding the old reference finishes on a consistent model."""

    __slots__ = ("model_id", "generation", "booster", "meta", "loaded_at")

    def __init__(self, model_id: str, generation: int, booster, meta):
        self.model_id = model_id
        self.generation = generation
        self.booster = booster
        self.meta = dict(meta or {})
        self.loaded_at = time.monotonic()

    @property
    def num_features(self) -> int:
        return self.booster.num_feature()


class _Job:
    """One device-predict dispatch handed to the executor thread."""

    __slots__ = ("fn", "done", "values", "error", "abandoned")

    def __init__(self, fn: Callable[[], np.ndarray]):
        self.fn = fn
        self.done = threading.Event()
        self.values: Optional[np.ndarray] = None
        self.error: Optional[BaseException] = None
        self.abandoned = False


class _DeviceExecutor(threading.Thread):
    """Single dedicated thread that owns device predict dispatches.  The
    batcher waits on each job with a deadline; a job that blows it is
    marked abandoned and a FRESH executor takes over — this thread may
    be wedged inside a hung dispatch, and a wedged thread can only be
    left behind, never joined."""

    def __init__(self, index: int):
        super().__init__(name="serve-device-%d" % index, daemon=True)
        self.jobs: "collections.deque[Optional[_Job]]" = collections.deque()
        self._ready = threading.Event()
        self._stop = False

    def submit(self, job: Optional[_Job]) -> None:
        self.jobs.append(job)
        self._ready.set()

    def retire(self) -> None:
        """Ask the thread to exit after its current job (it may be
        wedged inside that job forever — that is fine, it is daemon)."""
        self._stop = True
        self._ready.set()

    def run(self) -> None:
        while True:
            if not self.jobs:
                if self._stop:
                    return
                self._ready.wait(0.1)
                self._ready.clear()
                continue
            job = self.jobs.popleft()
            if job is None:
                return
            try:
                job.values = job.fn()
            except BaseException as e:      # noqa: BLE001 — ferried out
                job.error = e
            job.done.set()
            # drop the reference before waiting: the job closure captures
            # the batch matrix, which may be a zero-copy view of a wire
            # receive buffer or a mapped SHM segment awaiting unmap
            job = None
            if self._stop:
                return


class ServingRuntime:
    """The long-lived serving loop.  Use as a context manager or call
    `start()` / `stop()` explicitly; `submit()` / `predict()` are the
    request surface (thread-safe, any number of client threads)."""

    def __init__(self,
                 publish_dir: Optional[str] = None,
                 model_file: Optional[str] = None,
                 model_str: Optional[str] = None,
                 models: Optional[Dict[str, str]] = None,
                 params: Optional[Dict[str, Any]] = None,
                 raw_score: bool = False,
                 response_dtype: Optional[str] = None,
                 max_queue: int = 256,
                 max_batch_rows: int = 4096,
                 batch_window_s: float = 0.002,
                 default_deadline_s: float = 10.0,
                 predict_deadline_s: float = 30.0,
                 poll_interval_s: float = 0.2,
                 breaker_cooldown_s: float = 2.0,
                 probe_platform_on_start: bool = False,
                 report_path: Optional[str] = None,
                 metrics_port: Optional[int] = None,
                 priority_levels: int = 3,
                 quotas: Optional[Dict[str, float]] = None,
                 max_resident: int = 0,
                 policy=None,
                 canary_fraction: float = 0.0,
                 canary_policy=None,
                 prewarm_manifest: bool = True,
                 export_manifest: bool = True,
                 log=Log):
        """`publish_dir` subscribes the default model to a publish
        directory; `models` maps model_id -> publish_dir for
        multi-tenancy; `model_file`/`model_str` pin a static default
        model (no poller).  At least one source is required.

        admission knobs: `priority_levels` sets the number of
        priority classes (0 = highest); under queue pressure lower
        classes shed first through per-class queue reservations (class p
        may only occupy ``max_queue * (P - p) / P`` slots).  `quotas`
        maps model_id -> max fraction of the queue that tenant's
        requests may hold (rejection `quota_exceeded`, retryable) so one
        hot tenant cannot starve the rest.  `policy` is an
        `runtime.policy.AutoscaleShedPolicy`: a background thread feeds
        it the queue-depth fraction; its decisions retune
        `batch_window_s` and flip load-shed mode for the lowest class
        (rejection `load_shed`, retryable).  A ``"*"`` key in `quotas`
        is the default per-tenant share for every model id without an
        explicit entry — the knob that makes quota-fair admission
        tractable across hundreds of registered tenants.

        model-zoo residency: `max_resident` > 0 bounds how many
        registered models hold a LOADED entry at once.  Admission for a
        registered-but-paged-out tenant marks it *wanted*; its requests
        answer with the retryable ``no_model`` rejection until the
        poller pages it in, evicting the least-recently-used resident
        model first.  A model with queued or in-flight requests is NEVER
        evicted (pinned in tests); when every resident model is busy the
        page-in defers to the next poll instead of overshooting the
        bound.  Evicting exports the victim's per-tenant warm manifest
        (best effort), so the next page-in — here or on any replica —
        prewarms from the manifest instead of compiling cold.  The
        default 0 keeps every registered model resident (legacy).

        canary knobs: `canary_fraction` > 0 turns newly
        published generations into CANARIES — the poller loads them
        beside the incumbent instead of swapping, the batcher routes
        that fraction of batches to them (deterministic interleave at
        the existing swap seam), and a `runtime.policy.CanaryPolicy`
        (`canary_policy`, default-constructed when omitted) judges
        canary vs incumbent error/latency with hysteresis.  Sustained
        degradation ROLLS BACK: the canary is dropped, the publish dir
        gets a durable ROLLBACK marker condemning the generation
        fleet-wide, and the subscriber pins the incumbent until a fresh
        candidate lands.  Sustained health PROMOTES the canary to
        incumbent.  At the default `canary_fraction=0` every new
        generation swaps in directly — byte-identical to the pre-canary
        behavior.

        warm-start knobs: with `prewarm_manifest` (default on)
        a fresh runtime reads the newest ``warmup.json`` shape manifest
        from each publish dir and captures the row buckets it names
        BEFORE ``/healthz`` reports ready and before admission opens; a
        torn/stale/absent/shape-mismatched manifest degrades to the
        legacy smallest-bucket prewarm (counted in
        ``lgbm_warmup_total{outcome}``) — it never blocks serving.
        `export_manifest` (default on) publishes the buckets THIS
        process actually captured back to the publish dir at stop, so
        the next replica starts warm."""
        self.log = log
        self._params = dict(params or {})
        self._raw_score = bool(raw_score)
        # response_dtype="float32" serves f32 values — the
        # device fetch moves half the bytes (D2H shrinks 2×) and the
        # result equals the f64 answer .astype(float32) exactly (the
        # device computes in f32; the fetch dtype only changes the
        # upcast).  Default None keeps the legacy f64 surface.
        if response_dtype not in (None, "float32", "float64"):
            raise ValueError("response_dtype must be None, 'float32' or "
                             "'float64', got %r" % (response_dtype,))
        self._out_dtype = (np.float32 if response_dtype == "float32"
                           else None)
        self.max_queue = int(max_queue)
        self.max_batch_rows = int(max_batch_rows)
        self.batch_window_s = float(batch_window_s)
        self.default_deadline_s = float(default_deadline_s)
        self.predict_deadline_s = float(predict_deadline_s)
        self.poll_interval_s = float(poll_interval_s)
        self.breaker_cooldown_s = float(breaker_cooldown_s)
        self.probe_platform_on_start = bool(probe_platform_on_start)
        self.priority_levels = max(int(priority_levels), 1)
        self.quotas: Dict[str, float] = dict(quotas or {})
        self.policy = policy
        self.canary_fraction = float(canary_fraction)
        if not 0.0 <= self.canary_fraction <= 1.0:
            raise ValueError("canary_fraction must be in [0, 1], got %r"
                             % canary_fraction)
        self._canary_policy_proto = canary_policy
        self._canary_policies: Dict[str, policy_mod.CanaryPolicy] = {}
        self._canary: Dict[str, _ModelEntry] = {}
        self._canary_seq: "collections.Counter[str]" = collections.Counter()
        self.rollback_events: List[Dict[str, Any]] = []

        self._dirs: Dict[str, str] = dict(models or {})
        if publish_dir:
            self._dirs.setdefault("default", publish_dir)
        self._static: Optional[str] = None
        if model_str is not None:
            self._static = model_str
        elif model_file is not None:
            with open(model_file) as fh:
                self._static = fh.read()
        if not self._dirs and self._static is None:
            raise ValueError("ServingRuntime needs publish_dir=, models= "
                             "or a model_file/model_str")

        self._subs = {mid: publish.ModelSubscriber(d, attempts=1)
                      for mid, d in self._dirs.items()}
        self._entries: Dict[str, _ModelEntry] = {}
        self._entries_lock = threading.Lock()

        self.prewarm_manifest = bool(prewarm_manifest)
        self.export_manifest = bool(export_manifest)
        self.prewarm_events: List[Dict[str, Any]] = []
        #: readiness gate: set once start() has finished the
        #: prewarm pass — /healthz reports 503 and submit() sheds with
        #: reason "warming" until then, so a replica never admits a
        #: request it would answer with a cold compile
        self._ready = threading.Event()

        self._queue: "collections.deque[_Request]" = collections.deque()
        # batch-gather arena: preallocated per-bucket request
        # buffers keyed (row-bucket, cols, dtype) that multi-request
        # batches are gathered into instead of np.concatenate.  Only the
        # single batcher thread writes it, and a batch is fully consumed
        # (dispatched + drained) before the next one is gathered, so one
        # buffer per bucket serves the runtime's whole lifetime — zero
        # steady-state gather allocation.
        self._arena: Dict[Tuple[int, int, str], np.ndarray] = {}
        self._cond = threading.Condition()
        self._stopped = False
        self._started = False
        # per-tenant queued-request counts (the quota denominator) and
        # the policy-driven load-shed latch; both live under self._cond
        self._queued_by_model: "collections.Counter[str]" = \
            collections.Counter()
        self._shed_low = False
        # bounded model-zoo residency (0 = unbounded/legacy):
        # LRU stamps per tenant (touched at admission), demand marks for
        # paged-out tenants, and in-flight counts (the never-evict pin's
        # second leg — queued is the first)
        self.max_resident = max(int(max_resident or 0), 0)
        self._lru: Dict[str, float] = {}
        self._wanted: Dict[str, float] = {}
        self._inflight_by_model: "collections.Counter[str]" = \
            collections.Counter()
        self.residency_events: List[Dict[str, Any]] = []

        # serving stage trail: the stage watchdog in thread mode with a
        # bounded flight recorder (one stage per batch — unbounded
        # growth would be its own reliability bug)
        self.wd = resilience.Watchdog(
            0, hard=False, label="serve stage", use_alarm=False,
            keep_last=256, stream=sys.stderr,
            report_path=report_path
            or os.environ.get("LGBM_TPU_SERVE_REPORT"))
        self._wd_lock = threading.Lock()

        self._breaker = {"state": "closed", "open_until": 0.0}
        self.degradation_events: List[Dict[str, Any]] = []
        self.recovery_events: List[Dict[str, Any]] = []
        self.start_degradation: Optional[Dict[str, Any]] = None

        self._stats_lock = threading.Lock()
        self._stats: Dict[str, Any] = {
            "admitted": 0, "completed": 0,
            "rejected": collections.Counter(),
            "rows_served": 0, "batches_device": 0, "batches_host": 0,
            "swaps": 0, "degradations": 0, "recoveries": 0,
            "canary_batches": 0, "rollbacks": 0, "promotes": 0,
            "prewarm_failures": 0, "abandoned": 0,
        }

        self._executor_idx = 0
        self._executor: Optional[_DeviceExecutor] = None
        self._executor_lock = threading.Lock()
        # device jobs abandoned at their deadline whose thread may still
        # be inside the predictor (the breaker waits for them to end)
        self._abandoned: List[_Job] = []
        self._batcher: Optional[threading.Thread] = None
        self._poller: Optional[threading.Thread] = None
        self._policy_thread: Optional[threading.Thread] = None

        # live Prometheus endpoint: metrics_port=0 picks an
        # ephemeral port, exposed via `metrics_port` after start()
        self._metrics_port_req = metrics_port
        self.metrics_server: Optional[telemetry.MetricsServer] = None

    # -- lifecycle -----------------------------------------------------------
    def __enter__(self) -> "ServingRuntime":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def start(self) -> "ServingRuntime":
        if self._started:
            return self
        self._started = True
        # the kernel build cache: honor $LGBM_TPU_COMPILE_CACHE before
        # the first model loads
        warmup.maybe_enable_from_env()
        if self._metrics_port_req is not None:
            # /healthz answers 503 "warming" until the prewarm pass
            # below finishes — prewarm-before-admit, visible to LBs
            self.metrics_server = telemetry.start_http_server(
                self._metrics_port_req,
                health_provider=self._ready.is_set)
            self.log.info("serve: /metrics on port %d",
                          self.metrics_server.port)
        with self._wd_lock:
            self.wd("start")
        try:
            self._bring_up()
        except BaseException as e:
            # nothing half-started stays behind: the executor retires,
            # the metrics endpoint closes, the trail records why
            if isinstance(e, resilience.BackendUnavailable):
                self.start_degradation = e.event
            with self._wd_lock:
                if self.start_degradation is not None:
                    self.wd.annotate("degradation_event",
                                     self.start_degradation)
                self.wd.done()
            if self._executor is not None:
                self._executor.retire()
                self._executor = None
            if self.metrics_server is not None:
                self.metrics_server.stop()
                self.metrics_server = None
            self._started = False
            raise
        self._ready.set()
        self._batcher = threading.Thread(target=self._batcher_loop,
                                         name="serve-batcher", daemon=True)
        self._batcher.start()
        if self._subs:
            self._poller = threading.Thread(target=self._poller_loop,
                                            name="serve-poller", daemon=True)
            self._poller.start()
        if self.policy is not None:
            self._policy_thread = threading.Thread(
                target=self._policy_loop, name="serve-policy", daemon=True)
            self._policy_thread.start()
        with self._wd_lock:
            self.wd("serving", seconds=0)
        return self

    def _bring_up(self) -> None:
        """start()'s steps before readiness: the probe, the executor, the
        first generations and their prewarm."""
        if self.probe_platform_on_start:
            # the device is probed before any model loads: a card that
            # does not come up raises BackendUnavailable with the
            # degradation event (never a quiet fall to the CPU)
            resilience.resolve_backend(self._requested_platform())
        # the one thread that runs the predictor, from the first prewarm
        self._executor = self._spawn_executor()
        if self._static is not None:
            self._swap_in("default", self._static, generation=0, meta={})
        # default first: under bounded residency the lineage model must
        # win a residency slot before any zoo tenant claims one
        for mid in sorted(self._dirs, key=lambda m: (m != "default", m)):
            self._poll_model(mid)       # best effort; poller keeps trying
        # prewarm-before-admit: precompile the shape buckets
        # the lineage's manifest names BEFORE readiness opens.  Bounded
        # and guarded — a bad manifest degrades to the smallest-bucket
        # prewarm _swap_in already did, never blocks serving.
        self._prewarm_start()
        # fleet fault seam: `die_at_spawn:K` kills the K-th
        # spawned replica exactly here — prewarm paid, /healthz never
        # ready — so a FleetController's relaunch path is exercised on
        # the most expensive death window
        resilience.maybe_die_at_spawn()

    def stop(self) -> None:
        """Clean shutdown: queued requests are rejected explicitly
        (reason `shutdown`, non-retryable against THIS endpoint), never
        silently dropped."""
        with self._cond:
            if self._stopped:
                return
            self._stopped = True
            pending = list(self._queue)
            self._queue.clear()
            self._cond.notify_all()
        self._queued_by_model.clear()
        for req in pending:
            req.rejection = ServeRejected("shutdown", retryable=False,
                                          priority=req.priority)
            req.done.set()
            self._count_rejection("shutdown", priority=req.priority)
        # publish this process's observed shape buckets so the NEXT
        # replica of the lineage starts warm; best effort —
        # shutdown must never fail on a read-only publish dir
        if self.export_manifest:
            for mid in list(self._dirs):
                try:
                    self.export_warmup_manifest(mid)
                except Exception as e:    # noqa: BLE001 — best effort
                    self.log.warning("serve: warmup-manifest export for "
                                     "%s failed: %s", mid, e)
        if self._executor is not None:
            self._executor.submit(None)
        for t in (self._batcher, self._poller, self._policy_thread):
            if t is not None:
                t.join(timeout=5)
        with self._wd_lock:
            self.wd.done()
        if self.metrics_server is not None:
            self.metrics_server.stop()
            self.metrics_server = None

    # -- model lifecycle -----------------------------------------------------
    def _swap_in(self, model_id: str, model_text: str, generation: int,
                 meta: Dict[str, Any]) -> None:
        """Load + prewarm a generation, then swap it in atomically.  The
        swap is a dict assignment under a lock taken only for the
        assignment: batches capture their entry BEFORE predicting, so an
        in-flight batch finishes on the generation it started with."""
        from ..basic import Booster
        t0 = time.monotonic()
        c0 = graph_obs.total_compiles(warmup.PREDICT_SITE)
        bst = Booster(params=dict(self._params), model_str=model_text)
        entry = _ModelEntry(model_id, generation, bst, meta)
        # prewarm the smallest bucket's program so the first live batch
        # does not pay the capture; a failure is counted, and after
        # start-up the swap goes on (the host path serves)
        self._prewarm(entry, 1, "prewarm of %s gen %d"
                      % (model_id, generation))
        # the prewarm's captures go through the ledger, so a slow swap
        # names its cause (a reused bucket prewarms as a cache hit)
        prewarm_compiles = graph_obs.total_compiles(
            warmup.PREDICT_SITE) - c0
        graph_obs.cache_event("serving.prewarm",
                              "compile" if prewarm_compiles else "hit",
                              max(prewarm_compiles, 1))
        with self._entries_lock:
            fresh = model_id not in self._entries
            self._entries[model_id] = entry
            resident = len(self._entries)
        with self._stats_lock:
            self._stats["swaps"] += 1
        telemetry.counter("lgbm_serve_swaps_total").inc()
        telemetry.gauge("lgbm_serve_resident_models").set(resident)
        if self.max_resident > 0 and fresh:
            # a zoo tenant just paged in: clear its demand mark, stamp
            # its LRU slot, and prewarm from its per-tenant manifest so
            # the first live request doesn't pay the bucket compiles
            self._wanted.pop(model_id, None)
            self._lru.setdefault(model_id, time.monotonic())
            telemetry.counter("lgbm_serve_residency_events_total").inc(
                event="page_in")
            self.residency_events.append({
                "event": "page_in", "model": model_id,
                "generation": generation, "resident": resident,
                "wallclock": resilience.wallclock()})
            if self.prewarm_manifest and self._ready.is_set():
                pub_dir = self._dirs.get(model_id)
                try:
                    sec, _ = (warmup.read_manifest(pub_dir, "serving")
                              if pub_dir else (None, "static"))
                    if sec is not None and warmup.classify_serving_section(
                            sec, num_features=entry.num_features,
                            newest_generation=generation) == "ok":
                        self._prewarm_buckets(entry, sec["row_buckets"])
                except Exception as e:  # noqa: BLE001 — never block page-in
                    self.log.warning("serve: page-in prewarm of %s failed:"
                                     " %s", model_id, e)
        # sink end of the publish→subscriber flow arrow: the
        # flow id re-derives from the SAME meta fields the publisher
        # used, so the merged timeline links this swap back to the
        # training cycle that produced the generation
        tracing.flow_end(
            "model swap gen=%d" % generation,
            tracing.flow_id(meta.get("trace") or "no-trace", generation),
            model=model_id, generation=generation,
            producer_trace=meta.get("trace"))
        with self._wd_lock:
            self.wd.annotate("last_swap", {
                "model": model_id, "generation": generation,
                "load_s": round(time.monotonic() - t0, 4),
                "prewarm_compiles": prewarm_compiles,
                "wallclock": resilience.wallclock()})
        self.log.info("serve: %s now at generation %d (loaded in %.3fs)",
                      model_id, generation, time.monotonic() - t0)

    def _poll_model(self, model_id: str) -> None:
        sub = self._subs.get(model_id)
        if sub is None:
            return
        if not self._residency_admit(model_id):
            return
        rec = sub.resolve_once()
        if rec is None:
            return
        cur = self._entries.get(model_id)
        if cur is not None and cur.generation == rec.generation:
            return
        if self.canary_fraction <= 0 or cur is None:
            # canary disabled (or nothing to compare against yet): the
            # direct swap
            self._swap_in(model_id, rec.model_text, rec.generation,
                          rec.meta)
            return
        can = self._canary.get(model_id)
        if can is not None and can.generation == rec.generation:
            return
        self._canary_in(model_id, rec)

    # -- bounded model-zoo residency ------------------------------
    def _residency_admit(self, model_id: str) -> bool:
        """Gate a (re)load of `model_id` against the residency bound.
        Resident models always pass (generation swaps replace in place,
        no net growth).  A paged-out tenant passes only when it is
        WANTED (a request touched it since the last poll — the default
        lineage model is always wanted) AND a slot is free or an idle
        LRU victim can give one up."""
        if self.max_resident <= 0:
            return True
        with self._entries_lock:
            if model_id in self._entries:
                return True
            room = len(self._entries) < self.max_resident
        if model_id != "default" and model_id not in self._wanted:
            return False
        if room:
            return True
        return self._evict_lru(model_id)

    def _evict_lru(self, incoming: str) -> bool:
        """Evict the least-recently-used resident model to make room for
        `incoming`.  The never-evict invariant: a model with queued OR
        in-flight requests is not a candidate — its clients have been
        admitted and must complete on a loaded entry.  When every
        resident model is busy, the page-in DEFERS (returns False)
        rather than overshooting the bound; the poller retries next
        cycle.  The victim's per-tenant warm manifest exports first
        (best effort) so its next page-in starts warm."""
        with self._cond:
            busy = {m for m, n in self._queued_by_model.items() if n > 0}
            busy |= {m for m, n in self._inflight_by_model.items()
                     if n > 0}
        with self._entries_lock:
            candidates = [m for m in self._entries
                          if m != incoming and m not in busy]
        if not candidates:
            telemetry.counter("lgbm_serve_residency_events_total").inc(
                event="defer")
            self.residency_events.append({
                "event": "defer", "model": incoming,
                "wallclock": resilience.wallclock()})
            return False
        victim = min(candidates, key=lambda m: self._lru.get(m, 0.0))
        if self.export_manifest:
            try:
                self.export_warmup_manifest(victim)
            except Exception as e:          # noqa: BLE001 — best effort
                self.log.warning("serve: eviction manifest export for %s "
                                 "failed: %s", victim, e)
        with self._entries_lock:
            self._entries.pop(victim, None)
            resident = len(self._entries)
        self._canary.pop(victim, None)
        self._lru.pop(victim, None)
        telemetry.counter("lgbm_serve_residency_events_total").inc(
            event="evict")
        telemetry.gauge("lgbm_serve_resident_models").set(resident)
        event = {"event": "evict", "model": victim, "for": incoming,
                 "resident": resident,
                 "wallclock": resilience.wallclock()}
        self.residency_events.append(event)
        with self._wd_lock:
            self.wd.annotate("residency_evict", event)
        self.log.info("serve: evicted %s (LRU) to page in %s (%d/%d "
                      "resident)", victim, incoming, resident,
                      self.max_resident)
        return True

    # -- warm start: manifest prewarm + manifest export ----------
    def _prewarm_start(self) -> None:
        """Read each publish dir's ``warmup.json`` and capture the row
        buckets it names, BEFORE `_ready` opens.  Every attempt —
        manifest-driven or degraded — is counted in
        ``lgbm_warmup_total{kind="serving",outcome}``; a degradation
        means the legacy smallest-bucket prewarm from `_swap_in` is all
        this replica starts with."""
        if not self.prewarm_manifest:
            return
        for mid, pub_dir in self._dirs.items():
            if self.max_resident > 0 and mid not in self._entries:
                # paged-out zoo tenant: its page-in prewarms from its
                # own per-tenant manifest when demand arrives
                continue
            t0 = time.monotonic()
            entry = self._entries.get(mid)
            outcome, buckets = "legacy", []
            try:
                sec, reason = warmup.read_manifest(pub_dir, "serving")
                if sec is None:
                    outcome = "manifest_" + reason
                elif entry is None:
                    # nothing resolved yet (racing the very first
                    # publish): the poller's later swap-in prewarms
                    outcome = "no_model"
                else:
                    outcome = warmup.classify_serving_section(
                        sec, num_features=entry.num_features,
                        newest_generation=entry.generation)
                    if outcome == "ok":
                        buckets = self._prewarm_buckets(
                            entry, sec["row_buckets"])
                        outcome = "manifest_ok"
            except Exception as e:      # noqa: BLE001 — never block serving
                outcome = "error"
                self.log.warning("serve: manifest prewarm of %s failed "
                                 "(%s); legacy prewarm serves", mid, e)
            dt = time.monotonic() - t0
            warmup.record_prewarm("serving", outcome, dt)
            event = {"model": mid, "outcome": outcome,
                     "buckets": buckets, "seconds": round(dt, 4),
                     "wallclock": resilience.wallclock()}
            self.prewarm_events.append(event)
            with self._wd_lock:
                self.wd.annotate("prewarm", event)
            if outcome == "manifest_ok":
                self.log.info("serve: %s prewarmed %d manifest bucket(s) "
                              "in %.3fs before admission", mid,
                              len(buckets), dt)

    def _prewarm_buckets(self, entry: _ModelEntry,
                         buckets: List[int]) -> List[int]:
        """Dispatch one zero batch per manifest row bucket through the
        device path, so each bucket's program is captured before the
        first real request.  Bounded: at most MAX_PREWARM_BUCKETS, each
        clamped to the largest batch the gatherer can form; a failing
        bucket is skipped and counted (the host path still
        serves), never fatal."""
        # a gathered batch can reach twice max_batch_rows (the gatherer
        # takes a request while it holds fewer rows than the bound)
        cap = max(2 * self.max_batch_rows, 16)
        todo = sorted({min(int(b), cap) for b in buckets
                       if isinstance(b, int) and b > 0})
        done: List[int] = []
        for b in todo[:warmup.MAX_PREWARM_BUCKETS]:
            c0 = graph_obs.total_compiles(warmup.PREDICT_SITE)
            if not self._prewarm(entry, b, "prewarm of bucket %d" % b):
                continue
            compiles = graph_obs.total_compiles(warmup.PREDICT_SITE) - c0
            graph_obs.cache_event("serving.prewarm",
                                  "compile" if compiles else "hit",
                                  max(compiles, 1))
            done.append(b)
        return done

    def export_warmup_manifest(self, model_id: str = "default"
                               ) -> Optional[str]:
        """Publish the row buckets THIS process actually captured (from
        the program ledger) as the publish dir's ``serving`` manifest
        section.  No-op (returns None) when the model has no publish dir
        or no bucket was ever captured — an empty export must not clobber a
        useful manifest."""
        pub_dir = self._dirs.get(model_id)
        entry = self._entries.get(model_id)
        if not pub_dir or entry is None:
            return None
        buckets = warmup.serving_row_buckets(
            num_features=entry.num_features)
        if not buckets:
            return None
        return publish.ModelPublisher(pub_dir).publish_manifest(
            "serving", warmup.build_serving_section(
                num_features=entry.num_features, row_buckets=buckets,
                generation=entry.generation))

    # -- canary + automatic rollback -----------------
    def _policy_for(self, model_id: str) -> policy_mod.CanaryPolicy:
        pol = self._canary_policies.get(model_id)
        if pol is None:
            pol = (self._canary_policy_proto
                   if self._canary_policy_proto is not None
                   and not self._canary_policies
                   else policy_mod.CanaryPolicy())
            self._canary_policies[model_id] = pol
        return pol

    def _canary_in(self, model_id: str, rec) -> None:
        """Load a freshly published generation as the CANARY: it serves
        only `canary_fraction` of batches until the policy promotes or
        rolls it back.  The incumbent keeps full ownership of the rest —
        a regressed publish can never touch more than the canary share
        of traffic."""
        from ..basic import Booster
        t0 = time.monotonic()
        bst = Booster(params=dict(self._params), model_str=rec.model_text)
        entry = _ModelEntry(model_id, rec.generation, bst, rec.meta)
        self._prewarm(entry, 1, "canary prewarm of %s gen %d"
                      % (model_id, rec.generation))
        self._canary[model_id] = entry
        tracing.flow_end(
            "canary load gen=%d" % rec.generation,
            tracing.flow_id(rec.meta.get("trace") or "no-trace",
                            rec.generation),
            model=model_id, generation=rec.generation,
            producer_trace=rec.meta.get("trace"))
        start = self._policy_for(model_id).note_start(rec.generation)
        with self._wd_lock:
            self.wd.annotate("canary_start", dict(
                start, model=model_id,
                load_s=round(time.monotonic() - t0, 4)))
        self.log.warning("serve: generation %d of %s entered CANARY "
                         "(%.0f%% of batches); incumbent stays %d",
                         rec.generation, model_id,
                         self.canary_fraction * 100,
                         self._entries[model_id].generation)

    def _batch_error(self, values: np.ndarray,
                     batch: List[_Request]) -> Optional[float]:
        """Mean observed prediction error over the requests that carried
        a label (None when nobody did) — the canary policy's live
        quality signal.  Classification matrices score top-1 error;
        everything else scores mean absolute error on the transformed
        output."""
        errs: List[float] = []
        s = 0
        vals = np.asarray(values)
        for req in batch:
            e = s + req.n_rows
            if req.label is not None:
                lab = np.asarray(req.label, dtype=np.float64).reshape(-1)
                v = vals[s:e]
                if v.ndim == 2 and v.shape[1] > 1:
                    errs.append(float(np.mean(
                        np.argmax(v, axis=1) != lab[: v.shape[0]])))
                else:
                    errs.append(float(np.mean(np.abs(
                        v.reshape(-1) - lab[: v.size]))))
            s = e
        return float(np.mean(errs)) if errs else None

    def _apply_canary_decision(self, model_id: str,
                               rec: Dict[str, Any]) -> None:
        can = self._canary.pop(model_id, None)
        if can is None:
            return
        incumbent = self._entries.get(model_id)
        if rec["event"] == "canary_promote":
            with self._entries_lock:
                self._entries[model_id] = can
            with self._stats_lock:
                self._stats["promotes"] += 1
                self._stats["swaps"] += 1
            telemetry.counter("lgbm_serve_swaps_total").inc()
            with self._wd_lock:
                self.wd.annotate("canary_promote", dict(rec,
                                                        model=model_id))
            self.log.warning("serve: canary generation %d of %s PROMOTED "
                             "to incumbent", can.generation, model_id)
            return
        # rollback: condemn the generation fleet-wide and pin the
        # subscriber to the incumbent until a NEWER candidate lands.
        # The marker is durable (atomic file in the publish dir): it
        # survives pruning, relaunch, and is seen by every concurrent
        # reader — a condemned generation can never be resolved again.
        pinned = incumbent.generation if incumbent is not None else None
        pub_dir = self._dirs.get(model_id)
        marker = None
        if pub_dir:
            marker = publish.mark_rollback(
                pub_dir, can.generation, pinned_generation=pinned,
                reason="canary degradation", evidence=rec.get("evidence"))
            sub = self._subs.get(model_id)
            if sub is not None and pinned is not None:
                sub.pin_generation(pinned, release_above=can.generation)
        event = dict(rec, model=model_id, bad_generation=can.generation,
                     pinned_generation=pinned,
                     marker=bool(marker))
        self.rollback_events.append(event)
        with self._stats_lock:
            self._stats["rollbacks"] += 1
        with self._wd_lock:
            self.wd.annotate("canary_rollback", event)
        self.log.warning(
            "serve: canary generation %d of %s ROLLED BACK after %s "
            "batches (%s); fleet pinned to generation %s",
            can.generation, model_id, rec.get("canary_batches"),
            rec.get("evidence"), pinned)

    def _poller_loop(self) -> None:
        while not self._stopped:
            for mid in list(self._subs):
                try:
                    self._poll_model(mid)
                except BaseException as e:   # noqa: BLE001 — keep polling
                    self.log.warning("serve: poll of %s failed: %s", mid, e)
            time.sleep(self.poll_interval_s)

    def _policy_loop(self) -> None:
        """Feed the autoscale/shed policy the queue-depth fraction and
        APPLY its decisions: the gather window retunes live (the batcher
        reads `batch_window_s` per batch) and load-shed mode latches
        under the admission lock.  Every decision lands in the stage
        trail next to degradations and swaps."""
        pol = self.policy
        while not self._stopped:
            time.sleep(pol.interval_s)
            decisions = pol.observe(len(self._queue)
                                    / max(self.max_queue, 1))
            if not decisions:
                continue
            self.batch_window_s = pol.window_s
            with self._cond:
                self._shed_low = pol.shed_active
            for rec in decisions:
                with self._wd_lock:
                    self.wd.annotate("policy_decision", rec)
                self.log.warning(
                    "serve: policy %s (window=%.4fs shed=%s depth=%.0f%%)",
                    rec["action"], rec["window_s"], rec["shed_active"],
                    rec["depth_frac"] * 100)

    def set_shed_allowed(self, allowed: bool) -> None:
        """Grant/revoke the autoscale policy's shed permission.  A
        revoke while shed is latched releases it immediately under the
        admission lock.  No-op without a policy."""
        pol = self.policy
        if pol is None or not hasattr(pol, "allow_shed"):
            return
        decisions = pol.allow_shed(allowed)
        with self._cond:
            self._shed_low = bool(pol.shed_active)
        for rec in decisions:
            with self._wd_lock:
                self.wd.annotate("policy_decision", rec)
            self.log.warning("serve: fleet %s shed permission (shed=%s)",
                             "granted" if allowed else "revoked",
                             pol.shed_active)

    def generation(self, model_id: str = "default") -> Optional[int]:
        entry = self._entries.get(model_id)
        return entry.generation if entry is not None else None

    def canary_generation(self, model_id: str = "default") -> Optional[int]:
        """Generation currently under canary judgment (None when no
        canary window is open for this model)."""
        entry = self._canary.get(model_id)
        return entry.generation if entry is not None else None

    @property
    def metrics_port(self) -> Optional[int]:
        """The live /metrics port (None unless metrics_port= was given)."""
        return self.metrics_server.port if self.metrics_server else None

    @property
    def ready(self) -> bool:
        """True once the prewarm pass finished and admission opened
        (what /healthz reports)."""
        return self._ready.is_set()

    @property
    def wire_wait_timeout_s(self) -> float:
        """How long a wire-plane handler (socket or SHM ring) waits on
        an admitted request's future before giving up — generous enough
        that the runtime's own deadline machinery always fires first."""
        return self.default_deadline_s + self.predict_deadline_s + 10.0

    # -- request surface -----------------------------------------------------
    def submit(self, data, deadline_s: Optional[float] = None,
               model_id: str = "default", priority: int = 0,
               label=None, traceparent: Optional[str] = None) -> _Request:
        """Admit one request (a feature row [F] or small matrix [B, F]).
        Raises `ServeRejected` IMMEDIATELY when the queue is full or the
        server is stopped — shedding at admission is the backpressure
        contract; blocking the caller would just move the unbounded
        queue into the clients.

        `priority` (0 = highest, clamped to `priority_levels`) selects
        the admission class: class p only admits while the queue holds
        fewer than ``max_queue * (P - p) / P`` requests, so under
        pressure the lowest class sheds FIRST and the highest keeps the
        full queue.  A policy-flipped load-shed mode rejects the lowest
        class outright (`load_shed`); a tenant past its `quotas` share
        is rejected `quota_exceeded`.  All three rejections are
        machine-readable, carry the request's class, and are retryable.

        `label` optionally carries the request's ground-truth outcome
        (per row): it never influences the prediction — it feeds the
        canary policy's live error signal.

        `traceparent` attaches the client's trace context:
        the server records this request's queue_wait / batch_gather /
        device / drain stages as trace events under the client's trace
        id, and the response's stage decomposition rides `ServeResult.
        stages`.  A malformed value is dropped, never rejected."""
        X = np.atleast_2d(np.asarray(data, dtype=np.float64))
        return self._submit_array(X, deadline_s, model_id, priority,
                                  label, traceparent)

    def submit_view(self, X: np.ndarray,
                    deadline_s: Optional[float] = None,
                    model_id: str = "default",
                    priority: int = 0) -> _Request:
        """Zero-copy admission for the binary data plane:
        `X` must already be a 2-D float matrix — typically a float32
        VIEW of a wire receive buffer — and is queued AS IS: no dtype
        conversion, no copy, no per-request allocation.  The caller owns
        the aliased buffer and must not reuse it until the request
        completes (the wire handler's one-frame-in-flight protocol
        guarantees this).  Same admission contract as `submit`."""
        if X.ndim != 2:
            X = np.atleast_2d(X)
        return self._submit_array(X, deadline_s, model_id, priority,
                                  None, None)

    def _submit_array(self, X: np.ndarray, deadline_s: Optional[float],
                      model_id: str, priority: int, label,
                      traceparent: Optional[str]) -> _Request:
        deadline = time.monotonic() + (self.default_deadline_s
                                       if deadline_s is None
                                       else float(deadline_s))
        P = self.priority_levels
        prio = min(max(int(priority), 0), P - 1)
        req = _Request(model_id, X, deadline, priority=prio,
                       label=None if label is None
                       else np.asarray(label, dtype=np.float64),
                       trace=tracing.parse_traceparent(traceparent)
                       if traceparent else tracing.thread_context())
        with self._cond:
            if self._stopped or not self._started:
                raise ServeRejected("shutdown", retryable=False,
                                    detail="runtime not serving",
                                    priority=prio)
            if not self._ready.is_set():
                # admission opens only after the prewarm pass:
                # retryable, the client's bounded backoff lands after
                # readiness instead of paying the cold capture
                self._count_rejection("warming", priority=prio)
                raise ServeRejected(
                    "warming", retryable=True, priority=prio,
                    retry_after_s=0.1,
                    detail="prewarm in progress; retry shortly")
            if self._shed_low and prio == P - 1:
                self._count_rejection("load_shed", priority=prio)
                raise ServeRejected(
                    "load_shed", retryable=True, priority=prio,
                    queue_depth=len(self._queue), retry_after_s=0.1,
                    detail="policy shed mode active for the lowest class")
            # per-tenant quota, with "*" as the default share for every
            # registered tenant without an explicit entry
            quota = self.quotas.get(model_id, self.quotas.get("*"))
            if quota is not None and self._queued_by_model[model_id] >= \
                    max(int(quota * self.max_queue), 1):
                self._count_rejection("quota_exceeded", priority=prio)
                raise ServeRejected(
                    "quota_exceeded", retryable=True, priority=prio,
                    queue_depth=len(self._queue), retry_after_s=0.05,
                    detail="model %r is at its quota (%d queued >= %.0f%% "
                           "of the queue)" % (model_id,
                                              self._queued_by_model[model_id],
                                              quota * 100))
            limit = (self.max_queue * (P - prio)) // P
            if len(self._queue) >= limit:
                self._count_rejection("queue_full", priority=prio)
                raise ServeRejected(
                    "queue_full", retryable=True, priority=prio,
                    queue_depth=len(self._queue), retry_after_s=0.05,
                    detail="class p%d reservation is %d slots" % (prio,
                                                                  limit))
            self._queue.append(req)
            self._queued_by_model[model_id] += 1
            depth = len(self._queue)
            if self.max_resident > 0:
                # residency bookkeeping: every admission
                # touches the tenant's LRU stamp; a registered-but-
                # paged-out tenant is marked wanted so the poller pages
                # it in (this request retries through retryable
                # no_model rejections until the entry lands)
                self._lru[model_id] = req.enqueued
                if model_id in self._dirs \
                        and model_id not in self._entries:
                    self._wanted[model_id] = req.enqueued
            self._cond.notify()
        with self._stats_lock:
            self._stats["admitted"] += 1
        telemetry.gauge("lgbm_serve_queue_depth").set(depth)
        return req

    def predict(self, data, deadline_s: Optional[float] = None,
                model_id: str = "default", attempts: int = 3,
                seed: int = 0, priority: int = 0,
                label=None) -> ServeResult:
        """Blocking client helper: submit + wait, with bounded jittered
        retry on RETRYABLE rejections (queue_full under a load spike,
        no_model while the first generation lands).  A rejection that
        carries a `retry_after_s` hint raises the jittered delay to it
        — same contract as the binary `wire.WireClient`."""
        delays = resilience.backoff_delays(max(attempts, 1), base=0.05,
                                           cap=0.5, seed=seed)
        deadline = (self.default_deadline_s if deadline_s is None
                    else float(deadline_s))
        last: Optional[ServeRejected] = None
        for a in range(max(attempts, 1)):
            try:
                req = self.submit(data, deadline_s=deadline,
                                  model_id=model_id, priority=priority,
                                  label=label)
                return req.wait(timeout=deadline
                                + self.predict_deadline_s + 10.0)
            except ServeRejected as e:
                last = e
                if not e.retryable:
                    raise
                if a < len(delays):
                    time.sleep(retry_delay(delays[a], e.retry_after_s))
        assert last is not None
        raise last

    # -- the batcher ---------------------------------------------------------
    def _gather_batch(self, batch: List[_Request]) -> np.ndarray:
        """Rows of a multi-request batch, gathered into the preallocated
        per-bucket arena (no np.concatenate allocation).  A mixed
        float32/float64 batch — wire and JSON requests for the same
        model — gathers as float64 (the f32→f64 upcast is exact, and the
        device path casts to f32 anyway)."""
        if len(batch) == 1:
            return batch[0].X
        rows = sum(r.n_rows for r in batch)
        cols = int(batch[0].X.shape[1])
        dtype = batch[0].X.dtype
        for r in batch[1:]:
            if r.X.dtype != dtype:
                dtype = np.dtype(np.float64)
                break
        bucket = max(1 << max(rows - 1, 1).bit_length(), 16)
        key = (bucket, cols, dtype.str)
        arena = self._arena.get(key)
        if arena is None:
            arena = self._arena[key] = np.empty((bucket, cols), dtype)
        out = arena[:rows]
        s = 0
        for r in batch:
            out[s:s + r.n_rows] = r.X
            s += r.n_rows
        return out

    def _reject(self, req: _Request, reason: str, retryable: bool = True,
                detail: str = "") -> None:
        req.rejection = ServeRejected(reason, retryable=retryable,
                                      detail=detail, priority=req.priority)
        req.done.set()
        self._count_rejection(reason, priority=req.priority)

    def _count_rejection(self, reason: str,
                         priority: Optional[int] = None) -> None:
        with self._stats_lock:
            self._stats["rejected"][reason] += 1
        telemetry.counter("lgbm_serve_requests_total").inc(outcome=reason)
        if priority is not None:
            telemetry.counter("lgbm_serve_class_requests_total").inc(
                cls="p%d" % priority, outcome=reason)

    def _next_batch(self) -> Optional[List[_Request]]:
        """Pop a batch of same-model requests: head-of-line model wins,
        up to `max_batch_rows`, gathering follow-ups for at most
        `batch_window_s`.  Expired requests are shed here (deadline
        rejection) — work is never spent on an answer nobody is waiting
        for."""
        while True:
            with self._cond:
                while not self._queue and not self._stopped:
                    self._cond.wait(0.1)
                if self._stopped:
                    return None
                batch: List[_Request] = []
                rows = 0
                window_end = time.monotonic() + self.batch_window_s

                def take() -> None:
                    nonlocal rows
                    keep: List[_Request] = []
                    now = time.monotonic()
                    while self._queue and rows < self.max_batch_rows:
                        req = self._queue.popleft()
                        if req.deadline < now:
                            self._queued_by_model[req.model_id] -= 1
                            self._reject(req, "deadline_exceeded",
                                         detail="expired before batching")
                            continue
                        if batch and req.model_id != batch[0].model_id:
                            keep.append(req)
                            continue
                        self._queued_by_model[req.model_id] -= 1
                        req.t_batched = now      # queue_wait ends here
                        batch.append(req)
                        rows += req.n_rows
                    self._queue.extendleft(reversed(keep))

                take()
                while (batch and rows < self.max_batch_rows
                       and not self._stopped):
                    remaining = window_end - time.monotonic()
                    if remaining <= 0:
                        break
                    self._cond.wait(remaining)
                    take()
                if batch:
                    return batch
                # everything popped this round was shed as expired:
                # go back to waiting for live work

    def _batcher_loop(self) -> None:
        while True:
            batch = self._next_batch()
            if batch is None:
                return
            mid = batch[0].model_id
            # in-flight mark: between batch pop and response
            # drain the model is pinned against LRU eviction exactly
            # like a queued request would pin it
            with self._cond:
                self._inflight_by_model[mid] += len(batch)
            try:
                self._serve_batch(batch)
            except BaseException as e:       # noqa: BLE001 — must not die
                for req in batch:
                    if not req.done.is_set():
                        req.error = e
                        req.done.set()
                self.log.warning("serve: batch failed terminally: %s", e)
            finally:
                with self._cond:
                    self._inflight_by_model[mid] -= len(batch)
                # drop the reference BEFORE blocking for the next batch:
                # wire-plane requests are zero-copy views of a receive
                # buffer or a mapped SHM segment, and a stale `batch`
                # local would pin those bytes (and the segment's unmap)
                # for as long as the queue stays idle
                batch = None

    def _serve_batch(self, batch: List[_Request]) -> None:
        model_id = batch[0].model_id
        entry = self._entries.get(model_id)
        if entry is None:
            for req in batch:
                self._reject(req, "no_model", retryable=True,
                             detail="no generation loaded for %r"
                             % model_id)
            return
        # canary routing: while a canary window is open,
        # a deterministic interleave hands it exactly canary_fraction of
        # batches — the per-batch generation routing at the swap seam,
        # so in-flight batches still finish on the entry they captured
        canary = self._canary.get(model_id)
        kind = "incumbent"
        if canary is not None:
            self._canary_seq[model_id] += 1
            n, f = self._canary_seq[model_id], self.canary_fraction
            if int(n * f) > int((n - 1) * f):
                entry, kind = canary, "canary"
            telemetry.counter("lgbm_canary_batches_total").inc(kind=kind)
            if kind == "canary":
                with self._stats_lock:
                    self._stats["canary_batches"] += 1
        X = self._gather_batch(batch)
        with self._wd_lock:
            self.wd("batch model=%s gen=%d rows=%d"
                    % (model_id, entry.generation, X.shape[0]),
                    seconds=0)
        c0 = graph_obs.total_compiles(warmup.PREDICT_SITE)
        t_dispatch = time.monotonic()
        with tracing.span("serve batch", model=model_id,
                          generation=entry.generation,
                          rows=int(X.shape[0]), requests=len(batch)):
            values, served_by = self._serve_path(entry, X)
        t_values = time.monotonic()
        if canary is not None:
            pol = self._policy_for(model_id)
            decisions = pol.observe(
                kind, error=self._batch_error(values, batch),
                latency_s=time.monotonic() - t_dispatch)
            for d in decisions:
                self._apply_canary_decision(model_id, d)
        # a batch that captured a program pays the capture's wall time:
        # stamp it on the batch span and every response in it
        compiled = graph_obs.total_compiles(warmup.PREDICT_SITE) > c0
        if compiled:
            with self._wd_lock:
                self.wd.annotate("compiled", True)
        now = time.monotonic()
        with self._stats_lock:
            self._stats["rows_served"] += int(X.shape[0])
            self._stats["completed"] += len(batch)
            self._stats["batches_device" if served_by == "device"
                        else "batches_host"] += 1
        telemetry.counter("lgbm_serve_rows_total").inc(int(X.shape[0]))
        telemetry.counter("lgbm_serve_batches_total").inc(path=served_by)
        telemetry.gauge("lgbm_serve_queue_depth").set(len(self._queue))
        if served_by == "device":
            # LGBM_TPU_PROFILE serving hook: the first M device batches
            # land in one torch.profiler trace
            hook = telemetry.profile_hook("serve")
            hook.tick(entry.booster.predict_device())
            hook.tock()
        # model staleness at completion: age of the serving generation —
        # measured against its publish stamp when the publish meta
        # carries one, else against the local swap-in time.
        # The registry histogram is what the sim artifact scrapes.
        published_unix = entry.meta.get("published_unix")
        staleness = (time.time() - float(published_unix)
                     if published_unix is not None
                     else now - entry.loaded_at)
        telemetry.histogram("lgbm_serve_staleness_seconds").observe(
            max(staleness, 0.0), model=model_id)
        lat_hist = telemetry.histogram("lgbm_serve_latency_seconds")
        completed = telemetry.counter("lgbm_serve_requests_total")
        by_class = telemetry.counter("lgbm_serve_class_requests_total")
        model_trace = entry.meta.get("trace")
        s = 0
        for req in batch:
            e = s + req.n_rows
            latency = round(now - req.enqueued, 6)
            # per-request decomposition on the SAME clock as latency_s:
            # queue_wait ends at the batcher pop, batch_gather at the
            # dispatch, device at the values, drain at completion — the
            # four stages PARTITION [enqueued, now], so their sum equals
            # the latency to rounding (the acceptance pin)
            t_b = req.t_batched if req.t_batched is not None else t_dispatch
            stages = {
                "queue_wait_s": round(max(t_b - req.enqueued, 0.0), 6),
                "batch_gather_s": round(max(t_dispatch - t_b, 0.0), 6),
                "device_s": round(max(t_values - t_dispatch, 0.0), 6),
                "drain_s": round(max(now - t_values, 0.0), 6),
            }
            req.result = ServeResult(values[s:e], entry.generation,
                                     model_id, served_by, latency,
                                     compiled=compiled, stages=stages,
                                     model_trace=model_trace)
            if req.trace is not None:
                # the request's stages as slices under the CLIENT's trace
                # id — the cross-thread/cross-process half of the causal
                # timeline (only requests that carry a context pay this)
                marks = ((req.enqueued, t_b, "req/queue_wait"),
                         (t_b, t_dispatch, "req/batch_gather"),
                         (t_dispatch, t_values, "req/device"),
                         (t_values, now, "req/drain"))
                for a, b, nm in marks:
                    tracing.record(nm, int(a * 1e9),
                                   int(max(b - a, 0.0) * 1e9),
                                   trace=req.trace[0], parent=req.trace[1],
                                   served_by=served_by,
                                   generation=entry.generation)
            req.done.set()
            s = e
            # the registry histogram IS the serving latency ledger: the
            # /metrics quantiles and BENCH_SERVE's p50/p99 both read it
            lat_hist.observe(latency, model=model_id)
            completed.inc(outcome="completed")
            by_class.inc(cls="p%d" % req.priority, outcome="completed")

    # -- device path + circuit breaker ---------------------------------------
    def _spawn_executor(self) -> _DeviceExecutor:
        self._executor_idx += 1
        ex = _DeviceExecutor(self._executor_idx)
        ex.start()
        return ex

    def _requested_platform(self) -> str:
        """The platform the parameters ask for (the port's rule: the card
        unless device_type=cpu)."""
        from ..config import Config
        cfg = Config(dict(self._params))
        return "cpu" if str(cfg.device_type).lower() == "cpu" else "cuda"

    def _on_executor(self, fn: Callable[[], np.ndarray], deadline_s: float,
                     what: str = "device predict") -> np.ndarray:
        """Run `fn` on the executor thread under a deadline.  A job that
        blows it is abandoned (the executor may be wedged; a fresh one
        takes over) and surfaces as `StageTimeout`."""
        job = _Job(fn)
        with self._executor_lock:
            ex = self._executor
        ex.submit(job)
        if not job.done.wait(deadline_s):
            job.abandoned = True
            with self._executor_lock:
                if self._executor is ex:
                    ex.retire()
                    self._executor = self._spawn_executor()
                self._abandoned = [j for j in self._abandoned
                                   if not j.done.is_set()] + [job]
            with self._stats_lock:
                self._stats["abandoned"] += 1
            raise resilience.StageTimeout(what, deadline_s)
        if job.error is not None:
            raise job.error
        assert job.values is not None
        return np.asarray(job.values)

    def _abandoned_running(self) -> int:
        with self._executor_lock:
            return sum(1 for j in self._abandoned if not j.done.is_set())

    def _prewarm(self, entry: _ModelEntry, rows: int, what: str) -> bool:
        """One zero batch of `rows` rows through the device path on the
        executor (its bucket's program is captured).  A failure is
        counted in stats()["prewarm_failures"]; before readiness only the
        injected faults (`DevicePredictFault`, a blown deadline) are
        tolerated, anything else raises out of start()."""
        X = np.zeros((rows, entry.num_features))
        try:
            self._on_executor(lambda: entry.booster.predict(
                X, raw_score=self._raw_score, device=True),
                max(self.predict_deadline_s, PREWARM_DEADLINE_S), what)
            return True
        except Exception as e:              # noqa: BLE001 — counted
            with self._stats_lock:
                self._stats["prewarm_failures"] += 1
            injected = isinstance(e, (resilience.DevicePredictFault,
                                      resilience.StageTimeout))
            if not self._ready.is_set() and not injected:
                raise
            self.log.warning("serve: %s failed (%s: %s); the host path "
                             "serves it", what, type(e).__name__, e)
            return False

    def _device_predict(self, entry: _ModelEntry, X: np.ndarray
                        ) -> np.ndarray:
        """One device dispatch under the predict deadline."""
        kw = ({"out_dtype": self._out_dtype}
              if self._out_dtype is not None else {})
        return self._on_executor(lambda: entry.booster.predict(
            X, raw_score=self._raw_score, device=True, **kw),
            self.predict_deadline_s)

    def _serve_path(self, entry: _ModelEntry, X: np.ndarray):
        """(values, served_by): device when the breaker allows it, with
        host fallback — degraded, the server still answers."""
        if self._device_allowed(entry):
            try:
                return self._device_predict(entry, X), "device"
            except BaseException as e:       # noqa: BLE001 — degrade
                self._trip_breaker(entry, e)
        values = entry.booster.predict(X, raw_score=self._raw_score,
                                       device=False)
        if self._out_dtype is not None:
            # the host fallback serves the same surface dtype as the
            # device path, so a breaker flip never changes the response
            # schema mid-stream
            values = np.asarray(values, self._out_dtype)
        return values, "host"

    def _device_allowed(self, entry: _ModelEntry) -> bool:
        b = self._breaker
        if b["state"] == "closed":
            return True
        now = time.monotonic()
        if now < b["open_until"] or self._abandoned_running():
            # the probe waits for an abandoned call to leave the
            # predictor (it holds the predictor's lock until then)
            return False
        # cooldown elapsed: PROBE-based recovery (a tiny dispatch pays
        # the gamble, not a client batch)
        try:
            self._device_predict(
                entry, np.zeros((1, entry.num_features), np.float64))
        except BaseException as e:           # noqa: BLE001 — stay open
            b["open_until"] = time.monotonic() + self.breaker_cooldown_s
            with self._wd_lock:
                self.wd.annotate("recovery_probe_failed",
                                 "%s: %s" % (type(e).__name__, e))
            return False
        b["state"] = "closed"
        event = {"event": "serving_recovery", "from": "host",
                 "to": "device", "model": entry.model_id,
                 "generation": entry.generation,
                 "wallclock": resilience.wallclock()}
        self.recovery_events.append(event)
        with self._stats_lock:
            self._stats["recoveries"] += 1
        telemetry.counter("lgbm_serve_recoveries_total").inc()
        with self._wd_lock:
            self.wd.annotate("recovery_event", event)
        self.log.warning("serve: device path recovered (probe ok); "
                         "circuit closed")
        return True

    def _trip_breaker(self, entry: _ModelEntry, err: BaseException) -> None:
        timed_out = isinstance(err, resilience.StageTimeout)
        reason = "%s: %s" % (type(err).__name__, err)
        self._breaker["state"] = "open"
        self._breaker["open_until"] = (time.monotonic()
                                       + self.breaker_cooldown_s)
        event = {"event": "serving_degradation", "from": "device",
                 "to": "host", "reason": reason,
                 "model": entry.model_id, "generation": entry.generation,
                 "cooldown_s": self.breaker_cooldown_s,
                 "wallclock": resilience.wallclock()}
        self.degradation_events.append(event)
        with self._stats_lock:
            self._stats["degradations"] += 1
        telemetry.counter("lgbm_serve_degradations_total").inc()
        with self._wd_lock:
            if timed_out:
                # hung dispatch: the trail gets the timeout status AND
                # all-thread tracebacks naming the wedged executor
                self.wd.record_timeout(note=reason)
            self.wd.annotate("degradation_event", event)
        self.log.warning("serve: device batch failed (%s); circuit OPEN "
                         "for %.1fs, serving from the host predictor",
                         reason, self.breaker_cooldown_s)

    # -- observability -------------------------------------------------------
    def stats(self) -> Dict[str, Any]:
        with self._stats_lock:
            st = {k: (dict(v) if isinstance(v, collections.Counter) else v)
                  for k, v in self._stats.items()}
        st["queue_depth"] = len(self._queue)
        st["breaker"] = dict(self._breaker)
        st["abandoned_running"] = self._abandoned_running()
        st["priority_levels"] = self.priority_levels
        st["shed_active"] = self._shed_low
        if self.quotas:
            st["quotas"] = dict(self.quotas)
            st["queued_by_model"] = {m: c for m, c
                                     in self._queued_by_model.items() if c}
        if self.policy is not None:
            st["policy"] = dict(self.policy.state(),
                                decisions_tail=self.policy.decisions[-16:])
        st["generations"] = {mid: e.generation
                             for mid, e in self._entries.items()}
        if self.max_resident > 0:
            st["residency"] = {
                "max_resident": self.max_resident,
                "resident": len(self._entries),
                "registered": len(self._dirs),
                "wanted": sorted(self._wanted),
                "events_tail": self.residency_events[-16:],
                "page_ins": sum(1 for e in self.residency_events
                                if e["event"] == "page_in"),
                "evictions": sum(1 for e in self.residency_events
                                 if e["event"] == "evict"),
            }
        if self.canary_fraction > 0:
            st["canary_fraction"] = self.canary_fraction
            st["canary_generations"] = {mid: e.generation
                                        for mid, e in self._canary.items()}
            st["canary_policy"] = {mid: p.state() for mid, p
                                   in self._canary_policies.items()}
            st["rollback_events"] = list(self.rollback_events)
        st["ready"] = self._ready.is_set()
        st["prewarm_events"] = list(self.prewarm_events)
        st["degradation_events"] = list(self.degradation_events)
        st["recovery_events"] = list(self.recovery_events)
        if self.start_degradation is not None:
            st["start_degradation"] = self.start_degradation
        # the registry histogram is the latency ledger: the same numbers
        # a /metrics scrape (and BENCH_SERVE) reads
        hist = telemetry.histogram("lgbm_serve_latency_seconds")
        hstate = hist.state()
        st["latency_quantiles_s"] = {
            "p50": hist.quantile(0.5, state=hstate),
            "p95": hist.quantile(0.95, state=hstate),
            "p99": hist.quantile(0.99, state=hstate),
            "count": hstate["count"],
        }
        return st


# ---------------------------------------------------------------------------
# TCP front end (task=serve)
# ---------------------------------------------------------------------------

#: one encoder for every response — `json.dumps` builds a fresh
#: JSONEncoder per call, measurable at serving rates
_JSON_ENCODER = json.JSONEncoder(separators=(",", ":"))


class _Handler(socketserver.StreamRequestHandler):
    """JSON-lines protocol: one request object per line, one response
    object per line.  Requests: ``{"features": [...], "model": "id",
    "deadline_s": 2.0, "traceparent": "00-..-..-01"}`` or
    ``{"cmd": "stats"}``.  Responses: ``{"values": [...],
    "generation": N, "served_by": ..., "latency_s": ..., "stages":
    {queue_wait_s, batch_gather_s, device_s, drain_s}, "model_trace":
    ...}`` or a `ServeRejected.to_dict()` rejection."""

    def handle(self) -> None:
        rt: ServingRuntime = self.server.runtime    # type: ignore[attr-defined]
        for raw in self.rfile:
            line = raw.strip()
            if not line:
                continue
            try:
                msg = json.loads(line.decode("utf-8"))
                if msg.get("cmd") == "stats":
                    out = rt.stats()
                else:
                    rec = rt.submit(
                        np.asarray(msg["features"], np.float64),
                        deadline_s=msg.get("deadline_s"),
                        model_id=msg.get("model", "default"),
                        priority=int(msg.get("priority", 0)),
                        label=msg.get("label"),
                        # cross-process context propagation:
                        # the wire carries the client's traceparent
                        traceparent=msg.get("traceparent"),
                    ).wait(timeout=rt.wire_wait_timeout_s)
                    out = {"values": np.asarray(rec.values).tolist(),
                           "generation": rec.generation,
                           "served_by": rec.served_by,
                           "latency_s": rec.latency_s,
                           "compiled": rec.compiled,
                           "stages": rec.stages}
                    if rec.model_trace:
                        out["model_trace"] = rec.model_trace
            except ServeRejected as e:
                out = e.to_dict()
            except Exception as e:           # noqa: BLE001 — wire error
                out = {"error": "bad_request",
                       "detail": "%s: %s" % (type(e).__name__, e)}
            try:
                self.wfile.write((_JSON_ENCODER.encode(out)
                                  + "\n").encode("utf-8"))
                self.wfile.flush()
            except OSError:
                return                       # client went away


class ServingServer(socketserver.ThreadingTCPServer):
    """Thin TCP wrapper over a `ServingRuntime` (the CLI `task=serve`
    front end).  One thread per connection; all connections share the
    runtime's bounded queue, so admission control is global."""

    daemon_threads = True
    allow_reuse_address = True

    def __init__(self, runtime: ServingRuntime, host: str = "127.0.0.1",
                 port: int = 0):
        self.runtime = runtime
        super().__init__((host, port), _Handler)

    @property
    def port(self) -> int:
        return self.server_address[1]
