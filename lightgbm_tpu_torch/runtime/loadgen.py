"""Deterministic open-loop load generator with a verifying client pool
(counterpart of lightgbm_tpu/runtime/loadgen.py).

The many-users side of a production simulation, over the port's
`ServingRuntime`.  Three properties matter and all are deliberate:

* **Open loop.**  Arrival times are drawn from a seedable inhomogeneous
  Poisson process over a traffic *shape* (diurnal / bursty / step) and
  walked on an absolute clock: a slow server does not slow the offered
  load down, which is what makes overload visible.  The submitting
  thread never blocks on a response; completions are awaited by a
  separate client pool.
* **Deterministic.**  Same seed, same shape, same duration: the same
  arrival offsets, class assignment and probe rows, and the same as the
  JAX package's generator (both draw from `np.random.default_rng`).
* **Verifying.**  Every completed response is checked byte for byte
  against the offline predictor of the generation it reports, through
  the path it reports (a host response against the exact f64 host
  predictor, a device response against the device predictor, whose
  per-row outputs do not depend on the batch they rode in).

Offered load and verification verdicts land in the metrics registry
(``lgbm_loadgen_offered_total{cls}``,
``lgbm_loadgen_verified_total{result}``).

Only numpy at module scope; the model stack loads lazily inside the
verifier (first generation resolution).
"""
from __future__ import annotations

import math
import os
import queue
import threading
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from . import publish, telemetry, tracing
from .serving import ServeRejected


def _bucket_width_at(value: float) -> float:
    """Width of the fixed-layout latency bucket `value` falls in: the
    tolerance the stage-sum-vs-latency pin is allowed (one bucket)."""
    b = telemetry.LATENCY_BUCKETS_S
    i = 0
    while value > b[i]:
        i += 1
    if math.isinf(b[i]):
        i = len(b) - 2
    return b[i] - (b[i - 1] if i > 0 else 0.0)

__all__ = ["TrafficShape", "RequestClass", "ResponseVerifier",
           "LoadGenerator", "poisson_arrivals"]


class TrafficShape:
    """A named offered-load curve: ``rate(t)`` in requests/second at
    offset ``t`` from the run start, plus its peak (the thinning
    envelope)."""

    def __init__(self, name: str, rate_fn: Callable[[float], float],
                 peak_rps: float):
        self.name = name
        self._rate_fn = rate_fn
        self.peak_rps = float(peak_rps)

    def rate(self, t: float) -> float:
        return max(float(self._rate_fn(t)), 0.0)

    # -- the three canonical shapes ------------------------------------------
    @classmethod
    def diurnal(cls, base_rps: float, peak_rps: float,
                period_s: float) -> "TrafficShape":
        """A day compressed to `period_s`: sinusoid from base (trough)
        to peak, starting at the trough."""
        amp = (peak_rps - base_rps) / 2.0
        mid = base_rps + amp

        def rate(t: float) -> float:
            return mid - amp * math.cos(2.0 * math.pi * t / period_s)

        return cls("diurnal", rate, peak_rps)

    @classmethod
    def bursty(cls, base_rps: float, burst_rps: float, period_s: float,
               burst_len_s: float) -> "TrafficShape":
        """Flat base load with a square-wave burst of `burst_len_s`
        at the start of every `period_s` window."""

        def rate(t: float) -> float:
            return burst_rps if (t % period_s) < burst_len_s else base_rps

        return cls("bursty", rate, max(base_rps, burst_rps))

    @classmethod
    def step(cls, levels: List) -> "TrafficShape":
        """Piecewise-constant: ``levels`` is [(duration_s, rps), ...];
        past the last level the last rps holds."""
        levels = [(float(d), float(r)) for d, r in levels]

        def rate(t: float) -> float:
            acc = 0.0
            for dur, rps in levels:
                acc += dur
                if t < acc:
                    return rps
            return levels[-1][1]

        return cls("step", rate, max(r for _, r in levels))


def poisson_arrivals(shape: TrafficShape, duration_s: float,
                     seed: int = 0) -> np.ndarray:
    """Sorted arrival offsets (seconds) of an inhomogeneous Poisson
    process with rate ``shape.rate(t)``, by thinning a homogeneous
    process at ``peak_rps``.  Deterministic per (shape, duration, seed)."""
    rng = np.random.default_rng(seed)
    peak = max(shape.peak_rps, 1e-9)
    n = int(rng.poisson(peak * duration_s))
    t = np.sort(rng.uniform(0.0, duration_s, size=n))
    keep = rng.uniform(0.0, 1.0, size=n) * peak < \
        np.array([shape.rate(x) for x in t])
    return t[keep]


class RequestClass:
    """One slice of the request mix: a priority class hitting one model
    with `rows` feature rows per request, drawn with probability
    proportional to `weight`."""

    __slots__ = ("name", "priority", "model_id", "weight", "rows")

    def __init__(self, name: str, priority: int = 0,
                 model_id: str = "default", weight: float = 1.0,
                 rows: int = 1):
        self.name = name
        self.priority = int(priority)
        self.model_id = model_id
        self.weight = float(weight)
        self.rows = int(rows)


class ResponseVerifier:
    """Byte-identity oracle: offline `Booster.predict` references per
    (generation, served_by path), computed over the FIXED probe matrix so
    verifying a response is pure indexing.

    Generation texts resolve from `texts` (a {generation: model_text}
    map) first, then from the publish directory (the validated
    generation file — publish retention must cover the run, which the
    sim harness configures).  A generation that resolves nowhere is a
    ``wrong_generation`` verdict: the response names a model that was
    never validly published."""

    def __init__(self, probe: np.ndarray, pub_dir: Optional[str] = None,
                 texts: Optional[Dict[int, str]] = None,
                 params: Optional[Dict[str, Any]] = None,
                 raw_score: bool = False,
                 value_dtype: Optional[type] = None):
        """`value_dtype=np.float32` verifies a float32 serving surface
        (the binary wire plane / ``response_dtype="float32"``): the
        reference stays the exact f64 offline predict, narrowed with the
        same deterministic cast the server applies: still byte identity,
        in the narrower lane."""
        self.probe = np.asarray(probe, dtype=np.float64)
        self.pub_dir = pub_dir
        self.texts: Dict[int, str] = dict(texts or {})
        self.params = dict(params or {})
        self.raw_score = bool(raw_score)
        self.value_dtype = value_dtype
        self._refs: Dict[int, Dict[str, np.ndarray]] = {}
        self._lock = threading.Lock()

    def _resolve_text(self, generation: int) -> Optional[str]:
        text = self.texts.get(generation)
        if text is not None:
            return text
        if self.pub_dir is None:
            return None
        path = os.path.join(self.pub_dir,
                            publish._gen_name(generation))  # noqa: SLF001
        try:
            with open(path, "rb") as fh:
                raw = fh.read().decode("utf-8", "replace")
        except OSError:
            return None
        split = publish._split_validate(raw)                # noqa: SLF001
        return split[0] if split is not None else None

    def refs(self, generation: int) -> Optional[Dict[str, np.ndarray]]:
        with self._lock:
            cached = self._refs.get(generation)
        if cached is not None:
            return cached
        text = self._resolve_text(generation)
        if text is None:
            return None
        from ..basic import Booster
        bst = Booster(params=dict(self.params), model_str=text)
        # the reference DEVICE predict runs in the same process as the
        # sim's LGBM_TPU_FAULT churn, so a kill window can take it down
        # too — retry through the window (faults are transient by
        # design; the cache makes this a once-per-generation cost)
        entry: Optional[Dict[str, np.ndarray]] = None
        for _ in range(40):
            try:
                entry = {
                    "host": np.asarray(bst.predict(self.probe,
                                                   raw_score=self.raw_score,
                                                   device=False)),
                    "device": np.asarray(bst.predict(self.probe,
                                                     raw_score=self.raw_score,
                                                     device=True)),
                }
                break
            except BaseException:            # noqa: BLE001 — fault window
                time.sleep(0.25)
        if entry is None:
            raise RuntimeError("reference predict for generation %d kept "
                               "failing (fault window never closed?)"
                               % generation)
        with self._lock:
            self._refs.setdefault(generation, entry)
        return entry

    def verify(self, result, idx: np.ndarray) -> str:
        """Verdict for one `ServeResult` served over probe rows `idx`:
        ok / wrong_generation / mismatch / unverifiable (the reference
        itself could not be computed — never silently dropped)."""
        try:
            refs = self.refs(result.generation)
        except BaseException:                # noqa: BLE001 — verdict below
            return "unverifiable"
        if refs is None:
            return "wrong_generation"
        ref = refs.get(result.served_by)
        if ref is None:
            return "mismatch"
        expect = ref[idx]
        if self.value_dtype is not None:
            expect = expect.astype(self.value_dtype)
        if not np.array_equal(np.asarray(result.values), expect):
            return "mismatch"
        return "ok"


class LoadGenerator:
    """Drive one `ServingRuntime` with a shaped, classed, verified
    open-loop request stream.  `run()` blocks for `duration_s` and
    returns the machine-readable ledger."""

    def __init__(self, runtime, classes: List[RequestClass],
                 shape: TrafficShape, duration_s: float,
                 probe: np.ndarray, seed: int = 0,
                 verifier: Optional[ResponseVerifier] = None,
                 deadline_s: float = 2.0, waiters: int = 8,
                 trace_every: int = 0):
        """`trace_every=K` traces every K-th offered request:
        a fresh trace id travels to the server as the submit's
        traceparent (the server records queue/gather/device/drain slices
        under it), the client-side wait is recorded as the root span,
        and the response's stage decomposition is collected into the
        ledger's ``trace`` section with the stage-sum-vs-client-latency
        error accounted per sample.  0 disables sampling."""
        if not classes:
            raise ValueError("LoadGenerator needs at least one RequestClass")
        self.runtime = runtime
        self.classes = list(classes)
        self.shape = shape
        self.duration_s = float(duration_s)
        self.probe = np.asarray(probe, dtype=np.float64)
        self.seed = int(seed)
        self.verifier = verifier
        self.deadline_s = float(deadline_s)
        self.waiters = max(int(waiters), 1)
        self.trace_every = max(int(trace_every), 0)
        self.trace_samples: List[Dict[str, Any]] = []
        self._trace_lock = threading.Lock()
        self._ledger_lock = threading.Lock()

        self.offered: Dict[str, int] = {c.name: 0 for c in self.classes}
        self.completed: Dict[str, int] = {c.name: 0 for c in self.classes}
        self.shed: Dict[str, Dict[str, int]] = {c.name: {}
                                                for c in self.classes}
        self.verify_counts: Dict[str, int] = {}
        self.served_by: Dict[str, int] = {}
        self.bad_rejections = 0
        self.hard_errors: List[str] = []
        self.max_lag_s = 0.0
        #: the arrival offsets of the last run (poisson_arrivals of the
        #: shape, duration and seed)
        self.arrivals: Optional[np.ndarray] = None

    # -- the verifying client pool -------------------------------------------
    def _waiter(self, q: "queue.Queue") -> None:
        verified = telemetry.counter("lgbm_loadgen_verified_total")
        while True:
            item = q.get()
            if item is None:
                return
            req, idx, cls = item
            try:
                try:
                    rec = req.wait(timeout=self.deadline_s
                                   + self.runtime.predict_deadline_s + 10.0)
                except ServeRejected as e:
                    self._record_shed(cls, e)
                    continue
                verdict = (self.verifier.verify(rec, idx)
                           if self.verifier is not None else None)
                # one lock around the ledger counters: unlocked
                # read-modify-writes from several waiters lose updates
                # under preemption, and verified must equal completed
                with self._ledger_lock:
                    self.completed[cls.name] += 1
                    self.served_by[rec.served_by] = \
                        self.served_by.get(rec.served_by, 0) + 1
                    if verdict is not None:
                        self.verify_counts[verdict] = \
                            self.verify_counts.get(verdict, 0) + 1
                if verdict is not None:
                    verified.inc(result=verdict)
            except BaseException as e:       # noqa: BLE001 — a waiter
                # must NEVER die silently: a dead waiter would strand its
                # queue share and undercount verification
                self.hard_errors.append("%s: %s" % (type(e).__name__, e))

    def _trace_waiter(self, req, cls: RequestClass, ctx,
                      t_submit: float) -> None:
        """Dedicated waiter for ONE sampled request: the client clock
        must stop when the response ARRIVES, so a sampled request never
        sits behind head-of-line peers in the shared waiter pool's FIFO
        (that queueing is loadgen overhead, not observed latency)."""
        try:
            rec = req.wait(timeout=self.deadline_s
                           + self.runtime.predict_deadline_s + 10.0)
        except BaseException:       # noqa: BLE001 — sheds/errors are the
            return                  # shared pool's ledger, not a sample
        self._record_trace_sample(rec, req, cls, ctx, t_submit)

    def _record_trace_sample(self, rec, req, cls: RequestClass,
                             ctx, t_submit: float) -> None:
        """Close one sampled request's client-side root span and account
        its server stage decomposition against the CLIENT-observed
        latency (the acceptance pin: stage sum within one bucket width).

        Client-observed latency = submit call to response READY, both on
        the client's own clock reads: ``t_submit`` is taken before the
        submit call, and readiness is the request's completion stamp
        (``enqueued + latency_s`` on the same monotonic clock — what a
        TCP client's socket read would see modulo the wire).  The
        further gap until this waiter thread actually WAKES is recorded
        separately as ``delivery_s``: on an oversubscribed host (the
        1-core CI box) the scheduler's wake-up delay is real, but it is
        client-runtime noise, not server time — folding it into the pin
        would make the gate flake exactly where the decomposition is
        most precise (sub-10 ms requests)."""
        t_wake = time.monotonic()
        t_ready = req.enqueued + rec.latency_s
        client_latency = max(t_ready - t_submit, 0.0)
        tracing.record("client request %s" % cls.name,
                       int(t_submit * 1e9),
                       int(client_latency * 1e9),
                       trace=ctx[0], span_id=ctx[1],
                       cls=cls.name, served_by=rec.served_by,
                       generation=rec.generation,
                       model_trace=rec.model_trace)
        stage_sum = round(sum(rec.stages.values()), 6) if rec.stages \
            else None
        sample = {
            "cls": cls.name,
            "client_latency_s": round(client_latency, 6),
            "server_latency_s": rec.latency_s,
            "delivery_s": round(max(t_wake - t_ready, 0.0), 6),
            "stages": dict(rec.stages),
            "stage_sum_s": stage_sum,
            "stage_sum_err_s": round(abs(stage_sum - client_latency), 6)
            if stage_sum is not None else None,
            "bucket_width_s": _bucket_width_at(client_latency),
            "served_by": rec.served_by,
            "generation": rec.generation,
            "trace": tracing.make_traceparent(*ctx),
            "model_trace": rec.model_trace,
        }
        with self._trace_lock:
            if len(self.trace_samples) < 512:
                self.trace_samples.append(sample)

    def _record_shed(self, cls: RequestClass, e: ServeRejected) -> None:
        with self._ledger_lock:
            reasons = self.shed[cls.name]
            reasons[e.reason] = reasons.get(e.reason, 0) + 1
        d = e.to_dict()
        # the machine-readability contract: retryable flag, a reason,
        # and the priority class the shed applied to
        if not (d.get("error") == "rejected" and d.get("reason")
                and "retryable" in d
                and d.get("priority") == cls.priority):
            self.bad_rejections += 1

    # -- the open loop -------------------------------------------------------
    def run(self) -> Dict[str, Any]:
        arrivals = poisson_arrivals(self.shape, self.duration_s, self.seed)
        self.arrivals = arrivals
        rng = np.random.default_rng(self.seed + 1)
        weights = np.asarray([c.weight for c in self.classes], np.float64)
        weights = weights / weights.sum()
        cls_idx = rng.choice(len(self.classes), size=len(arrivals),
                             p=weights)
        row_idx = [rng.integers(0, len(self.probe),
                                size=self.classes[c].rows)
                   for c in cls_idx]

        q: "queue.Queue" = queue.Queue()
        pool = [threading.Thread(target=self._waiter, args=(q,),
                                 name="loadgen-waiter-%d" % i, daemon=True)
                for i in range(self.waiters)]
        for t in pool:
            t.start()
        trace_threads: List[threading.Thread] = []
        offered = telemetry.counter("lgbm_loadgen_offered_total")
        t0 = time.monotonic()
        for i, (off, ci, idx) in enumerate(zip(arrivals, cls_idx, row_idx)):
            cls = self.classes[ci]
            now = time.monotonic() - t0
            if off > now:
                time.sleep(off - now)
            else:
                # open loop: late arrivals submit immediately; the lag is
                # recorded, the offered schedule is never thinned
                self.max_lag_s = max(self.max_lag_s, now - off)
            self.offered[cls.name] += 1
            offered.inc(cls=cls.name)
            # sampled tracing: every K-th request gets a
            # fresh trace id that travels to the server as traceparent
            ctx = None
            tp = None
            if self.trace_every and i % self.trace_every == 0 \
                    and tracing.enabled():
                trace_threads = [t for t in trace_threads if t.is_alive()]
                if len(trace_threads) < 256:   # bound the waiter spawn
                    ctx = (tracing.new_trace_id(), tracing.new_span_id())
                    tp = tracing.make_traceparent(*ctx)
            t_submit = time.monotonic()
            try:
                req = self.runtime.submit(self.probe[idx],
                                          deadline_s=self.deadline_s,
                                          model_id=cls.model_id,
                                          priority=cls.priority,
                                          traceparent=tp)
            except ServeRejected as e:
                self._record_shed(cls, e)
                continue
            if ctx is not None:
                # a dedicated waiter per sampled request: its client
                # clock stops at response arrival, not at its turn in
                # the shared pool's FIFO
                tt = threading.Thread(target=self._trace_waiter,
                                      args=(req, cls, ctx, t_submit),
                                      name="loadgen-trace", daemon=True)
                tt.start()
                trace_threads.append(tt)
            q.put((req, idx, cls))
        for _ in pool:
            q.put(None)
        for t in pool:
            t.join(timeout=60)
        for t in trace_threads:
            t.join(timeout=60)
        return self.ledger()

    def ledger(self) -> Dict[str, Any]:
        total_offered = sum(self.offered.values())
        out: Dict[str, Any] = {
            "shape": self.shape.name,
            "duration_s": self.duration_s,
            "seed": self.seed,
            "offered_total": total_offered,
            "offered_rps_mean": round(total_offered
                                      / max(self.duration_s, 1e-9), 2),
            "max_lag_s": round(self.max_lag_s, 4),
            "served_by": dict(self.served_by),
            "verification": dict(self.verify_counts),
            "non_machine_readable_rejections": self.bad_rejections,
            "hard_errors": self.hard_errors[:10],
            "classes": {},
        }
        if self.trace_every:
            with self._trace_lock:
                samples = list(self.trace_samples)
            errs = [s["stage_sum_err_s"] for s in samples
                    if s["stage_sum_err_s"] is not None]
            within = [s for s in samples
                      if s["stage_sum_err_s"] is not None
                      and s["stage_sum_err_s"] <= s["bucket_width_s"]]
            out["trace"] = {
                "trace_every": self.trace_every,
                "sampled": len(samples),
                "with_stages": len(errs),
                "stage_sum_within_bucket": len(within),
                "stage_sum_max_err_s": round(max(errs), 6) if errs
                else None,
                # the acceptance pin: EVERY sampled request's stage sum
                # lands within one bucket width of its client latency
                "ok": bool(samples) and len(within) == len(errs) > 0,
                "samples": samples[:64],
            }
        for c in self.classes:
            shed = sum(self.shed[c.name].values())
            out["classes"][c.name] = {
                "priority": c.priority,
                "model": c.model_id,
                "offered": self.offered[c.name],
                "completed": self.completed[c.name],
                "shed": shed,
                "shed_rate": round(shed / self.offered[c.name], 4)
                if self.offered[c.name] else 0.0,
                "reasons": dict(self.shed[c.name]),
            }
        return out
