"""Metrics, spans and exporters (counterpart of
lightgbm_tpu/runtime/telemetry.py).

* **Metrics registry** (`MetricsRegistry` / the process-global
  `REGISTRY`): counters, gauges and bounded-memory streaming histograms
  whose p50 / p95 / p99 are exact to within one bucket of the FIXED
  layout (`LATENCY_BUCKETS_S`).  Label cardinality is bounded per family:
  past `max_label_sets` distinct label sets (64 unless the table says
  otherwise), new ones land in an explicit ``__overflow__`` series.  Every
  metric must be declared in `METRIC_TABLE`; an undeclared name raises.
  The table declares only the families this package emits, each row
  equal to the JAX package's row of that name except the graph ledger's
  (the JAX package's docs/OBSERVABILITY.md stays the catalog).

* **Spans** (`span` / `record_span`): named wall-clock spans recorded
  into ``lgbm_span_seconds{span}`` / ``lgbm_spans_total{span,status}``;
  the stage watchdog (`resilience.Watchdog`) records every stage close
  here, with digit runs normalized to ``N``.

* **The training seam** (`train_iteration`, around every
  `Booster.update`): the iteration's wall time, the iteration counter,
  the per-iteration blocking-sync gauges (from `runtime/syncs.py`, whose
  every event also counts into ``lgbm_host_syncs_total{label}``) and the
  profiler hook.

* **Exporters:**
  1. `MetricsServer`: a Prometheus text endpoint (``GET /metrics``;
     ``/metrics.json`` returns the JSON snapshot; ``/healthz``).
  2. ``$LGBM_TPU_METRICS_FILE``: a periodic ATOMIC JSON-lines snapshot
     file (each flush rewrites the whole file tmp + fsync + rename).
  3. ``LGBM_TPU_PROFILE=<dir>``: the first ``LGBM_TPU_PROFILE_ITERS``
     training iterations (default 5) in one `torch.profiler` trace under
     ``<dir>/train``, of CUDA activity when the engine runs on the card
     and of CPU activity otherwise (`profile_hook`).  A profiler that cannot start or stop says so on
     stderr and in the log; training goes on where it was.

Every instrument checks the module's enable flag first, so with
`set_enabled(False)` each site costs one global read and a return.
`gather_host_snapshots` gathers every rank's snapshot over the
torch.distributed group.  No torch or numpy at module scope.
"""
from __future__ import annotations

import collections
import contextlib
import json
import math
import os
import re
import sys
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from . import tracing
from .resilience import atomic_write, wallclock

# every process that touches the metrics registry also arms the trace
# flight-recorder's atexit dump when $LGBM_TPU_TRACE_DIR is set, so
# every process of a run collects its own trace
tracing.maybe_autostart()

__all__ = [
    "METRIC_TABLE", "LATENCY_BUCKETS_S", "OVERFLOW_LABEL",
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "REGISTRY",
    "set_enabled", "enabled", "counter", "gauge", "histogram",
    "span", "record_span", "normalize_span_name", "SPAN_KEEP_KEYS",
    "count_sync",
    "MetricsServer", "start_http_server",
    "MetricsFileWriter", "maybe_start_file_export", "write_snapshot_now",
    "snapshot", "render_prometheus", "profile_hook", "reset",
    "gather_host_snapshots", "merge_host_snapshots", "mesh_snapshot",
    "render_prometheus_from_snapshot", "mesh_process_count",
]

#: the fixed latency/duration bucket layout (seconds).  Quantiles read
#: from these histograms are exact to within one bucket width.
LATENCY_BUCKETS_S: Tuple[float, ...] = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0, math.inf)

#: every label of an over-cardinality label set is rewritten to this
#: value — overload is visible as an explicit bucket, never as silent
#: unbounded growth or a dropped sample.
OVERFLOW_LABEL = "__overflow__"

#: THE metric registry: every metric this package emits, its type, its
#: label names and its one-line meaning, each row the JAX package's row
#: of that name (tests/test_torch_telemetry.py pins it; the graph
#: ledger's rows keep the JAX names, types and labels and say in their
#: help what the port counts).
METRIC_TABLE: Dict[str, Dict[str, Any]] = {
    "lgbm_train_iterations_total": {
        "type": "counter", "labels": (),
        "help": "Completed Booster.update calls (all boosting variants)"},
    "lgbm_train_iteration_seconds": {
        "type": "histogram", "labels": (),
        "help": "Wall time of one boosting iteration (dispatch-side; at "
                "pipeline_depth>0 host assembly drains off this clock)"},
    "lgbm_train_host_syncs_per_iter": {
        "type": "gauge", "labels": ("path",),
        "help": "Blocking host fetches recorded during the last "
                "iteration, path=total/critical (sync-audit seam)"},
    "lgbm_host_syncs_total": {
        "type": "counter", "labels": ("label",),
        "help": "Blocking device->host syncs through runtime/syncs.py, "
                "by call-site label"},
    "lgbm_host_syncs_critical_total": {
        "type": "counter", "labels": ("label",),
        "help": "Sync-audit events recorded ON the tree->tree critical "
                "path (pinned 0 at pipeline_depth=1 fused fast path)"},
    "lgbm_span_seconds": {
        "type": "histogram", "labels": ("span",),
        "help": "Named span durations (watchdog stage closes land here; "
                "digit runs in names normalized to N)"},
    "lgbm_spans_total": {
        "type": "counter", "labels": ("span", "status"),
        "help": "Span completions by status=ok/error/timeout"},
    # the graph ledger (runtime/graph_obs.py) keeps the JAX package's
    # family names, types and labels, so one dashboard reads both
    # packages; their help says what the port counts
    "lgbm_xla_compiles_total": {
        "type": "counter", "labels": ("site",), "max_label_sets": 256,
        "help": "Program builds per site: CUDA graph captures per "
                "graphs.Site, grower programs and nvcc kernel builds "
                "(runtime/graph_obs.py ledger)"},
    "lgbm_xla_compile_seconds": {
        "type": "histogram", "labels": ("site",), "max_label_sets": 256,
        "help": "Wall time of each build (a capture's eager warm-up run "
                "and capture, a grower program's state, an nvcc run)"},
    "lgbm_xla_retraces_total": {
        "type": "counter", "labels": ("site", "delta"),
        "max_label_sets": 256,
        "help": "Steady-state rebuilds (after graph_obs.mark_steady), "
                "labeled with the shape delta that triggered them"},
    "lgbm_program_cache_events_total": {
        "type": "counter", "labels": ("site", "event"),
        "max_label_sets": 256,
        "help": "Program-cache traffic per site: event=hit (a graph "
                "replay)/compile for graph sites, hit/miss for the grower "
                "and predictor caches and the kernel builds"},
    # the serving, publish, canary, quality and online families (the
    # JAX package's rows)
    "lgbm_ingest_rows_total": {
        "type": "counter", "labels": ("mode",),
        "help": "Rows parsed by ingest, mode=full_parse/tail_append/"
                "binary_cache/file_parse"},
    "lgbm_ingest_seconds": {
        "type": "histogram", "labels": (),
        "help": "Wall time of one ingest pass (parse or cache load)"},
    "lgbm_ingest_window_rows": {
        "type": "gauge", "labels": (),
        "help": "Rows currently staged in the online rolling window"},
    "lgbm_online_cycles_total": {
        "type": "counter", "labels": ("status",),
        "help": "Continuous-training cycles, status=ok/timeout/"
                "quarantine/gate_reject"},
    "lgbm_online_publish_seconds": {
        "type": "histogram", "labels": (),
        "help": "Atomic model publish latency per cycle"},
    "lgbm_serve_latency_seconds": {
        "type": "histogram", "labels": ("model",),
        "help": "Per-request serving latency, admission to completion "
                "(drives BENCH_SERVE's p50/p99)"},
    "lgbm_serve_requests_total": {
        "type": "counter", "labels": ("outcome",),
        "help": "Serving requests by outcome: completed, or the shed "
                "reason (queue_full/deadline_exceeded/no_model/shutdown)"},
    "lgbm_serve_rows_total": {
        "type": "counter", "labels": (),
        "help": "Feature rows served (completed requests only)"},
    "lgbm_serve_batches_total": {
        "type": "counter", "labels": ("path",),
        "help": "Micro-batches served, path=device/host (host = degraded)"},
    "lgbm_serve_queue_depth": {
        "type": "gauge", "labels": (),
        "help": "Admission queue depth sampled at the last submit/batch"},
    "lgbm_serve_swaps_total": {
        "type": "counter", "labels": (),
        "help": "Hot model swaps (new generation loaded + prewarmed)"},
    "lgbm_serve_degradations_total": {
        "type": "counter", "labels": (),
        "help": "Circuit-breaker trips device->host"},
    "lgbm_serve_recoveries_total": {
        "type": "counter", "labels": (),
        "help": "Probe-based recoveries host->device"},
    "lgbm_serve_bytes_total": {
        "type": "counter", "labels": ("path", "dir"),
        "help": "Binary wire-plane bytes moved (headers + payloads), "
                "path=tcp/uds/shm, dir=rx/tx"},
    "lgbm_shm_sessions_total": {
        "type": "counter", "labels": ("event",),
        "help": "SHM ring sessions by lifecycle event: ready/closed/"
                "reclaimed (peer died with work in flight)/torn "
                "(protocol violation)/rejected_setup/leaked"},
    "lgbm_shm_frames_total": {
        "type": "counter", "labels": ("outcome",),
        "help": "SHM ring frames by outcome: completed/rejected/"
                "bad_crc (rejected in place, counters stay in sync)"},
    "lgbm_shm_doorbell_syscalls_total": {
        "type": "counter", "labels": ("op",),
        "help": "Every syscall the ring doorbell makes, op=ring (wake "
                "peer)/wait (poll)/drain (eventfd read) — zero in the "
                "spin-hot steady state, which BENCH_WIRE measures"},
    "lgbm_serve_frames_total": {
        "type": "counter", "labels": ("outcome",),
        "help": "Binary wire frames by outcome: completed/rejected or "
                "the torn-frame class (truncated_header/short_payload/"
                "bad_crc/bad_magic/bad_version/bad_dtype/oversized)"},
    "lgbm_serve_class_requests_total": {
        "type": "counter", "labels": ("cls", "outcome"),
        "help": "Serving requests by priority class (cls=p0 highest..pN "
                "lowest) and outcome: completed or the machine-readable "
                "shed reason (queue_full/load_shed/quota_exceeded/...)"},
    "lgbm_serve_staleness_seconds": {
        "type": "histogram", "labels": ("model",),
        "help": "Age of the serving generation at batch completion "
                "(now minus its publish stamp) - the model-staleness "
                "distribution the production sim reports"},
    "lgbm_policy_decisions_total": {
        "type": "counter", "labels": ("action",),
        "help": "Autoscale/shed policy transitions, action=widen/narrow/"
                "shed_on/shed_off (runtime/policy.py hysteresis "
                "controller)"},
    "lgbm_policy_window_seconds": {
        "type": "gauge", "labels": (),
        "help": "Current micro-batch gather window the policy controller "
                "has set on the serving runtime"},
    "lgbm_policy_shed_active": {
        "type": "gauge", "labels": (),
        "help": "1 while the policy holds the lowest priority class in "
                "load-shed mode, else 0"},
    "lgbm_loadgen_offered_total": {
        "type": "counter", "labels": ("cls",),
        "help": "Requests the load generator offered (open-loop "
                "arrivals), by priority class - the shed-rate "
                "denominator the sim artifact scrapes"},
    "lgbm_loadgen_verified_total": {
        "type": "counter", "labels": ("result",),
        "help": "Load-generator response verifications, result=ok/"
                "wrong_generation/mismatch/unverifiable (byte-identity "
                "vs the offline predictor for the reported generation)"},
    "lgbm_ingest_quarantined_total": {
        "type": "counter", "labels": ("reason",),
        "help": "Rows the ingest quarantine dropped before they could "
                "reach a training window, reason=nonfinite_label/"
                "nonfinite_weight/bad_query_id/column_drift "
                "(runtime/quality.py firewall stage one)"},
    "lgbm_publish_gate_total": {
        "type": "counter", "labels": ("verdict",),
        "help": "Pre-publish eval-gate decisions per cycle, verdict="
                "pass/reject/no_incumbent/no_metric/disabled (firewall "
                "stage two; a reject persists the rejected model next "
                "to the publish dir)"},
    "lgbm_canary_events_total": {
        "type": "counter", "labels": ("event",),
        "help": "Canary lifecycle events, event=start/promote/rollback "
                "(runtime/policy.CanaryPolicy; rollback also writes the "
                "durable ROLLBACK marker in the publish dir)"},
    "lgbm_canary_batches_total": {
        "type": "counter", "labels": ("kind",),
        "help": "Serving micro-batches routed while a canary window is "
                "open, kind=canary/incumbent (the canary-fraction "
                "accounting the chaos artifact scrapes)"},
    "lgbm_warmup_total": {
        "type": "counter", "labels": ("kind", "outcome"),
        "help": "Prewarm attempts by role (kind=serving/train_online) "
                "and outcome: manifest_ok, or the degradation to the "
                "legacy prewarm (manifest_missing/manifest_torn/"
                "manifest_stale/manifest_invalid/shape_mismatch/error) "
                "(runtime/warmup.py)"},
    "lgbm_warmup_seconds": {
        "type": "histogram", "labels": ("kind",),
        "help": "Wall time of one prewarm pass (manifest read + bucket "
                "precompiles before readiness opens)"},
    "lgbm_fleet_replicas": {
        "type": "gauge", "labels": ("state",),
        "help": "Serving replica processes as the fleet controller sees "
                "them, state=target/alive/ready (runtime/fleet.py "
                "control loop)"},
    "lgbm_fleet_scale_events_total": {
        "type": "counter", "labels": ("action",),
        "help": "Fleet controller actions applied, action=spawn/retire/"
                "relaunch/shed_on/shed_off (scale decisions come from "
                "runtime/policy.FleetScalePolicy)"},
    "lgbm_fleet_reaction_seconds": {
        "type": "histogram", "labels": (),
        "help": "Scale-up reaction time: first SLO-breach sample of a "
                "pressure streak to the first scrape with windowed p99 "
                "back under the SLO"},
    "lgbm_serve_resident_models": {
        "type": "gauge", "labels": (),
        "help": "Model entries currently loaded in this serving runtime "
                "(bounded by max_resident when the model-zoo residency "
                "manager is on)"},
    "lgbm_serve_residency_events_total": {
        "type": "counter", "labels": ("event",),
        "help": "Model-zoo residency transitions, event=page_in (tenant "
                "loaded on demand)/evict (LRU victim dropped, manifest "
                "exported)/defer (every resident model busy; page-in "
                "retries next poll)"},
    "lgbm_compile_cache_events_total": {
        "type": "counter", "labels": ("event",),
        "help": "Kernel build-cache traffic, event=hit (a built library "
                "found on disk)/miss (nvcc built one)/evict (LRU sweep "
                "past the size budget) (runtime/warmup.py seam over "
                "ops/build.py BUILD_DIR)"},
}

# ---------------------------------------------------------------------------
# enable flag (the hot-loop gate)
# ---------------------------------------------------------------------------

_enabled = True


def set_enabled(on: bool) -> bool:
    """Flip the whole subsystem; returns the previous state.  Disabled,
    every instrument call is one global read + an early return."""
    global _enabled
    prev = _enabled
    _enabled = bool(on)
    return prev


def enabled() -> bool:
    return _enabled


# ---------------------------------------------------------------------------
# instruments
# ---------------------------------------------------------------------------

class _Family:
    """One metric family: name + label names + children per label set.
    Children are created lazily under the lock; past `max_label_sets`
    distinct sets, the overflow child absorbs new ones."""

    kind = "untyped"

    def __init__(self, name: str, help_: str, labels: Tuple[str, ...],
                 max_label_sets: int, registry: "MetricsRegistry",
                 buckets: Tuple[float, ...] = LATENCY_BUCKETS_S):
        self.name = name
        self.help = help_
        self.label_names = tuple(labels)
        self.max_label_sets = max_label_sets
        self._registry = registry
        self._buckets = buckets
        self._lock = threading.Lock()
        self._children: Dict[Tuple[str, ...], Any] = {}

    def _key(self, labels: Dict[str, str]) -> Tuple[str, ...]:
        if set(labels) != set(self.label_names):
            raise ValueError(
                "metric %s takes labels %r, got %r"
                % (self.name, self.label_names, tuple(labels)))
        return tuple(str(labels[n]) for n in self.label_names)

    def _child(self, labels: Dict[str, str]):
        key = self._key(labels)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                if (len(self._children) >= self.max_label_sets
                        and self.label_names):
                    key = (OVERFLOW_LABEL,) * len(self.label_names)
                    child = self._children.get(key)
                    if child is not None:
                        return child
                child = self._new_child()
                self._children[key] = child
            return child

    def _new_child(self):
        raise NotImplementedError

    def items(self) -> List[Tuple[Tuple[str, ...], Any]]:
        with self._lock:
            return sorted(self._children.items())

    def clear(self) -> None:
        with self._lock:
            self._children.clear()


class _CounterChild:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0


class Counter(_Family):
    kind = "counter"

    def _new_child(self) -> _CounterChild:
        return _CounterChild()

    def inc(self, amount: float = 1.0, **labels: str) -> None:
        if not _enabled:
            return
        child = self._child(labels)
        with self._lock:
            child.value += amount
            self._registry.ops += 1

    def value(self, **labels: str) -> float:
        child = self._children.get(self._key(labels))
        return child.value if child is not None else 0.0

    def total(self) -> float:
        with self._lock:
            return sum(c.value for c in self._children.values())


class _GaugeChild:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0


class Gauge(_Family):
    kind = "gauge"

    def _new_child(self) -> _GaugeChild:
        return _GaugeChild()

    def set(self, value: float, **labels: str) -> None:
        if not _enabled:
            return
        child = self._child(labels)
        with self._lock:
            child.value = float(value)
            self._registry.ops += 1

    def inc(self, amount: float = 1.0, **labels: str) -> None:
        if not _enabled:
            return
        child = self._child(labels)
        with self._lock:
            child.value += amount
            self._registry.ops += 1

    def value(self, **labels: str) -> float:
        child = self._children.get(self._key(labels))
        return child.value if child is not None else 0.0


class _HistChild:
    __slots__ = ("counts", "sum", "count")

    def __init__(self, n_buckets: int):
        self.counts = [0] * n_buckets     # per-bucket (non-cumulative)
        self.sum = 0.0
        self.count = 0


class Histogram(_Family):
    """Bounded-memory streaming histogram: one int per fixed bucket plus
    sum/count.  `quantile(q)` is exact to within one bucket width —
    inside the resolved bucket it interpolates linearly (the Prometheus
    ``histogram_quantile`` rule), and values past the largest finite
    edge report that edge."""

    kind = "histogram"

    def _new_child(self) -> _HistChild:
        return _HistChild(len(self._buckets))

    @property
    def buckets(self) -> Tuple[float, ...]:
        return self._buckets

    def observe(self, value: float, **labels: str) -> None:
        if not _enabled:
            return
        child = self._child(labels)
        i = 0
        b = self._buckets
        while value > b[i]:               # last bucket is +Inf: always stops
            i += 1
        with self._lock:
            child.counts[i] += 1
            child.sum += value
            child.count += 1
            self._registry.ops += 1

    # -- read side -----------------------------------------------------------
    def state(self, **labels: str) -> Dict[str, Any]:
        """Aggregated (counts, sum, count) — over ALL label sets when no
        labels are given.  A copyable snapshot: diff two of these to
        scope quantiles to a measurement window."""
        with self._lock:
            if labels:
                child = self._children.get(self._key(labels))
                children = [child] if child is not None else []
            else:
                children = list(self._children.values())
            counts = [0] * len(self._buckets)
            total, cnt = 0.0, 0
            for c in children:
                for i, v in enumerate(c.counts):
                    counts[i] += v
                total += c.sum
                cnt += c.count
        return {"buckets": list(self._buckets), "counts": counts,
                "sum": total, "count": cnt}

    def quantile(self, q: float, state: Optional[Dict[str, Any]] = None,
                 **labels: str) -> Optional[float]:
        st = state if state is not None else self.state(**labels)
        return quantile_from_state(st, q)

    def bucket_width_at(self, value: float) -> float:
        """Width of the bucket `value` falls in — the quantile error
        bound at that point (the +Inf bucket reports the last finite
        width)."""
        b = self._buckets
        i = 0
        while value > b[i]:
            i += 1
        if math.isinf(b[i]):
            i = len(b) - 2
        lo = b[i - 1] if i > 0 else 0.0
        return b[i] - lo


def state_delta(after: Dict[str, Any], before: Dict[str, Any]
                ) -> Dict[str, Any]:
    """Histogram movement between two `Histogram.state()` snapshots."""
    return {
        "buckets": list(after["buckets"]),
        "counts": [a - b for a, b in zip(after["counts"], before["counts"])],
        "sum": after["sum"] - before["sum"],
        "count": after["count"] - before["count"],
    }


def quantile_from_state(state: Dict[str, Any], q: float) -> Optional[float]:
    """The q-quantile of a histogram state (None when empty): resolve
    the bucket holding rank q*count, interpolate linearly inside it."""
    count = state["count"]
    if count <= 0:
        return None
    rank = q * count
    b = state["buckets"]
    seen = 0
    for i, c in enumerate(state["counts"]):
        if seen + c >= rank and c > 0:
            lo = b[i - 1] if i > 0 else 0.0
            hi = b[i]
            if math.isinf(hi):
                return lo if i > 0 else None
            frac = (rank - seen) / c
            return lo + (hi - lo) * min(max(frac, 0.0), 1.0)
        seen += c
    # rank beyond the recorded mass (q=1.0 edge): largest finite edge hit
    for i in range(len(b) - 1, -1, -1):
        if state["counts"][i] > 0:
            return b[i] if not math.isinf(b[i]) else b[i - 1]
    return None


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

class MetricsRegistry:
    """Name -> instrument map over a declaration table.  Undeclared
    names raise — the docs drift lint is only complete if every product
    metric is table-declared."""

    _KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}

    def __init__(self, table: Optional[Dict[str, Dict[str, Any]]] = None,
                 max_label_sets: int = 64):
        self.table = METRIC_TABLE if table is None else table
        self.max_label_sets = int(max_label_sets)
        self.ops = 0                       # recorded-op count
        self._lock = threading.Lock()
        self._families: Dict[str, _Family] = {}

    def _family(self, name: str, kind: str) -> _Family:
        fam = self._families.get(name)
        if fam is not None:
            if fam.kind != kind:
                raise ValueError("metric %s is a %s, not a %s"
                                 % (name, fam.kind, kind))
            return fam
        decl = self.table.get(name)
        if decl is None:
            raise KeyError(
                "metric %r is not declared in METRIC_TABLE — declare it "
                "first" % name)
        if decl["type"] != kind:
            raise ValueError("metric %s is declared as a %s, not a %s"
                             % (name, decl["type"], kind))
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = self._KINDS[kind](
                    name, decl["help"], tuple(decl["labels"]),
                    # per-family override: the graph ledger's families
                    # carry one label set per site x event, more than the
                    # default bound
                    int(decl.get("max_label_sets", self.max_label_sets)),
                    self,
                    buckets=tuple(decl.get("buckets", LATENCY_BUCKETS_S)))
                self._families[name] = fam
        return fam

    def counter(self, name: str) -> Counter:
        return self._family(name, "counter")            # type: ignore

    def gauge(self, name: str) -> Gauge:
        return self._family(name, "gauge")              # type: ignore

    def histogram(self, name: str) -> Histogram:
        return self._family(name, "histogram")          # type: ignore

    def families(self) -> List[_Family]:
        with self._lock:
            return [self._families[n] for n in sorted(self._families)]

    def reset(self) -> None:
        """Drop every recorded value (tests, measured sections).  The
        declaration table is untouched."""
        with self._lock:
            fams = list(self._families.values())
            self.ops = 0
        for fam in fams:
            fam.clear()

    # -- export --------------------------------------------------------------
    def render_prometheus(self) -> str:
        """Prometheus text exposition format 0.0.4."""
        out: List[str] = []
        for fam in self.families():
            out.append("# HELP %s %s" % (fam.name, _esc_help(fam.help)))
            out.append("# TYPE %s %s" % (fam.name, fam.kind))
            for key, child in fam.items():
                lbl = _label_str(fam.label_names, key)
                if fam.kind == "histogram":
                    cum = 0
                    for i, edge in enumerate(fam.buckets):   # type: ignore
                        cum += child.counts[i]
                        le = "+Inf" if math.isinf(edge) else _fmt(edge)
                        out.append('%s_bucket%s %d' % (
                            fam.name,
                            _label_str(fam.label_names + ("le",),
                                       key + (le,), raw_last=True), cum))
                    out.append("%s_sum%s %s" % (fam.name, lbl,
                                                _fmt(child.sum)))
                    out.append("%s_count%s %d" % (fam.name, lbl,
                                                  child.count))
                else:
                    out.append("%s%s %s" % (fam.name, lbl,
                                            _fmt(child.value)))
        return "\n".join(out) + "\n"

    def snapshot(self, context: Optional[str] = None) -> Dict[str, Any]:
        """JSON-able dump of everything recorded (one snapshot-file line)."""
        metrics: Dict[str, Any] = {}
        for fam in self.families():
            series = []
            for key, child in fam.items():
                entry: Dict[str, Any] = {
                    "labels": dict(zip(fam.label_names, key))}
                if fam.kind == "histogram":
                    entry.update({
                        "count": child.count, "sum": round(child.sum, 9),
                        "counts": list(child.counts)})
                    for qn, q in (("p50", 0.5), ("p95", 0.95),
                                  ("p99", 0.99)):
                        v = quantile_from_state(
                            {"buckets": fam.buckets,      # type: ignore
                             "counts": child.counts, "sum": child.sum,
                             "count": child.count}, q)
                        entry[qn] = None if v is None else round(v, 9)
                else:
                    entry["value"] = child.value
                series.append(entry)
            metrics[fam.name] = {"type": fam.kind, "series": series}
        snap = {"wallclock": wallclock(), "pid": os.getpid(),
                "metrics": metrics}
        if context:
            snap["context"] = context
        return snap


def _esc_help(s: str) -> str:
    return s.replace("\\", "\\\\").replace("\n", "\\n")


def _esc_label(s: str) -> str:
    return (s.replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _fmt(v: float) -> str:
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _label_str(names: Tuple[str, ...], values: Tuple[str, ...],
               raw_last: bool = False) -> str:
    if not names:
        return ""
    parts = []
    for i, (n, v) in enumerate(zip(names, values)):
        if raw_last and i == len(names) - 1:
            parts.append('%s="%s"' % (n, v))
        else:
            parts.append('%s="%s"' % (n, _esc_label(v)))
    return "{%s}" % ",".join(parts)


#: the process-global registry every product instrument records into
REGISTRY = MetricsRegistry()


def counter(name: str) -> Counter:
    return REGISTRY.counter(name)


def gauge(name: str) -> Gauge:
    return REGISTRY.gauge(name)


def histogram(name: str) -> Histogram:
    return REGISTRY.histogram(name)


def snapshot(context: Optional[str] = None) -> Dict[str, Any]:
    return REGISTRY.snapshot(context)


def render_prometheus() -> str:
    return REGISTRY.render_prometheus()


def reset() -> None:
    REGISTRY.reset()


# ---------------------------------------------------------------------------
# aggregation across hosts: merged series carry a {host} label so a
# multi-host scrape or snapshot attributes every number
# ---------------------------------------------------------------------------

def mesh_process_count() -> int:
    """Process count of the distributed run this process is part of,
    without initializing anything: 1 unless `torch.distributed` is already
    imported and initialized."""
    torch = sys.modules.get("torch")
    if torch is None:
        return 1
    dist = getattr(torch, "distributed", None)
    if dist is None or not dist.is_available() or not dist.is_initialized():
        return 1
    return max(int(dist.get_world_size()), 1)


def gather_host_snapshots(context: Optional[str] = None,
                          registry: Optional[MetricsRegistry] = None
                          ) -> Dict[str, Dict[str, Any]]:
    """{rank: snapshot} across every process of the torch.distributed
    group (the JAX package's telemetry.py:793-): one process, or no
    group, gives the local snapshot under "0"; several exchange their
    snapshots through the group's object all-gather, so every process
    returns the full map and process 0 can export it.  It never starts
    a group.  Every rank must call it (it is a collective)."""
    reg = registry if registry is not None else REGISTRY
    local = reg.snapshot(context)
    if mesh_process_count() <= 1:
        return {"0": local}
    from ..parallel import comm
    return {str(r): snap for r, snap in
            enumerate(comm.all_gather_object(local))}


def merge_host_snapshots(hosts: Dict[str, Dict[str, Any]]
                         ) -> Dict[str, Any]:
    """One combined snapshot: every series of every host, with a
    ``host`` label prepended — the artifact a multi-host dryrun ships
    and the view a process-0 /metrics scrape serves."""
    merged_metrics: Dict[str, Any] = {}
    for host in sorted(hosts, key=lambda h: (len(h), h)):
        snap = hosts[host]
        for name, fam in snap.get("metrics", {}).items():
            slot = merged_metrics.setdefault(
                name, {"type": fam["type"], "series": []})
            for entry in fam["series"]:
                e = dict(entry)
                e["labels"] = dict({"host": host}, **entry.get("labels", {}))
                slot["series"].append(e)
    return {"wallclock": wallclock(), "hosts": sorted(hosts),
            "metrics": merged_metrics}


def mesh_snapshot(context: Optional[str] = None,
                  registry: Optional[MetricsRegistry] = None
                  ) -> Dict[str, Any]:
    """Gather + merge in one call (every process gets the merged view)."""
    return merge_host_snapshots(gather_host_snapshots(context, registry))


def render_prometheus_from_snapshot(snap: Dict[str, Any],
                                    table: Optional[Dict[str, Any]] = None
                                    ) -> str:
    """Prometheus text exposition from a (possibly merged, {host}-
    labeled) snapshot dict.  Histogram bucket edges come from the
    METRIC_TABLE declaration (all product histograms ride the one fixed
    layout); unknown names fall back to `LATENCY_BUCKETS_S`."""
    table = METRIC_TABLE if table is None else table
    out: List[str] = []
    for name in sorted(snap.get("metrics", {})):
        fam = snap["metrics"][name]
        decl = table.get(name, {})
        out.append("# HELP %s %s" % (name, _esc_help(
            decl.get("help", "(undeclared)"))))
        out.append("# TYPE %s %s" % (name, fam["type"]))
        for entry in fam["series"]:
            labels = entry.get("labels", {})
            names = tuple(labels)
            values = tuple(str(labels[k]) for k in names)
            lbl = _label_str(names, values)
            if fam["type"] == "histogram":
                edges = tuple(decl.get("buckets", LATENCY_BUCKETS_S))
                cum = 0
                for i, edge in enumerate(edges):
                    cum += entry["counts"][i] \
                        if i < len(entry.get("counts", [])) else 0
                    le = "+Inf" if math.isinf(edge) else _fmt(edge)
                    out.append("%s_bucket%s %d" % (
                        name, _label_str(names + ("le",), values + (le,),
                                         raw_last=True), cum))
                out.append("%s_sum%s %s" % (name, lbl, _fmt(entry["sum"])))
                out.append("%s_count%s %d" % (name, lbl, entry["count"]))
            else:
                out.append("%s%s %s" % (name, lbl, _fmt(entry["value"])))
    return "\n".join(out) + "\n"


def count_sync(label: str, critical: bool) -> None:
    """Sync-audit bridge (called by runtime/syncs.record for every
    blocking host fetch)."""
    if not _enabled:
        return
    REGISTRY.counter("lgbm_host_syncs_total").inc(label=label)
    if critical:
        REGISTRY.counter("lgbm_host_syncs_critical_total").inc(label=label)


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------

_DIGITS = re.compile(r"\d+")

#: ``key=<digits>`` pairs whose digits SURVIVE normalization: these are
#: bounded product parameters (the boost-window length, the pipeline
#: depth) whose value IS the series identity — collapsing them merged
#: e.g. the J=2 and J=4 window-dispatch stages into one metric series.
#: Unbounded identifiers (cycle/gen/rows counts)
#: stay normalized: only keys listed here escape, so cardinality stays
#: bounded by the small set of legal values those knobs take.
SPAN_KEEP_KEYS: Tuple[str, ...] = ("J", "depth", "window", "K")

#: one alternation, tried left to right: a ``key=value`` token for an
#: allowlisted key is consumed whole (and kept verbatim); any other
#: digit run collapses to ``N``.
_NORM = re.compile(r"\b(?:%s)=\d{1,4}\b|\d+" % "|".join(SPAN_KEEP_KEYS))


def normalize_span_name(name: str, max_len: int = 80) -> str:
    """Digit runs -> ``N`` and a hard length cap, so per-cycle /
    per-batch stage names ("cycle 17: train", "batch ... rows=512")
    collapse to a bounded family of span names — EXCEPT ``key=value``
    digits for the `SPAN_KEEP_KEYS` product parameters, which stay
    distinguishable ("window dispatch J=4" vs "J=2" are different
    stages, not two samples of one)."""
    return _NORM.sub(lambda m: m.group(0) if "=" in m.group(0) else "N",
                     name)[:max_len]


def record_span(name: str, dur_s: float, status: str = "ok",
                trace: bool = True) -> None:
    """One completed span on the shared clock.  The stage-trail watchdog
    calls this at every stage close.  The RAW name also lands in the
    trace flight recorder (`trace=False` for callers that already
    recorded the trace event themselves — the `span` context manager)."""
    if not _enabled:
        return
    key = normalize_span_name(name)
    REGISTRY.histogram("lgbm_span_seconds").observe(max(dur_s, 0.0),
                                                    span=key)
    REGISTRY.counter("lgbm_spans_total").inc(span=key, status=status)
    if trace:
        now = time.monotonic_ns()
        dur_ns = int(max(dur_s, 0.0) * 1e9)
        tracing.record(name, now - dur_ns, dur_ns, status=status)


@contextlib.contextmanager
def span(name: str):
    """Context-manager span: records duration + ok/error status into the
    registry AND opens a causal trace span (children recorded inside the
    scope parent under it)."""
    t0 = time.monotonic()
    try:
        with tracing.span(name):
            yield
    except BaseException:
        record_span(name, time.monotonic() - t0, status="error",
                    trace=False)
        raise
    record_span(name, time.monotonic() - t0, status="ok", trace=False)


# ---------------------------------------------------------------------------
# per-iteration training instrumentation (the Booster.update seam)
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def train_iteration(device=None):
    """Wraps one boosting iteration: wall time into the iteration
    histogram, the iteration counter, the per-iteration sync gauges
    (total and critical path) and the training profiler hook (with CUDA
    activity when `device` is the card)."""
    if not _enabled:
        yield
        return
    from . import syncs
    hook = profile_hook("train")
    hook.tick(device)
    s0 = syncs.snapshot()
    t0 = time.monotonic()
    # one causal slice per boosting iteration: the tree dispatch marks
    # are recorded inside it
    try:
        with tracing.span("train/iteration"):
            yield
    finally:
        hook.tock()
    dt = time.monotonic() - t0
    d = syncs.delta(s0)
    REGISTRY.histogram("lgbm_train_iteration_seconds").observe(dt)
    REGISTRY.counter("lgbm_train_iterations_total").inc()
    g = REGISTRY.gauge("lgbm_train_host_syncs_per_iter")
    g.set(d["total"], path="total")
    g.set(d["critical_path"], path="critical")


# ---------------------------------------------------------------------------
# HTTP exporter (GET /metrics)
# ---------------------------------------------------------------------------

class MetricsServer:
    """Prometheus scrape endpoint over the stdlib HTTP server.  Serves
    ``/metrics`` (text exposition), ``/metrics.json`` (snapshot) and
    ``/healthz``; runs on a daemon thread, `stop()` shuts it down."""

    def __init__(self, port: int = 0, host: str = "127.0.0.1",
                 registry: Optional[MetricsRegistry] = None,
                 health_provider: Optional[Any] = None):
        """`health_provider`: optional zero-arg callable; while it returns
        falsy, ``/healthz`` answers 503 ``warming`` instead of 200 ``ok``
        (the serving runtime's prewarm-before-admit readiness gate)."""
        import http.server

        reg = registry if registry is not None else REGISTRY

        class _Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self) -> None:            # noqa: N802 — stdlib API
                path = self.path.split("?", 1)[0]
                status = 200
                if path == "/metrics":
                    body = reg.render_prometheus().encode("utf-8")
                    ctype = "text/plain; version=0.0.4; charset=utf-8"
                elif path == "/metrics.json":
                    body = (json.dumps(reg.snapshot()) + "\n").encode("utf-8")
                    ctype = "application/json"
                elif path == "/healthz":
                    healthy = True
                    if health_provider is not None:
                        try:
                            healthy = bool(health_provider())
                        except Exception:   # noqa: BLE001 — gate, not crash
                            healthy = False
                    body = b"ok\n" if healthy else b"warming\n"
                    status = 200 if healthy else 503
                    ctype = "text/plain"
                else:
                    self.send_response(404)
                    self.end_headers()
                    return
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, fmt, *args) -> None:
                pass                              # scrapes are not stderr news

        class _Server(http.server.ThreadingHTTPServer):
            daemon_threads = True
            allow_reuse_address = True

        self.registry = reg
        self._httpd = _Server((host, int(port)), _Handler)
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, kwargs={"poll_interval": 0.2},
            name="lgbm-metrics-http", daemon=True)
        self._thread.start()

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)


def start_http_server(port: int = 0, host: str = "127.0.0.1",
                      registry: Optional[MetricsRegistry] = None,
                      health_provider: Optional[Any] = None
                      ) -> MetricsServer:
    return MetricsServer(port=port, host=host, registry=registry,
                         health_provider=health_provider)


# ---------------------------------------------------------------------------
# JSON-lines snapshot file ($LGBM_TPU_METRICS_FILE)
# ---------------------------------------------------------------------------

METRICS_FILE_ENV = "LGBM_TPU_METRICS_FILE"
METRICS_INTERVAL_ENV = "LGBM_TPU_METRICS_INTERVAL"

#: snapshot lines kept per file (the file is a rolling window, not an
#: unbounded log; each flush rewrites it atomically)
SNAPSHOT_KEEP_LAST = 256


class MetricsFileWriter:
    """Periodic atomic JSON-lines snapshots for batch runs.  Every flush
    rewrites the WHOLE file via tmp+fsync+rename (`atomic_write`), so a
    concurrent scraper reads either the previous window or the new one,
    never a torn line — plain append could tear mid-line."""

    def __init__(self, path: str, interval_s: float = 30.0,
                 context: Optional[str] = None,
                 registry: Optional[MetricsRegistry] = None):
        self.path = path
        self.interval_s = float(interval_s)
        self.context = context
        self.registry = registry if registry is not None else REGISTRY
        self._lines: "collections.deque[str]" = collections.deque(
            maxlen=SNAPSHOT_KEEP_LAST)
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        if self.interval_s > 0:
            self._thread = threading.Thread(target=self._loop,
                                            name="lgbm-metrics-file",
                                            daemon=True)
            self._thread.start()

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.write_now()
            except OSError:
                pass                    # export must never take the run down

    def write_now(self, context: Optional[str] = None) -> None:
        """Append one snapshot line and atomically rewrite the file.  On
        a multi-process run (mesh_process_count() > 1) the line is
        the MERGED mesh snapshot with {host}-labeled series — process 0
        ships the whole mesh's numbers in its file."""
        if mesh_process_count() > 1:
            snap = mesh_snapshot(context or self.context, self.registry)
        else:
            snap = self.registry.snapshot(context or self.context)
        with self._lock:
            self._lines.append(json.dumps(snap))
            atomic_write(self.path, "\n".join(self._lines) + "\n")

    def stop(self, final_flush: bool = True) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
        if final_flush:
            try:
                self.write_now()
            except OSError:
                pass


_file_writer: Optional[MetricsFileWriter] = None
_file_writer_lock = threading.Lock()


def maybe_start_file_export(context: Optional[str] = None
                            ) -> Optional[MetricsFileWriter]:
    """Start (once per process) the periodic snapshot writer when
    ``$LGBM_TPU_METRICS_FILE`` is set; interval from
    ``$LGBM_TPU_METRICS_INTERVAL`` (seconds, default 30).  Returns the
    writer, or None when the env var is unset."""
    global _file_writer
    path = os.environ.get(METRICS_FILE_ENV)
    if not path:
        return None
    with _file_writer_lock:
        if _file_writer is None or _file_writer.path != path:
            interval = float(os.environ.get(METRICS_INTERVAL_ENV, "30"))
            _file_writer = MetricsFileWriter(path, interval_s=interval,
                                             context=context)
    return _file_writer


def write_snapshot_now(context: Optional[str] = None) -> Optional[str]:
    """One-shot snapshot flush (a run's exit path): writes through
    the active writer, creating one (interval 0 = no background thread)
    if the env var is set and none exists.  Returns the path written."""
    writer = maybe_start_file_export(context)
    if writer is None:
        return None
    writer.write_now(context)
    return writer.path


# ---------------------------------------------------------------------------
# device-profiler hook (LGBM_TPU_PROFILE=<dir>)
# ---------------------------------------------------------------------------

PROFILE_ENV = "LGBM_TPU_PROFILE"
PROFILE_ITERS_ENV = "LGBM_TPU_PROFILE_ITERS"
PROFILE_BATCHES_ENV = "LGBM_TPU_PROFILE_BATCHES"


class _ProfilerHook:
    """Wraps the first N ticks (training iterations) of the process in ONE
    `torch.profiler` trace, written as Chrome trace JSON under
    ``$LGBM_TPU_PROFILE/<kind>`` (``trace_<pid>.json``).  `tick` opens the
    trace at the first tick: CUDA activity (the card's kernels, copies and
    the runtime calls that launched them) when the tick's device is the
    card, else CPU activity (a main-path iteration on the card enqueues
    ~90k host ops, and a trace holding them takes minutes to read);
    `tock`, at the end of the tick's work, closes it once N ticks have
    run.  One-shot per kind per process.  A
    profiler that raises disables the hook with a warning on stderr and in
    the log: profiling is diagnostics, and the run goes on unprofiled
    where it was."""

    def __init__(self, kind: str, limit_env: str, default_limit: int):
        self.kind = kind
        self.dir = os.environ.get(PROFILE_ENV) or None
        self.limit = int(os.environ.get(limit_env, default_limit)) \
            if self.dir else 0
        self.ticks = 0
        self.active = False
        self.done = self.dir is None
        self.path: Optional[str] = None
        self.cuda = False
        #: seconds the profiler took to stop and to write the trace
        self.stop_s = self.export_s = None
        self._prof = None
        self._lock = threading.Lock()

    def _warn(self, what: str, e: BaseException) -> None:
        self.done = True
        self.active = False
        self._prof = None
        msg = ("telemetry WARNING: profiler hook disabled at %s (%s: %s); "
               "training continues unprofiled" % (what, type(e).__name__, e))
        sys.stderr.write("[%s] %s\n" % (wallclock(), msg))
        from ..utils.log import Log
        Log.warning(msg)

    def tick(self, device=None) -> None:
        if self.done:
            return
        with self._lock:
            if self.done:
                return
            if not self.active:
                try:
                    import torch.profiler as tp
                    out = os.path.join(self.dir, self.kind)
                    os.makedirs(out, exist_ok=True)
                    self.cuda = getattr(device, "type", None) == "cuda"
                    self._prof = tp.profile(activities=[
                        tp.ProfilerActivity.CUDA if self.cuda
                        else tp.ProfilerActivity.CPU])
                    self._prof.start()
                    self.path = os.path.join(out, "trace_%d.json"
                                             % os.getpid())
                    self.active = True
                    sys.stderr.write(
                        "[%s] telemetry: torch.profiler trace started for "
                        "%d %s ticks (%s) -> %s\n"
                        % (wallclock(), self.limit, self.kind,
                           "CUDA" if self.cuda else "CPU", self.path))
                except Exception as e:       # noqa: BLE001 — diagnostics
                    self._warn("start", e)
                    return
            self.ticks += 1

    def tock(self) -> None:
        if not self.active or self.ticks < self.limit:
            return
        with self._lock:
            if not self.active:
                return
            try:
                t0 = time.perf_counter()
                self._prof.stop()
                t1 = time.perf_counter()
                self._prof.export_chrome_trace(self.path)
                self.stop_s = t1 - t0
                self.export_s = time.perf_counter() - t1
                self.active = False
                self.done = True
                self._prof = None
                sys.stderr.write(
                    "[%s] telemetry: torch.profiler trace closed after %d "
                    "%s ticks (stop %.3f s, export %.3f s) -> %s\n"
                    % (wallclock(), self.ticks, self.kind, self.stop_s,
                       self.export_s, self.path))
            except Exception as e:           # noqa: BLE001 — diagnostics
                self._warn("stop", e)


_hooks: Dict[str, _ProfilerHook] = {}
_hooks_lock = threading.Lock()


def profile_hook(kind: str) -> _ProfilerHook:
    """The per-process profiler hook for `kind` ("train" ticks per
    boosting iteration, ``$LGBM_TPU_PROFILE_ITERS`` of them; "serve" per
    device-served batch, ``$LGBM_TPU_PROFILE_BATCHES``)."""
    hook = _hooks.get(kind)
    if hook is None:
        with _hooks_lock:
            hook = _hooks.get(kind)
            if hook is None:
                if kind not in ("train", "serve"):
                    raise ValueError("unknown profile hook %r (train or "
                                     "serve)" % (kind,))
                env, dflt = ((PROFILE_ITERS_ENV, 5) if kind == "train"
                             else (PROFILE_BATCHES_ENV, 20))
                hook = _ProfilerHook(kind, env, dflt)
                _hooks[kind] = hook
    return hook


def _reset_profile_hooks() -> None:
    """Test seam: re-read the profiler environment."""
    with _hooks_lock:
        _hooks.clear()
