"""The trace flight recorder (counterpart of lightgbm_tpu/runtime/tracing.py).

A bounded ring of structured trace events, plus the plumbing that lets
one training iteration be followed across threads and processes:

* **Events** carry ``trace_id`` / ``span_id`` / ``parent_id`` (W3C-sized
  hex ids), a monotonic-ns timestamp, the recording thread and free
  labels.  The ring is bounded (`TRACE_RING_EVENTS`); overflow drops the
  OLDEST events and counts them, so the recorder always holds the most
  recent window.
* **Context propagation.**  A thread-local span stack is the ambient
  parent; `context()` captures it for another thread and `attach(ctx)` /
  `bind(fn, ...)` restore it there.  Across processes the context travels
  as a ``traceparent`` string (``00-<trace>-<span>-01``), and
  ``$LGBM_TPU_TRACEPARENT`` seeds a subprocess's root context.
* **Exporters.**  `export_chrome()` renders the ring as Chrome trace-event
  JSON (Perfetto-loadable: one process track per pid, one row per thread,
  flow arrows), timestamps on the absolute unix clock through a
  per-process (unix_ns, monotonic_ns) anchor, so `merge_traces()` fuses N
  per-process files into one timeline.  ``$LGBM_TPU_TRACE_DIR`` arms an
  atexit dump (``trace_<host>_<pid>.json``) in every process that imports
  the runtime's telemetry.

Every recording call checks the module's enable flag first, so with
tracing off (``LGBM_TPU_TRACE=0`` or `set_enabled(False)`) each site costs
one global read and a return.  The training engine records a ``tree
dispatch`` instant per tree (`boosting/gbdt.py`) inside the
``train/iteration`` span of `telemetry.train_iteration`; the graph ledger
records each CUDA graph capture and kernel build on its own ``graph
capture`` row (`runtime/graph_obs.py`).  No torch or numpy at module
scope.
"""
from __future__ import annotations

import atexit
import collections
import contextlib
import json
import os
import socket
import struct
import threading
import time
import zlib
from typing import Any, Dict, Iterable, List, Optional, Tuple

from .resilience import atomic_write

__all__ = [
    "TRACE_RING_EVENTS", "TRACE_DIR_ENV", "TRACEPARENT_ENV",
    "TRACE_ENABLED_ENV",
    "set_enabled", "enabled", "reset", "set_context",
    "span", "instant", "record", "counter_event",
    "current", "current_traceparent", "context", "attach", "bind",
    "make_traceparent", "parse_traceparent", "process_root",
    "flow_id", "flow_start", "flow_end",
    "export_chrome", "export_to_dir", "merge_traces", "ring_summary",
    "maybe_autostart",
]

#: ring capacity (events per process).  ~200 bytes/event in memory: the
#: default bounds the recorder near 12 MB however long the process runs.
TRACE_RING_EVENTS = int(os.environ.get("LGBM_TPU_TRACE_RING", "65536"))

#: directory the atexit exporter dumps this process's ring into
#: (``trace_<host>_<pid>.json``); unset = no automatic dump.
TRACE_DIR_ENV = "LGBM_TPU_TRACE_DIR"

#: cross-process context seed: a child launched with this env var set
#: parents its root spans under the caller's span.
TRACEPARENT_ENV = "LGBM_TPU_TRACEPARENT"

#: kill switch: "0" disables every recording call at the one-global-read
#: cost (the <1% disabled-path pin covers this path).
TRACE_ENABLED_ENV = "LGBM_TPU_TRACE"

#: hard cap on label values embedded in events (they become export JSON)
_LABEL_MAX_CHARS = 200

# ---------------------------------------------------------------------------
# enable flag + clock anchor
# ---------------------------------------------------------------------------

_enabled = os.environ.get(TRACE_ENABLED_ENV, "1") != "0"

#: the absolute-clock anchor: every event timestamp is monotonic ns, and
#: export maps it to unix ns through this pair — so traces from
#: different processes (or hosts sharing wall clocks) merge onto one
#: timeline without negotiation.
_ANCHOR_MONO_NS = time.monotonic_ns()
_ANCHOR_UNIX_NS = time.time_ns()


def set_enabled(on: bool) -> bool:
    """Flip the recorder; returns the previous state.  Disabled, every
    recording call is one global read + an early return."""
    global _enabled
    prev = _enabled
    _enabled = bool(on)
    return prev


def enabled() -> bool:
    return _enabled


def mono_to_unix_ns(t_ns: int) -> int:
    return _ANCHOR_UNIX_NS + (t_ns - _ANCHOR_MONO_NS)


# ---------------------------------------------------------------------------
# ids + traceparent
# ---------------------------------------------------------------------------

_id_lock = threading.Lock()
_id_state = struct.unpack("<Q", os.urandom(8))[0] | 1


def _next_id64() -> int:
    """Cheap process-unique 64-bit id stream (splitmix64): one lock'd
    integer step beats an os.urandom syscall on the request path."""
    global _id_state
    with _id_lock:
        _id_state = (_id_state + 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
        z = _id_state
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return (z ^ (z >> 31)) or 1


def new_span_id() -> str:
    return "%016x" % _next_id64()


def new_trace_id() -> str:
    return "%016x%016x" % (_next_id64(), _next_id64())


def make_traceparent(trace_id: str, span_id: str) -> str:
    """W3C-shaped header value: ``00-<32 hex>-<16 hex>-01``."""
    return "00-%s-%s-01" % (trace_id, span_id)


def parse_traceparent(value: Any) -> Optional[Tuple[str, str]]:
    """(trace_id, span_id) from a traceparent string, or None when the
    value is absent/malformed — a bad header is dropped, never raised."""
    if not isinstance(value, str):
        return None
    parts = value.strip().lower().split("-")
    if len(parts) < 3:
        return None
    trace_id, span_id = parts[1], parts[2]
    if len(trace_id) != 32 or len(span_id) != 16:
        return None
    try:
        int(trace_id, 16), int(span_id, 16)
    except ValueError:
        return None
    if int(trace_id, 16) == 0 or int(span_id, 16) == 0:
        return None
    return trace_id, span_id


# ---------------------------------------------------------------------------
# the ring
# ---------------------------------------------------------------------------

class _Ring:
    """Bounded event store.  Each event is appended as ONE fully-built
    dict (deque.append is atomic under the GIL), so concurrent writers
    can never tear an event; ordering is restored at export time by a
    sort on the monotonic timestamp.  `dropped` counts overflow."""

    def __init__(self, maxlen: int):
        self._events: "collections.deque[dict]" = collections.deque(
            maxlen=maxlen)
        self.maxlen = maxlen
        self.total = 0          # events ever recorded (bench events/iter)
        self._lock = threading.Lock()

    def append(self, ev: dict) -> None:
        # total is advisory (bench denominator) — the append itself must
        # stay a single atomic deque op on the hot path
        self._events.append(ev)
        self.total += 1

    @property
    def dropped(self) -> int:
        return max(self.total - len(self._events), 0)

    def snapshot(self) -> List[dict]:
        with self._lock:
            return list(self._events)

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self.total = 0


_RING = _Ring(TRACE_RING_EVENTS)

# thread bookkeeping: tid -> thread name at first event (export metadata)
_thread_names: Dict[int, str] = {}

#: synthetic track registry: track name -> stable synthetic tid (export
#: emits a thread_name metadata row per track).  Used for events that
#: should render on their own Perfetto row (the graph capture track)
#: rather than on the recording thread's.
_tracks: Dict[str, int] = {}
_tracks_lock = threading.Lock()


def _track_tid(name: str) -> int:
    tid = _tracks.get(name)
    if tid is None:
        with _tracks_lock:
            tid = _tracks.get(name)
            if tid is None:
                tid = 0x7FFF0000 + len(_tracks)
                _tracks[name] = tid
    return tid


def _tid() -> int:
    t = threading.current_thread()
    tid = t.ident or 0
    if tid not in _thread_names:
        _thread_names[tid] = t.name
    return tid


def _clean_labels(labels: Dict[str, Any]) -> Dict[str, Any]:
    out = {}
    for k, v in labels.items():
        if isinstance(v, (int, float, bool)) or v is None:
            out[k] = v
        else:
            out[k] = str(v)[:_LABEL_MAX_CHARS]
    return out


# ---------------------------------------------------------------------------
# context
# ---------------------------------------------------------------------------

_tls = threading.local()

_proc_root: Optional[Tuple[str, str]] = None
_proc_root_read = False


def process_root() -> Optional[Tuple[str, str]]:
    """The context ``$LGBM_TPU_TRACEPARENT`` seeded this process with
    (None when unset/malformed): the ambient parent of any root span
    opened before an explicit context exists — a subprocess's first
    spans link back to the launcher that set the env var."""
    global _proc_root, _proc_root_read
    if not _proc_root_read:
        _proc_root = parse_traceparent(os.environ.get(TRACEPARENT_ENV))
        _proc_root_read = True
    return _proc_root


def _stack() -> list:
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


def current() -> Optional[Tuple[str, str]]:
    """(trace_id, span_id) of the innermost open span on this thread —
    falling back to an attached context, then the process root."""
    st = _stack()
    if st:
        return st[-1]
    return process_root()


def current_traceparent() -> Optional[str]:
    ctx = current()
    return make_traceparent(*ctx) if ctx is not None else None


def context() -> Optional[Tuple[str, str]]:
    """Capture the current context for hand-off to another thread."""
    return current()


def thread_context() -> Optional[Tuple[str, str]]:
    """The innermost open span on this thread only, with no process-root
    fallback: per-item consumers (the serving per-request tracer) use it
    so an ambient ``$LGBM_TPU_TRACEPARENT`` does not turn every request
    into a traced one."""
    st = _stack()
    return st[-1] if st else None


@contextlib.contextmanager
def attach(ctx: Optional[Tuple[str, str]]):
    """Adopt a captured (or parsed-traceparent) context as this thread's
    ambient parent for the scope.  ``attach(None)`` is a no-op scope."""
    if ctx is None:
        yield
        return
    st = _stack()
    st.append((ctx[0], ctx[1]))
    try:
        yield
    finally:
        st.pop()


def bind(fn, name: Optional[str] = None, **labels):
    """Wrap `fn` so it runs under THIS thread's current context when
    invoked later on another thread (the assembler hand-off seam).  With
    a `name`, the invocation is additionally recorded as a span.
    Disabled, returns `fn` unchanged — zero indirection on the off
    path."""
    if not _enabled:
        return fn
    ctx = context()
    if ctx is None and name is None:
        return fn

    def bound(*a, **k):
        with attach(ctx):
            if name is not None:
                with span(name, **labels):
                    return fn(*a, **k)
            return fn(*a, **k)
    return bound


# ---------------------------------------------------------------------------
# recording
# ---------------------------------------------------------------------------

def record(name: str, t0_ns: int, dur_ns: int, *,
           trace: Optional[str] = None, span_id: Optional[str] = None,
           parent: Optional[str] = None, status: str = "ok",
           track: Optional[str] = None, **labels) -> None:
    """Retro-record one COMPLETED span (watchdog stage closes and graph
    captures arrive after the fact, with a duration already in hand).
    Context defaults to the thread's current context; `track` renders
    the event on a named synthetic Perfetto row instead of the recording
    thread's."""
    if not _enabled:
        return
    ctx = current()
    if trace is None:
        trace = ctx[0] if ctx is not None else None
    if parent is None and ctx is not None:
        parent = ctx[1]
    ev: Dict[str, Any] = {
        "ph": "X", "name": str(name)[:_LABEL_MAX_CHARS],
        "t_ns": int(t0_ns), "dur_ns": max(int(dur_ns), 0),
        "tid": _track_tid(track) if track else _tid(),
    }
    if trace:
        ev["trace"] = trace
    ev["span"] = span_id or new_span_id()
    if parent:
        ev["parent"] = parent
    if status != "ok":
        ev["status"] = status
    if labels:
        ev["args"] = _clean_labels(labels)
    _RING.append(ev)


@contextlib.contextmanager
def span(name: str, **labels):
    """Open a live span: a child of the current context (or a fresh
    trace root when there is none), ambient for everything recorded in
    the scope, one 'X' event at close carrying ok/error status."""
    if not _enabled:
        yield None
        return
    ctx = current()
    trace = ctx[0] if ctx is not None else new_trace_id()
    parent = ctx[1] if ctx is not None else None
    sid = new_span_id()
    st = _stack()
    st.append((trace, sid))
    t0 = time.monotonic_ns()
    status = "ok"
    try:
        yield (trace, sid)
    except BaseException:
        status = "error"
        raise
    finally:
        st.pop()
        record(name, t0, time.monotonic_ns() - t0, trace=trace,
               span_id=sid, parent=parent, status=status, **labels)


def instant(name: str, track: Optional[str] = None, **labels) -> None:
    """One point-in-time event under the current context."""
    if not _enabled:
        return
    ctx = current()
    ev: Dict[str, Any] = {
        "ph": "i", "name": str(name)[:_LABEL_MAX_CHARS],
        "t_ns": time.monotonic_ns(),
        "tid": _track_tid(track) if track else _tid(),
    }
    if ctx is not None:
        ev["trace"], ev["parent"] = ctx
    if labels:
        ev["args"] = _clean_labels(labels)
    _RING.append(ev)


def counter_event(name: str, value: float, track: str = "counters") -> None:
    """One Perfetto counter sample (renders as a little graph row)."""
    if not _enabled:
        return
    _RING.append({"ph": "C", "name": str(name)[:_LABEL_MAX_CHARS],
                  "t_ns": time.monotonic_ns(),
                  "tid": _track_tid(track), "value": float(value)})


# -- flow links (publish -> subscriber arrows) ------------------------------

def flow_id(*parts: Any) -> int:
    """Stable flow id from the parts both ends of a link know (e.g. the
    publishing cycle's traceparent + the generation number)."""
    return zlib.crc32("|".join(str(p) for p in parts).encode("utf-8"))


def flow_start(name: str, fid: int, **labels) -> None:
    """Source end of a Perfetto flow arrow (the publish side)."""
    if not _enabled:
        return
    ctx = current()
    ev: Dict[str, Any] = {"ph": "s", "name": str(name)[:_LABEL_MAX_CHARS],
                          "t_ns": time.monotonic_ns(), "tid": _tid(),
                          "flow": int(fid)}
    if ctx is not None:
        ev["trace"], ev["parent"] = ctx
    if labels:
        ev["args"] = _clean_labels(labels)
    _RING.append(ev)


def flow_end(name: str, fid: int, **labels) -> None:
    """Sink end of a flow arrow (the subscriber swap-in side)."""
    if not _enabled:
        return
    ctx = current()
    ev: Dict[str, Any] = {"ph": "f", "name": str(name)[:_LABEL_MAX_CHARS],
                          "t_ns": time.monotonic_ns(), "tid": _tid(),
                          "flow": int(fid)}
    if ctx is not None:
        ev["trace"], ev["parent"] = ctx
    if labels:
        ev["args"] = _clean_labels(labels)
    _RING.append(ev)


# ---------------------------------------------------------------------------
# export
# ---------------------------------------------------------------------------

_context_name: Optional[str] = None


def set_context(name: str) -> None:
    """Name this process's role ("train_online", "replica_binary") for
    export headers and {host,pid} track labels — the atexit dump uses it
    when no explicit context is passed."""
    global _context_name
    _context_name = str(name)


def ring_summary() -> Dict[str, Any]:
    evs = _RING.snapshot()
    return {"events": len(evs), "recorded_total": _RING.total,
            "dropped": _RING.dropped, "capacity": _RING.maxlen,
            "threads": len({e["tid"] for e in evs}),
            "traces": len({e.get("trace") for e in evs} - {None})}


def export_chrome(path: Optional[str] = None,
                  context_name: Optional[str] = None) -> Dict[str, Any]:
    """The ring as Chrome trace-event JSON (Perfetto's legacy-JSON
    loader).  Timestamps are ABSOLUTE unix microseconds via the anchor
    pair, so per-process files merge by concatenation; `merge_traces`
    only has to relabel tracks.  With `path`, the JSON is also written
    atomically."""
    pid = os.getpid()
    host = socket.gethostname()
    if context_name is None:
        context_name = _context_name
    events: List[Dict[str, Any]] = []
    proc_label = "%s pid=%d%s" % (host, pid,
                                  " (%s)" % context_name if context_name
                                  else "")
    events.append({"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
                   "args": {"name": proc_label}})
    raw = sorted(_RING.snapshot(), key=lambda e: e["t_ns"])
    tids = {e["tid"] for e in raw}
    track_by_tid = {tid: name for name, tid in _tracks.items()}
    for tid in sorted(tids):
        tname = track_by_tid.get(tid) or _thread_names.get(tid) \
            or "thread-%d" % tid
        events.append({"ph": "M", "name": "thread_name", "pid": pid,
                       "tid": tid, "args": {"name": tname}})
    for e in raw:
        ts_us = mono_to_unix_ns(e["t_ns"]) / 1000.0
        out: Dict[str, Any] = {"ph": e["ph"], "name": e["name"],
                               "pid": pid, "tid": e["tid"],
                               "ts": round(ts_us, 3)}
        if e["ph"] == "X":
            out["dur"] = round(e["dur_ns"] / 1000.0, 3)
        if e["ph"] == "i":
            out["s"] = "t"
        if e["ph"] in ("s", "f"):
            out["id"] = "0x%x" % e["flow"]
            out["cat"] = "link"
            if e["ph"] == "f":
                out["bp"] = "e"
        if e["ph"] == "C":
            out["args"] = {"value": e["value"]}
        else:
            args = dict(e.get("args", {}))
            for key in ("trace", "span", "parent", "status"):
                if key in e:
                    args[key] = e[key]
            if args:
                out["args"] = args
        events.append(out)
    doc = {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {
            "host": host, "pid": pid,
            "anchor_unix_ns": _ANCHOR_UNIX_NS,
            "recorded_total": _RING.total,
            "dropped": _RING.dropped,
            "traceparent_env": os.environ.get(TRACEPARENT_ENV),
        },
    }
    if context_name:
        doc["otherData"]["context"] = context_name
    if path:
        atomic_write(path, json.dumps(doc) + "\n")
    return doc


def export_to_dir(trace_dir: Optional[str] = None,
                  context_name: Optional[str] = None) -> Optional[str]:
    """Dump this process's ring into `trace_dir` (default: the
    ``$LGBM_TPU_TRACE_DIR`` env) as ``trace_<host>_<pid>.json``; returns
    the path, or None when no directory is configured."""
    trace_dir = trace_dir or os.environ.get(TRACE_DIR_ENV)
    if not trace_dir:
        return None
    try:
        os.makedirs(trace_dir, exist_ok=True)
        path = os.path.join(trace_dir, "trace_%s_%d.json"
                            % (socket.gethostname(), os.getpid()))
        export_chrome(path, context_name=context_name)
        return path
    except OSError:
        return None                      # diagnostics must never crash exit


def merge_traces(paths: Iterable[str], out_path: Optional[str] = None,
                 max_events: Optional[int] = None) -> Dict[str, Any]:
    """Fuse N per-process Chrome trace files into ONE timeline.

    Every input already carries absolute-unix timestamps (the anchor
    seam), so fusing is: re-key each file onto a unique pid slot (two
    replicas on one host can share a real pid across time), keep its
    ``{host,pid}`` process_name, concatenate, and sort.  `max_events`
    (slices, newest kept) bounds a committed artifact's size — the cut
    is recorded in otherData, never silent."""
    merged: List[Dict[str, Any]] = []
    sources: List[Dict[str, Any]] = []
    for slot, path in enumerate(sorted(paths)):
        with open(path) as fh:
            doc = json.load(fh)
        other = doc.get("otherData", {})
        sources.append({"file": os.path.basename(path),
                        "host": other.get("host"),
                        "pid": other.get("pid"),
                        "dropped": other.get("dropped", 0),
                        "context": other.get("context")})
        for ev in doc.get("traceEvents", []):
            ev = dict(ev)
            ev["pid"] = slot + 1
            merged.append(ev)
    meta = [e for e in merged if e.get("ph") == "M"]
    body = sorted((e for e in merged if e.get("ph") != "M"),
                  key=lambda e: e.get("ts", 0.0))
    truncated = 0
    if max_events is not None and len(body) > max_events:
        truncated = len(body) - max_events
        body = body[-max_events:]
    doc = {"traceEvents": meta + body, "displayTimeUnit": "ms",
           "otherData": {"merged_from": sources,
                         "events": len(body),
                         "truncated_oldest": truncated}}
    if out_path:
        atomic_write(out_path, json.dumps(doc) + "\n")
    return doc


def reset() -> None:
    """Test seam: drop every recorded event and forget thread/track
    names (context stacks and the enable flag are untouched)."""
    global _proc_root_read
    _RING.clear()
    _thread_names.clear()
    _proc_root_read = False


# ---------------------------------------------------------------------------
# autostart (the fleet self-collection seam)
# ---------------------------------------------------------------------------

_atexit_armed = False


def maybe_autostart() -> bool:
    """Arm the atexit ring dump when ``$LGBM_TPU_TRACE_DIR`` is set.
    Idempotent; returns whether the dump is armed.  Called at import
    from the telemetry module, so every process of a fleet (trainer,
    replicas, bench, dryrun children) self-collects without per-caller
    wiring."""
    global _atexit_armed
    if _atexit_armed:
        return True
    if not os.environ.get(TRACE_DIR_ENV):
        return False
    atexit.register(export_to_dir)
    _atexit_armed = True
    return True


def main(argv: Optional[List[str]] = None) -> int:
    """``python -m lightgbm_tpu_torch.runtime.tracing merge out.json
    in*.json``: the standalone merge tool."""
    import sys
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 3 or argv[0] != "merge":
        print("usage: python -m lightgbm_tpu_torch.runtime.tracing merge "
              "<out.json> <trace1.json> [trace2.json ...]")
        return 2
    doc = merge_traces(argv[2:], out_path=argv[1])
    print("merged %d events from %d files -> %s"
          % (doc["otherData"]["events"],
             len(doc["otherData"]["merged_from"]), argv[1]))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
