"""The program ledger: the counterpart of lightgbm_tpu/runtime/xla_obs.py
over the port's program caches.

The JAX package's ledger counts XLA traces and compiles per `jax.jit`
site.  The port compiles no XLA program; what costs it time on the first
call, and what a silent rebuild would cost again, is:

* **a CUDA graph capture** per `runtime/graphs.Site` (the grower's root,
  split and frontier-round steps, the device predictor's traversal): the
  eager warm-up run and the capture count as one compile of the site,
  with its wall time and the shapes that triggered it (`record_build`);
  every replay counts as a hit (`record_replay`);
* **a grower program** (`boosting/grower2.py`, site ``grower2.program``):
  the device state and step closures built for a new payload;
* **an nvcc build** of a kernel source (`ops/build.py`, site
  ``build.<source>``), or a hit when the built library is found on disk
  (`build_event`);
* **the python-side caches** (`cache_event`): the grower made per fast
  state (``gbdt.grower_cache``) and the device predictor's program per row
  bucket (``predictor.bucket_cache``), hit or miss.

After `mark_steady()`, any further build at any site is a retrace,
recorded with the site and the shape delta against the site's previous
build (``lgbm_xla_retraces_total{site,delta}``), so a test pins "N more
iterations build nothing" by `snapshot()` / `delta()`.  The metric
families keep the JAX package's names (``lgbm_xla_compiles_total{site}``,
``lgbm_xla_compile_seconds{site}``, ``lgbm_xla_retraces_total{site,delta}``,
``lgbm_program_cache_events_total{site,event}``) so one dashboard reads
both packages.  Each build is also a slice on the trace recorder's
``graph capture`` row.  The ledger is host bookkeeping; with telemetry
disabled a replay costs one counter add.  No torch at module scope.
"""
from __future__ import annotations

import collections
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from . import telemetry, tracing
from .resilience import wallclock

__all__ = [
    "LEDGER", "ProgramLedger", "signature", "sig_delta", "record_build",
    "record_replay", "build_event", "cache_event", "mark_steady",
    "snapshot", "delta", "reset", "calls_snapshot", "calls_delta",
    "set_compile_observer", "total_compiles",
]

#: build-history entries kept per site (the ledger lives as long as the
#: process)
HISTORY_PER_SITE = 32

#: cap on signature and delta strings (they become label values)
SIG_MAX_CHARS = 160

#: the trace recorder's row for builds
TRACK = "graph capture"

_SHORT = {"float32": "f32", "float64": "f64", "int32": "i32",
          "int64": "i64", "uint8": "u8", "int16": "i16", "int8": "i8",
          "bool": "b1", "bfloat16": "bf16", "float16": "f16"}


def _aval_str(x: Any) -> str:
    """dtype[shape] of a tensor; other values as their repr (short) or
    type name, so their change still shows in a delta."""
    shape = getattr(x, "shape", None)
    dtype = getattr(x, "dtype", None)
    if shape is not None and dtype is not None:
        short = str(dtype).replace("torch.", "")
        return "%s[%s]" % (_SHORT.get(short, short),
                           ",".join(str(int(d)) for d in shape))
    if isinstance(x, (bool, int, float, str)):
        return repr(x)[:24]
    return type(x).__name__


def signature(*args: Any, **kwargs: Any) -> Tuple[str, ...]:
    """The shape signature of a build's inputs: one entry per argument."""
    out = [_aval_str(a) for a in args]
    out.extend("%s=%s" % (k, _aval_str(kwargs[k])) for k in sorted(kwargs))
    return tuple(out)


def sig_delta(old: Optional[Tuple[str, ...]],
              new: Tuple[str, ...]) -> str:
    """The argument slots that changed between two signatures,
    ``argN:old->new``: what a steady-state rebuild reports."""
    if old is None:
        return "first_trace"
    parts = []
    for i in range(max(len(old), len(new))):
        o = old[i] if i < len(old) else "<absent>"
        n = new[i] if i < len(new) else "<absent>"
        if o != n:
            parts.append("arg%d:%s->%s" % (i, o, n))
    return (";".join(parts) or "identical_signature")[:SIG_MAX_CHARS]


class _Site:
    __slots__ = ("name", "compiles", "calls", "cache_hits", "cache_misses",
                 "last_sig", "compile_seconds", "history")

    def __init__(self, name: str):
        self.name = name
        self.compiles = 0
        self.calls = 0
        self.cache_hits = 0
        self.cache_misses = 0
        self.last_sig: Optional[Tuple[str, ...]] = None
        self.compile_seconds = 0.0
        self.history: "collections.deque" = collections.deque(
            maxlen=HISTORY_PER_SITE)

    def to_json(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {
            "compiles": self.compiles, "calls": self.calls,
            "compile_seconds": round(self.compile_seconds, 6),
            "last_signature": list(self.last_sig or ()),
            "history": list(self.history),
        }
        if self.cache_hits or self.cache_misses:
            d["cache_hits"] = self.cache_hits
            d["cache_misses"] = self.cache_misses
        return d


class ProgramLedger:
    """Process-wide build / replay ledger (one instance: `LEDGER`)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._sites: Dict[str, _Site] = {}
        self._steady = False
        #: called with (site, event, wall_s) after every kernel build
        #: event (runtime/warmup.py's cache classifier registers here;
        #: warmup imports this module, never the reverse)
        self._observer: Optional[Callable[[str, str, float], None]] = None
        #: steady-state violations: {site, delta, wall_s, wallclock}
        self.retraces: List[Dict[str, Any]] = []

    def register(self, site: str) -> _Site:
        rec = self._sites.get(site)
        if rec is None:
            with self._lock:
                rec = self._sites.setdefault(site, _Site(site))
        return rec

    def record_build(self, site: str, wall_s: float,
                     sig: Tuple[str, ...] = ()) -> None:
        """One build (a capture, a grower program, an nvcc run) of `site`,
        `wall_s` long, triggered by inputs of signature `sig`."""
        rec = self.register(site)
        prev = rec.last_sig
        change = sig_delta(prev, sig)
        with self._lock:
            rec.compiles += 1
            rec.compile_seconds += wall_s
            rec.last_sig = sig
            rec.history.append({
                "wallclock": wallclock(), "wall_s": round(wall_s, 6),
                "signature": list(sig)[:16], "delta": change})
        telemetry.counter("lgbm_xla_compiles_total").inc(site=site)
        telemetry.histogram("lgbm_xla_compile_seconds").observe(
            wall_s, site=site)
        telemetry.counter("lgbm_program_cache_events_total").inc(
            site=site, event="compile")
        now_ns = time.monotonic_ns()
        dur_ns = int(wall_s * 1e9)
        tracing.record("build %s" % site, now_ns - dur_ns, dur_ns,
                       track=TRACK, site=site, delta=change)
        if self._steady:
            event = {"site": site, "delta": change,
                     "wall_s": round(wall_s, 6), "wallclock": wallclock()}
            with self._lock:
                self.retraces.append(event)
            telemetry.counter("lgbm_xla_retraces_total").inc(
                site=site, delta=change)
            tracing.instant("RETRACE %s" % site, track=TRACK, site=site,
                            delta=change)

    def record_replay(self, site: str) -> None:
        """One replay of a captured program: a cache hit."""
        rec = self.register(site)
        with self._lock:
            rec.calls += 1
        telemetry.counter("lgbm_program_cache_events_total").inc(
            site=site, event="hit")

    def cache_event(self, site: str, event: str, n: int = 1) -> None:
        """hit / miss / evict of a python-side program cache."""
        rec = self.register(site)
        with self._lock:
            if event == "hit":
                rec.cache_hits += n
            elif event == "miss":
                rec.cache_misses += n
        telemetry.counter("lgbm_program_cache_events_total").inc(
            n, site=site, event=event)

    def build_event(self, source: str, event: str, wall_s: float = 0.0,
                    sig: Tuple[str, ...] = ()) -> None:
        """A kernel source's build: "miss" (nvcc ran, `wall_s` long) is a
        build of site ``build.<source>``, "hit" (the library was on disk)
        a cache hit there.  The observer hears both."""
        site = "build." + source
        if event == "miss":
            self.record_build(site, wall_s, sig)
        self.cache_event(site, event)
        obs = self._observer
        if obs is not None:
            obs(source, event, wall_s)

    def mark_steady(self, on: bool = True) -> None:
        """After warm-up: any further build at any site is a retrace."""
        self._steady = bool(on)

    @property
    def steady(self) -> bool:
        return self._steady

    def set_compile_observer(self, fn: Optional[Callable[[str, str, float],
                                                         None]]) -> None:
        self._observer = fn

    # -- read side -----------------------------------------------------------
    def snapshot(self) -> Dict[str, int]:
        """{site: builds}; diff two of these to pin a window."""
        with self._lock:
            return {name: s.compiles for name, s in self._sites.items()}

    def delta(self, before: Dict[str, int]) -> Dict[str, int]:
        """Builds per site since `before` (non-zero entries only)."""
        return {k: v - before.get(k, 0) for k, v in self.snapshot().items()
                if v - before.get(k, 0)}

    def calls_snapshot(self) -> Dict[str, int]:
        """{site: replays}."""
        with self._lock:
            return {name: s.calls for name, s in self._sites.items()}

    def calls_delta(self, before: Dict[str, int]) -> Dict[str, int]:
        return {k: v - before.get(k, 0)
                for k, v in self.calls_snapshot().items()
                if v - before.get(k, 0)}

    def misses_snapshot(self) -> Dict[str, int]:
        """{site: python-side cache misses}."""
        with self._lock:
            return {name: s.cache_misses for name, s in self._sites.items()}

    def total_compiles(self, site: Optional[str] = None) -> int:
        """Builds at `site` (all sites when None): the counterpart of the
        JAX ledger's total_compiles, which serving reads before and after
        a batch to stamp it `compiled`."""
        with self._lock:
            if site is not None:
                rec = self._sites.get(site)
                return rec.compiles if rec is not None else 0
            return sum(s.compiles for s in self._sites.values())

    def to_json(self) -> Dict[str, Any]:
        with self._lock:
            sites = {name: s.to_json()
                     for name, s in sorted(self._sites.items())}
            retraces = list(self.retraces)
        return {"wallclock": wallclock(), "steady": self._steady,
                "total_compiles": sum(s["compiles"]
                                      for s in sites.values()),
                "sites": sites, "retraces": retraces}

    def reset(self) -> None:
        """Test seam: forget every recorded event."""
        with self._lock:
            self._sites.clear()
            self.retraces.clear()
        self._steady = False


#: THE ledger every build site records into
LEDGER = ProgramLedger()


def record_build(site: str, wall_s: float, sig: Tuple[str, ...] = ()) -> None:
    LEDGER.record_build(site, wall_s, sig)


def record_replay(site: str) -> None:
    LEDGER.record_replay(site)


def build_event(source: str, event: str, wall_s: float = 0.0,
                sig: Tuple[str, ...] = ()) -> None:
    LEDGER.build_event(source, event, wall_s, sig)


def cache_event(site: str, event: str, n: int = 1) -> None:
    LEDGER.cache_event(site, event, n)


def mark_steady(on: bool = True) -> None:
    LEDGER.mark_steady(on)


def snapshot() -> Dict[str, int]:
    return LEDGER.snapshot()


def delta(before: Dict[str, int]) -> Dict[str, int]:
    return LEDGER.delta(before)


def calls_snapshot() -> Dict[str, int]:
    return LEDGER.calls_snapshot()


def calls_delta(before: Dict[str, int]) -> Dict[str, int]:
    return LEDGER.calls_delta(before)


def total_compiles(site: Optional[str] = None) -> int:
    return LEDGER.total_compiles(site)


def reset() -> None:
    LEDGER.reset()


def set_compile_observer(fn: Optional[Callable[[str, str, float], None]]
                         ) -> None:
    LEDGER.set_compile_observer(fn)
