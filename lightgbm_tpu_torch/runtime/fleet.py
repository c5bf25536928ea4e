"""Elastic serving fleet (counterpart of lightgbm_tpu/runtime/fleet.py):
an SLO-driven autoscaling controller over `ServingRuntime` replica
subprocesses.  Three pieces, one file, because they share the spawn
protocol:

* **`FleetController`** spawns and retires replica subprocesses against
  an SLO.  Every ``interval_s`` it scrapes each replica's
  ``/metrics.json`` (the scrape an operator's Prometheus would make; the
  controller has no private channel into a replica), aggregates the
  queue-depth fraction and a windowed p99 (the
  ``lgbm_serve_latency_seconds`` histogram delta between scrapes), and
  feeds a `policy.FleetScalePolicy` hysteresis state machine.
  ``scale_up`` spawns a replica; its ``LGBM_TPU_SPAWN_ORDINAL`` rides
  the environment so the ``die_at_spawn:K`` fault can target the K-th
  fleet spawn.  ``scale_down`` retires the newest ready replica (SIGTERM,
  then a graceful drain; its last metrics snapshot is kept).  A replica
  that dies un-retired, a ``die_at_spawn`` corpse or a replica whose
  card did not come up, is reaped and relaunched while the target
  demands it, with a doubling backoff after a death before readiness.
  Shedding is the last resort: ``shed_allowed`` reaches replicas through
  ``fleet_state.json`` and is granted only when the policy latches
  ``shed_on`` at ``max_replicas``.
* **the `--replica` entry point** (``python -m
  lightgbm_tpu_torch.runtime.fleet --replica SPEC --endpoint PATH``):
  one serving replica as a process.  It builds a `ServingRuntime` from a
  JSON spec (model zoo, quotas, bounded residency, shed policy), fronts
  it with a binary `WireTCPServer` (and a `WireUnixServer`, the shared-
  memory ring's handshake plane, where the socket path fits in fewer
  than 100 bytes), publishes its ports atomically to an endpoint file,
  and polls ``fleet_state.json`` for the shed grant.  SIGTERM drains
  gracefully (the wire servers close first, then the runtime).
* **`FleetClient`**: the `LoadGenerator`-compatible front door, with
  `ServingRuntime.submit`'s future contract; each request travels the
  binary wire (or the shared-memory ring) to a ready replica, round
  robin.  A replica dying mid-request is retried on a peer within the
  deadline budget; rejection frames re-raise as `ServeRejected` with the
  request's priority class attached.

**Replicas on the card.**  A replica is a fresh interpreter started by
`subprocess.Popen` (never a fork of a process whose CUDA is up), with
``PYTHONPATH`` at the repo root.  It runs on the card unless its spec's
``params`` say ``device_type=cpu``: it probes the backend first
(`resilience.resolve_backend`), and a probe that fails raises
`BackendUnavailable` and exits with `BACKEND_UNAVAILABLE_EXIT` before
any endpoint is published, so the controller's crash-loop backoff
applies; a replica never serves from the host predictor for want of a
card.  On one card every replica shares the device; each records its
peak device memory in its endpoint file beside its pid and ports (at
readiness, and again after its drain).  The device predictor needs no
hand-written kernel, so a replica builds none: its endpoint file counts
the kernel builds and loads it made (`kernel_builds`, 0).

Reaction-time accounting: an episode opens at the first pressure sample
(depth above the high watermark or windowed p99 above the SLO) and
closes at the first scrape with neither; the span lands in
``lgbm_fleet_reaction_seconds`` and the controller's ledger.

The controller and the client are stdlib + numpy; torch stays in the
replica processes.
"""
from __future__ import annotations

import json
import os
import queue
import signal
import subprocess
import sys
import threading
import time
import urllib.request
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from . import telemetry
from .policy import FleetScalePolicy
from .resilience import BackendUnavailable, wallclock
from .serving import ServeRejected
from ..utils.log import Log

__all__ = ["FleetController", "FleetClient", "ReplicaHandle",
           "replica_main", "BACKEND_UNAVAILABLE_EXIT"]

#: a replica's exit code when its card did not come up
BACKEND_UNAVAILABLE_EXIT = 3


def _atomic_write_json(path: str, obj: Dict[str, Any]) -> None:
    tmp = path + ".tmp.%d" % os.getpid()
    with open(tmp, "w") as fh:
        json.dump(obj, fh)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, path)


def _http_get_json(port: int, path: str, timeout: float = 2.0
                   ) -> Optional[Dict[str, Any]]:
    try:
        with urllib.request.urlopen(
                "http://127.0.0.1:%d%s" % (port, path),
                timeout=timeout) as resp:
            return json.loads(resp.read().decode("utf-8"))
    except Exception:           # noqa: BLE001 — scrape loss is a signal gap
        return None


def _healthz_ok(port: int, timeout: float = 2.0) -> bool:
    try:
        with urllib.request.urlopen(
                "http://127.0.0.1:%d/healthz" % port,
                timeout=timeout) as resp:
            return resp.status == 200
    except Exception:           # noqa: BLE001 — warming answers 503
        return False


# ---------------------------------------------------------------------------
# replica handle
# ---------------------------------------------------------------------------

#: scheduler boost a WARMING replica runs at: on a contended box the
#: spawn-to-ready path (interpreter + model load + prewarm compiles) is
#: the thing a fleet-wide SLO breach is waiting on, so it briefly
#: outranks the serving plane — spawned through ``nice -n -2`` (needs
#: CAP_SYS_NICE; GNU nice degrades to 0 without it) and reniced back to
#: 0 by `replica_main` once ready
PREWARM_NICE_BOOST = 2


def _which(cmd: str) -> Optional[str]:
    for d in os.environ.get("PATH", "/usr/bin:/bin").split(os.pathsep):
        p = os.path.join(d, cmd)
        if os.access(p, os.X_OK):
            return p
    return None


class ReplicaHandle:
    """One replica subprocess as the controller sees it: the Popen, the
    spawn ordinal, readiness, and the LAST metrics snapshot (kept after
    death so the ledger never loses a dead replica's counters)."""

    def __init__(self, name: str, proc: subprocess.Popen, ordinal: int,
                 endpoint_path: str):
        self.name = name
        self.proc = proc
        self.ordinal = ordinal
        self.endpoint_path = endpoint_path
        self.spawned_mono = time.monotonic()
        self.ready = False
        self.ready_mono: Optional[float] = None
        self.retiring = False
        self.term_mono: Optional[float] = None
        self.dead = False
        self.stopped_mono: Optional[float] = None
        self.endpoint: Optional[Dict[str, Any]] = None
        self.last_snapshot: Optional[Dict[str, Any]] = None
        self.last_hist: Optional[Dict[str, Any]] = None

    @property
    def metrics_port(self) -> Optional[int]:
        return self.endpoint.get("metrics_port") if self.endpoint else None

    @property
    def wire_port(self) -> Optional[int]:
        return self.endpoint.get("wire_port") if self.endpoint else None

    @property
    def wire_uds(self) -> Optional[str]:
        """The replica's UDS wire path (the SHM handshake plane), when
        it published one — same-host clients prefer it."""
        return self.endpoint.get("wire_uds") if self.endpoint else None

    def replica_seconds(self, now_mono: float) -> float:
        end = self.stopped_mono if self.stopped_mono is not None \
            else now_mono
        return max(end - self.spawned_mono, 0.0)


# ---------------------------------------------------------------------------
# controller
# ---------------------------------------------------------------------------

class FleetController:
    """Spawn/retire `--replica` subprocesses against an SLO.

    `spec` is the replica spec dict the entrypoint consumes (see
    `replica_main`); it is written once to ``<fleet_dir>/replica.json``
    and every spawn points at it.  `policy` supplies min/max replicas
    and the hysteresis; the controller is the *actuator* — the decision
    logic stays in the clock-free, unit-tested state machine."""

    def __init__(self, fleet_dir: str, spec: Dict[str, Any],
                 policy: Optional[FleetScalePolicy] = None,
                 interval_s: float = 0.5,
                 spawn_grace_s: float = 60.0,
                 drain_grace_s: float = 10.0,
                 env: Optional[Dict[str, str]] = None,
                 log=Log):
        self.fleet_dir = os.path.abspath(fleet_dir)
        os.makedirs(self.fleet_dir, exist_ok=True)
        self.spec_path = os.path.join(self.fleet_dir, "replica.json")
        _atomic_write_json(self.spec_path, spec)
        self.spec = spec
        self.policy = policy or FleetScalePolicy()
        self.interval_s = float(interval_s)
        self.spawn_grace_s = float(spawn_grace_s)
        self.drain_grace_s = float(drain_grace_s)
        self.env = dict(env or {})
        self.log = log
        self.state_path = os.path.join(self.fleet_dir, "fleet_state.json")
        self._write_state(False)

        self.replicas: List[ReplicaHandle] = []       # live (incl. spawning)
        self.retired: List[ReplicaHandle] = []        # dead + retired
        self._ordinal = 0
        self._lock = threading.RLock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._max_queue = int(spec.get("max_queue", 256))

        # ledger
        self.events: List[Dict[str, Any]] = []
        self.timeline: List[Dict[str, Any]] = []
        self.reactions_s: List[float] = []
        self._pressure_since: Optional[float] = None
        self._t0 = time.monotonic()
        self._replica_seconds_done = 0.0
        self.relaunches = 0
        self.scale_ups = 0
        self.scale_downs = 0
        # crash-loop guard: a replica dying before EVER reporting ready
        # backs the next spawn off (doubling, capped) so a broken spec
        # cannot fork-bomb the box; any replica reaching ready resets it
        self._spawn_backoff_s = 0.0
        self._spawn_backoff_until = 0.0
        # lock-free endpoint snapshot for the client hot path (list
        # replacement is atomic; a tick-stale entry just retries a peer)
        self._eps_cache: List[Tuple[str, int]] = []
        # endpoint -> UDS path for replicas that published one (the SHM
        # ring handshake plane; same replacement-is-atomic discipline)
        self._uds_cache: Dict[Tuple[str, int], str] = {}

    # -- state file the replicas poll ---------------------------------------
    def _write_state(self, shed_allowed: bool) -> None:
        _atomic_write_json(self.state_path,
                           {"shed_allowed": bool(shed_allowed),
                            "wallclock": wallclock()})

    # -- spawn / retire / reap ----------------------------------------------
    def _event(self, action: str, **extra: Any) -> None:
        rec = {"event": "fleet", "action": action,
               "t_s": round(time.monotonic() - self._t0, 3),
               "wallclock": wallclock()}
        rec.update(extra)
        self.events.append(rec)
        telemetry.counter("lgbm_fleet_scale_events_total").inc(action=action)

    def _spawn(self, reason: str = "scale_up") -> ReplicaHandle:
        self._ordinal += 1
        name = "replica-%03d" % self._ordinal
        ep_path = os.path.join(self.fleet_dir, name + ".endpoint.json")
        try:
            os.unlink(ep_path)
        except OSError:
            pass
        env = dict(os.environ)
        env.update(self.env)
        # the replica must resolve THIS package even when spawned with a
        # different cwd (the fleet dir)
        pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        env["PYTHONPATH"] = pkg_root + os.pathsep + env.get("PYTHONPATH",
                                                            "")
        # the fault seam: die_at_spawn:K targets the K-th fleet spawn
        # (a per-process counter could never see K > 1, so the ordinal
        # rides the environment)
        env["LGBM_TPU_SPAWN_ORDINAL"] = str(self._ordinal)
        log_path = os.path.join(self.fleet_dir, name + ".log")
        logf = open(log_path, "ab")
        # a fresh interpreter: never a fork of this process, whose CUDA
        # may be up
        argv = [sys.executable, "-m", "lightgbm_tpu_torch.runtime.fleet",
                "--replica", self.spec_path,
                "--endpoint", ep_path,
                "--fleet-state", self.state_path]
        nice = _which("nice")
        if nice:
            # the prewarm sprint starts at exec so the boost covers the
            # interpreter + import phase too; GNU nice degrades to
            # niceness 0 with a warning when CAP_SYS_NICE is missing
            argv = [nice, "-n", str(-PREWARM_NICE_BOOST)] + argv
        proc = subprocess.Popen(
            argv, stdout=logf, stderr=subprocess.STDOUT, env=env,
            cwd=self.fleet_dir)
        logf.close()
        h = ReplicaHandle(name, proc, self._ordinal, ep_path)
        self.replicas.append(h)
        self._event(reason if reason == "relaunch" else "spawn",
                    replica=name, ordinal=self._ordinal, pid=proc.pid)
        return h

    def _refresh_eps(self) -> None:
        live = [h for h in self.replicas
                if h.ready and not h.retiring and h.wire_port is not None]
        self._eps_cache = [("127.0.0.1", h.wire_port) for h in live]
        self._uds_cache = {("127.0.0.1", h.wire_port): h.wire_uds
                           for h in live if h.wire_uds}

    def _retire(self, h: ReplicaHandle) -> None:
        h.retiring = True
        try:
            h.proc.send_signal(signal.SIGTERM)
        except OSError:
            pass
        self._refresh_eps()
        self._event("retire", replica=h.name, pid=h.proc.pid)

    def _finish(self, h: ReplicaHandle) -> None:
        """Move a dead handle to the retired list, closing its
        replica-seconds account."""
        h.dead = True
        h.stopped_mono = time.monotonic()
        self._replica_seconds_done += h.replica_seconds(h.stopped_mono)
        if h in self.replicas:
            self.replicas.remove(h)
        self.retired.append(h)
        self._refresh_eps()

    def _reap(self) -> None:
        now = time.monotonic()
        for h in list(self.replicas):
            rc = h.proc.poll()
            if rc is None:
                continue
            was_ready = h.ready
            self._finish(h)
            if h.retiring:
                self._event("retired", replica=h.name, returncode=rc)
                continue
            # un-asked-for death (fault churn, die_at_spawn corpse, OOM):
            # relaunch while the target demands it
            self.relaunches += 1
            self._event("death", replica=h.name, returncode=rc,
                        was_ready=was_ready)
            if not was_ready:
                self._spawn_backoff_s = min(
                    max(self._spawn_backoff_s * 2, 1.0), 10.0)
                self._spawn_backoff_until = now + self._spawn_backoff_s
            if len(self.replicas) < self.policy.target \
                    and now >= self._spawn_backoff_until:
                self._spawn(reason="relaunch")
        # a retiring replica that ignores SIGTERM past the drain grace
        # is killed: an elastic fleet cannot leak processes
        for h in list(self.replicas):
            if h.retiring and h.proc.poll() is None:
                if h.term_mono is None:
                    h.term_mono = now
                elif now - h.term_mono > self.drain_grace_s:
                    try:
                        h.proc.kill()
                    except OSError:
                        pass

    def _check_ready(self) -> None:
        now = time.monotonic()
        for h in self.replicas:
            if h.ready or h.retiring:
                continue
            if h.endpoint is None and os.path.exists(h.endpoint_path):
                try:
                    with open(h.endpoint_path) as fh:
                        h.endpoint = json.load(fh)
                except (OSError, ValueError):
                    h.endpoint = None
            if h.endpoint is not None and h.metrics_port \
                    and _healthz_ok(h.metrics_port):
                h.ready = True
                h.ready_mono = now
                self._spawn_backoff_s = 0.0
                self._spawn_backoff_until = 0.0
                self._event("ready", replica=h.name,
                            spawn_to_ready_s=round(now - h.spawned_mono, 3))
            elif now - h.spawned_mono > self.spawn_grace_s:
                # never-ready corpse with a live pid: kill and let the
                # reaper relaunch
                try:
                    h.proc.kill()
                except OSError:
                    pass

    # -- the scrape → aggregate → decide loop -------------------------------
    @staticmethod
    def _snapshot_hist(snap: Dict[str, Any], family: str
                       ) -> Dict[str, Any]:
        """Sum one histogram family across ALL label series of one
        replica's /metrics.json snapshot into a Histogram.state()-shaped
        dict (buckets come from the METRIC_TABLE declaration — the
        snapshot wire format carries counts only)."""
        edges = list(telemetry.LATENCY_BUCKETS_S)
        counts = [0] * len(edges)
        total = 0
        hsum = 0.0
        fam = (snap.get("metrics") or {}).get(family) or {}
        for entry in fam.get("series", []):
            cts = entry.get("counts") or []
            for i, c in enumerate(cts[:len(counts)]):
                counts[i] += int(c)
            total += int(entry.get("count", 0))
            hsum += float(entry.get("sum", 0.0))
        return {"buckets": edges, "counts": counts, "sum": hsum,
                "count": total}

    @staticmethod
    def _snapshot_gauge(snap: Dict[str, Any], family: str) -> float:
        fam = (snap.get("metrics") or {}).get(family) or {}
        return float(sum(float(e.get("value", 0.0))
                         for e in fam.get("series", [])))

    def _scrape(self) -> Tuple[float, Optional[float], int]:
        """One sweep: scrape every ready replica, return
        (fleet depth fraction, windowed p99 or None, replicas scraped)."""
        depth = 0.0
        scraped = 0
        window = {"buckets": list(telemetry.LATENCY_BUCKETS_S),
                  "counts": [0] * len(telemetry.LATENCY_BUCKETS_S),
                  "sum": 0.0, "count": 0}
        for h in self.replicas:
            if not h.ready or h.metrics_port is None:
                continue
            snap = _http_get_json(h.metrics_port, "/metrics.json")
            if snap is None:
                continue
            scraped += 1
            h.last_snapshot = snap
            depth += self._snapshot_gauge(snap, "lgbm_serve_queue_depth")
            hist = self._snapshot_hist(snap, "lgbm_serve_latency_seconds")
            if h.last_hist is not None:
                delta = telemetry.state_delta(hist, h.last_hist)
            else:
                delta = hist
            h.last_hist = hist
            for i, c in enumerate(delta["counts"]):
                window["counts"][i] += max(int(c), 0)
            window["count"] += max(int(delta["count"]), 0)
            window["sum"] += max(float(delta["sum"]), 0.0)
        if scraped == 0:
            return 0.0, None, 0
        depth_frac = depth / max(scraped * self._max_queue, 1)
        p99 = telemetry.quantile_from_state(window, 0.99) \
            if window["count"] > 0 else None
        return min(depth_frac, 1.0), p99, scraped

    def _apply(self, decisions: List[Dict[str, Any]]) -> None:
        for d in decisions:
            action = d["action"]
            if action == "scale_up":
                # count the decision; the paced top-up in _tick does the
                # actual spawn (one warming replica at a time: on a
                # contended host N concurrent prewarms each take N times
                # longer than one, so pacing lands capacity sooner)
                self.scale_ups += 1
            elif action == "scale_down":
                self.scale_downs += 1
                # retire the NEWEST ready replica: the oldest carry the
                # warmest caches and the longest uptime
                ready = [h for h in self.replicas
                         if h.ready and not h.retiring]
                if ready:
                    self._retire(max(ready, key=lambda h: h.spawned_mono))
            elif action == "shed_on":
                self._write_state(True)
                self._event("shed_on")
            elif action == "shed_off":
                self._write_state(False)
                self._event("shed_off")

    def _tick(self) -> None:
        with self._lock:
            self._reap()
            self._check_ready()
            depth_frac, p99, scraped = self._scrape()
            decisions = []
            if scraped > 0:
                decisions = self.policy.observe(depth_frac, p99_s=p99)
                self._apply(decisions)
            # top the fleet up toward the target, PACED: at most one
            # warming replica at a time (covers scale_up decisions,
            # min_replicas at start, and deaths the reaper saw).  The
            # next spawn launches when the previous one reports ready —
            # serialized prewarms finish faster than contended ones
            alive = [h for h in self.replicas if not h.retiring]
            warming = sum(1 for h in alive if not h.ready)
            if len(alive) < self.policy.target and warming == 0 \
                    and time.monotonic() >= self._spawn_backoff_until:
                self._spawn()
            # reaction episodes: breach sample opens, all-clear closes
            now = time.monotonic()
            pressure = (depth_frac > self.policy.high_watermark
                        or (p99 is not None and p99 > self.policy.slo_p99_s))
            if pressure and self._pressure_since is None \
                    and scraped > 0:
                self._pressure_since = now
            elif not pressure and self._pressure_since is not None \
                    and scraped > 0:
                span = now - self._pressure_since
                self._pressure_since = None
                self.reactions_s.append(round(span, 3))
                telemetry.histogram(
                    "lgbm_fleet_reaction_seconds").observe(span)
            n_ready = sum(1 for h in self.replicas
                          if h.ready and not h.retiring)
            n_spawning = sum(1 for h in self.replicas
                             if not h.ready and not h.retiring)
            n_retiring = sum(1 for h in self.replicas if h.retiring)
            g = telemetry.gauge("lgbm_fleet_replicas")
            g.set(n_ready, state="ready")
            g.set(n_spawning, state="spawning")
            g.set(n_retiring, state="retiring")
            self._refresh_eps()
            self.timeline.append({
                "t_s": round(now - self._t0, 3),
                "ready": n_ready, "spawning": n_spawning,
                "retiring": n_retiring, "target": self.policy.target,
                "depth_frac": round(depth_frac, 4),
                "p99_s": None if p99 is None else round(p99, 6),
                "shed_latched": self.policy.shed_latched,
            })

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                self._tick()
            except Exception as e:   # noqa: BLE001 — the control loop
                # must survive a scrape / spawn hiccup; losing the loop
                # is the outage
                self.log.warning("fleet: tick failed: %s: %s",
                                 type(e).__name__, e)
            self._stop.wait(self.interval_s)

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "FleetController":
        with self._lock:
            while len(self.replicas) < self.policy.min_replicas:
                self._spawn(reason="spawn")
        self._thread = threading.Thread(target=self._loop,
                                        name="fleet-controller",
                                        daemon=True)
        self._thread.start()
        return self

    def wait_ready(self, n: Optional[int] = None,
                   timeout: float = 120.0) -> int:
        """Block until `n` (default min_replicas) replicas are ready."""
        want = int(n if n is not None else self.policy.min_replicas)
        deadline = time.monotonic() + timeout
        got = 0
        while time.monotonic() < deadline:
            with self._lock:
                got = sum(1 for h in self.replicas
                          if h.ready and not h.retiring)
            if got >= want:
                return got
            time.sleep(0.1)
        raise TimeoutError("fleet: %d/%d replicas ready after %.0fs"
                           % (got, want, timeout))

    def ready_endpoints(self) -> List[Tuple[str, int]]:
        """Lock-free: the client hot path reads the last tick's
        snapshot; a stale entry costs one retry, not a lock convoy."""
        return self._eps_cache

    def uds_path_for(self, addr: Tuple[str, int]) -> Optional[str]:
        """The replica's UDS wire path for a ready endpoint, if it
        published one — the door to the shared-memory ring transport
        for same-host clients (None → TCP only)."""
        return self._uds_cache.get(addr)

    def stop(self) -> Dict[str, Any]:
        self._eps_cache = []
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
        with self._lock:
            if self._pressure_since is not None:
                # a pressure episode still open at teardown counts in
                # full: stopping mid-breach must not hide the breach
                span = time.monotonic() - self._pressure_since
                self._pressure_since = None
                self.reactions_s.append(round(span, 3))
                telemetry.histogram(
                    "lgbm_fleet_reaction_seconds").observe(span)
            for h in list(self.replicas):
                if h.proc.poll() is None:
                    try:
                        h.proc.send_signal(signal.SIGTERM)
                    except OSError:
                        pass
            deadline = time.monotonic() + self.drain_grace_s
            while time.monotonic() < deadline and any(
                    h.proc.poll() is None for h in self.replicas):
                time.sleep(0.1)
            for h in list(self.replicas):
                if h.proc.poll() is None:
                    try:
                        h.proc.kill()
                    except OSError:
                        pass
                    h.proc.wait(timeout=5)
                self._finish(h)
        return self.report()

    # -- ledger ---------------------------------------------------------------
    def report(self) -> Dict[str, Any]:
        now = time.monotonic()
        with self._lock:
            live = sum(h.replica_seconds(now) for h in self.replicas)
            total = self._replica_seconds_done + live
            return {
                "scale_ups": self.scale_ups,
                "scale_downs": self.scale_downs,
                "relaunches": self.relaunches,
                "replica_seconds": round(total, 3),
                "reactions_s": list(self.reactions_s),
                "scale_up_reaction_s_max": max(self.reactions_s)
                if self.reactions_s else None,
                "events": list(self.events),
                "timeline": list(self.timeline),
                "policy": self.policy.state(),
            }


# ---------------------------------------------------------------------------
# LoadGenerator-compatible fleet client
# ---------------------------------------------------------------------------

class _FleetResult:
    """The slice of `ServeResult` the loadgen waiter and verifier read,
    rebuilt from a decoded wire response."""

    __slots__ = ("values", "generation", "model_id", "served_by",
                 "latency_s", "stages", "model_trace")

    def __init__(self, rec: Dict[str, Any]):
        # the wire client's values view is only valid until its next
        # call — copy before the connection is reused
        v = np.array(rec["values"], copy=True)
        if v.ndim == 2 and v.shape[1] == 1:
            # the wire frame is always [rows, cols]; restore the
            # in-process ServeResult convention (1-D for single-output
            # objectives) so the byte-verifier's reference shape matches
            v = v[:, 0]
        self.values = v
        self.generation = int(rec["generation"])
        self.model_id = rec.get("model", "default")
        self.served_by = rec.get("served_by", "device")
        self.latency_s = float(rec.get("latency_s", 0.0))
        self.stages = dict(rec.get("stages") or {})
        self.model_trace = None


class _FleetFuture:
    """`submit()`'s return: the same wait-or-raise contract as the
    in-process request object."""

    __slots__ = ("enqueued", "priority", "_ev", "_rec", "_exc")

    def __init__(self, priority: int = 0) -> None:
        self.enqueued = time.monotonic()
        self.priority = int(priority)
        self._ev = threading.Event()
        self._rec: Optional[_FleetResult] = None
        self._exc: Optional[BaseException] = None

    def _resolve(self, rec: Optional[_FleetResult],
                 exc: Optional[BaseException]) -> None:
        self._rec = rec
        self._exc = exc
        self._ev.set()

    def wait(self, timeout: Optional[float] = None) -> _FleetResult:
        if not self._ev.wait(timeout):
            raise ServeRejected("client_timeout", retryable=True,
                                priority=self.priority,
                                detail="fleet client gave up waiting")
        if self._exc is not None:
            raise self._exc
        assert self._rec is not None
        return self._rec


class FleetClient:
    """Drive a whole fleet through one LoadGenerator: `submit` matches
    `ServingRuntime.submit`'s future contract, but each request rides
    the binary wire to a ready replica, round robin (the shared-memory
    ring where the replica published a Unix socket and `prefer_shm`).
    A replica dying mid-request retries on a peer inside the deadline
    budget; rejection frames re-raise as `ServeRejected` with the
    request's priority class (the wire rejection frame does not carry
    it; the client knows what it sent).  `transports` counts the
    answered requests by the transport that carried them ("shm" /
    "wire")."""

    def __init__(self, controller: FleetController, workers: int = 16,
                 predict_deadline_s: float = 30.0,
                 request_timeout_s: float = 35.0,
                 prefer_shm: bool = True):
        from .wire import WireClient            # lazy: client-side only
        self._WireClient = WireClient
        self._ShmClient = None
        if prefer_shm:
            try:
                from .shm_ring import ShmClient
                self._ShmClient = ShmClient
            except ImportError:
                pass                  # non-Linux: sockets only
        self.controller = controller
        self.predict_deadline_s = float(predict_deadline_s)
        self.request_timeout_s = float(request_timeout_s)
        self._q: "queue.Queue" = queue.Queue()
        self._rr = 0
        self._rr_lock = threading.Lock()
        self.transports: Dict[str, int] = {"shm": 0, "wire": 0}
        self._stop = threading.Event()
        self._workers = [threading.Thread(target=self._worker,
                                          name="fleet-client-%d" % i,
                                          daemon=True)
                         for i in range(int(workers))]
        for t in self._workers:
            t.start()

    # -- the LoadGenerator seam ----------------------------------------------
    def submit(self, X: np.ndarray, deadline_s: Optional[float] = None,
               model_id: str = "default", priority: int = 0,
               traceparent: Optional[str] = None) -> _FleetFuture:
        fut = _FleetFuture(priority)
        self._q.put((fut, np.ascontiguousarray(X, dtype=np.float32),
                     model_id, int(priority)))
        return fut

    def _pick(self, skip: Optional[Tuple[str, int]] = None
              ) -> Optional[Tuple[str, int]]:
        eps = self.controller.ready_endpoints()
        if skip is not None and len(eps) > 1:
            eps = [e for e in eps if e != skip] or eps
        if not eps:
            return None
        with self._rr_lock:
            self._rr += 1
            return eps[self._rr % len(eps)]

    def _worker(self) -> None:
        conns: Dict[Tuple[str, int], Any] = {}
        while not self._stop.is_set():
            item = self._q.get()
            if item is None:
                return
            fut, X, model_id, priority = item
            self._serve_one(conns, fut, X, model_id, priority)

    def _serve_one(self, conns: Dict[Tuple[str, int], Any], fut, X,
                   model_id: str, priority: int) -> None:
        deadline = fut.enqueued + self.request_timeout_s
        last_err: Optional[BaseException] = None
        addr: Optional[Tuple[str, int]] = None
        while time.monotonic() < deadline:
            addr = self._pick(skip=addr)
            if addr is None:
                time.sleep(0.05)
                continue
            cli = conns.get(addr)
            try:
                if cli is None:
                    # same-host replicas that published a UDS path get
                    # the shared-memory ring; a ring setup failure falls
                    # back to the socket plane (a transport choice: the
                    # replica, and its card, answer either way)
                    uds = self.controller.uds_path_for(addr)
                    if uds is not None and self._ShmClient is not None:
                        try:
                            cli = self._ShmClient(
                                uds, timeout=self.request_timeout_s)
                        except Exception:    # noqa: BLE001 — fallback
                            cli = None
                    if cli is None:
                        cli = self._WireClient(addr, timeout=self.
                                               request_timeout_s)
                    conns[addr] = cli
                rec = cli.request_once(X, model_id=model_id,
                                       priority=priority)
            except Exception as e:   # noqa: BLE001 — dead replica,
                # torn connection, refused port: drop the conn, try a
                # peer inside the budget
                last_err = e
                dead = conns.pop(addr, None)
                if dead is not None:
                    try:
                        dead.close()
                    except Exception:        # noqa: BLE001
                        pass
                continue
            if rec.get("error") == "rejected":
                # the wire rejection frame carries no priority class —
                # the client attaches the one it sent, preserving
                # loadgen's machine-readability gate
                fut._resolve(None, ServeRejected(
                    rec.get("reason", "rejected"),
                    retryable=bool(rec.get("retryable", True)),
                    priority=priority,
                    retry_after_s=rec.get("retry_after_s")))
                return
            with self._rr_lock:
                self.transports["wire" if isinstance(
                    cli, self._WireClient) else "shm"] += 1
            fut._resolve(_FleetResult(rec), None)
            return
        fut._resolve(None, ServeRejected(
            "fleet_unavailable", retryable=True, priority=priority,
            detail=str(last_err) if last_err else "no ready replica"))

    def close(self) -> None:
        self._stop.set()
        for _ in self._workers:
            self._q.put(None)
        for t in self._workers:
            t.join(timeout=5)


# ---------------------------------------------------------------------------
# the --replica subprocess entrypoint
# ---------------------------------------------------------------------------

def _kernel_builds() -> int:
    """Kernel builds and loads this process made (nvcc runs, libraries
    found built and loaded): a replica's device predictor needs none."""
    from . import graph_obs
    n = sum(v for k, v in graph_obs.snapshot().items()
            if k.startswith("build."))
    build = sys.modules.get("lightgbm_tpu_torch.ops.build")
    return n + (len(build._libs) if build is not None else 0)


def _on_cpu(params: Optional[Dict[str, Any]]) -> bool:
    """Whether a replica's params ask for the CPU (the tests do)."""
    p = params or {}
    return str(p.get("device_type", p.get("device", ""))).lower() == "cpu"


def _peak_device_bytes(params: Optional[Dict[str, Any]]) -> Optional[int]:
    """This process's peak device memory on the card (None on the CPU)."""
    if _on_cpu(params):
        return None
    import torch
    return int(torch.cuda.max_memory_allocated())


def replica_main(spec_path: str, endpoint_path: str,
                 fleet_state_path: Optional[str] = None) -> int:
    """One serving replica as a process: ServingRuntime (model zoo +
    bounded residency + shed policy) fronted by a binary wire server,
    ports published atomically to `endpoint_path`, `fleet_state.json`
    polled for the shed grant, SIGTERM drains gracefully.  Returns
    `BACKEND_UNAVAILABLE_EXIT`, with no endpoint published, when the
    card does not come up."""
    from .policy import AutoscaleShedPolicy
    from .serving import ServingRuntime
    from .wire import WireTCPServer, WireUnixServer

    with open(spec_path) as fh:
        spec = json.load(fh)

    params = spec.get("params")
    pol = None
    if spec.get("shed_policy", True):
        pol = AutoscaleShedPolicy(
            high_watermark=float(spec.get("shed_high", 0.85)),
            low_watermark=float(spec.get("shed_low", 0.5)),
            patience=int(spec.get("shed_patience", 3)))
        # the fleet grants shedding only at max replicas; until the
        # grant arrives, pressure must surface as queue depth the
        # controller can see, not silently dropped requests
        pol.allow_shed(bool(spec.get("shed_allowed", False)))
    rt = ServingRuntime(
        models=spec.get("models"),
        model_file=spec.get("model_file"),
        params=params,
        raw_score=bool(spec.get("raw_score", False)),
        response_dtype=spec.get("response_dtype", "float32"),
        max_queue=int(spec.get("max_queue", 256)),
        max_batch_rows=int(spec.get("max_batch_rows", 4096)),
        batch_window_s=float(spec.get("batch_window_s", 0.002)),
        default_deadline_s=float(spec.get("default_deadline_s", 10.0)),
        predict_deadline_s=float(spec.get("predict_deadline_s", 30.0)),
        poll_interval_s=float(spec.get("poll_interval_s", 0.2)),
        priority_levels=int(spec.get("priority_levels", 3)),
        quotas=spec.get("quotas"),
        max_resident=int(spec.get("max_resident", 0)),
        policy=pol,
        # the card is probed before any model loads
        probe_platform_on_start=not _on_cpu(params),
        metrics_port=0)
    try:
        rt.start()                   # die_at_spawn fires in here
    except BackendUnavailable as e:
        sys.stderr.write("[%s] replica: %s\n%s\n" % (
            wallclock(), e, json.dumps(e.event, default=str)))
        sys.stderr.flush()
        return BACKEND_UNAVAILABLE_EXIT
    srv = WireTCPServer(rt, port=0)
    srv_thread = threading.Thread(target=srv.serve_forever,
                                  kwargs={"poll_interval": 0.2},
                                  name="replica-wire", daemon=True)
    srv_thread.start()
    # the UDS / shared-memory plane beside TCP: same runtime, same
    # frames.  AF_UNIX paths cap near 108 bytes, so a longer path, or a
    # bind that fails, leaves the replica on TCP alone (a transport
    # choice, not a device fallback)
    usrv = None
    uds_path = (endpoint_path[:-len(".endpoint.json")]
                if endpoint_path.endswith(".endpoint.json")
                else os.path.splitext(endpoint_path)[0]) + ".sock"
    if bool(spec.get("wire_uds", True)) and len(uds_path) < 100:
        try:
            usrv = WireUnixServer(rt, uds_path)
            threading.Thread(target=usrv.serve_forever,
                             kwargs={"poll_interval": 0.2},
                             name="replica-wire-uds", daemon=True).start()
        except OSError:
            usrv = None
    ep = {
        "pid": os.getpid(),
        "metrics_port": rt.metrics_port,
        "wire_port": srv.port,
        "peak_device_bytes": _peak_device_bytes(params),
        "kernel_builds": _kernel_builds(),
        "wallclock": wallclock()}
    if usrv is not None:
        ep["wire_uds"] = uds_path
    _atomic_write_json(endpoint_path, ep)
    try:
        # end of the prewarm sprint: rejoin the serving plane at normal
        # priority (raising nice needs no privilege; no-op when the
        # spawn-side boost was unavailable)
        boost = -os.nice(0)
        if boost > 0:
            os.nice(boost)
    except OSError:
        pass

    stop = threading.Event()

    def _term(_sig, _frm) -> None:
        stop.set()

    signal.signal(signal.SIGTERM, _term)
    signal.signal(signal.SIGINT, _term)

    last_shed: Optional[bool] = None
    while not stop.is_set():
        if fleet_state_path:
            try:
                with open(fleet_state_path) as fh:
                    allowed = bool(json.load(fh).get("shed_allowed",
                                                     False))
            except (OSError, ValueError):
                allowed = None       # torn read: keep the last grant
            if allowed is not None and allowed != last_shed:
                rt.set_shed_allowed(allowed)
                last_shed = allowed
        stop.wait(0.25)

    # drain: close the front doors first, then the runtime (rejects the
    # queue explicitly and exports warm manifests for the next spawn)
    srv.shutdown()
    srv.server_close()
    if usrv is not None:
        usrv.shutdown()
        usrv.server_close()
    rt.stop()
    # the peak over the replica's whole life, and its kernel builds
    ep.update(peak_device_bytes=_peak_device_bytes(params),
              kernel_builds=_kernel_builds(), drained=True)
    _atomic_write_json(endpoint_path, ep)
    return 0


def _main(argv: List[str]) -> int:
    import argparse
    ap = argparse.ArgumentParser(prog="python -m lightgbm_tpu_torch."
                                      "runtime.fleet")
    ap.add_argument("--replica", metavar="SPEC_JSON",
                    help="run one replica from this spec file")
    ap.add_argument("--endpoint", metavar="PATH",
                    help="where the replica publishes its ports")
    ap.add_argument("--fleet-state", metavar="PATH", default=None,
                    help="fleet_state.json to poll for the shed grant")
    args = ap.parse_args(argv)
    if not args.replica or not args.endpoint:
        ap.error("--replica SPEC_JSON and --endpoint PATH are required")
    return replica_main(args.replica, args.endpoint, args.fleet_state)


if __name__ == "__main__":          # pragma: no cover — subprocess entry
    sys.exit(_main(sys.argv[1:]))
