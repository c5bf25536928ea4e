"""Fault-tolerant training runtime (counterpart of
lightgbm_tpu/runtime/resilience.py, its training half).

The reference survives multi-hour training through periodic snapshots
(gbdt.cpp:330-334); this module is the port's form of that posture:

* **Stage watchdog** (`Watchdog`): a named deadline per stage.  On expiry
  it captures `faulthandler` tracebacks of all threads, persists the stage
  trail and its culprit into a JSON report, and raises `StageTimeout`
  (soft mode) or kills the process group with `WATCHDOG_EXIT_CODE` (hard
  mode).  Off the main thread (thread mode) it keeps the trail only and
  the owner reports expiries (`record_timeout`).

* **Preemption-safe snapshots** (`write_snapshot`, `find_resume_snapshot`,
  `restore_training_state`, `PreemptionGuard`): a snapshot file is a model
  file plus a footer carrying the training state (scores, the payload's
  row order, the RNG streams, the boosting variant's bookkeeping) and a
  sha256 checksum, in the JAX package's format field for field, so a
  snapshot of either package validates and loads in the other.  Writes
  are atomic (tmp + fsync + rename) with keep-last-K retention; SIGTERM /
  SIGINT write a final snapshot at the next iteration boundary; resume
  scans past corrupt snapshots to the newest valid one and continues to a
  model byte-identical to an uninterrupted run.

* **Non-finite sentinel** (`NonFiniteDetected`, `SentinelGuard`): the
  tree outputs the port fetches once per tree are screened for NaN / inf
  under `sentinel_nonfinite=abort|rollback`, with the fill's non-finite
  flag beside them (see `sentinel_check`).

* **Fault injection** (`LGBM_TPU_FAULT`): every fault of the JAX
  package's table (`FAULT_TABLE`), at the port's own injection points:
  training, publish, serving, the online trainer's, the fleet's spawns
  and the shared-memory ring's clients.

* **Platform probe** (`probe_platform`, `resolve_backend`): one
  short-deadline child process initializes CUDA through torch and reports
  the backend, the device count and the card's name; a hung bind dumps
  its tracebacks and is killed at the deadline.  `resolve_backend` probes
  with the JAX package's retries and backoff, but where the JAX chain
  degrades the process to the CPU, a failed probe here raises
  `BackendUnavailable` carrying the machine-readable degradation event:
  the port lands on the CPU only when the caller asks for it.

No torch or numpy import at module scope: a CLI entry can use this module
without touching the card.
"""
from __future__ import annotations

import base64
import contextlib
import datetime
import hashlib
import json
import os
import signal
import subprocess
import sys
import tempfile
import threading
import time
import zlib
from typing import Any, Dict, List, Optional, Tuple

__all__ = [
    "StageTimeout", "Watchdog", "wallclock", "backoff_delays",
    "atomic_write", "read_stage_report", "write_snapshot",
    "validate_snapshot",
    "load_snapshot_state", "find_resume_snapshot", "snapshot_paths",
    "capture_training_state", "restore_training_state",
    "make_resume_callback", "PreemptionGuard", "TrainingPreempted",
    "NonFiniteDetected", "SentinelGuard", "sentinel_check",
    "fault_arg", "fault_active", "maybe_die_or_preempt",
    "maybe_corrupt_snapshot", "maybe_inject_nan", "maybe_slow_stage",
    "maybe_torn_publish", "maybe_die_at_publish", "maybe_die_at_spawn",
    "maybe_fail_predict", "DevicePredictFault", "maybe_poison_rows",
    "maybe_flip_labels", "maybe_regress_model", "snapshot_model_text",
    "FAULT_TABLE", "FAULT_NAMES", "maybe_die_at_ring", "probe_platform",
    "resolve_backend", "BackendUnavailable",
]


def wallclock() -> str:
    """ISO-ish wall-clock tag: every stage line shows WHEN it started, so
    a stall's duration is readable from the trail alone."""
    return datetime.datetime.now().strftime("%Y-%m-%dT%H:%M:%S")


# ---------------------------------------------------------------------------
# fault injection (LGBM_TPU_FAULT=name[:arg],name[:arg],...)
# ---------------------------------------------------------------------------

#: the faults the port injects, with the JAX package's spelling of their
#: argument and where each lands here.  Anything else in the spec is
#: rejected loudly: a typoed fault name injecting nothing would make a
#: "green under fault" test meaningless.
FAULT_TABLE: Dict[str, Dict[str, str]] = {
    "hang_import": {
        "arg": "SECS",
        "injects_at": "platform probe child (probe_platform), "
                      "non-cpu probes only"},
    "die_at_iter": {
        "arg": "K",
        "injects_at": "Booster.update entry (maybe_die_or_preempt)"},
    "sigterm_at_iter": {
        "arg": "K",
        "injects_at": "Booster.update entry (SIGTERM to self)"},
    "corrupt_snapshot": {
        "arg": "[K]",
        "injects_at": "write_snapshot, after the atomic rename"},
    "nan_grad": {
        "arg": "K",
        "injects_at": "the tree_fetch host copy (sentinel_check)"},
    "bogus_platform": {
        "arg": "",
        "injects_at": "probe_platform / resolve_backend request rewrite"},
    "torn_write": {
        "arg": "[K]",
        "injects_at": "ModelPublisher.publish, before the atomic path"},
    "slow_stage": {
        "arg": "NAME:SECS",
        "injects_at": "stage open in the continuous trainer "
                      "(maybe_slow_stage; one-shot per process)"},
    "die_at_publish": {
        "arg": "K",
        "injects_at": "ModelPublisher.publish, between generation rename "
                      "and manifest write"},
    "die_at_predict": {
        "arg": "K",
        "injects_at": "device-predict micro-batch boundary "
                      "(maybe_fail_predict in DevicePredictor.predict_raw)"},
    "slow_predict": {
        "arg": "SECS",
        "injects_at": "device-predict micro-batch boundary "
                      "(maybe_fail_predict; every batch while armed)"},
    "poison_rows": {
        "arg": "F",
        "injects_at": "online ingest, after parse / before quarantine "
                      "(maybe_poison_rows; fraction F of every chunk)"},
    "label_flip": {
        "arg": "K",
        "injects_at": "online cycle K's training-window labels "
                      "(maybe_flip_labels in the continuous trainer)"},
    "regress_model": {
        "arg": "K",
        "injects_at": "continuous trainer's publish seam, after the "
                      "eval gate (maybe_regress_model on cycle K's "
                      "model text)"},
    "die_at_spawn": {
        "arg": "K",
        "injects_at": "ServingRuntime.start, after the prewarm pass and "
                      "before /healthz readiness (maybe_die_at_spawn on "
                      "the K-th spawn ordinal)"},
    "die_at_ring": {
        "arg": "K",
        "injects_at": "ShmClient ring produce, right after the K-th "
                      "request frame is published with its response "
                      "unread (maybe_die_at_ring): the crashed-client "
                      "reclamation path"},
}

FAULT_NAMES = tuple(FAULT_TABLE)


def _fault_spec() -> Dict[str, Optional[str]]:
    """Parse LGBM_TPU_FAULT on every call (cheap, and tests flip the
    environment without any cache to bust)."""
    raw = os.environ.get("LGBM_TPU_FAULT", "")
    if not raw:
        return {}
    out: Dict[str, Optional[str]] = {}
    for tok in raw.split(","):
        tok = tok.strip()
        if not tok:
            continue
        name, _, arg = tok.partition(":")
        if name not in FAULT_NAMES:
            raise ValueError(
                "unknown fault %r in LGBM_TPU_FAULT=%r (known: %s)"
                % (name, raw, ", ".join(FAULT_NAMES)))
        out[name] = arg if arg != "" else None
    return out


def fault_active(name: str) -> bool:
    return name in _fault_spec()


def fault_arg(name: str, default: Optional[str] = None) -> Optional[str]:
    spec = _fault_spec()
    if name not in spec:
        return default
    return spec[name] if spec[name] is not None else default


def maybe_probe_hang_seconds(platform: Optional[str]) -> float:
    """`hang_import:SECS` models a device bind that hangs: the probe
    child sleeps before it imports torch.  A cpu probe never hangs, so
    the injection applies to non-cpu probes only."""
    if platform is None or platform == "cpu":
        return 0.0
    if not fault_active("hang_import"):
        return 0.0
    return float(fault_arg("hang_import", "30"))


def maybe_die_or_preempt(booster) -> None:
    """Training-loop fault hooks, called at every iteration boundary
    (Booster.update entry):

    * ``die_at_iter:K``: an abrupt, snapshot-less death (power loss, the
      OOM killer) once K iterations are complete: `os._exit(137)`.
    * ``sigterm_at_iter:K``: a preemption notice: SIGTERM is delivered to
      this process, which the PreemptionGuard turns into
      write-final-snapshot-then-exit at the iteration boundary.

    The completed iterations are the model's once the dispatch pipeline
    has drained (the JAX package's resilience.py:231).
    """
    spec = _fault_spec()
    if "die_at_iter" not in spec and "sigterm_at_iter" not in spec:
        return
    eng = getattr(booster, "_engine", None)
    if eng is None:
        return
    eng.flush()
    done = int(eng.model.current_iteration)
    if "die_at_iter" in spec and done >= int(spec["die_at_iter"] or 0):
        sys.stderr.write("[%s] FAULT die_at_iter: abrupt exit after %d "
                         "iterations\n" % (wallclock(), done))
        sys.stderr.flush()
        os._exit(137)
    if "sigterm_at_iter" in spec and done == int(spec["sigterm_at_iter"] or 0):
        sys.stderr.write("[%s] FAULT sigterm_at_iter: delivering SIGTERM "
                         "after %d iterations\n" % (wallclock(), done))
        sys.stderr.flush()
        os.kill(os.getpid(), signal.SIGTERM)


def maybe_corrupt_snapshot(path: str, total_iter: int) -> None:
    """`corrupt_snapshot[:K]` truncates the snapshot written at iteration
    K (every snapshot when K is omitted) AFTER the atomic rename: a
    snapshot that landed on disk torn.  Resume must detect it by the
    checksum and fall back to the previous valid snapshot."""
    if not fault_active("corrupt_snapshot"):
        return
    arg = fault_arg("corrupt_snapshot")
    if arg is not None and int(arg) != int(total_iter):
        return
    size = os.path.getsize(path)
    with open(path, "r+b") as fh:
        fh.truncate(max(size // 2, 1))
    sys.stderr.write("[%s] FAULT corrupt_snapshot: truncated %s to %d "
                     "bytes\n" % (wallclock(), path, max(size // 2, 1)))


def maybe_inject_nan(engine, host: Dict) -> None:
    """`nan_grad:K` poisons iteration K's fetched tree outputs the way a
    non-finite gradient burst would (NaN leaf values), so the sentinel's
    detection and policy run end to end."""
    if not fault_active("nan_grad"):
        return
    if int(engine.iter) != int(fault_arg("nan_grad", "0")):
        return
    host["leaf_value"] = host["leaf_value"].copy()
    host["leaf_value"][:] = float("nan")


#: stages already stalled by `slow_stage` in this process: the injection
#: is one-shot per process (a transient stall; a permanent one would only
#: crash-loop the service)
_SLOW_STAGES_FIRED: set = set()


def maybe_slow_stage(stage_name: str, defer: bool = False) -> float:
    """`slow_stage:NAME:SECS` stalls the first stage whose name contains
    NAME for SECS seconds, long enough to blow the stage's watchdog
    deadline: the service must record the timeout in its stage trail and
    go on with the next cycle.  Returns the injected stall (0.0 when
    nothing fired); `defer=True` skips the sleep so the caller can record
    the injection in its trail first (the alarm lands mid-sleep)."""
    if not fault_active("slow_stage"):
        return 0.0
    arg = fault_arg("slow_stage", "")
    name, _, secs = (arg or "").partition(":")
    if not name or name not in stage_name or name in _SLOW_STAGES_FIRED:
        return 0.0
    _SLOW_STAGES_FIRED.add(name)
    stall = float(secs or "5")
    sys.stderr.write("[%s] FAULT slow_stage: stalling stage %r for %.1fs\n"
                     % (wallclock(), stage_name, stall))
    sys.stderr.flush()
    if not defer:
        time.sleep(stall)
    return stall


def maybe_torn_publish(path: str, body: str, publish_count: int) -> None:
    """`torn_write[:K]`: the K-th publish (1-based; every publish when K
    is omitted) lands torn and the process dies: half the body is written
    straight to the final path (no tmp, no fsync, no rename) and the
    process exits abruptly.  Subscribers must reject the torn generation
    by its checksum; the relaunched publisher must republish it."""
    if not fault_active("torn_write"):
        return
    arg = fault_arg("torn_write")
    if arg is not None and int(arg) != int(publish_count):
        return
    with open(path, "w") as fh:
        fh.write(body[: max(len(body) // 2, 1)])
    sys.stderr.write("[%s] FAULT torn_write: tore publish #%d at %s and "
                     "dying\n" % (wallclock(), publish_count, path))
    sys.stderr.flush()
    os._exit(137)


def maybe_die_at_publish(publish_count: int) -> None:
    """`die_at_publish:K` kills the process between the generation file's
    atomic rename and the manifest update of the K-th publish (1-based):
    the newest valid generation on disk is ahead of the manifest.
    Subscribers must still resolve a valid model and the relaunched
    publisher must reconcile."""
    if not fault_active("die_at_publish"):
        return
    if int(fault_arg("die_at_publish", "1")) != int(publish_count):
        return
    sys.stderr.write("[%s] FAULT die_at_publish: abrupt exit mid-publish "
                     "#%d (generation renamed, manifest stale)\n"
                     % (wallclock(), publish_count))
    sys.stderr.flush()
    os._exit(137)


def maybe_die_at_spawn(spawn_ordinal: Optional[int] = None) -> None:
    """`die_at_spawn:K` kills a serving process after its prewarm pass
    and before readiness, the K-th spawn (1-based, from
    ``LGBM_TPU_SPAWN_ORDINAL``, which a spawner sets per child)."""
    if not fault_active("die_at_spawn"):
        return
    if spawn_ordinal is None:
        try:
            spawn_ordinal = int(os.environ.get("LGBM_TPU_SPAWN_ORDINAL",
                                               "1") or 1)
        except ValueError:
            spawn_ordinal = 1
    if int(fault_arg("die_at_spawn", "1")) != int(spawn_ordinal):
        return
    sys.stderr.write("[%s] FAULT die_at_spawn: abrupt exit during spawn "
                     "#%d (prewarmed, never ready)\n"
                     % (wallclock(), spawn_ordinal))
    sys.stderr.flush()
    os._exit(137)


def maybe_die_at_ring(frames_in_flight: int) -> None:
    """`die_at_ring:K` kills a shared-memory ring client the instant its
    K-th request frame is published with the response still unread: the
    server holds a mapped segment with live admissions aliasing it and a
    peer that will never drain the response ring.  The server must see
    the death on the control socket, drain the in-flight work, unmap with
    no leaked mapping and keep serving every other client."""
    if not fault_active("die_at_ring"):
        return
    if int(fault_arg("die_at_ring", "1")) != int(frames_in_flight):
        return
    sys.stderr.write("[%s] FAULT die_at_ring: abrupt client exit with "
                     "%d frames in flight in the ring\n"
                     % (wallclock(), frames_in_flight))
    sys.stderr.flush()
    os._exit(137)


#: device-predict fault bookkeeping: batches seen while die_at_predict is
#: armed (the victim is the predict call, never the process)
_PREDICT_FAULT = {"batches": 0}


class DevicePredictFault(RuntimeError):
    """The injected stand-in for a device failure mid-predict
    (`LGBM_TPU_FAULT=die_at_predict`): the serving runtime must catch it,
    trip its circuit breaker and answer from the host predictor."""


def maybe_fail_predict() -> None:
    """Serving fault seam, consulted at every device-predict micro-batch
    boundary (models/device_predictor.py `predict_raw`, inside the
    predictor's device lock):

    * ``slow_predict:SECS`` stalls every device batch by SECS while armed,
      long enough to blow the serving runtime's predict deadline: the
      batch is re-served from the host and the timeout lands in the
      serving stage trail.
    * ``die_at_predict:K``: the K-th device batch (1-based, counted while
      armed) and every later one raise `DevicePredictFault`; the runtime
      degrades to the host predictor and recovers once the fault clears.
    """
    spec = _fault_spec()
    if "slow_predict" in spec:
        stall = float(spec["slow_predict"] or "5")
        sys.stderr.write("[%s] FAULT slow_predict: stalling device batch "
                         "for %.1fs\n" % (wallclock(), stall))
        sys.stderr.flush()
        time.sleep(stall)
    if "die_at_predict" in spec:
        _PREDICT_FAULT["batches"] += 1
        if _PREDICT_FAULT["batches"] >= int(spec["die_at_predict"] or "1"):
            sys.stderr.write("[%s] FAULT die_at_predict: failing device "
                             "batch #%d\n"
                             % (wallclock(), _PREDICT_FAULT["batches"]))
            sys.stderr.flush()
            raise DevicePredictFault(
                "injected device predict failure "
                "(LGBM_TPU_FAULT=die_at_predict, batch #%d)"
                % _PREDICT_FAULT["batches"])


def maybe_poison_rows(X, y):
    """`poison_rows:F` corrupts fraction F of every parsed ingest chunk
    as an upstream logging outage would: a stride of rows gets a
    non-finite label (alternating NaN / +inf).  The quarantine must route
    every poisoned row to its ledger.  Returns (y, n_poisoned); X is
    untouched (NaN features are legitimate missing values)."""
    if not fault_active("poison_rows") or y is None or len(y) == 0:
        return y, 0
    frac = float(fault_arg("poison_rows", "0.1"))
    if frac <= 0:
        return y, 0
    stride = max(int(round(1.0 / min(frac, 1.0))), 1)
    import numpy as np
    y = np.array(y, dtype=np.float64, copy=True)
    idx = np.arange(0, len(y), stride)
    y[idx[0::2]] = float("nan")
    y[idx[1::2]] = float("inf")
    sys.stderr.write("[%s] FAULT poison_rows: poisoned %d/%d labels\n"
                     % (wallclock(), len(idx), len(y)))
    sys.stderr.flush()
    return y, int(len(idx))


def maybe_flip_labels(y, cycle: int):
    """`label_flip:K` inverts the training labels of cycle K's window:
    valid-looking values carrying wrong information, which the quarantine
    cannot catch.  The pre-publish eval gate must refuse the model.
    Returns (y, flipped?)."""
    if not fault_active("label_flip") or y is None or len(y) == 0:
        return y, False
    if int(fault_arg("label_flip", "0")) != int(cycle):
        return y, False
    import numpy as np
    y = np.asarray(y, dtype=np.float64)
    flipped = (float(np.max(y)) + float(np.min(y))) - y
    sys.stderr.write("[%s] FAULT label_flip: inverted cycle %d's %d "
                     "labels\n" % (wallclock(), cycle, len(y)))
    sys.stderr.flush()
    return flipped, True


def maybe_regress_model(model_text: str, cycle: int) -> str:
    """`regress_model:K` sabotages cycle K's model text at the publish
    seam, after the eval gate: every `leaf_value=` line is scaled by -2,
    a valid, loadable model whose predictions are badly wrong, which only
    the serving canary can catch."""
    if not fault_active("regress_model"):
        return model_text
    if int(fault_arg("regress_model", "0")) != int(cycle):
        return model_text
    lines = model_text.split("\n")
    for i, line in enumerate(lines):
        if line.startswith("leaf_value="):
            vals = ["%.17g" % (-2.0 * float(tok))
                    for tok in line[len("leaf_value="):].split()]
            lines[i] = "leaf_value=" + " ".join(vals)
    sys.stderr.write("[%s] FAULT regress_model: sabotaged cycle %d's "
                     "leaf values at the publish seam\n"
                     % (wallclock(), cycle))
    sys.stderr.flush()
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# stage watchdog
# ---------------------------------------------------------------------------

class StageTimeout(RuntimeError):
    """A watchdogged stage exceeded its deadline (soft mode)."""

    def __init__(self, stage: str, seconds: float):
        super().__init__("stage %r exceeded its %ds deadline"
                         % (stage, seconds))
        self.stage = stage
        self.seconds = seconds


#: hard-mode exit code.  Not 124 (a bare timeout's): rc 73 means "the
#: stage watchdog fired and the diagnostics are in the stage report /
#: stderr", never "something hung silently".
WATCHDOG_EXIT_CODE = 73


def _dump_all_threads() -> str:
    """faulthandler tracebacks of every thread, as text."""
    import faulthandler
    with tempfile.TemporaryFile(mode="w+") as fh:
        faulthandler.dump_traceback(file=fh, all_threads=True)
        fh.seek(0)
        return fh.read()


class Watchdog:
    """Per-stage SIGALRM watchdog with a persistent stage trail.

    ``wd(name)`` (or ``wd.stage_scope(name, seconds)``) opens a named
    stage under a deadline; a hung stage prints its name, dumps the
    tracebacks of all threads, rewrites the JSON report (when
    ``report_path`` or ``$LGBM_TPU_STAGE_REPORT`` is set) and then either
    raises `StageTimeout` (``hard=False``) or kills the process (group)
    with `WATCHDOG_EXIT_CODE` (``hard=True``).  The report is rewritten at
    every stage transition too, so even a SIGKILL'd process leaves a trail
    naming the stage it died in.

    **Thread mode** (`use_alarm=False`, chosen off the main thread):
    SIGALRM cannot be armed outside the main thread, so the watchdog keeps
    the trail only and the owner enforces its deadlines, reporting an
    expiry through `record_timeout()`.  `keep_last=N` bounds the trail
    for long-lived owners; dropped entries are counted in the report.
    Every stage close is also a span in the metrics registry
    (`telemetry.record_span`).
    """

    def __init__(self, seconds: int, hard: bool = False,
                 report_path: Optional[str] = None,
                 kill_process_group: bool = False,
                 label: str = "stage", stream=None,
                 use_alarm: Optional[bool] = None,
                 keep_last: Optional[int] = None):
        self.seconds = int(seconds)
        self.hard = hard
        self.report_path = report_path or os.environ.get(
            "LGBM_TPU_STAGE_REPORT")
        self.kill_process_group = kill_process_group
        self.label = label
        self.stream = stream  # None -> sys.stdout at emit time
        if use_alarm is None:
            use_alarm = (hasattr(signal, "SIGALRM") and threading
                         .current_thread() is threading.main_thread())
        self.use_alarm = bool(use_alarm)
        self.keep_last = keep_last
        self.dropped_stages = 0
        self.stage = "<init>"
        self.stages: List[Dict[str, Any]] = []
        self.tracebacks: Optional[str] = None
        self._t0: Optional[float] = None

    # -- trail bookkeeping ---------------------------------------------------
    def _close_current(self, status: str) -> None:
        if self._t0 is not None and self.stages:
            dur = round(time.monotonic() - self._t0, 3)
            self.stages[-1]["dur_s"] = dur
            self.stages[-1]["status"] = status
            # lazy import: telemetry imports this module at its scope
            try:
                from . import telemetry
                telemetry.record_span(
                    "%s/%s" % (self.label, self.stages[-1]["name"]),
                    dur, status=status)
            except Exception as e:           # noqa: BLE001 — never fatal
                sys.stderr.write("[%s] WATCHDOG: stage span not recorded "
                                 "(%s: %s)\n" % (wallclock(),
                                                 type(e).__name__, e))
        self._t0 = None

    def report(self) -> Dict[str, Any]:
        rep: Dict[str, Any] = {"stages": self.stages, "culprit": None}
        for st in self.stages:
            if st.get("status") in ("timeout", "running", "error"):
                rep["culprit"] = st["name"]
        if self.dropped_stages:
            rep["dropped_stages"] = self.dropped_stages
        if self.tracebacks is not None:
            rep["tracebacks"] = self.tracebacks
        return rep

    def _persist(self) -> None:
        if not self.report_path:
            return
        try:
            atomic_write(self.report_path,
                         json.dumps(self.report(), indent=1))
        except OSError as e:
            # the report must never take the run down, but says so
            sys.stderr.write("[%s] WATCHDOG: stage report %s not written "
                             "(%s)\n" % (wallclock(), self.report_path, e))

    # -- stage transitions ---------------------------------------------------
    def __call__(self, stage: str, seconds: Optional[int] = None) -> None:
        """Open `stage` under a deadline (default: the watchdog's),
        closing the previous stage as ok."""
        self._close_current("ok")
        budget = int(seconds if seconds is not None else self.seconds)
        self.stage = stage
        self.stages.append({"name": stage, "t_start": wallclock(),
                            "budget_s": budget, "status": "running"})
        if self.keep_last and len(self.stages) > self.keep_last:
            drop = len(self.stages) - self.keep_last
            del self.stages[:drop]
            self.dropped_stages += drop
        self._t0 = time.monotonic()
        out = self.stream if self.stream is not None else sys.stdout
        out.write("[%s] %s: %s (budget %ds)\n"
                  % (wallclock(), self.label, stage, budget))
        out.flush()
        self._persist()
        if self.use_alarm:
            if budget > 0:
                signal.signal(signal.SIGALRM, self._fire)
                signal.alarm(budget)
            else:
                # an unbounded stage disarms the previous stage's alarm,
                # which would otherwise blame this stage for its deadline
                signal.alarm(0)

    def annotate(self, key: str, value: Any) -> None:
        """Attach structured evidence to the CURRENT stage's trail entry
        and persist it again."""
        if self.stages:
            self.stages[-1][key] = value
            self._persist()

    @contextlib.contextmanager
    def stage_scope(self, stage: str, seconds: Optional[int] = None):
        """Context-manager spelling; closes the stage on exit.  The alarm
        is disarmed on every exit path."""
        self(stage, seconds)
        try:
            yield
        except StageTimeout:
            raise
        except BaseException:
            if self.use_alarm:
                signal.alarm(0)
            self._close_current("error")
            self._persist()
            raise
        else:
            self.done(final=False)

    def _fire(self, signum, frame):
        self._close_current("timeout")
        self.tracebacks = _dump_all_threads()
        msg = ("[%s] WATCHDOG: %s %r exceeded its deadline; thread "
               "tracebacks follow\n%s"
               % (wallclock(), self.label, self.stage, self.tracebacks))
        sys.stderr.write(msg)
        sys.stderr.flush()
        self._persist()
        if self.hard:
            if self.kill_process_group:
                try:
                    # children first; this process dies of its own SIGKILL
                    os.killpg(os.getpgid(0), signal.SIGKILL)
                except (OSError, PermissionError):
                    pass
            os._exit(WATCHDOG_EXIT_CODE)
        raise StageTimeout(self.stage, self.stages[-1]["budget_s"]
                           if self.stages else self.seconds)

    def record_timeout(self, note: Optional[str] = None) -> None:
        """Thread-mode deadline expiry reported by the owner: the current
        stage closes as ``timeout`` with the tracebacks captured and the
        report persisted, as a fired alarm would, but nothing raises and
        nothing exits."""
        self._close_current("timeout")
        if note and self.stages:
            self.stages[-1]["note"] = note
        self.tracebacks = _dump_all_threads()
        sys.stderr.write("[%s] WATCHDOG: %s %r exceeded its deadline "
                         "(thread mode)%s\n"
                         % (wallclock(), self.label, self.stage,
                            ": " + note if note else ""))
        sys.stderr.flush()
        self._persist()

    def done(self, final: bool = True) -> None:
        """Disarm the alarm (before the owner returns: an orphaned SIGALRM
        would kill the process later)."""
        if self.use_alarm:
            signal.alarm(0)
            if final:
                signal.signal(signal.SIGALRM, signal.SIG_DFL)
        self._close_current("ok")
        if final:
            self._persist()


def backoff_delays(attempts: int, base: float = 1.0, cap: float = 8.0,
                   seed: int = 0) -> List[float]:
    """Deterministic jittered exponential backoff (full jitter, seeded so
    tests and ranks are reproducible)."""
    delays = []
    state = (seed * 2654435761 + 12345) & 0xFFFFFFFF
    for a in range(max(attempts - 1, 0)):
        state = (state * 1103515245 + 12345) & 0x7FFFFFFF
        frac = 0.5 + (state / 0x7FFFFFFF) * 0.5          # [0.5, 1.0)
        delays.append(round(min(cap, base * (2 ** a)) * frac, 2))
    return delays


#: the probe child: dumps its own tracebacks and exits shortly BEFORE the
#: parent's kill lands, so a hung bind still leaves evidence on stderr.
#: `_LGBM_TPU_PROBE_HANG` carries the injected hang (from the parent's
#: fault spec; a real hang inside torch's CUDA init is caught the same
#: way).
_PROBE_CHILD = r"""
import faulthandler, os, sys, time
faulthandler.dump_traceback_later(%(dump_after)f, exit=True)
hang = float(os.environ.get("_LGBM_TPU_PROBE_HANG", "0"))
if hang > 0:
    time.sleep(hang)
platform = os.environ["_LGBM_TPU_PROBE_PLATFORM"]
import torch
if platform == "cpu":
    print("platform=cpu devices=1 name=cpu", flush=True)
elif platform in ("cuda", "gpu"):
    if not torch.cuda.is_available():
        sys.exit("platform %%s: no CUDA device (torch.cuda.is_available() "
                 "is false)" %% platform)
    torch.cuda.init()
    print("platform=cuda devices=%%d name=%%s"
          %% (torch.cuda.device_count(), torch.cuda.get_device_name(0)),
          flush=True)
else:
    sys.exit("unknown platform %%r: the PyTorch package runs on cuda or "
             "cpu" %% platform)
"""


def probe_platform(platform: Optional[str] = None, deadline: float = 20.0
                   ) -> Dict[str, Any]:
    """One short-deadline subprocess probe of the device's initialization
    (`platform` "cuda", the default, or "cpu").

    Returns a machine-readable record: ``{"ok": bool, "platform":
    requested, "backend": reported backend or None, "devices",
    "device_name", "rc", "dur_s", "reason", "tail"}`` (``tail``, the
    child's stderr, on failure only).  Never hangs: the child self-dumps
    and exits just before `deadline`, and the parent kills it at
    `deadline` if even that failed."""
    env = dict(os.environ)
    req = platform if platform is not None else "cuda"
    if fault_active("bogus_platform") and req != "cpu":
        req = "bogus"
    env["_LGBM_TPU_PROBE_PLATFORM"] = req
    hang = maybe_probe_hang_seconds(req)
    if hang > 0:
        env["_LGBM_TPU_PROBE_HANG"] = str(hang)
    code = _PROBE_CHILD % {"dump_after": max(deadline - 2.0, 1.0)}
    t0 = time.monotonic()
    rec: Dict[str, Any] = {"platform": req, "ok": False, "backend": None,
                           "devices": None, "device_name": None,
                           "rc": None, "reason": None,
                           "t_start": wallclock()}
    try:
        r = subprocess.run([sys.executable, "-c", code], env=env,
                           timeout=deadline, capture_output=True, text=True)
        rec["rc"] = r.returncode
        out = (r.stdout or "").strip().splitlines()
        tail = (r.stderr or "")[-2000:]
        if r.returncode == 0 and out and out[-1].startswith("platform="):
            head, _, name = out[-1].partition(" name=")
            fields = dict(kv.split("=", 1) for kv in head.split())
            rec.update(ok=True, backend=fields["platform"],
                       devices=int(fields["devices"]), device_name=name)
        elif "Timeout" in tail or "dump_traceback_later" in tail \
                or r.returncode != 0 and "Thread 0x" in tail:
            rec["reason"] = "hang (child self-dumped at deadline)"
            rec["tail"] = tail
        else:
            rec["reason"] = "init failed (rc=%d)" % r.returncode
            rec["tail"] = tail
    except subprocess.TimeoutExpired as e:
        rec["rc"] = -9
        rec["reason"] = "hang (parent killed the probe at %.0fs)" % deadline
        rec["tail"] = ((e.stderr or b"").decode("utf-8", "replace")
                       if isinstance(e.stderr, bytes)
                       else (e.stderr or ""))[-2000:]
    rec["dur_s"] = round(time.monotonic() - t0, 2)
    return rec


class BackendUnavailable(RuntimeError):
    """The requested device did not come up within the probe's retries.
    `event` is the machine-readable degradation record (the JAX package's
    ``platform_degradation`` event, with ``"to": None``: the port does
    not land on the CPU on its own); `trail` the probe records."""

    def __init__(self, event: Dict[str, Any], trail: List[Dict[str, Any]]):
        super().__init__(
            "platform %s did not come up after %d probe(s) (%s); the "
            "PyTorch package runs on the CPU only when asked "
            "(device_type=cpu)" % (event["from"], event["attempts"],
                                   event["reason"]))
        self.event = event
        self.trail = trail


def resolve_backend(requested: Optional[str] = None, deadline: float = 20.0,
                    attempts: int = 2
                    ) -> Tuple[str, None, List[Dict[str, Any]]]:
    """Probe `requested` ("cuda", the default, or "cpu") up to `attempts`
    times with the JAX package's jittered backoff.  Returns ``(backend,
    None, probe_trail)`` (the JAX triple, whose degradation event is
    always None here); a probe that never succeeds raises
    `BackendUnavailable` with the event::

        {"event": "platform_degradation", "from": ..., "to": None,
         "reason": ..., "attempts": N, "probes": [...], "wallclock": ...}
    """
    req = requested if requested is not None else "cuda"
    if req == "gpu":
        req = "cuda"
    trail: List[Dict[str, Any]] = []
    if req == "cpu":
        trail.append(probe_platform("cpu", deadline=deadline))
        return "cpu", None, trail
    delays = backoff_delays(attempts)
    for a in range(attempts):
        rec = probe_platform(req, deadline=deadline)
        trail.append(rec)
        if rec["ok"]:
            return rec["backend"], None, trail
        if a < len(delays):
            time.sleep(delays[a])
    event = {
        "event": "platform_degradation",
        "from": trail[-1]["platform"], "to": None,
        "reason": trail[-1].get("reason") or "probe failed",
        "attempts": attempts,
        "probes": [{k: v for k, v in t.items() if k != "tail"}
                   for t in trail],
        "wallclock": wallclock(),
    }
    raise BackendUnavailable(event, trail)


# ---------------------------------------------------------------------------
# atomic snapshot writes + checksum + retention
# ---------------------------------------------------------------------------

def atomic_write(path: str, text: str) -> None:
    """tmp + flush + fsync + rename in the destination directory: a crash
    at any point leaves the old file or the new one, never a torn write
    and never a stray tmp file."""
    d = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(prefix=".%s.tmp" % os.path.basename(path),
                               dir=d)
    try:
        with os.fdopen(fd, "w") as fh:
            fh.write(text)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, path)
    except BaseException:
        with contextlib.suppress(OSError):
            os.unlink(tmp)
        raise


def read_stage_report(path: str) -> Optional[Dict[str, Any]]:
    """Tolerant stage-trail reader: the report dict, or None for a
    missing, unreadable, torn or non-JSON file."""
    try:
        with open(path) as fh:
            rep = json.load(fh)
    except (OSError, ValueError):
        return None
    return rep if isinstance(rep, dict) else None


_STATE_PREFIX = "!snapshot_state="
_CHECKSUM_PREFIX = "!snapshot_checksum=sha256:"

#: zlib level of the footer's blobs.  The score planes and the row order
#: are floats and a permutation, which zlib barely shrinks (0.1 % at 1M
#: rows) at ~1 s a snapshot for the two passes at the default level;
#: stored blocks (level 0) are zlib all the same, so either package's
#: reader decodes them.
ZLIB_LEVEL = 0


def _with_footer(model_text: str, state: Dict[str, Any]) -> str:
    """Model text + state footer + checksum line.  The footer lies past
    'end of trees', where the model parser reads only the parameters, so
    a snapshot file IS a loadable model file."""
    blob = base64.b64encode(
        zlib.compress(json.dumps(state).encode(), ZLIB_LEVEL)).decode()
    body = model_text
    if not body.endswith("\n"):
        body += "\n"
    body += _STATE_PREFIX + blob + "\n"
    digest = hashlib.sha256(body.encode()).hexdigest()
    return body + _CHECKSUM_PREFIX + digest + "\n"


def validate_snapshot(path: str) -> Tuple[bool, str]:
    """(ok, reason).  A snapshot is valid iff it ends with a checksum line
    whose sha256 matches everything before it and its state footer
    decodes: truncated, torn and bit-flipped files all fail."""
    try:
        with open(path, "rb") as fh:
            raw = fh.read()
    except OSError as e:
        return False, "unreadable: %s" % e
    text = raw.decode("utf-8", "replace")
    lines = text.rstrip("\n").split("\n")
    if not lines or not lines[-1].startswith(_CHECKSUM_PREFIX):
        return False, "missing checksum footer (truncated?)"
    digest = lines[-1][len(_CHECKSUM_PREFIX):].strip()
    body = text[: text.rfind(_CHECKSUM_PREFIX)]
    if hashlib.sha256(body.encode()).hexdigest() != digest:
        return False, "checksum mismatch (torn or corrupted write)"
    if load_snapshot_state(path, _prevalidated_text=text) is None:
        return False, "state footer missing or undecodable"
    return True, "ok"


def load_snapshot_state(path: str, _prevalidated_text: Optional[str] = None
                        ) -> Optional[Dict[str, Any]]:
    """The state dict from a snapshot's footer, or None."""
    try:
        if _prevalidated_text is None:
            with open(path) as fh:
                _prevalidated_text = fh.read()
        for line in reversed(_prevalidated_text.rstrip("\n").split("\n")):
            if line.startswith(_STATE_PREFIX):
                blob = line[len(_STATE_PREFIX):].strip()
                return json.loads(zlib.decompress(
                    base64.b64decode(blob)).decode())
    except (OSError, ValueError, zlib.error):
        return None
    return None


def snapshot_model_text(path: str) -> Optional[str]:
    """The model-text portion of a snapshot file (everything before the
    state footer), byte for byte what `save_model_to_string()` gave at
    capture time: the continuous trainer republishes from it after a
    death between snapshot and publish.  None when the file has no
    footer."""
    try:
        with open(path) as fh:
            text = fh.read()
    except OSError:
        return None
    cut = text.find(_STATE_PREFIX)
    if cut < 0:
        return None
    return text[:cut]


def snapshot_paths(output_model: str) -> List[Tuple[int, str]]:
    """Existing ``<output_model>.snapshot_iter_<N>`` files, newest first."""
    d = os.path.dirname(os.path.abspath(output_model)) or "."
    base = os.path.basename(output_model) + ".snapshot_iter_"
    out = []
    try:
        names = os.listdir(d)
    except OSError:
        return []
    for name in names:
        if name.startswith(base):
            tail = name[len(base):]
            if tail.isdigit():
                out.append((int(tail), os.path.join(d, name)))
    out.sort(reverse=True)
    return out


def _warner(log):
    def warn(msg, *args):
        if log is not None:
            log.warning(msg, *args)
        else:
            sys.stderr.write("resilience: " + (msg % args) + "\n")
    return warn


def find_resume_snapshot(output_model: str, log=None
                         ) -> Tuple[Optional[str], Optional[Dict[str, Any]]]:
    """Newest VALID snapshot of `output_model`, scanning past corrupt or
    truncated ones with a warning for each."""
    warn = _warner(log)
    for it, path in snapshot_paths(output_model):
        ok, reason = validate_snapshot(path)
        if ok:
            return path, load_snapshot_state(path)
        warn("snapshot %s is invalid (%s); falling back to the previous "
             "one", path, reason)
    return None, None


# ---------------------------------------------------------------------------
# training-state capture / restore (byte-identical resume)
# ---------------------------------------------------------------------------

def _b64_np(arr) -> str:
    import numpy as np
    a = np.ascontiguousarray(arr)
    return base64.b64encode(zlib.compress(a.tobytes(), ZLIB_LEVEL)).decode()


def _np_b64(blob: str, dtype, shape):
    import numpy as np
    raw = zlib.decompress(base64.b64decode(blob))
    return np.frombuffer(raw, dtype=dtype).reshape(shape).copy()


def _rng_state_to_json(rng) -> Dict[str, Any]:
    """numpy Generator (Philox) state -> JSON-able dict."""
    import numpy as np

    def conv(v):
        if isinstance(v, dict):
            return {k: conv(x) for k, x in v.items()}
        if isinstance(v, np.ndarray):
            return {"__nd__": v.dtype.str, "data": v.tolist()}
        if isinstance(v, (np.integer,)):
            return int(v)
        return v

    return conv(rng._rng.bit_generator.state)


def _rng_state_from_json(rng, state: Dict[str, Any]) -> None:
    import numpy as np

    def conv(v):
        if isinstance(v, dict):
            if "__nd__" in v:
                return np.asarray(v["data"], dtype=np.dtype(v["__nd__"]))
            return {k: conv(x) for k, x in v.items()}
        return v

    rng._rng.bit_generator.state = conv(state)


def _params_fingerprint(raw_params: Dict[str, Any]) -> str:
    items = sorted((str(k), str(v)) for k, v in raw_params.items())
    return hashlib.sha256(json.dumps(items).encode()).hexdigest()[:16]


def _scores_and_order(eng):
    """([K, n_pad] f32 scores in original row order, [n_rows] int32 row
    order of the payload or None) in ONE blocking fetch (`snapshot`): the
    scores and the decoded index column, both exact in f64, go as one
    block."""
    import numpy as np
    import torch
    from . import syncs
    if not eng._fast_active:
        return np.asarray(syncs.device_get(eng.score, label="snapshot"),
                          np.float32), None
    fs = eng._fast
    block = torch.cat([fs.original_scores().double().reshape(-1),
                       fs.row_index().double()])
    host = syncs.device_get(block, label="snapshot")
    n = fs.K * fs.n_pad
    return (host[:n].astype(np.float32).reshape(fs.K, fs.n_pad),
            host[n:].astype(np.int32))


def capture_training_state(booster) -> Dict[str, Any]:
    """Everything a resumed run needs to continue BYTE-IDENTICALLY to an
    uninterrupted one, beyond the trees: the padded raw score planes, the
    payload's row order (the CPU's f32 histograms sum in row order, and
    GOSS draws over the payload's rows), the bag mask and both host RNG
    streams, and the variant's bookkeeping (DART's drop RNG and tree
    weights).  The JAX package's footer, field for field; the one
    blocking fetch is labelled `snapshot`."""
    return _capture(booster)[0]


def _capture(booster):
    """(capture_training_state's dict, the [K, n_pad] scores it
    encodes)."""
    import numpy as np
    eng = booster._engine
    if eng is None:
        raise RuntimeError("capture_training_state needs a training Booster")
    # every dispatched tree in the model and an open boosting window
    # settled at the reported iteration (the JAX package's :1081)
    eng.flush(sync_scores=True)
    score, perm = _scores_and_order(eng)
    state: Dict[str, Any] = {
        "version": 1,
        "total_iter": int(eng.model.current_iteration),
        "boosting": type(eng).__name__,
        "K": int(eng.num_tree_per_iteration),
        "n_pad": int(eng.train_set.num_data_padded),
        "num_data": int(eng.train_set.num_data),
        "score": _b64_np(score),
        "perm": _b64_np(perm) if perm is not None else None,
        "perm_len": int(perm.size) if perm is not None else 0,
        "bag_mask": _b64_np(np.packbits(eng.bag_mask_host > 0)),
        "bagging_rng": _rng_state_to_json(eng.bagging_rng),
        "feature_rng": _rng_state_to_json(eng.feature_rng),
        "shrinkage_rate": float(eng.shrinkage_rate),
        "boosted_from_average": bool(eng._boosted_from_average),
        # the JAX package's record of the boost-from-average score; the
        # port folds it into the first tree and keeps no copy
        "init_score_value": float(getattr(eng, "init_score_value", 0.0)),
        "params_fingerprint": _params_fingerprint(
            getattr(eng.config, "raw_params", {})),
    }
    if hasattr(eng, "random_for_drop"):                     # DART
        state["dart"] = {
            "drop_rng": _rng_state_to_json(eng.random_for_drop),
            "tree_weight": [float(w) for w in eng.tree_weight],
            "sum_weight": float(eng.sum_weight),
        }
    return state, score


def restore_training_state(booster, state: Dict[str, Any], log=None) -> None:
    """Surgery on a freshly made Booster (init_model = the snapshot's
    trees) that makes its next iteration arithmetically identical to the
    uninterrupted run's, before its payload is built (the order of the
    continued-training replay):

    * the padded raw scores are installed verbatim (over the replay's f32
      re-rounding of the loaded f64 leaf values);
    * the iteration counter moves to the run's global clock (``iter =
      total, num_init_iteration = 0``), so the bagging grid, GOSS's
      warm-up and key, RF's average and DART's drop candidates see the
      uninterrupted run's history;
    * both host RNG streams and DART's drop RNG and tree weights resume
      mid-stream;
    * the payload is built from the installed scores and its rows put in
      the captured order (each row of the identity-ordered payload moved
      whole, its index column(s) with it), with the bag applied again at
      the next iteration (`bag_dirty`).
    A snapshot of another dataset (K, padded or real rows) is refused with
    a warning and training continues as plain continued training."""
    import numpy as np
    import torch
    warn = _warner(log)
    eng = booster._engine
    if eng is None:
        raise RuntimeError("restore_training_state needs a training Booster")
    K, n_pad = int(state["K"]), int(state["n_pad"])
    if (K != eng.num_tree_per_iteration
            or n_pad != eng.train_set.num_data_padded
            or int(state["num_data"]) != eng.train_set.num_data):
        warn("snapshot shape (K=%d, n_pad=%d) does not match this dataset "
             "(K=%d, n_pad=%d); resuming with plain continued-training "
             "semantics instead", K, n_pad, eng.num_tree_per_iteration,
             eng.train_set.num_data_padded)
        return
    fp = _params_fingerprint(getattr(eng.config, "raw_params", {}))
    if state.get("params_fingerprint") not in (None, fp):
        warn("training parameters differ from the snapshot's; the resumed "
             "model may not be byte-identical to an uninterrupted run")

    score = _np_b64(state["score"], np.float32, (K, n_pad))
    eng.score = torch.from_numpy(score).to(eng.device)
    eng._fast_active = False
    eng.iter = int(state["total_iter"])
    eng.num_init_iteration = 0
    eng.shrinkage_rate = float(state["shrinkage_rate"])
    eng._boosted_from_average = bool(state["boosted_from_average"])
    bag_bits = _np_b64(state["bag_mask"], np.uint8, (-1,))
    eng.bag_mask_host = np.unpackbits(bag_bits)[:n_pad].astype(np.float32)
    _rng_state_from_json(eng.bagging_rng, state["bagging_rng"])
    _rng_state_from_json(eng.feature_rng, state["feature_rng"])
    if "dart" in state and hasattr(eng, "random_for_drop"):
        _rng_state_from_json(eng.random_for_drop, state["dart"]["drop_rng"])
        eng.tree_weight = [float(w) for w in state["dart"]["tree_weight"]]
        eng.sum_weight = float(state["dart"]["sum_weight"])

    if state.get("perm"):
        fs = eng._enter_fast()          # identity-ordered, from eng.score
        perm = _np_b64(state["perm"], np.int32, (int(state["perm_len"]),))
        if perm.size == fs.n_rows:
            # row j of the uninterrupted payload held original row
            # perm[j]; the guard rows all hold one content, so the first
            # guard row sources them
            src = torch.from_numpy(np.where(perm < n_pad, perm, n_pad)
                                   .astype(np.int64)).to(eng.device)
            fs.payload.copy_(fs.payload[src])
            fs.bag_dirty = True
        else:
            warn("snapshot payload order length %d does not match the "
                 "rebuilt payload (%d rows); resuming in identity order "
                 "(the model may differ in low-order bits)",
                 perm.size, fs.n_rows)


def make_resume_callback(state: Dict[str, Any], log=None):
    """A before-iteration callback that restores `state` once, before the
    first resumed iteration (train() makes the Booster, so this is the
    earliest seam)."""
    done = {"flag": False}

    def _callback(env) -> None:
        if done["flag"]:
            return
        done["flag"] = True
        restore_training_state(env.model, state, log=log)

    _callback.before_iteration = True
    _callback.order = 0
    return _callback


def write_snapshot(booster, output_model: str, total_iter: Optional[int] = None,
                   retention: int = -1, log=None,
                   extra_state: Optional[Dict[str, Any]] = None,
                   retention_grace_s: float = 0.0) -> Optional[str]:
    """Atomic snapshot ``<output_model>.snapshot_iter_<N>``: the model and
    the resume state footer, with keep-last-`retention` cleanup (<= 0
    keeps everything).  Non-finite scores are not snapshotted (a poisoned
    snapshot would poison the resume).  `extra_state` goes under the
    footer's ``"service"`` key (the continuous trainer's schedule clock;
    resume ignores it).  With `retention_grace_s` > 0 a snapshot past the
    K newest is unlinked only once it is also older than the grace
    window, so a reader that just resolved its path can still read it."""
    import numpy as np
    state, score = _capture(booster)
    if extra_state:
        state["service"] = dict(extra_state)
    if total_iter is None:
        total_iter = state["total_iter"]
    if not np.isfinite(score).all():
        _warner(log)("scores are non-finite at iteration %d; snapshot NOT "
                     "written", total_iter)
        return None
    path = "%s.snapshot_iter_%d" % (output_model, total_iter)
    atomic_write(path, _with_footer(
        booster._model.save_model_to_string(), state))
    maybe_corrupt_snapshot(path, total_iter)
    if retention > 0:
        cutoff = time.time() - max(retention_grace_s, 0.0)
        for it, old in snapshot_paths(output_model)[retention:]:
            with contextlib.suppress(OSError):
                if retention_grace_s <= 0 or os.path.getmtime(old) < cutoff:
                    os.unlink(old)
    return path


# ---------------------------------------------------------------------------
# preemption guard (SIGTERM/SIGINT -> final snapshot -> exit)
# ---------------------------------------------------------------------------

class TrainingPreempted(Exception):
    """Raised at the iteration boundary after a preemption signal; the
    final snapshot is written when this propagates."""

    def __init__(self, signum: int, iteration: int,
                 snapshot: Optional[str]):
        super().__init__("training preempted by signal %d at iteration %d"
                         % (signum, iteration))
        self.signum = signum
        self.iteration = iteration
        self.snapshot = snapshot


class PreemptionGuard:
    """SIGTERM/SIGINT -> write-final-snapshot-then-exit, at the next
    iteration boundary (mid-iteration state, a half-appended multiclass
    iteration or trees queued on the card, is not snapshotable; one
    iteration bounds the preemption latency).

    Use as a context manager around the training loop; `callback` goes
    LAST among the after-iteration callbacks."""

    def __init__(self, output_model: str, retention: int = -1, log=None):
        self.output_model = output_model
        self.retention = retention
        self.log = log
        self.signum: Optional[int] = None
        self._prev: Dict[int, Any] = {}

        def _callback(env) -> None:
            if self.signum is None:
                return
            total = int(env.model.current_iteration())
            snap = write_snapshot(env.model, self.output_model,
                                  total_iter=total,
                                  retention=self.retention, log=self.log)
            raise TrainingPreempted(self.signum, total, snap)

        _callback.order = 100
        self.callback = _callback

    def _handler(self, signum, frame):
        self.signum = signum
        sys.stderr.write("[%s] preemption signal %d received; writing a "
                         "final snapshot at the next iteration boundary\n"
                         % (wallclock(), signum))
        sys.stderr.flush()

    def __enter__(self) -> "PreemptionGuard":
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                self._prev[sig] = signal.signal(sig, self._handler)
            except ValueError:
                # not the main thread: the guard is inert, and says so
                sys.stderr.write("[%s] PreemptionGuard: signal %d cannot be "
                                 "handled off the main thread; the guard "
                                 "is inert\n" % (wallclock(), sig))
        return self

    def __exit__(self, *exc) -> None:
        for sig, prev in self._prev.items():
            with contextlib.suppress(ValueError):
                signal.signal(sig, prev)
        return None


# ---------------------------------------------------------------------------
# non-finite sentinel
# ---------------------------------------------------------------------------

class NonFiniteDetected(ArithmeticError):
    """A freshly grown tree carried NaN / inf outputs (the symptom of a
    non-finite gradient, hessian or score burst)."""

    def __init__(self, iteration: int, tree_index: int, field: str):
        super().__init__(
            "non-finite %s detected in the tree grown at iteration %d "
            "(tree %d)" % (field, iteration, tree_index))
        self.iteration = iteration
        self.tree_index = tree_index
        self.field = field


#: the key of the fill's non-finite flag in a tree's fetched outputs
NONFINITE_KEY = "nonfinite_gradients"


def sentinel_check(engine, host: Dict) -> None:
    """Screen one tree's outputs from its `tree_fetch` (no fetch of its
    own).  Policy 'off' skips the scan; 'abort' / 'rollback' raise
    `NonFiniteDetected` for `SentinelGuard` to arbitrate.  Beside the JAX
    package's leaf and internal values, the fill's flag (`NONFINITE_KEY`,
    set when a gradient or hessian the tree reads is not finite) is read:
    the card's f32 histograms sum in fixed point, where a NaN or inf
    converts to an extreme integer and the leaf sums can come out finite,
    so the values alone would miss a burst the CPU's f32 sums show."""
    import numpy as np
    policy = getattr(engine, "_sentinel_policy", "off")
    if policy == "off":
        return
    maybe_inject_nan(engine, host)
    nl = max(int(host["num_leaves"]), 1)
    tree = len(engine.model.trees)
    if not np.isfinite(host["leaf_value"][:nl]).all():
        raise NonFiniteDetected(int(engine.iter), tree, "leaf values")
    if nl > 1 and not np.isfinite(host["internal_value"][:nl - 1]).all():
        raise NonFiniteDetected(int(engine.iter), tree, "internal values")
    flag = host.get(NONFINITE_KEY)
    if flag is not None and bool(np.asarray(flag).reshape(-1)[0]):
        raise NonFiniteDetected(int(engine.iter), tree, "gradients")


class SentinelGuard:
    """Pre-iteration state for the abort-or-rollback policy.

    'abort' re-raises, naming the iteration; 'rollback' drops the
    iteration's trees (all K of them), puts back the pre-iteration
    training and validation scores bit for bit, and stops training (the
    gradient source produces non-finites; every later tree would be
    poisoned).  The scores are kept on the device, as clones taken when
    the guard is made (the training scores scattered to original row
    order), so neither policy adds a blocking sync; the payload, whose
    scores the fused step has already moved, is left, and the next entry
    rebuilds it from the restored scores."""

    def __init__(self, engine):
        self.engine = engine
        self.policy = getattr(engine, "_sentinel_policy", "off")
        self.pre_trees = len(engine.model.trees)
        self.pre_iter = int(engine.iter)
        self.score = None
        self.valid = None
        if self.policy == "rollback":
            self.score = engine._fast.original_scores() \
                if engine._fast_active else engine.score.clone()
            self.valid = [vs[3].clone() for vs in engine.valid_sets]

    def handle(self, err: NonFiniteDetected, log) -> bool:
        """True (training finished) after a rollback; raises for the abort
        policy (the Booster.update contract)."""
        if self.policy != "rollback" or self.score is None:
            raise type(err)(err.iteration, err.tree_index, err.field)
        eng = self.engine
        del eng.model.trees[self.pre_trees:]
        eng.iter = self.pre_iter
        eng._fast_active = False
        eng.score = self.score
        for vs, saved in zip(eng.valid_sets, self.valid):
            vs[3] = saved
        log.warning(
            "%s; policy=rollback: iteration %d discarded, scores restored, "
            "training stopped", err, err.iteration)
        return True
