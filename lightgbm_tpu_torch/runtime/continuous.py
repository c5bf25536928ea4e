"""Continuous training: a rolling-window trainer with atomic publish
(counterpart of lightgbm_tpu/runtime/continuous.py; `task=train_online`).

A long-running service that keeps a model fresh against a moving data
window and publishes every cycle through runtime/publish.py:

* **ingest**: a background producer thread parses the data file through
  io/parser.py whenever it changes and keeps the newest
  `online_window_rows` rows staged for the next cycle; when the file
  only grows, only the appended tail is parsed.  Rows that fail the
  schema check go to the quarantine ledger (runtime/quality.py); a
  binary cache (`online_save_binary=true`) makes a relaunch's ingest one
  binary load.
* **train**: each cycle boosts `online_rounds` iterations (continued
  training on the live engine, each tree one captured device program on
  the card) or refits the current model to the new window, on an
  absolute-clock schedule: cycle slots are ``t0 + k*interval`` with
  ``t0`` kept in ``<output_model>.service.json``, so a relaunch rejoins
  the same schedule instead of drifting.
* **gate**: with a finite `publish_gate_tolerance` each window's
  deterministic holdout judges the candidate against the incumbent, and
  a regression is recorded (``rejected_<N>.txt``) and undone instead of
  published.
* **recover**: warm start from the newest valid snapshot (the training
  runtime's snapshots, byte-identical resume), finish a preempted cycle
  to its exact iteration target, and republish a cycle whose publish was
  torn or never landed from the snapshot's own model text, so the
  generation is byte-identical to an uninterrupted run's.
* **observe**: every stage runs under the stage watchdog (named
  deadlines, a persisted JSON trail) and each cycle's trail carries its
  blocking syncs (`runtime/syncs.py`), its program-ledger delta
  (`runtime/graph_obs.py`: captures and grower programs built), the
  ingest record and the publish latency.

A relaunch whose publish dir carries a matching ``train_online`` shape
manifest trains one throwaway iteration before the first slot, so the
grower's programs are built and captured before the first cycle's clock.
"""
from __future__ import annotations

import json
import math
import os
import threading
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np

from . import graph_obs, publish, quality, resilience, syncs, telemetry, \
    tracing, warmup
from ..utils.log import LightGBMError, Log

__all__ = ["ContinuousTrainer", "OnlineParams"]


class OnlineParams:
    """Config surface of `task=train_online` (all `k=v` CLI params).

    Everything not consumed here flows through as ordinary training
    parameters (objective, num_leaves, bagging, device_type, ...).
    """

    def __init__(self, params: Dict[str, Any]):
        p = dict(params)
        self.data = p.pop("data", p.pop("train_data", None))
        self.output_model = p.pop("output_model", "LightGBM_online.txt")
        self.input_model = p.pop("input_model", None)
        self.publish_dir = p.pop("publish_dir",
                                 self.output_model + ".pub")
        self.interval_s = float(p.pop("online_interval", 10.0))
        self.cycles = int(p.pop("online_cycles", 0))          # 0 = forever
        self.rounds = max(int(p.pop("online_rounds", 5)), 1)
        self.mode = str(p.pop("online_mode", "boost")).lower()
        self.window_rows = int(p.pop("online_window_rows", 0))
        self.save_binary = str(p.pop("online_save_binary", "")
                               ).lower() in ("true", "1")
        self.publish_retention = int(p.pop("publish_retention", 8))
        self.publish_grace_s = float(p.pop("publish_grace", 30.0))
        self.snapshot_retention = int(p.pop("snapshot_retention", 4))
        self.snapshot_grace_s = float(p.pop("snapshot_grace", 30.0))
        self.stage_timeout = int(p.pop("online_stage_timeout", 600))
        # metrics_port=N serves GET /metrics (Prometheus text) from the
        # live trainer; 0 picks an ephemeral port (logged at start)
        mp = p.pop("metrics_port", None)
        self.metrics_port = int(mp) if mp is not None else None
        self.label_column = int(p.pop("label_column", p.pop("label", 0) or 0))
        self.has_header = str(p.pop("has_header", p.pop("header", ""))
                              ).lower() in ("true", "1") or None
        # ranking online path: `query_column=<i>` names the
        # parsed FEATURE column (post label extraction) carrying the
        # query id; consecutive equal ids form one query group.  The
        # column is stripped from the features, the rolling window trims
        # only on group boundaries, and each cycle's dataset carries the
        # window's group sizes — lambdarank streams like any objective.
        qc = p.pop("query_column", None)
        self.query_column = int(qc) if qc is not None else None
        # -- model-quality firewall -------------------------------
        # stage one: quarantine threshold — an ingest pass whose
        # quarantined fraction exceeds this fails the CYCLE loudly
        # (status=quarantine) instead of training on the remainder.
        self.quarantine_limit = float(p.pop("online_quarantine_limit", 0.5))
        # stage two: pre-publish eval gate.  tolerance=inf (the default)
        # DISABLES the gate entirely: no holdout is carved out of the
        # window and the training path is byte-identical to a gate-less
        # build (the default-off contract).  A finite tolerance holds out
        # `publish_gate_holdout` of each window, evaluates candidate vs
        # incumbent with the configured metric stack, and refuses to
        # publish a regression.
        self.gate_tolerance = float(p.pop("publish_gate_tolerance",
                                          math.inf))
        self.gate_holdout = float(p.pop("publish_gate_holdout", 0.2))
        gm = p.pop("publish_gate_metric", None)
        self.gate_metric = str(gm) if gm else None
        # warm start: a relaunch whose publish dir carries a
        # matching shape manifest precompiles the grower programs
        # BEFORE the first cycle slot (online_prewarm=false opts out)
        self.prewarm = str(p.pop("online_prewarm", "true")
                           ).lower() not in ("false", "0")
        self.train_params = p
        if not self.data:
            raise LightGBMError("train_online needs data=<file>")
        if self.mode not in ("boost", "refit"):
            raise LightGBMError("online_mode must be boost or refit, got %r"
                                % self.mode)
        if self.query_column is not None and self.mode == "refit":
            raise LightGBMError("query_column (ranking) requires "
                                "online_mode=boost; refit re-fits leaf "
                                "values without query structure")
        if self.gate_enabled and not 0.0 < self.gate_holdout < 1.0:
            raise LightGBMError("publish_gate_holdout must be in (0, 1), "
                                "got %r" % self.gate_holdout)
        if not 0.0 <= self.quarantine_limit <= 1.0:
            raise LightGBMError("online_quarantine_limit must be in "
                                "[0, 1], got %r" % self.quarantine_limit)

    @property
    def gate_enabled(self) -> bool:
        return math.isfinite(self.gate_tolerance)


class _IngestProducer(threading.Thread):
    """Background ingest: incremental tail-append parser + rolling window.

    The first pass parses `path` fully through io/parser.py and records
    the sniffed format (separator, header, feature count), the consumed
    byte offset and a signature of the bytes just before it.  When the
    file GROWS and that signature still matches, only the appended tail
    is read and parsed — rows outside the new tail are never re-read,
    re-parsed or re-binned.  Any other change (rewrite,
    truncation, signature mismatch, no trailing newline) falls back to a
    full re-parse.  The newest `online_window_rows` rows stay staged; the
    training loop never blocks on an unchanged file (the parse of a
    growing file overlaps the previous cycle's training)."""

    #: bytes hashed immediately before the consumed offset; a rewrite that
    #: happens to grow the file is caught by this prefix check
    _SIG_BYTES = 64

    def __init__(self, cfg: OnlineParams, log=Log):
        super().__init__(name="online-ingest", daemon=True)
        self.cfg = cfg
        self.log = log
        self._ready = threading.Event()
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._latest: Optional[Tuple] = None   # (stamp, X, y, q)
        self._error: Optional[BaseException] = None
        self._stamp: Optional[Tuple] = None
        # incremental-parse state
        self._fmt: Optional[Tuple] = None   # (fmt, sep, n_features)
        self._offset: Optional[int] = None  # bytes consumed (None = no tail)
        self._sig: bytes = b""
        self._chunks: list = []             # [(X, y, q)] rolling window
        # ingest telemetry (read by the cycle stage trail and the pins)
        self.last_ingest: Optional[Dict[str, Any]] = None
        self.rows_parsed_total = 0
        # ingest quarantine: schema-invalid rows are
        # routed here instead of the window; the cycle reads the ledger
        # for its stage trail and the quarantine-fraction threshold
        self.quarantine = quality.QuarantineLedger()

    def _file_stamp(self) -> Optional[Tuple]:
        try:
            st = os.stat(self.cfg.data)
            return (st.st_mtime_ns, st.st_size)
        except OSError:
            return None

    # -- incremental parsing -------------------------------------------------
    def _sig_ok(self) -> bool:
        if self._offset is None:
            return False
        lo = max(0, self._offset - self._SIG_BYTES)
        try:
            with open(self.cfg.data, "rb") as fh:
                fh.seek(lo)
                return fh.read(self._offset - lo) == self._sig
        except OSError:
            return False

    def _record_offset(self, size: int) -> None:
        """Arm tail mode at `size` if the consumed region ends on a line
        boundary; otherwise disable it until the next full parse."""
        try:
            with open(self.cfg.data, "rb") as fh:
                if size <= 0:
                    self._offset = None
                    return
                fh.seek(size - 1)
                if fh.read(1) != b"\n":
                    self._offset = None
                    return
                lo = max(0, size - self._SIG_BYTES)
                fh.seek(lo)
                self._sig = fh.read(size - lo)
                self._offset = size
        except OSError:
            self._offset = None

    def _parse_tail(self, size: int) -> Tuple[np.ndarray, np.ndarray]:
        """Parse ONLY the appended bytes [offset, last complete line)."""
        from ..io.parser import _parse_delimited, _parse_libsvm
        fmt, sep, n_feat = self._fmt
        with open(self.cfg.data, "rb") as fh:
            fh.seek(self._offset)
            blob = fh.read(size - self._offset)
        cut = blob.rfind(b"\n")
        if cut < 0:          # no complete appended line yet
            return (np.empty((0, n_feat)), np.empty(0))
        consumed = blob[:cut + 1]
        lines = [l for l in consumed.decode("utf-8", "replace").splitlines()
                 if l.strip()]
        if lines:
            if fmt == "libsvm":
                X, y = _parse_libsvm(lines, n_feat)
            else:
                X, y = _parse_delimited(lines, sep, self.cfg.label_column,
                                        n_feat)
        else:
            X, y = np.empty((0, n_feat)), np.empty(0)
        self._offset += len(consumed)
        lo = max(0, self._offset - self._SIG_BYTES)
        self._sig = (self._sig + consumed)[-(self._offset - lo):]
        return X, y

    def _split_query(self, X: np.ndarray):
        """Strip the query-id column (ranking mode): (features, qid)."""
        qc = self.cfg.query_column
        if qc is None:
            return X, None
        if X.shape[0] == 0:
            return X[:, : max(X.shape[1] - 1, 0)], np.empty(0, np.int64)
        if not 0 <= qc < X.shape[1]:
            raise LightGBMError("query_column %d out of range for %d "
                                "parsed columns" % (qc, X.shape[1]))
        q = X[:, qc].astype(np.int64)
        return np.delete(X, qc, axis=1), q

    def _append_window(self, X: np.ndarray, y: np.ndarray,
                       q: Optional[np.ndarray]) -> None:
        if X.shape[0]:
            self._chunks.append((X, y, q))
        w = self.cfg.window_rows
        if w <= 0:
            return
        total = sum(c[0].shape[0] for c in self._chunks)
        while len(self._chunks) > 1 and \
                total - self._chunks[0][0].shape[0] >= w:
            total -= self._chunks[0][0].shape[0]
            self._chunks.pop(0)
        if total > w:
            X0, y0, q0 = self._chunks[0]
            cut = total - w
            if q0 is not None and cut < q0.size:
                # ranking window: never split a query group — advance the
                # cut to the next group boundary (the window may come up
                # slightly short of `window_rows`, never torn mid-query)
                boundaries = np.flatnonzero(np.diff(q0)) + 1
                later = boundaries[boundaries >= cut]
                cut = int(later[0]) if later.size else q0.size
            if cut >= X0.shape[0] and len(self._chunks) > 1:
                self._chunks.pop(0)
            else:
                self._chunks[0] = (
                    X0[cut:], y0[cut:],
                    q0[cut:] if q0 is not None else None)

    def _window(self):
        Xs = [c[0] for c in self._chunks]
        ys = [c[1] for c in self._chunks]
        qs = [c[2] for c in self._chunks]
        q = None
        if qs and qs[0] is not None:
            q = np.concatenate(qs) if len(qs) > 1 else qs[0]
        return (np.concatenate(Xs) if len(Xs) > 1 else Xs[0],
                np.concatenate(ys) if len(ys) > 1 else ys[0], q)

    def _parse_once(self) -> None:
        t0 = time.perf_counter()
        size = os.path.getsize(self.cfg.data)
        mode = "full_parse"
        if self._fmt is not None and self._offset is not None \
                and size > self._offset and self._sig_ok():
            X, y = self._parse_tail(size)
            mode = "tail_append"
        else:
            from ..io.parser import parse_file, sniff
            X, y = parse_file(self.cfg.data,
                              label_column=self.cfg.label_column,
                              has_header=self.cfg.has_header)
            fmt, sep, _, _ = sniff(self.cfg.data, self.cfg.has_header)
            self._fmt = (fmt, sep, X.shape[1])
            self._chunks = []
            self._record_offset(size)
        parsed = int(X.shape[0])
        # fault seam: an upstream logging outage poisoning a fraction of
        # every chunk's labels — the quarantine below must catch it
        y, _ = resilience.maybe_poison_rows(X, y)
        X, q = self._split_query(X)
        # firewall stage one: schema validation — offenders go to the
        # bounded ledger, never the window.  The clean-path fast case
        # (keep.all()) adds zero copies, so a healthy stream's windows
        # (and therefore its models) are byte-identical to a
        # quarantine-less build.
        keep, _ = quality.validate_rows(X, y, query=q,
                                        ledger=self.quarantine)
        quarantined = parsed - int(keep.sum())
        if quarantined:
            X, y = X[keep], np.asarray(y)[keep]
            q = q[keep] if q is not None else None
        self._append_window(X, y, q)
        Xw, yw, qw = self._window()
        dt = time.perf_counter() - t0
        with self._lock:
            self._latest = (self._stamp, Xw, yw, qw)
        self.rows_parsed_total += parsed
        self.last_ingest = {
            "mode": mode, "rows_parsed": parsed,
            "seconds": round(dt, 4),
            "rows_per_sec": round(parsed / dt, 1) if dt > 0 else None,
            "window_rows": int(Xw.shape[0]),
            "quarantined": quarantined,
            "quarantine_frac": round(quarantined / parsed, 4)
            if parsed else 0.0,
        }
        # the same ingest record feeds the live registry:
        # rows/sec is the counter+histogram pair, the window a gauge
        telemetry.counter("lgbm_ingest_rows_total").inc(parsed, mode=mode)
        telemetry.histogram("lgbm_ingest_seconds").observe(dt)
        telemetry.gauge("lgbm_ingest_window_rows").set(Xw.shape[0])
        self._ready.set()

    def run(self) -> None:
        while not self._stop.is_set():
            stamp = self._file_stamp()
            if stamp is not None and stamp != self._stamp:
                self._stamp = stamp
                try:
                    self._parse_once()
                except BaseException as e:   # surfaced at the next ingest
                    if self._latest is None:
                        self._error = e
                        self._ready.set()
                    else:
                        self.log.warning("online ingest: re-parse of %s "
                                         "failed (%s); keeping the previous "
                                         "window", self.cfg.data, e)
            self._stop.wait(0.2)

    def stop(self) -> None:
        self._stop.set()

    def current(self, timeout: float) -> Tuple:
        """(stamp, X, y, query_ids) of the freshest staged window; the
        query ids are None outside ranking mode."""
        if not self._ready.wait(timeout):
            raise LightGBMError("online ingest: no parsed window of %s "
                                "within %.0fs" % (self.cfg.data, timeout))
        if self._error is not None:
            raise LightGBMError("online ingest: cannot parse %s: %s"
                                % (self.cfg.data, self._error))
        with self._lock:
            return self._latest  # type: ignore[return-value]


class ContinuousTrainer:
    """The service loop.  `run()` returns a process exit code: 0 when the
    target cycle count is reached or the run is preempted cleanly."""

    def __init__(self, params: Dict[str, Any], log=Log):
        self.cfg = OnlineParams(params)
        self.log = log
        self.publisher = publish.ModelPublisher(
            self.cfg.publish_dir, keep_last=self.cfg.publish_retention,
            grace_s=self.cfg.publish_grace_s)
        self.wd = resilience.Watchdog(
            self.cfg.stage_timeout, hard=False, label="online stage",
            report_path=os.environ.get("LGBM_TPU_STAGE_REPORT",
                                       self.cfg.output_model
                                       + ".stage_trail.json"))
        self._booster = None
        self._window_stamp: Optional[Tuple] = None
        self._base_iter = 0              # iterations in the pre-service model
        self.timeouts = 0
        # pre-publish eval gate state: the holdout
        # slice of the CURRENT window, refreshed whenever a window is
        # adopted; None while the gate is disabled
        self._holdout: Optional[Tuple] = None
        self.gate_rejections = 0
        self.quarantine_failures = 0

    # -- service state file (the schedule clock) ----------------------------
    @property
    def _state_path(self) -> str:
        return self.cfg.output_model + ".service.json"

    def _load_or_create_state(self) -> Dict[str, Any]:
        try:
            with open(self._state_path) as fh:
                st = json.load(fh)
            if float(st.get("interval", -1)) != self.cfg.interval_s:
                self.log.warning(
                    "online_interval changed (%.3fs -> %.3fs); the schedule "
                    "clock keeps its original t0", st.get("interval"),
                    self.cfg.interval_s)
            return st
        except (OSError, ValueError):
            st = {"t0": time.time(), "interval": self.cfg.interval_s,
                  "base_iter": self._base_iter, "mode": self.cfg.mode,
                  "created": resilience.wallclock()}
            resilience.atomic_write(self._state_path, json.dumps(st, indent=1))
            return st

    # -- stage plumbing ------------------------------------------------------
    def _stage(self, cycle: int, name: str,
               seconds: Optional[int] = None) -> None:
        label = "cycle %d: %s" % (cycle, name)
        self.wd(label, seconds)
        stalled = resilience.maybe_slow_stage(label, defer=True)
        if stalled:
            # annotate BEFORE sleeping: the watchdog alarm lands mid-sleep
            # and the trail must already name the injected stall
            self.wd.annotate("injected_stall_s", stalled)
            time.sleep(stalled)

    # -- data / booster construction ----------------------------------------
    def _binary_cache_path(self) -> str:
        return self.cfg.output_model + ".window.bin"

    def _cache_fresh(self) -> bool:
        cache = self._binary_cache_path()
        try:
            return os.path.getmtime(cache) >= os.path.getmtime(self.cfg.data)
        except OSError:
            return False

    @staticmethod
    def _group_sizes(q: Optional[np.ndarray]) -> Optional[np.ndarray]:
        """Run lengths of consecutive equal query ids (ranking mode)."""
        if q is None or q.size == 0:
            return None
        starts = np.flatnonzero(np.diff(q)) + 1
        return np.diff(np.concatenate([[0], starts, [q.size]]))

    def _make_dataset(self, X, y, q=None):
        from ..basic import Dataset
        from ..config import Config
        from ..io.dataset import BinnedDataset
        params = dict(self.cfg.train_params)
        if BinnedDataset.is_binary_file(self.cfg.data):
            ds = Dataset(self.cfg.data, params=params)
            ds.construct(Config(params))
            return ds
        if self.cfg.save_binary and self._cache_fresh():
            try:
                ds = Dataset(self._binary_cache_path(), params=params)
                ds.construct(Config(params))
                return ds
            except LightGBMError as e:
                # e.g. a stale format_version from an older build: the
                # service rebuilds the cache instead of wedging the cycle
                self.log.warning("online: binary window cache unusable "
                                 "(%s); rebuilding it", e)
        ds = Dataset(X, label=y, group=self._group_sizes(q), params=params)
        if self.cfg.save_binary:
            ds.construct(Config(params))
            ds.save_binary(self._binary_cache_path())
        return ds

    def _build_booster(self, X, y, q=None, init_model=None, snap_state=None):
        from ..basic import Booster
        ds = self._make_dataset(X, y, q)
        bst = Booster(params=dict(self.cfg.train_params), train_set=ds,
                      init_model=init_model)
        if snap_state is not None:
            resilience.restore_training_state(bst, snap_state, log=self.log)
        return bst

    def _model_text(self, booster) -> str:
        return booster._model.save_model_to_string()

    def _total_iter(self) -> int:
        return int(self._booster.current_iteration())

    # -- schedule ------------------------------------------------------------
    def _wait_for_slot(self, t0: float, guard) -> None:
        """Sleep until the next absolute slot boundary ``t0 + m*interval``
        strictly in the future, waking early on a preemption signal.  A
        relaunch lands in whatever slot is next on the SAME clock — the
        schedule does not drift with downtime."""
        if self.cfg.interval_s <= 0:
            return
        now = time.time()
        m = max(int(math.ceil((now - t0) / self.cfg.interval_s)), 0)
        deadline = t0 + m * self.cfg.interval_s
        if deadline - now < 1e-4:        # exactly on the boundary: take it
            return
        while True:
            if guard.signum is not None:
                return
            remaining = deadline - time.time()
            if remaining <= 0:
                return
            time.sleep(min(remaining, 0.05))

    # -- recovery ------------------------------------------------------------
    def _recover_boost(self, X, y, q=None) -> int:
        """Boost-mode recovery: warm start from the newest valid snapshot
        and reconcile snapshots against published generations.  Returns
        the number of COMPLETED cycles."""
        from ..models.gbdt_model import GBDTModel
        snap_path, snap_state = resilience.find_resume_snapshot(
            self.cfg.output_model, log=self.log)
        init = None
        if self.cfg.input_model:
            init = GBDTModel.load_model(self.cfg.input_model)
            self._base_iter = int(init.current_iteration)
        if snap_path is None:
            self._booster = self._build_booster(X, y, q, init_model=init)
            return 0
        svc = snap_state.get("service", {})
        self._base_iter = int(svc.get("base_iter", self._base_iter))
        total = int(snap_state["total_iter"])
        done_cycles = (total - self._base_iter) // self.cfg.rounds
        self.log.info("online: warm start from %s (iteration %d, "
                      "%d completed cycles)", snap_path, total, done_cycles)
        self.wd("recover: warm start")
        self._booster = self._build_booster(
            X, y, q, init_model=GBDTModel.load_model(snap_path),
            snap_state=snap_state)
        # republish a cycle whose publish was torn away with the dead
        # process: the snapshot's own model text IS what that publish
        # would have carried
        latest = self.publisher.latest_valid()
        latest_gen = latest.generation if latest else 0
        mid = (total - self._base_iter) % self.cfg.rounds
        if mid == 0 and done_cycles > latest_gen:
            self.wd("recover: republish generation %d" % done_cycles)
            text = resilience.snapshot_model_text(snap_path)
            if text is not None:
                # the republish runs before any cycle span exists: open
                # one so this generation's meta carries THIS process's
                # fresh trace context like every other publish
                with tracing.span("recover republish %d" % done_cycles):
                    self.publisher.publish(text, meta=self._gen_meta(
                        done_cycles, total), generation=done_cycles)
                self.log.info("online: republished generation %d from the "
                              "snapshot", done_cycles)
        return done_cycles

    def _recover_refit(self) -> int:
        """Refit-mode recovery: the published lineage IS the state."""
        from ..basic import Booster
        latest = self.publisher.latest_valid()
        if latest is None:
            return 0
        self._booster = Booster(params=dict(self.cfg.train_params),
                                model_str=latest.model_text)
        self.log.info("online: refit mode resumed from published "
                      "generation %d", latest.generation)
        return int(latest.meta.get("cycle", latest.generation))

    def _gen_meta(self, cycle: int, total_iter: int) -> Dict[str, Any]:
        meta = {"cycle": cycle, "total_iter": int(total_iter),
                "mode": self.cfg.mode, "rounds_per_cycle": self.cfg.rounds,
                "window_rows": self.cfg.window_rows}
        # the producing cycle's trace context rides the publish meta
        #: a served response links back to the training cycle
        # that made its model, across the process boundary.  A relaunch
        # opens a FRESH trace, but every pre-kill generation keeps the
        # dead process's context in its footer — the lineage stays
        # linkable across preemptions.
        tp = tracing.current_traceparent()
        if tp is not None:
            meta["trace"] = tp
        return meta

    # -- pre-publish eval gate --------------------------
    def _gate_split(self, X, y, q=None) -> Tuple:
        """Carve the deterministic holdout out of a freshly adopted
        window (gate enabled) and stage it for this window's gate
        evaluations; with the gate disabled the window passes through
        UNTOUCHED (same arrays, no copy — the byte-identity contract)."""
        if not self.cfg.gate_enabled:
            self._holdout = None
            return X, y, q
        hold = quality.holdout_mask(X.shape[0], self.cfg.gate_holdout, q)
        self._holdout = (X[hold], np.asarray(y)[hold],
                         q[hold] if q is not None else None)
        keep = ~hold
        return (X[keep], np.asarray(y)[keep],
                q[keep] if q is not None else None)

    def _gate_decide(self, cycle: int) -> Dict[str, Any]:
        """Evaluate the candidate (the live model) and the incumbent (the
        newest published generation) on the SAME holdout slice with the
        configured metric stack; returns the auditable gate record."""
        from ..models.gbdt_model import GBDTModel
        Xh, yh, qh = self._holdout
        params = dict(self.cfg.train_params)
        cand = quality.evaluate_model(self._booster._model, Xh, yh, params,
                                      query=qh)
        inc_rec = self.publisher.latest_valid()
        inc = None
        if inc_rec is not None:
            inc = quality.evaluate_model(
                GBDTModel.load_model_from_string(inc_rec.model_text),
                Xh, yh, params, query=qh)
        rec = quality.gate_verdict(cand, inc, self.cfg.gate_tolerance,
                                   self.cfg.gate_metric)
        rec["cycle"] = cycle
        rec["holdout_rows"] = int(len(yh))
        rec["incumbent_generation"] = \
            inc_rec.generation if inc_rec is not None else None
        telemetry.counter("lgbm_publish_gate_total").inc(
            verdict=rec["verdict"])
        self.wd.annotate("publish_gate", rec)
        return rec

    # -- the loop ------------------------------------------------------------
    def run(self) -> int:
        cfg = self.cfg
        # the kernel build cache: honor $LGBM_TPU_COMPILE_CACHE before the
        # first cycle builds a kernel
        warmup.maybe_enable_from_env()
        guard = resilience.PreemptionGuard(cfg.output_model,
                                           retention=cfg.snapshot_retention,
                                           log=self.log)
        producer = _IngestProducer(cfg, log=self.log)
        producer.start()
        metrics_server = None
        if cfg.metrics_port is not None:
            metrics_server = telemetry.start_http_server(cfg.metrics_port)
            self.log.info("online: serving /metrics on port %d",
                          metrics_server.port)
        telemetry.maybe_start_file_export("train_online")
        try:
            with guard:
                return self._run_inner(guard, producer)
        finally:
            producer.stop()
            self.wd.done()
            telemetry.write_snapshot_now("train_online")
            if metrics_server is not None:
                metrics_server.stop()

    def _run_inner(self, guard, producer) -> int:
        cfg = self.cfg
        state = self._load_or_create_state()
        t0 = float(state["t0"])

        self.wd("ingest: first window")
        stamp, X, y, q = producer.current(timeout=max(cfg.stage_timeout, 60))
        self._window_stamp = stamp
        X, y, q = self._gate_split(X, y, q)

        if cfg.mode == "boost":
            done = self._recover_boost(X, y, q)
        else:
            done = self._recover_refit()
        if self._booster is None:
            self.wd("bootstrap: initial booster")
            from ..models.gbdt_model import GBDTModel
            init = GBDTModel.load_model(cfg.input_model) \
                if cfg.input_model else None
            if init is not None:
                self._base_iter = int(init.current_iteration)
            self._booster = self._build_booster(X, y, q, init_model=init)
        # keep base_iter on disk so every relaunch derives the same cycle
        # arithmetic even before its first snapshot
        if int(state.get("base_iter", -1)) != self._base_iter:
            state["base_iter"] = self._base_iter
            resilience.atomic_write(self._state_path,
                                    json.dumps(state, indent=1))

        # warm start: a relaunch builds the grower programs now, in the
        # dead time before the first slot, instead of inside cycle 1's
        # budget
        self._maybe_prewarm(X, y, q)

        cycle = done + 1
        while cfg.cycles <= 0 or cycle <= cfg.cycles:
            self._stage(cycle, "wait for slot", seconds=0)
            self._wait_for_slot(t0, guard)
            if guard.signum is not None:
                return self._preempt(guard, cycle)
            try:
                self._run_cycle(cycle, producer, guard)
            except resilience.StageTimeout as e:
                self.timeouts += 1
                telemetry.counter("lgbm_online_cycles_total").inc(
                    status="timeout")
                self.log.warning("online: %s — cycle %d will be retried at "
                                 "the next slot", e, cycle)
                self.wd.annotate("retry", True)
                continue
            except quality.QuarantineExceeded as e:
                # firewall stage one tripping its threshold: the window
                # is mostly garbage — refuse the cycle LOUDLY and retry
                # at the next slot (fresh data may arrive; training on
                # the remainder would launder the outage into a model)
                self.quarantine_failures += 1
                telemetry.counter("lgbm_online_cycles_total").inc(
                    status="quarantine")
                self.log.warning("online: %s", e)
                self.wd.annotate("quarantine_failed", str(e))
                continue
            except resilience.TrainingPreempted:
                return self._preempt(guard, cycle, snapshot_written=True)
            if guard.signum is not None:
                return self._preempt(guard, cycle + 1)
            cycle += 1

        self.wd("save final model (%s)" % cfg.output_model)
        self._booster.save_model(cfg.output_model)
        self.wd.done(final=False)
        self.log.info("online: target of %d cycles reached; final model "
                      "saved to %s", cfg.cycles, cfg.output_model)
        return 0

    # -- warm start: manifest prewarm + manifest export ----------
    def _maybe_prewarm(self, X, y, q) -> None:
        """Relaunch prewarm: when the publish dir's ``warmup.json``
        carries a ``train_online`` section whose program-shape signature
        matches THIS configuration, train ONE iteration on a THROWAWAY
        booster over the same window: the kernels build (or load from
        the build cache) and the grower's steps are captured before the
        first cycle slot, and the live booster's state is untouched, so
        published generations stay byte-identical.  Any mismatch or
        failure degrades to a cold first cycle, counted in
        ``lgbm_warmup_total{kind="train_online",outcome}``."""
        if not self.cfg.prewarm or self.cfg.interval_s <= 0:
            # interval 0 = no slot wait to hide the prewarm in: the
            # first cycle starts immediately, so prewarming would only
            # delay it (schedule-free bench/test runs keep today's cost)
            return
        t0 = time.monotonic()
        outcome = "legacy"
        try:
            sec, reason = warmup.read_manifest(self.cfg.publish_dir,
                                               "train_online")
            if sec is None:
                outcome = "manifest_" + reason
            else:
                outcome = warmup.classify_train_section(
                    sec, params=self.cfg.train_params,
                    n_features=int(X.shape[1]))
                if outcome == "ok":
                    self.wd("prewarm: compile from manifest")
                    throwaway = self._build_booster(X, y, q)
                    throwaway.update()
                    outcome = "manifest_ok"
        except BaseException as e:   # noqa: BLE001 — never block the loop
            outcome = "error"
            self.log.warning("online: manifest prewarm failed (%s); "
                             "first cycle runs cold", e)
        dt = time.monotonic() - t0
        warmup.record_prewarm("train_online", outcome, dt)
        self.wd.annotate("prewarm", {"outcome": outcome,
                                     "seconds": round(dt, 4)})
        if outcome == "manifest_ok":
            self.log.info("online: grower programs prewarmed from the "
                          "manifest in %.2fs (before the first slot)", dt)

    def _export_manifest(self, cycle: int) -> None:
        """Publish this trainer's shape manifest alongside the cycle's
        generation: the program-shape signature + the jit sites the
        ledger saw compile.  Best effort — a manifest failure must never
        fail a published cycle."""
        try:
            n_feat = int(self._booster._model.max_feature_idx) + 1
            self.publisher.publish_manifest(
                "train_online", warmup.build_train_section(
                    self.cfg.train_params, n_feat, generation=cycle))
        except Exception as e:       # noqa: BLE001 — best effort
            self.log.warning("online: warmup-manifest export failed: %s", e)

    def _run_cycle(self, cycle: int, producer, guard) -> None:
        # one trace per cycle: the root span every watchdog
        # stage close, dispatch mark and assembler drain of this cycle
        # records under; its traceparent rides the published meta so the
        # serving side can link responses back to this exact cycle
        with tracing.span("cycle %d" % cycle, cycle=cycle):
            self._run_cycle_traced(cycle, producer, guard)

    def _run_cycle_traced(self, cycle: int, producer, guard) -> None:
        cfg = self.cfg

        # -- ingest: adopt a fresh window if the producer staged one ---------
        self._stage(cycle, "ingest")
        stamp, X, y, q = producer.current(timeout=max(cfg.stage_timeout, 60))
        info = getattr(producer, "last_ingest", None)
        if info:
            # ingest telemetry (mode + rows/sec) rides the cycle's stage
            # trail next to the sync audit and publish latency
            self.wd.annotate("ingest", dict(info))
            if info.get("quarantined"):
                self.wd.annotate("quarantine",
                                 producer.quarantine.summary())
            frac = float(info.get("quarantine_frac", 0.0) or 0.0)
            if frac > cfg.quarantine_limit:
                raise quality.QuarantineExceeded(
                    "cycle %d: ingest quarantined %.0f%% of the last "
                    "parse (online_quarantine_limit=%.0f%%) — refusing "
                    "to train on the remainder" % (
                        cycle, frac * 100, cfg.quarantine_limit * 100))
        # fault seam: valid-looking but WRONG labels for this cycle's
        # TRAINING slice (the flip lands after the gate split, so the
        # holdout stays trustworthy — the eval gate below is the
        # defense, not the quarantine)
        flip_armed = (resilience.fault_active("label_flip") and
                      int(resilience.fault_arg("label_flip", "-1") or -1)
                      == cycle)
        if (stamp != self._window_stamp or flip_armed) \
                and cfg.mode == "boost":
            # continued training onto the new window: the live engine's
            # trees carry over as the init model (scores are replayed onto
            # the new data — reference continued-training semantics)
            self.log.info("online: data window changed; rebuilding the "
                          "engine on %d rows", X.shape[0])
            Xtr, ytr, qtr = self._gate_split(X, y, q)
            ytr, _ = resilience.maybe_flip_labels(ytr, cycle)
            self._booster = self._build_booster(
                Xtr, ytr, qtr, init_model=self._booster._model)
            self._window_stamp = stamp
        elif stamp != self._window_stamp:
            self._window_stamp = stamp
        if cfg.mode == "refit":
            Xtr, ytr, _ = self._gate_split(X, y, None)
            ytr, _ = resilience.maybe_flip_labels(ytr, cycle)
            self._refit_window = (Xtr, ytr)
        else:
            self._refit_window = (X, y)

        # -- train: to the cycle's absolute iteration target -----------------
        self._stage(cycle, "train")
        s0 = syncs.snapshot()
        c0 = graph_obs.snapshot()
        it0 = self._total_iter()
        pre_refit = None
        refitting = (cfg.mode == "refit"
                     and self._booster._model.current_iteration > 0)
        if not refitting:
            # boost mode every cycle; refit mode's FIRST cycle bootstraps
            # an initial model the later refit cycles keep re-fitting
            target = self._base_iter + cfg.rounds * (
                cycle if cfg.mode == "boost" else 1)
            while self._total_iter() < target:
                self._booster.update()
                if guard.signum is not None:
                    raise resilience.TrainingPreempted(
                        guard.signum, self._total_iter(),
                        self._snapshot(cycle, mid_cycle=True))
        else:
            X, y = self._refit_window
            pre_refit = self._booster
            self._booster = self._booster.refit(X, y)
        self.wd.annotate("syncs", syncs.delta(s0)["by_label"])
        # per-cycle program-ledger delta: steady-state cycles on an
        # unchanged window annotate {}; a rebuild (a new window) names the
        # sites that built and captured again
        self.wd.annotate("program_builds", graph_obs.delta(c0))

        # -- eval gate: judge the candidate BEFORE it can become state -------
        gate_rec = None
        if cfg.gate_enabled and self._holdout is not None:
            self._stage(cycle, "gate")
            gate_rec = self._gate_decide(cycle)
            if gate_rec["verdict"] == "reject":
                self._reject_cycle(cycle, gate_rec, it0, pre_refit)
                return

        # -- snapshot (boost mode: full resume state at the boundary) --------
        if self._booster._engine is not None:
            self._stage(cycle, "snapshot")
            self._snapshot(cycle)

        # -- publish ---------------------------------------------------------
        self._stage(cycle, "publish")
        t_pub = time.monotonic()
        meta = self._gen_meta(cycle, self._total_iter())
        if gate_rec is not None:
            meta["gate"] = gate_rec
        # fault seam: a regression the offline gate cannot see (injected
        # AFTER the verdict) — the serving canary is the defense
        rec = self.publisher.publish(
            resilience.maybe_regress_model(
                self._model_text(self._booster), cycle),
            meta=meta, generation=cycle)
        telemetry.histogram("lgbm_online_publish_seconds").observe(
            time.monotonic() - t_pub)
        telemetry.counter("lgbm_online_cycles_total").inc(status="ok")
        self.wd.annotate("publish_latency_s",
                         round(time.monotonic() - t_pub, 4))
        # the warm-start shape manifest rides every publish:
        # a relaunch — or a fresh serving replica — reads it to compile
        # before its first real work
        self._export_manifest(cycle)
        self.log.info("online: cycle %d published generation %d (%s)",
                      cycle, rec.generation, os.path.basename(rec.path))

    def _reject_cycle(self, cycle: int, gate_rec: Dict[str, Any],
                      it0: int, pre_refit) -> None:
        """Gate rejection: persist the rejected candidate for the audit
        trail, then UNDO the cycle so the regressed trees cannot leak
        into the next cycle's lineage — boost mode rolls the cycle's
        iterations back (scores restored per iteration), refit mode
        restores the pre-refit booster.  The incumbent generation keeps
        serving; the trainer retries toward the same absolute targets on
        the next window."""
        self.gate_rejections += 1
        rej_path = self.publisher.record_rejection(
            self._model_text(self._booster), gate_rec, cycle)
        if pre_refit is not None:
            self._booster = pre_refit
        else:
            while self._total_iter() > it0:
                self._booster.rollback_one_iter()
            # the rejected cycle's TRAINING DATA may be what was wrong
            # (label_flip models exactly this): force the next cycle to
            # rebuild from the freshest window instead of continuing on
            # the suspect dataset
            self._window_stamp = None
        telemetry.counter("lgbm_online_cycles_total").inc(
            status="gate_reject")
        self.wd.annotate("gate_rejected", {
            "cycle": cycle, "rejected_model": os.path.basename(rej_path),
            "metric": gate_rec.get("metric"),
            "regression": gate_rec.get("regression")})
        self.log.warning(
            "online: cycle %d REJECTED by the publish gate (%s regressed "
            "%.4f > tolerance %s); rejected model persisted at %s, "
            "incumbent generation %s keeps serving",
            cycle, gate_rec.get("metric"),
            gate_rec.get("regression") or float("nan"),
            gate_rec.get("tolerance"), rej_path,
            gate_rec.get("incumbent_generation"))

    def _snapshot(self, cycle: int, mid_cycle: bool = False) -> Optional[str]:
        extra = {"cycle": cycle - 1 if mid_cycle else cycle,
                 "base_iter": self._base_iter,
                 "mid_cycle": bool(mid_cycle)}
        return resilience.write_snapshot(
            self._booster, self.cfg.output_model,
            retention=self.cfg.snapshot_retention, log=self.log,
            extra_state=extra,
            retention_grace_s=self.cfg.snapshot_grace_s)

    def _preempt(self, guard, cycle: int,
                 snapshot_written: bool = False) -> int:
        """Clean preemption exit: the snapshot (written at the iteration
        boundary) plus the service state file carry everything the next
        launch needs to finish this cycle and rejoin the slot schedule."""
        if not snapshot_written and self._booster is not None \
                and self._booster._engine is not None:
            self.wd("preempt: final snapshot")
            self._snapshot(cycle, mid_cycle=True)
        self.log.warning("online: preempted by signal %s during cycle %d; "
                         "relaunch with the same parameters to continue the "
                         "schedule", guard.signum, cycle)
        return 0
