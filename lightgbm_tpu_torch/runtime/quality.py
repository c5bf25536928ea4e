"""The model-quality firewall (counterpart of
lightgbm_tpu/runtime/quality.py): ingest quarantine and the pre-publish
eval gate.  The third stage, canary routing with automatic rollback,
lives in `runtime/policy.CanaryPolicy` and `runtime/serving.py`.

* **Ingest quarantine** (`validate_rows` + `QuarantineLedger`): every
  parsed or pushed row is checked against the dataset's schema
  (non-finite labels, non-finite weights, bad query ids, column-count
  drift) and offenders go to a bounded ledger (counts, a few sample rows,
  the reason) instead of the training window.  Counts land in
  ``lgbm_ingest_quarantined_total{reason}`` and in the cycle's stage
  trail; past a configured fraction `QuarantineExceeded` fails the cycle.
* **Pre-publish eval gate** (`holdout_mask` + `evaluate_model` +
  `gate_verdict`): each cycle holds out a deterministic slice of the
  window (index arithmetic: the same window gives the same holdout and
  the same verdict), evaluates the candidate with the port's metric
  layer and refuses a generation whose primary metric regresses beyond
  ``publish_gate_tolerance`` against the incumbent.  Verdicts land in
  ``lgbm_publish_gate_total{verdict}``; a rejection is kept beside the
  publish dir (`ModelPublisher.record_rejection`).

Host-side numpy only: no torch at module scope.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..utils.log import LightGBMError
from . import telemetry

__all__ = ["QuarantineLedger", "QuarantineExceeded", "validate_rows",
           "holdout_mask", "evaluate_model", "gate_verdict"]

#: quarantine reasons, in the order they are checked; a row failing
#: several checks is counted once under the FIRST failing reason
QUARANTINE_REASONS = ("nonfinite_label", "nonfinite_weight",
                     "bad_query_id", "column_drift")

#: sample rows retained per reason — the ledger is evidence, not a copy
#: of the poison stream
_MAX_SAMPLES = 4


class QuarantineExceeded(LightGBMError):
    """The quarantined fraction of one ingest pass crossed the configured
    threshold: the window is mostly garbage and training on the remainder
    would launder a data outage into a published model.  The continuous
    trainer fails the CYCLE on this (status=quarantine in
    ``lgbm_online_cycles_total``) and retries at the next slot."""


class QuarantineLedger:
    """Bounded record of everything quarantine dropped.

    ``counts`` accumulates per reason; ``samples`` keeps at most
    `_MAX_SAMPLES` (row_repr, reason) pairs per reason so a post-mortem
    can see WHAT was dropped without the ledger growing with the
    outage.  Mirrored into ``lgbm_ingest_quarantined_total{reason}`` at
    every `record`.
    """

    def __init__(self):
        self.counts: Dict[str, int] = {}
        self.samples: Dict[str, List[str]] = {}
        self.rows_seen = 0
        self.rows_quarantined = 0

    def record(self, reason: str, count: int,
               sample_rows: Optional[List[str]] = None) -> None:
        if count <= 0:
            return
        self.counts[reason] = self.counts.get(reason, 0) + int(count)
        self.rows_quarantined += int(count)
        slot = self.samples.setdefault(reason, [])
        for s in (sample_rows or [])[: max(_MAX_SAMPLES - len(slot), 0)]:
            slot.append(s)
        telemetry.counter("lgbm_ingest_quarantined_total").inc(
            int(count), reason=reason)

    def observe_clean(self, count: int) -> None:
        self.rows_seen += int(count)

    @property
    def total(self) -> int:
        return self.rows_quarantined

    def fraction(self) -> float:
        denom = self.rows_seen + self.rows_quarantined
        return self.rows_quarantined / denom if denom else 0.0

    def summary(self) -> Dict[str, Any]:
        """The stage-trail / artifact record."""
        return {"quarantined_total": self.rows_quarantined,
                "rows_seen": self.rows_seen,
                "by_reason": dict(self.counts),
                "samples": {r: list(s) for r, s in self.samples.items()}}


def _sample_reprs(X: np.ndarray, y: Optional[np.ndarray],
                  idx: np.ndarray) -> List[str]:
    out = []
    for i in idx[:_MAX_SAMPLES]:
        lab = "?" if y is None else repr(float(y[i]))
        head = np.asarray(X[i]).ravel()[:6]
        out.append("row[%d] label=%s X[:6]=%s" % (int(i), lab,
                                                  np.array2string(head)))
    return out


def validate_rows(X: np.ndarray, y: Optional[np.ndarray] = None,
                  weight: Optional[np.ndarray] = None,
                  query: Optional[np.ndarray] = None,
                  expected_features: Optional[int] = None,
                  ledger: Optional[QuarantineLedger] = None
                  ) -> Tuple[np.ndarray, Dict[str, int]]:
    """Schema validation of one parsed/pushed chunk.

    Returns ``(keep_mask, counts)``: a boolean mask of rows safe to
    train on, and the per-reason quarantine counts.  Checks, in order:

    * **column_drift** — the chunk's width differs from the declared
      feature count: the WHOLE chunk is quarantined (rows of the wrong
      shape cannot be partially salvaged);
    * **nonfinite_label** — NaN/Inf labels (a NaN gradient is how one
      bad logging row poisons every histogram it touches);
    * **nonfinite_weight** — NaN/Inf weights;
    * **bad_query_id** — non-finite or negative query ids in ranking
      mode (group boundaries derived from them would be garbage).

    NaN *features* are deliberately NOT quarantined: missing values are
    first-class GBDT inputs (`use_missing`) and dropping
    them would silently change models on legitimate data.
    """
    n = int(X.shape[0])
    keep = np.ones(n, dtype=bool)
    counts: Dict[str, int] = {}
    if n == 0:
        return keep, counts

    if expected_features is not None and int(X.shape[1]) != int(
            expected_features):
        counts["column_drift"] = n
        if ledger is not None:
            ledger.record("column_drift", n, [
                "chunk width %d != declared %d"
                % (X.shape[1], expected_features)])
        return np.zeros(n, dtype=bool), counts

    def _apply(mask_bad: np.ndarray, reason: str) -> None:
        bad = mask_bad & keep
        c = int(bad.sum())
        if not c:
            return
        counts[reason] = c
        if ledger is not None:
            ledger.record(reason, c,
                          _sample_reprs(X, y, np.flatnonzero(bad)))
        keep[bad] = False

    if y is not None:
        yv = np.asarray(y, dtype=np.float64).reshape(-1)
        _apply(~np.isfinite(yv), "nonfinite_label")
    if weight is not None:
        wv = np.asarray(weight, dtype=np.float64).reshape(-1)
        _apply(~np.isfinite(wv), "nonfinite_weight")
    if query is not None:
        qv = np.asarray(query, dtype=np.float64).reshape(-1)
        _apply(~np.isfinite(qv) | (qv < 0), "bad_query_id")
    if ledger is not None:
        ledger.observe_clean(int(keep.sum()))
    return keep, counts


# ---------------------------------------------------------------------------
# pre-publish eval gate
# ---------------------------------------------------------------------------

def holdout_mask(n_rows: int, holdout_frac: float,
                 query: Optional[np.ndarray] = None) -> np.ndarray:
    """Deterministic holdout selection: pure index arithmetic, no RNG —
    the same window always yields the same mask (the gate-determinism
    pin).  Every ``k``-th row (``k = round(1/holdout_frac)``) is held
    out; in ranking mode every ``k``-th QUERY GROUP is held out instead,
    so a group is never torn between train and holdout."""
    n = int(n_rows)
    if n <= 0 or holdout_frac <= 0.0:
        return np.zeros(n, dtype=bool)
    k = max(int(round(1.0 / min(holdout_frac, 0.5))), 2)
    if query is None:
        mask = (np.arange(n) % k) == (k - 1)
    else:
        q = np.asarray(query).reshape(-1)
        starts = np.concatenate([[0], np.flatnonzero(np.diff(q)) + 1])
        group_of = np.searchsorted(starts, np.arange(n), side="right") - 1
        mask = (group_of % k) == (k - 1)
    if mask.all() or not mask.any():
        # degenerate tiny windows: never hold out everything (or nothing
        # when a fraction was asked for) — fall back to the last row
        mask = np.zeros(n, dtype=bool)
        mask[-1] = True
    return mask


def evaluate_model(model, X: np.ndarray, y: np.ndarray, params: Dict,
                   weight: Optional[np.ndarray] = None,
                   query: Optional[np.ndarray] = None
                   ) -> List[Tuple[str, float, bool]]:
    """Metric-stack evaluation of one model on a holdout slice:
    ``[(metric_name, value, is_higher_better), ...]`` using the SAME
    metric layer training uses (config-selected metrics, objective
    transform applied by each metric).  `model` is a `GBDTModel` or
    anything with ``predict_raw``."""
    from ..config import Config
    from ..metric import create_metrics
    from ..objective import create_objective

    cfg = Config(dict(params))
    objective = create_objective(cfg.objective, cfg) \
        if isinstance(cfg.objective, str) else None
    raw = np.asarray(model.predict_raw(np.asarray(X, dtype=np.float64))).T
    qb = None
    if query is not None and len(query):
        q = np.asarray(query).reshape(-1)
        starts = np.concatenate([[0], np.flatnonzero(np.diff(q)) + 1,
                                 [q.size]])
        qb = starts.astype(np.int64)
    out: List[Tuple[str, float, bool]] = []
    for m in create_metrics(cfg.metric, cfg):
        m.init(np.asarray(y, dtype=np.float64), weight, qb)
        score = raw if getattr(m, "multiclass", False) else \
            (raw[0] if raw.shape[0] == 1 else raw.reshape(-1))
        out.append((m.name, float(m.eval(score, objective)),
                    bool(m.is_higher_better)))
    return out


def gate_verdict(candidate: List[Tuple[str, float, bool]],
                 incumbent: Optional[List[Tuple[str, float, bool]]],
                 tolerance: float,
                 primary_metric: Optional[str] = None) -> Dict[str, Any]:
    """The gate decision over two metric sets.

    The PRIMARY metric (named, or the first evaluated one) drives the
    verdict: the candidate is rejected when it regresses more than
    ``tolerance`` RELATIVE to the incumbent's value (direction taken
    from the metric's higher-is-better flag).  ``tolerance=inf``
    disables the gate entirely (the default-off contract: disabled, the
    trainer behaves byte-identically to a gate-less build).  Returns the
    auditable record that lands in the publish meta / rejection file and
    in ``lgbm_publish_gate_total{verdict}``."""
    rec: Dict[str, Any] = {
        "tolerance": None if math.isinf(tolerance) else float(tolerance),
        "candidate": [[n, v, h] for n, v, h in candidate],
        "incumbent": None if incumbent is None
        else [[n, v, h] for n, v, h in incumbent],
    }
    if math.isinf(tolerance):
        rec.update(verdict="disabled", regression=None)
        return rec
    if not candidate:
        # no metric configured: nothing to gate on — pass, loudly noted
        rec.update(verdict="no_metric", regression=None)
        return rec
    pick = 0
    if primary_metric:
        for i, (n, _, _) in enumerate(candidate):
            if n == primary_metric:
                pick = i
                break
        else:
            raise LightGBMError(
                "publish_gate_metric %r is not among the evaluated "
                "metrics %r" % (primary_metric,
                                [n for n, _, _ in candidate]))
    name, cand_v, higher = candidate[pick]
    rec["metric"] = name
    if incumbent is None:
        rec.update(verdict="no_incumbent", regression=None)
        return rec
    inc_v = None
    for n, v, _ in incumbent:
        if n == name:
            inc_v = v
            break
    if inc_v is None or not math.isfinite(inc_v):
        rec.update(verdict="no_incumbent", regression=None)
        return rec
    # signed regression: positive = candidate is WORSE, relative to the
    # incumbent's magnitude (floored so a near-zero incumbent loss does
    # not turn numeric noise into an infinite relative regression)
    delta = (inc_v - cand_v) if higher else (cand_v - inc_v)
    regression = delta / max(abs(inc_v), 1e-12)
    rec["regression"] = float(regression)
    rec["verdict"] = "reject" if (math.isfinite(cand_v) is False
                                  or regression > tolerance) else "pass"
    return rec
