"""The port's model-quality firewall (lightgbm_tpu_torch/runtime/
quality.py and the stream's ``quarantine=``) against the JAX package's
(lightgbm_tpu/runtime/quality.py, lightgbm_tpu/io/stream.py) on seeded
inputs: `validate_rows`' masks, reasons and ledger, `holdout_mask`,
`gate_verdict`, `evaluate_model` (within 1e-6) and the stream's
push-time quarantine."""
import json
import math

import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as lt
from lightgbm_tpu.io.stream import StreamingDatasetBuilder as JBuilder
from lightgbm_tpu.models.gbdt_model import GBDTModel as JModel
from lightgbm_tpu.runtime import quality as jquality
from lightgbm_tpu_torch.io.stream import StreamingDatasetBuilder
from lightgbm_tpu_torch.models.gbdt_model import GBDTModel
from lightgbm_tpu_torch.runtime import quality, telemetry
from lightgbm_tpu_torch.utils.log import LightGBMError

torch.set_num_threads(1)


def _poisoned(seed: int, n: int = 200, f: int = 5):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, f))
    X[rng.random((n, f)) < 0.05] = np.nan        # missing values stay
    y = rng.standard_normal(n)
    y[rng.random(n) < 0.07] = np.nan
    y[rng.random(n) < 0.03] = np.inf
    w = rng.uniform(0.5, 1.5, n)
    w[rng.random(n) < 0.04] = np.nan
    q = np.repeat(np.arange(n // 10), 10).astype(np.float64)
    q[rng.random(n) < 0.03] = -1.0
    return X, y, w, q


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_validate_rows_matches_jax(seed):
    X, y, w, q = _poisoned(seed)
    led, jled = quality.QuarantineLedger(), jquality.QuarantineLedger()
    keep, counts = quality.validate_rows(X, y, weight=w, query=q,
                                         expected_features=5, ledger=led)
    jkeep, jcounts = jquality.validate_rows(X, y, weight=w, query=q,
                                            expected_features=5,
                                            ledger=jled)
    assert np.array_equal(keep, jkeep) and counts == jcounts
    assert set(counts) == {"nonfinite_label", "nonfinite_weight",
                           "bad_query_id"}
    assert led.summary() == jled.summary()
    assert led.fraction() == jled.fraction()
    # NaN features are legitimate missing values, never quarantined
    assert keep[np.isfinite(y) & np.isfinite(w) & (q >= 0)].all()
    # column drift quarantines the whole chunk, in both
    assert quality.validate_rows(X, y, expected_features=6)[1] == \
        jquality.validate_rows(X, y, expected_features=6)[1] == \
        {"column_drift": 200}


def test_quarantine_ledger_bounded_and_counted():
    led = quality.QuarantineLedger()
    snap = telemetry.snapshot("t")
    before = sum(e["value"] for e in snap["metrics"].get(
        "lgbm_ingest_quarantined_total", {}).get("series", [])
        if e["labels"] == {"reason": "nonfinite_label"})
    for i in range(50):
        led.record("nonfinite_label", 1, ["row %d" % i])
    assert led.counts["nonfinite_label"] == 50
    assert len(led.summary()["samples"]["nonfinite_label"]) == 4
    snap = telemetry.snapshot("t")
    after = sum(e["value"] for e in snap["metrics"][
        "lgbm_ingest_quarantined_total"]["series"]
        if e["labels"] == {"reason": "nonfinite_label"})
    assert after - before == 50


@pytest.mark.parametrize("n,frac,grouped", [
    (1000, 0.2, False), (37, 0.1, False), (3, 0.5, False),
    (210, 0.25, True), (50, 0.3, True)])
def test_holdout_mask_matches_jax(n, frac, grouped):
    q = np.repeat(np.arange(n // 7 + 1), 7)[:n] if grouped else None
    mask = quality.holdout_mask(n, frac, q)
    assert np.array_equal(mask, jquality.holdout_mask(n, frac, q))
    assert 0 < mask.sum() < n
    if grouped:
        for g in np.unique(q):
            assert mask[q == g].all() or not mask[q == g].any()


@pytest.mark.parametrize("cand,inc,tol,metric", [
    ([("auc", 0.70, True)], [("auc", 0.80, True)], 0.05, None),
    ([("auc", 0.80, True)], [("auc", 0.70, True)], 0.05, None),
    ([("l2", 0.30, False)], [("l2", 0.20, False)], 0.1, None),
    ([("l2", 0.21, False)], [("l2", 0.20, False)], 0.1, None),
    ([("l2", 0.30, False)], [("l2", 0.20, False)], math.inf, None),
    ([("l2", 0.30, False)], None, 0.1, None),
    ([], [("l2", 0.2, False)], 0.1, None),
    ([("l2", math.nan, False)], [("l2", 0.2, False)], 0.1, None),
    ([("l1", 0.5, False), ("auc", 0.6, True)],
     [("l1", 0.1, False), ("auc", 0.61, True)], 0.05, "auc"),
])
def test_gate_verdict_matches_jax(cand, inc, tol, metric):
    # compared as JSON: a NaN candidate's record holds NaN
    assert json.dumps(quality.gate_verdict(cand, inc, tol, metric),
                      sort_keys=True) == \
        json.dumps(jquality.gate_verdict(cand, inc, tol, metric),
                   sort_keys=True)


def test_gate_verdict_unknown_metric_raises():
    with pytest.raises(LightGBMError, match="not among"):
        quality.gate_verdict([("l2", 0.1, False)], None, 0.1, "auc")


def _rank_data(rng, n, f):
    X = rng.standard_normal((n, f))
    rel = np.clip(np.round(X[:, 0] + 0.5 * rng.standard_normal(n) + 1),
                  0, 3)
    q = np.repeat(np.arange(n // 20), 20)
    return X, rel, q


@pytest.mark.parametrize("objective,extra", [
    ("binary", {"metric": "auc,binary_logloss,binary_error"}),
    ("regression", {"metric": "l2,l1,huber"}),
    ("multiclass", {"num_class": 3,
                    "metric": "multi_logloss,multi_error"}),
    ("lambdarank", {"metric": "ndcg", "eval_at": "1,3"}),
])
def test_evaluate_model_matches_jax(objective, extra):
    rng = np.random.default_rng(11)
    n, f = 600, 5
    group = None
    if objective == "lambdarank":
        X, y, q = _rank_data(rng, n, f)
        group = np.full(n // 20, 20)
    else:
        X = rng.standard_normal((n, f))
        q = None
        if objective == "binary":
            y = (X[:, 0] + 0.5 * rng.standard_normal(n) > 0).astype(float)
        elif objective == "multiclass":
            y = np.digitize(X[:, 0] + 0.3 * rng.standard_normal(n),
                            [-0.4, 0.4]).astype(float)
        else:
            y = X[:, 0] * 2 + rng.standard_normal(n)
    params = dict(objective=objective, num_leaves=7, verbose=-1,
                  device_type="cpu", **extra)
    bst = lt.train(params, lt.Dataset(X, label=y, group=group), 4)
    text = bst.model_to_string()
    hold = quality.holdout_mask(n, 0.25, q)
    w = rng.uniform(0.5, 1.5, n)
    for weight in (None, w[hold]):
        got = quality.evaluate_model(
            GBDTModel.load_model_from_string(text), X[hold], y[hold],
            params, weight=weight, query=None if q is None else q[hold])
        want = jquality.evaluate_model(
            JModel.load_model_from_string(text), X[hold], y[hold],
            params, weight=weight, query=None if q is None else q[hold])
        assert [(m, h) for m, _, h in got] == [(m, h) for m, _, h in want]
        assert len(got) >= 1
        for (_, v, _), (_, jv, _) in zip(got, want):
            assert abs(v - jv) <= 1e-6 * max(1.0, abs(jv)), (got, want)


def test_stream_quarantine_dense_matches_jax():
    rng = np.random.default_rng(1)
    X = rng.standard_normal((400, 3))
    y = (X[:, 0] > 0).astype(np.float64)
    y[[4, 90, 377]] = [np.nan, np.inf, -np.inf]
    w = np.ones(400)
    w[12] = np.nan
    params = {"min_data_in_leaf": 2, "verbose": -1}
    # default off: the bad labels stay
    b0 = StreamingDatasetBuilder(params=params)
    b0.push_dense(X, label=y)
    assert b0.num_pushed_rows == 400 and np.isnan(b0.labels()).sum() == 1
    built = {}
    for name, cls in (("torch", StreamingDatasetBuilder),
                      ("jax", JBuilder)):
        b = cls(params=params, quarantine=True)
        for s in range(0, 400, 100):
            b.push_dense(X[s:s + 100], label=y[s:s + 100],
                         weight=w[s:s + 100])
        built[name] = b
    b, jb = built["torch"], built["jax"]
    assert b.num_pushed_rows == jb.num_pushed_rows == 396
    assert np.array_equal(b.labels(), jb.labels())
    assert np.array_equal(b.weights(), jb.weights())
    assert b.quarantine.summary() == jb.quarantine.summary()
    ds = lt.Dataset(b, label=b.labels(), weight=b.weights(),
                    params=dict(params, device_type="cpu")).construct()
    assert ds.num_data() == 396


def test_stream_quarantine_csr_and_positioned_error():
    import scipy.sparse as sp
    from lightgbm_tpu.utils.log import LightGBMError as JError
    X = np.random.default_rng(2).standard_normal((10, 4))
    X[X < 0] = 0.0
    y = np.ones(10)
    y[3] = np.inf
    csr = sp.csr_matrix(X)
    b = StreamingDatasetBuilder(quarantine=True)
    b.push_csr(csr.indptr, csr.indices, csr.data, 4, label=y)
    jb = JBuilder(quarantine=True)
    jb.push_csr(csr.indptr, csr.indices, csr.data, 4, label=y)
    assert b.num_pushed_rows == jb.num_pushed_rows == 9
    assert b.finalize().num_data == 9
    ref = StreamingDatasetBuilder().push_dense(X, label=np.ones(10)) \
        .finalize()
    b2 = StreamingDatasetBuilder(reference=ref, num_total_rows=10,
                                 quarantine=True)
    with pytest.raises(LightGBMError, match="quarantine"):
        b2.push_dense(X, label=y, start_row=0)
    jref = JBuilder().push_dense(X, label=np.ones(10)).finalize()
    with pytest.raises(JError, match="quarantine"):
        JBuilder(reference=jref, num_total_rows=10,
                 quarantine=True).push_dense(X, label=y, start_row=0)
