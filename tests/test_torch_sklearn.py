"""The port's scikit-learn estimators against the JAX package's on the
CPU: the twelve cases of tests/test_sklearn.py on seeded synthetic data
shaped like their fixtures (the reference examples' 28 dense columns, 5
classes for multiclass, 300 sparse columns in queries for lambdarank; the
rows cut), each estimator's predictions held against the JAX
estimator's fitted on the same input; pickle, get_params / set_params,
sklearn.base.clone and a small GridSearchCV; and the module loaded with
scikit-learn hidden, where the estimators fit and predict all the
same."""
import importlib.util
import pickle
import sys

import numpy as np
import pytest
import torch

import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt

from test_torch_train import _assert_same_structure

# one intra-op thread: the pytest-xdist workers share the cores, and
# torch's OpenMP regions spin in their barriers when oversubscribed
torch.set_num_threads(1)

#: predictions of the two packages' estimators on their training rows
#: (raw scores, probabilities and regression outputs): the CPU parity of
#: tests/test_torch_train.py.  Held-out rows are not compared: one in a
#: bin that no training row holds sits between thresholds that tie
#: exactly, and which of them each package picks is decided by ulps
#: (_assert_same_structure)
PRED_ATOL = 1e-5
CPU = dict(device_type="cpu")
#: where leaves get small (five classes, few-document leaves, a thinned
#: class): a split that gains about 0 is taken or not on f32 noise in
#: each package (ROADMAP queue C; at min_split_gain 0.01 the JAX package
#: split a thinned-class leaf for a gain of 1.5e-5 that the port did not
#: take), so the compared fits ask a least gain
TIE_FREE = dict(min_split_gain=0.1)
#: the compared fits bin to 63 bins (a parameter passed through to the
#: engines), which keeps the CPU split searches of both packages short
SMALL = dict(max_bin=63)


def _dense(seed, n, f=28):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, f))
    z = X[:, 0] + 0.6 * X[:, 1] * X[:, 2] - 0.4 * np.abs(X[:, 3]) \
        + 0.3 * X[:, 4] + 0.3 * rng.standard_normal(n)
    return X, z, rng.uniform(0.5, 1.5, n)


@pytest.fixture(scope="module")
def regression_data():
    X, z, w = _dense(0, 2500)
    return X[:2000], z[:2000], X[2000:], z[2000:], w[:2000]


@pytest.fixture(scope="module")
def binary_data():
    X, z, w = _dense(1, 2500)
    y = (z > 0).astype(np.float64)
    return X[:2000], y[:2000], X[2000:], y[2000:], w[:2000]


@pytest.fixture(scope="module")
def multiclass_data():
    X, z, w = _dense(2, 1250)
    y = np.digitize(z, np.quantile(z, [0.2, 0.4, 0.6, 0.8])).astype(
        np.float64)
    return X[:1000], y[:1000], X[1000:], y[1000:], w[:1000]


@pytest.fixture(scope="module")
def rank_data():
    """rank.train's shape: 300 columns, most of them 0 in most rows (a
    third non-zero: sparse enough for zeros to matter, dense enough that
    EFB bundles none, whose f32 default bins flip exact ties between the
    packages, ROADMAP queue C), in queries of 3 to 30 documents,
    relevance 0-4."""
    rng = np.random.default_rng(3)
    sizes = rng.integers(3, 31, 60)
    n = int(sizes.sum())
    X = rng.standard_normal((n, 300)) * (rng.random((n, 300)) < 0.35)
    X[:, :6] = rng.standard_normal((n, 6))
    rel = np.clip(np.round(X[:, 0] + 0.5 * X[:, 1] + 1.5
                           + 0.3 * rng.standard_normal(n)), 0, 4)
    cut = int(sizes[:45].sum())
    return (X[:cut], rel[:cut], sizes[:45], X[cut:], rel[cut:], sizes[45:])


def _both(name, params, fit_args, fit_kw=None):
    """The same estimator fitted by both packages on the same input; their
    trees agree node for node (the training rows' routing)."""
    fit_kw = dict(fit_kw or {})
    params = dict(SMALL, **params)
    ej = getattr(lj, name)(**params).fit(*fit_args, **fit_kw)
    et = getattr(lt, name)(**params, **CPU).fit(*fit_args, **fit_kw)
    _assert_same_structure(ej.booster_, et.booster_, fit_args[0])
    return ej, et


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), rtol=1e-5,
                               atol=PRED_ATOL)


def test_regressor(regression_data):
    X, y, Xt, yt, w = regression_data
    rj, reg = _both("LGBMRegressor", dict(n_estimators=15, num_leaves=31),
                    (X, y), dict(sample_weight=w))
    pred = reg.predict(Xt)
    assert np.mean((pred - yt) ** 2) < 0.5 * np.var(yt)
    assert reg.n_features_ == X.shape[1]
    imp = reg.feature_importances_
    assert imp.shape == (X.shape[1],) and imp.sum() > 0
    np.testing.assert_array_equal(imp, rj.feature_importances_)
    _close(reg.predict(X), rj.predict(X))


def test_classifier_binary(binary_data):
    X, y, Xt, yt, w = binary_data
    cj, clf = _both("LGBMClassifier", dict(n_estimators=15), (X, y),
                    dict(sample_weight=w))
    assert list(clf.classes_) == [0.0, 1.0]
    proba = clf.predict_proba(Xt)
    assert proba.shape == (len(yt), 2)
    np.testing.assert_allclose(proba.sum(axis=1), 1.0, rtol=1e-6)
    labels = clf.predict(Xt)
    assert np.mean(labels == yt) > 0.7
    _close(clf.predict_proba(X), cj.predict_proba(X))
    np.testing.assert_array_equal(clf.predict(X), cj.predict(X))


def test_classifier_multiclass(multiclass_data):
    X, y, Xt, yt, w = multiclass_data
    cj, clf = _both("LGBMClassifier", dict(n_estimators=10, **TIE_FREE),
                    (X, y), dict(sample_weight=w))
    assert clf.n_classes_ == 5
    proba = clf.predict_proba(Xt)
    assert proba.shape == (len(yt), 5)
    assert np.mean(clf.predict(Xt) == yt) > 0.4
    _close(clf.predict_proba(X), cj.predict_proba(X))


def test_classifier_string_labels(binary_data):
    X, y, _, _, w = binary_data
    y_str = np.where(y > 0, "pos", "neg")
    cj, clf = _both("LGBMClassifier", dict(n_estimators=5), (X, y_str),
                    dict(sample_weight=w))
    labels = clf.predict(X)
    assert set(labels) <= {"pos", "neg"}
    assert np.mean(labels == y_str) > 0.7
    np.testing.assert_array_equal(labels, cj.predict(X))


def test_ranker(rank_data):
    X, y, q, Xt, yt, qt = rank_data
    kw = dict(eval_set=[(Xt, yt)], eval_group=[qt], eval_metric="ndcg")
    # leaves of five documents at least: one- and two-document leaves of
    # lambdarank tie between candidates at near-tied scores (queue C)
    rj, rk = _both("LGBMRanker", dict(n_estimators=10, min_child_samples=5,
                                      max_bin=31, **TIE_FREE),
                   (X, y), dict(group=q, **kw))
    assert "ndcg@1" in rk.evals_result_["valid_0"]
    scores = rk.predict(Xt)
    assert scores.shape == (len(yt),)
    _close(rk.predict(X), rj.predict(X))


def test_custom_objective(regression_data):
    X, y, Xt, yt, _ = regression_data

    def l2_obj(y_true, y_pred):
        return y_pred - y_true, np.ones_like(y_true)

    rj, reg = _both("LGBMRegressor", dict(n_estimators=10, objective=l2_obj),
                    (X, y))
    pred = reg.predict(Xt)
    builtin = lt.LGBMRegressor(n_estimators=10, **CPU).fit(X, y).predict(Xt)
    assert np.mean((pred - yt) ** 2) < np.mean((builtin - yt) ** 2) + 0.1
    _close(reg.predict(X), rj.predict(X))


def test_early_stopping_sklearn(binary_data):
    X, y, Xt, yt, w = binary_data
    kw = dict(sample_weight=w, eval_set=[(Xt, yt)],
              eval_metric="binary_logloss", early_stopping_rounds=3)
    cj, clf = _both("LGBMClassifier", dict(n_estimators=100,
                                           learning_rate=0.3), (X, y), kw)
    assert clf.best_iteration_ > 0
    assert clf.booster_.num_trees() < 100
    assert clf.best_iteration_ == cj.best_iteration_
    _close(clf.predict_proba(X), cj.predict_proba(X))


def test_pickle_round_trip(binary_data):
    X, y, Xt, _, _ = binary_data
    clf = lt.LGBMClassifier(n_estimators=5, **CPU)
    clf.fit(X, y)
    clone = pickle.loads(pickle.dumps(clf))
    np.testing.assert_allclose(clone.predict_proba(Xt), clf.predict_proba(Xt))
    assert clone.get_params() == clf.get_params()


def test_get_set_params():
    reg = lt.LGBMRegressor(num_leaves=15, learning_rate=0.2, max_bin=63)
    params = reg.get_params()
    assert params["num_leaves"] == 15
    assert params["learning_rate"] == 0.2
    assert params["max_bin"] == 63
    assert params == lj.LGBMRegressor(num_leaves=15, learning_rate=0.2,
                                      max_bin=63).get_params()
    reg.set_params(num_leaves=7, min_data_in_bin=5)
    assert reg.num_leaves == 7
    assert reg.get_params()["min_data_in_bin"] == 5
    reg2 = lt.LGBMRegressor(**params)
    assert reg2.num_leaves == 15


def test_class_weight_balanced(binary_data):
    X, y, _, _, w = binary_data
    keep = (y == 0) | (np.arange(len(y)) % 10 == 0)
    Xi, yi, wi = X[keep], y[keep], w[keep]
    plain = lt.LGBMClassifier(n_estimators=10, **CPU).fit(
        Xi, yi, sample_weight=wi)
    bj, balanced = _both("LGBMClassifier",
                         dict(n_estimators=10, class_weight="balanced",
                              **TIE_FREE),
                         (Xi, yi), dict(sample_weight=wi))
    assert balanced.predict(Xi).sum() > plain.predict(Xi).sum()
    _close(balanced.predict_proba(Xi), bj.predict_proba(Xi))


def test_refit_with_fewer_classes_resets_num_class(multiclass_data,
                                                   binary_data):
    Xm, ym, _, _, _ = multiclass_data
    Xb, yb, _, _, _ = binary_data
    clf = lt.LGBMClassifier(n_estimators=3, **CPU)
    clf.fit(Xm, ym)
    assert clf.n_classes_ == 5
    assert clf.booster_.num_model_per_iteration() == 5
    clf.fit(Xb, yb)
    assert clf.n_classes_ == 2
    assert clf.booster_.num_model_per_iteration() == 1
    assert set(np.unique(clf.predict(Xb))) <= {0.0, 1.0}


def test_custom_eval_metric_on_valid(binary_data):
    X, y, Xt, yt, w = binary_data

    def neg_count(preds, dataset):
        return "neg_count", float(np.sum(preds < 0)), False

    kw = dict(sample_weight=w, eval_set=[(Xt, yt)], eval_metric=neg_count)
    cj, clf = _both("LGBMClassifier", dict(n_estimators=5), (X, y), kw)
    rec = clf.evals_result_["valid_0"]["neg_count"]
    assert len(rec) == 5
    assert rec == cj.evals_result_["valid_0"]["neg_count"]


def test_sklearn_clone_and_grid_search(regression_data):
    """sklearn.base.clone keeps every parameter, pass-through ones too,
    and GridSearchCV fits the port's regressor by its R^2 score."""
    base = pytest.importorskip("sklearn.base")
    ms = pytest.importorskip("sklearn.model_selection")
    X, y, _, _, _ = regression_data
    reg = lt.LGBMRegressor(n_estimators=5, num_leaves=7, max_bin=63, **CPU)
    twin = base.clone(reg)
    assert twin is not reg and twin.get_params() == reg.get_params()
    grid = ms.GridSearchCV(reg, {"num_leaves": [3, 15]}, cv=2)
    grid.fit(X[:600], y[:600])
    assert grid.best_params_["num_leaves"] in (3, 15)
    assert grid.best_estimator_.booster_.device.type == "cpu"
    assert np.isfinite(grid.best_score_)


def test_works_without_sklearn(binary_data, monkeypatch):
    """The module loaded with scikit-learn hidden from sys.modules: the
    estimators derive from object, and fit, predict, get_params and
    set_params work all the same."""
    for name in [m for m in sys.modules if m == "sklearn"
                 or m.startswith("sklearn.")]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "sklearn", None)
    spec = importlib.util.spec_from_file_location(
        "lightgbm_tpu_torch._sklearn_alone", lt.sklearn.__file__)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod._SKBase is object
    X, y, Xt, _, _ = binary_data
    clf = mod.LGBMClassifier(n_estimators=5, num_leaves=7, **CPU)
    assert clf.set_params(num_leaves=15).get_params()["num_leaves"] == 15
    clf.fit(X, y)
    ref = lt.LGBMClassifier(n_estimators=5, num_leaves=15, **CPU).fit(X, y)
    np.testing.assert_array_equal(clf.predict_proba(Xt),
                                  ref.predict_proba(Xt))
