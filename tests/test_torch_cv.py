"""cv() in the port against the JAX package on the CPU (mirroring
tests/test_cv.py, the same seeded numpy inputs, weighted rows): the
result keys, means and standard deviations per iteration for stratified,
shuffled, custom and whole-query folds, eval_train_metric,
return_cvbooster with its best_iteration, early stopping, init_model and
a reset_parameter schedule through the CVBooster."""
import numpy as np
import pytest
import torch

import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt
from lightgbm_tpu.engine import _group_folds as jax_group_folds
from lightgbm_tpu_torch.engine import _group_folds

# one intra-op thread: the pytest-xdist workers share the cores, and
# torch's OpenMP regions spin in their barriers when oversubscribed
torch.set_num_threads(1)

N, F = 900, 6
BASE = {"objective": "binary", "metric": ["auc", "binary_logloss"],
        "num_leaves": 7, "min_data_in_leaf": 5, "verbose": -1}
#: per-iteration means and deviations of the two packages (f32 scores)
RTOL = 1e-5


def _cpu(params):
    return dict(params, device_type="cpu")


def _data(n=N, seed=3):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, F))
    y = (X[:, 0] + 0.3 * X[:, 1] + rng.standard_normal(n) * 0.4 > 0)
    return X, y.astype(np.float64), rng.uniform(0.5, 1.5, n)


def _cv_both(params, rounds, dataset=None, **kwargs):
    """cv in both packages on the same rows; (JAX result, port result)."""
    X, y, w = _data() if dataset is None else dataset[:3]
    extra = dataset[3] if dataset is not None and len(dataset) > 3 else {}
    rj = lj.cv(params, lj.Dataset(X, label=y, weight=w, **extra), rounds,
               **kwargs)
    rt = lt.cv(_cpu(params), lt.Dataset(X, label=y, weight=w, **extra),
               rounds, **kwargs)
    return rj, rt


def _assert_results_match(rj, rt):
    keys = {k for k in rj if k != "cvbooster"}
    assert {k for k in rt if k != "cvbooster"} == keys
    for k in keys:
        np.testing.assert_allclose(rt[k], rj[k], rtol=RTOL, atol=1e-7,
                                   err_msg=k)


@pytest.fixture(scope="module")
def stratified():
    return _cv_both(BASE, 4, nfold=3, eval_train_metric=True,
                    return_cvbooster=True)


def test_cv_stratified_matches_jax(stratified):
    rj, rt = stratified
    assert set(rt) == {"auc-mean", "auc-stdv", "binary_logloss-mean",
                       "binary_logloss-stdv", "train auc-mean",
                       "train auc-stdv", "train binary_logloss-mean",
                       "train binary_logloss-stdv", "cvbooster"}
    assert len(rt["auc-mean"]) == 4
    _assert_results_match(rj, rt)


def test_cv_eval_train_metric(stratified):
    rt = stratified[1]
    assert rt["train auc-mean"][-1] >= rt["auc-mean"][-1] - 1e-6
    assert rt["train binary_logloss-mean"][-1] < \
        rt["binary_logloss-mean"][-1]


def test_cv_return_cvbooster_and_best_iteration(stratified):
    rj, rt = stratified
    cvb = rt["cvbooster"]
    assert isinstance(cvb, lt.CVBooster)
    assert len(cvb.boosters) == 3
    assert cvb.num_trees() == [4] * 3
    assert cvb.best_iteration == rj["cvbooster"].best_iteration
    assert 1 <= cvb.best_iteration <= 4
    # each fold's last valid metrics (device scores) are its booster's
    # on its own test rows through the host model
    for bst, res in zip(cvb.boosters, cvb.eval_valid()):
        valid = dict(bst._valid_data)["valid"]
        got = {m: v for name, m, v, _ in res if name == "valid"}
        want = {m: v for _, m, v, _ in bst.eval(valid, "valid")}
        assert set(got) == set(want) == {"auc", "binary_logloss"}
        for m in got:
            assert got[m] == pytest.approx(want[m], rel=1e-5)


@pytest.mark.parametrize("kind", ["shuffled", "custom"])
def test_cv_fold_kinds_match_jax(kind):
    if kind == "shuffled":
        kwargs = dict(nfold=2, stratified=False, shuffle=True, seed=11)
    else:
        idx = np.arange(N)
        kwargs = dict(folds=[(idx[300:], idx[:300]), (idx[:600], idx[600:])])
    rj, rt = _cv_both(dict(BASE, metric="auc"), 3, return_cvbooster=True,
                      **kwargs)
    assert len(rt["cvbooster"].boosters) == 2
    _assert_results_match(rj, rt)


def test_group_folds_match_jax_and_keep_queries_whole():
    sizes = np.array([10, 20, 5, 8, 12, 30, 7, 9])
    seen = []
    for got, want in zip(_group_folds(sizes, 3), jax_group_folds(sizes, 3)):
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        tr, te, gtr, gte = got
        assert gtr.sum() == len(tr) and gte.sum() == len(te)
        assert len(np.intersect1d(tr, te)) == 0
        seen.append(te)
    np.testing.assert_array_equal(np.sort(np.concatenate(seen)),
                                  np.arange(sizes.sum()))


def test_cv_ranking_group_folds_match_jax():
    rng = np.random.default_rng(5)
    n_q, per_q = 40, 12
    n = n_q * per_q
    X = rng.standard_normal((n, F))
    rel = (X[:, 0] > 0.3).astype(np.float64) + (X[:, 1] > 0.8)
    params = {"objective": "lambdarank", "metric": "ndcg", "eval_at": "3",
              "num_leaves": 7, "min_data_in_leaf": 2, "verbose": -1}
    rj, rt = _cv_both(params, 3, dataset=(X, rel, rng.uniform(0.5, 1.5, n),
                                          dict(group=np.full(n_q, per_q))),
                      nfold=2)
    assert set(rt) == {"ndcg@3-mean", "ndcg@3-stdv"}
    _assert_results_match(rj, rt)


def test_cv_early_stopping_truncates_at_the_best_mean():
    """Early stopping on the first valid metric's mean: the result ends at
    the best iteration of the full run, once that best is
    early_stopping_rounds behind."""
    X, y, w = _data(400, seed=8)
    params = _cpu(dict(BASE, metric="binary_logloss", num_leaves=15,
                       min_data_in_leaf=2, learning_rate=0.5))
    full = lt.cv(params, lt.Dataset(X, label=y, weight=w), 8, nfold=2)
    means = full["binary_logloss-mean"]
    best = int(np.argmin(means))
    assert best + 2 < 8, "the data must overfit within 8 rounds"
    stopped = lt.cv(params, lt.Dataset(X, label=y, weight=w), 8, nfold=2,
                    early_stopping_rounds=2, return_cvbooster=True)
    assert stopped["binary_logloss-mean"] == means[:best + 1]
    assert stopped["cvbooster"].best_iteration == best + 1


def test_cv_init_model_and_reset_parameter_match_jax(tmp_path):
    """Every fold continues the loaded model; a learning-rate schedule
    reaches every fold booster through the CVBooster."""
    X, y, w = _data()
    warm = lt.train(_cpu(BASE), lt.Dataset(X, label=y, weight=w), 3,
                    verbose_eval=False)
    path = str(tmp_path / "warm.txt")
    warm.save_model(path)
    rates = [0.2, 0.05, 0.1]
    res = []
    for pkg in (lj, lt):
        res.append(pkg.cv(_cpu(BASE) if pkg is lt else BASE,
                          pkg.Dataset(X, label=y, weight=w), 3, nfold=2,
                          init_model=path, return_cvbooster=True,
                          callbacks=[pkg.reset_parameter(
                              learning_rate=rates)]))
    rj, rt = res
    _assert_results_match(rj, rt)
    for bst in rt["cvbooster"].boosters:
        assert bst.current_iteration() == 6
        assert [t.shrinkage for t in bst._model.trees[3:]] == \
            pytest.approx(rates, rel=1e-12)
        assert bst.params["learning_rate"] == rates[-1]
