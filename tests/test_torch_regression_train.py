"""Training every single-model objective of the port against the JAX
package on the CPU (the same seeded numpy inputs): the regression family,
xentropy and xentlambda node for node with weighted rows, the renewal
objectives (L1, quantile, MAPE) under every grower mode, training from an
init_score, and the validation scores with the init score a regression
boosts from."""
import functools

import numpy as np
import pytest
import torch

import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.boosting import gbdt as tgbdt
from lightgbm_tpu_torch.boosting import grower2 as tgrower2
from lightgbm_tpu_torch.ops import cuda_segment

from test_torch_train import _assert_same_structure

# one intra-op thread: the pytest-xdist workers share the cores, and
# torch's OpenMP regions spin in their barriers when oversubscribed
torch.set_num_threads(1)

N, F, ROUNDS = 2000, 8, 5
PARAMS = dict(num_leaves=31, max_bin=63, learning_rate=0.1, verbose=-1)
RENEW = ("regression_l1", "quantile", "mape")
#: leaf values: rtol 1e-5, with an atol for leaves near 0, whose f32
#: gradient sums cancel (each package sums in its own order)
LEAF_RTOL, LEAF_ATOL = 1e-5, 2e-6


def _data(objective, seed=0, n=N):
    """X and labels of the objective's domain: positive for poisson, gamma
    and tweedie, in [0, 1] for the cross-entropies, else real around 3."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, F))
    f = X[:, 0] + 0.5 * X[:, 1] * X[:, 2] - 0.3 * np.abs(X[:, 3])
    noise = 0.3 * rng.standard_normal(n)
    if objective in ("poisson", "gamma", "tweedie"):
        return X, np.exp(0.5 * f + noise)
    if objective in ("xentropy", "xentlambda"):
        return X, 1.0 / (1.0 + np.exp(-(f + noise)))
    return X, 3.0 + f + noise


def _weights(seed=0, n=N):
    """Continuous row weights: no two candidate gains tie exactly
    (tests/test_torch_train.py:_weights)."""
    return np.random.default_rng(seed + 100).uniform(0.5, 1.5, n)


def _params(objective, **extra):
    params = dict(PARAMS, objective=objective, **extra)
    if objective in RENEW:
        # a leaf whose rows all sit on one side of the quantile has a
        # constant grad / hess ratio, so every split of it gains 0 exactly
        # and f32 noise (~1e-6) picks one; both packages skip such splits
        params.setdefault("min_gain_to_split", 0.01)
    return params


def _assert_leaves_close(bj, bt):
    for tj, tt in zip(bj._model.trees, bt._model.trees):
        nl = tj.num_leaves
        np.testing.assert_allclose(tt.leaf_value[:nl], tj.leaf_value[:nl],
                                   rtol=LEAF_RTOL, atol=LEAF_ATOL)


OBJECTIVES = [("regression", {}), ("regression", dict(reg_sqrt=True)),
              ("regression_l1", {}), ("huber", {}), ("fair", {}),
              ("poisson", {}), ("quantile", dict(alpha=0.3)), ("mape", {}),
              ("gamma", {}), ("tweedie", {}), ("xentropy", {}),
              ("xentlambda", {})]


@pytest.mark.parametrize("objective,extra", OBJECTIVES,
                         ids=["%s%s" % (o, "-sqrt" if e.get("reg_sqrt")
                                        else "") for o, e in OBJECTIVES])
def test_objective_trains_node_for_node(objective, extra):
    X, y = _data(objective)
    w = _weights()
    params = _params(objective, **extra)
    bj = lj.train(params, lj.Dataset(X, label=y, weight=w), ROUNDS,
                  verbose_eval=False)
    bt = lt.train(dict(params, device_type="cpu"),
                  lt.Dataset(X, label=y, weight=w), ROUNDS,
                  verbose_eval=False)
    assert bt.current_iteration() == bj.current_iteration() == ROUNDS
    assert bt._model.objective_str == bj._model.objective_str
    _assert_same_structure(bj, bt, X)
    _assert_leaves_close(bj, bt)
    np.testing.assert_allclose(bt.predict(X, raw_score=True),
                               bj.predict(X, raw_score=True), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(bt._engine.raw_train_score(),
                               bj._engine.raw_train_score(), rtol=1e-5,
                               atol=1e-5)
    # renewal reads the pre-tree scores with a second blocking fetch
    syncs = 2 if objective in RENEW else 1
    assert bt.host_syncs_per_tree() == [syncs] * ROUNDS


def _renew_data(objective):
    """Unweighted rows whose gradients are dyadic (L1's +-1, quantile's
    0.75 / -0.25, MAPE's +-1 on labels with |label| <= 1): every f32
    histogram sum is exact, so each grower mode meets the one-leaf loop's
    sums in whatever order it adds them."""
    X, y = _data("regression", seed=3)
    if objective == "mape":
        y = np.clip((y - 3.0) / 4.0, -1.0, 1.0)
    return X, y


def _merged(monkeypatch):
    monkeypatch.setattr(cuda_segment, "PARTITION_HIST_VALIDATED", True)
    monkeypatch.setattr(tgbdt, "make_partitioned_grower", functools.partial(
        tgrower2.make_partitioned_grower, merged_hist=True))


@pytest.mark.parametrize("mode", ["frontier", "pooled", "merged"])
@pytest.mark.parametrize("objective", RENEW)
def test_renewal_grower_modes_write_one_leaf_text(objective, mode,
                                                  monkeypatch):
    X, y = _renew_data(objective)
    params = dict(PARAMS, objective=objective, alpha=0.25,
                  device_type="cpu")

    def train(**extra):
        return lt.train(dict(params, **extra), lt.Dataset(X, label=y),
                        ROUNDS, verbose_eval=False)

    one = train()
    if mode == "frontier":
        bst = train(tpu_frontier_batch=8)
        assert bst.split_rounds_per_tree() < one.split_rounds_per_tree()
    elif mode == "pooled":
        bst = train(histogram_pool_size=0.01)
        assert bst._engine.grower_cfg.hist_pool_slots == 2
    else:
        _merged(monkeypatch)
        bst = train()
        assert bst._engine.grower.hist_engine == "partition_segment_hist"
    assert bst.host_syncs_per_tree() == [2] * ROUNDS
    assert bst.model_to_string() == one.model_to_string()


@pytest.mark.parametrize("objective", ["regression", "binary",
                                       "regression_l1"])
def test_init_score_training_matches_jax(objective):
    X, y = _data(objective, seed=5)
    if objective == "binary":
        y = (y > 3.0).astype(np.float64)
    w = _weights(5)
    init = np.random.default_rng(6).standard_normal(N) * 0.5 + \
        (3.0 if objective != "binary" else 0.0)
    params = _params(objective)
    bj = lj.train(params, lj.Dataset(X, label=y, weight=w, init_score=init),
                  ROUNDS, verbose_eval=False)
    dt = lt.Dataset(X, label=y, weight=w, init_score=init)
    bt = lt.train(dict(params, device_type="cpu"), dt, ROUNDS,
                  verbose_eval=False)
    np.testing.assert_array_equal(dt.get_init_score(), init)
    # no boost from average: the first tree keeps its shrinkage
    assert bt._model.trees[0].shrinkage == pytest.approx(0.1)
    _assert_same_structure(bj, bt, X)
    _assert_leaves_close(bj, bt)
    # the model holds no init score; the training scores start from it
    np.testing.assert_allclose(bt.predict(X, raw_score=True),
                               bj.predict(X, raw_score=True), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(bt._engine.raw_train_score()[0],
                               bt.predict(X, raw_score=True) + init,
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(bt._engine.raw_train_score(),
                               bj._engine.raw_train_score(), rtol=1e-5,
                               atol=1e-5)


def test_set_init_score_before_construct():
    X, y = _data("regression", seed=7)
    init = np.full(N, 2.5)
    ds = lt.Dataset(X, label=y)
    ds.set_init_score(init)
    bst = lt.train(dict(PARAMS, objective="regression", device_type="cpu"),
                   ds, 2, verbose_eval=False)
    np.testing.assert_array_equal(ds.get_init_score(), init)
    np.testing.assert_allclose(bst._engine.raw_train_score()[0],
                               bst.predict(X, raw_score=True) + 2.5,
                               rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("case", ["before", "after", "after-init-score",
                                  "stump"])
def test_valid_scores_match_jax(case):
    """The regression's init score is the label mean (~3), which the JAX
    package adds to the validation scores and the port folds into the
    first tree's leaves; the scores agree to f32 rounding, for a set added
    before training, one added after it (with its own init score) and a
    first tree that is a stump."""
    X, y = _data("regression", seed=9)
    w = _weights(9)
    # the training rows in another order: both packages route them alike
    perm = np.random.default_rng(10).permutation(N)
    Xv, yv = X[perm], y[perm]
    vinit = np.random.default_rng(11).standard_normal(N) \
        if case == "after-init-score" else None
    params = dict(PARAMS, objective="regression", metric="l2")
    if case == "stump":
        params["min_data_in_leaf"] = N
    boosters = []
    for pkg, extra in ((lj, {}), (lt, dict(device_type="cpu"))):
        ds = pkg.Dataset(X, label=y, weight=w)
        bst = pkg.Booster(dict(params, **extra), ds)
        if case in ("before", "stump"):
            bst.add_valid(pkg.Dataset(Xv, label=yv, reference=ds), "v")
        for _ in range(ROUNDS):
            if bst.update():
                break
        if case.startswith("after"):
            if pkg is lj:
                bst._engine.flush()
            bst.add_valid(pkg.Dataset(Xv, label=yv, reference=ds,
                                      init_score=vinit), "v")
        boosters.append(bst)
    bj, bt = boosters
    assert bt.current_iteration() == bj.current_iteration() == \
        (1 if case == "stump" else ROUNDS)
    vj = bj._engine.raw_valid_score(0)[0]
    vt = bt._engine.raw_valid_score(0)[0]
    np.testing.assert_allclose(vt, vj, rtol=1e-5, atol=1e-5)
    expect = bt.predict(Xv, raw_score=True)
    if vinit is not None:
        expect = expect + vinit
    np.testing.assert_allclose(vt, expect, rtol=1e-6, atol=1e-5)
