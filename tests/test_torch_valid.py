"""Validation sets in the port against the JAX package on the CPU: scores
kept per validation set and updated after every tree, the metrics on
them per iteration, valid_names / evals_result, early stopping, and a
validation set added after training has started (its scores replay the
existing trees)."""
import numpy as np
import pytest
import torch

import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt
from lightgbm_tpu.callback import record_evaluation

# one intra-op thread: the pytest-xdist workers share the cores, and
# torch's OpenMP regions spin in their barriers when oversubscribed
torch.set_num_threads(1)

N, F = 2000, 8
PARAMS = dict(objective="binary", num_leaves=15, max_bin=63,
              learning_rate=0.1, verbose=-1,
              metric=["auc", "binary_logloss"])


def _data(seed, n=N, noise=0.3):
    """X (5 % NaN), labels, row weights and a function that draws fresh
    labels for the same rows."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, F))
    signal = X[:, 0] + 0.5 * X[:, 1] * X[:, 2] - 0.3 * np.abs(X[:, 3])

    def labels():
        return (signal + noise * rng.standard_normal(n) > 0).astype(
            np.float64)

    y = labels()
    X[rng.random((n, F)) < 0.05] = np.nan
    # continuous weights: no two candidate gains tie exactly, so the two
    # packages grow the same trees (tests/test_torch_train.py)
    return X, y, rng.uniform(0.5, 1.5, n), labels


def _train_both(params, X, y, w, valid_sets, rounds, **kw):
    """Train both packages with the same validation sets; returns the
    boosters and their per-iteration results."""
    tj = lj.Dataset(X, label=y, weight=w)
    tt = lt.Dataset(X, label=y, weight=w)
    vj = [lj.Dataset(Xv, label=yv, reference=tj) for Xv, yv in valid_sets]
    vt = [lt.Dataset(Xv, label=yv, reference=tt) for Xv, yv in valid_sets]
    names = ["valid_%c" % c for c in "ab"[:len(valid_sets)]]
    ej, et = {}, {}
    bj = lj.train(params, tj, rounds, valid_sets=vj, valid_names=names,
                  callbacks=[record_evaluation(ej)], verbose_eval=False, **kw)
    bt = lt.train(dict(params, device_type="cpu"), tt, rounds, valid_sets=vt,
                  valid_names=names, evals_result=et, verbose_eval=False,
                  **kw)
    return bj, bt, ej, et


def _valid_scores(booster, i):
    return booster._engine.raw_valid_score(i)[0]


def test_valid_scores_and_metrics_match_jax():
    # validation rows the two packages route alike are the training rows
    # (held-out rows may fall between two exactly tied thresholds, which
    # the packages break by ulps): here in another order, and a subset
    # with fresh labels
    X, y, w, labels = _data(0)
    perm = np.random.default_rng(1).permutation(N)
    sets = [(X[perm], y[perm]), (X[perm[:500]], labels()[perm[:500]])]
    bj, bt, ej, et = _train_both(PARAMS, X, y, w, sets, 5)
    for i, (Xv, _) in enumerate(sets):
        np.testing.assert_allclose(_valid_scores(bt, i),
                                   _valid_scores(bj, i), rtol=1e-5,
                                   atol=1e-6)
    assert list(et) == list(ej) == ["valid_a", "valid_b"]
    for name in ej:
        assert list(et[name]) == list(ej[name]) == ["auc", "binary_logloss"]
        for metric in ej[name]:
            assert len(et[name][metric]) == 5
            np.testing.assert_allclose(et[name][metric], ej[name][metric],
                                       rtol=0, atol=1e-6)
    res_t, res_j = bt.eval_valid(), bj.eval_valid()
    assert [r[:2] for r in res_t] == [r[:2] for r in res_j]
    assert [r[3] for r in res_t] == [r[3] for r in res_j]
    np.testing.assert_allclose([r[2] for r in res_t], [r[2] for r in res_j],
                               atol=1e-6)


# every training path updates the validation scores after each tree
@pytest.mark.parametrize("extra", [
    {}, dict(gradient_quantization=True, gradient_quant_dtype="int8"),
    dict(tpu_frontier_batch=4)])
def test_valid_scores_equal_predict_on_held_out_rows(extra):
    X, y, w, _ = _data(2)
    Xv, yv, _, _ = _data(3, n=700)
    _, bt, _, et = _train_both(dict(PARAMS, **extra), X, y, w, [(Xv, yv)],
                               5)
    np.testing.assert_allclose(_valid_scores(bt, 0),
                               bt.predict(Xv, raw_score=True), rtol=1e-5,
                               atol=1e-6)
    assert et["valid_a"]["auc"][-1] == bt.eval_valid()[0][2]


def test_early_stopping_matches_jax():
    # noisy labels and many leaves: the AUC on the same rows with fresh
    # labels peaks early, then falls as the trees learn the noise
    X, y, w, labels = _data(4, noise=3.0)
    Xv, yv = X, labels()
    params = dict(PARAMS, num_leaves=63, min_data_in_leaf=5,
                  learning_rate=0.5, metric="auc")
    bj, bt, ej, et = _train_both(params, X, y, w, [(Xv, yv)], 40,
                                 early_stopping_rounds=3)
    aucs = et["valid_a"]["auc"]
    assert bt.best_iteration == int(np.argmax(aucs)) + 1
    assert len(aucs) == bt.best_iteration + 3 < 40
    assert bt.best_iteration == bj.best_iteration
    assert bt.best_score["valid_a"]["auc"] == aucs[bt.best_iteration - 1]
    np.testing.assert_allclose(aucs, ej["valid_a"]["auc"], atol=1e-6)


@pytest.mark.parametrize("before", [0, 3])
def test_valid_set_added_after_training_started(before):
    X, y, w, labels = _data(6)
    Xv, yv = X[:600], labels()[:600]
    params = dict(PARAMS, device_type="cpu")
    ref = lt.Booster(params, lt.Dataset(X, label=y, weight=w))
    ref.add_valid(lt.Dataset(Xv, label=yv, reference=ref.train_set), "v")
    late = lt.Booster(params, lt.Dataset(X, label=y, weight=w))
    for _ in range(before):
        late.update()
    # made without reference=train_set: binned with the training mappers
    late.add_valid(lt.Dataset(Xv, label=yv), "v")
    for _ in range(5):
        ref.update()
    for _ in range(5 - before):
        late.update()
    np.testing.assert_array_equal(_valid_scores(late, 0),
                                  _valid_scores(ref, 0))
    assert late.eval_valid() == ref.eval_valid()
    # the JAX package replays the same trees onto a late valid set once
    # its dispatch pipeline is drained: its add_valid replays only the
    # trees already fetched, and misses the one in flight (ROADMAP queue C)
    bj = lj.Booster(dict(PARAMS), lj.Dataset(X, label=y, weight=w))
    for _ in range(before):
        bj.update()
    bj._engine.flush()
    bj.add_valid(lj.Dataset(Xv, label=yv, reference=bj.train_set), "v")
    for _ in range(5 - before):
        bj.update()
    np.testing.assert_allclose(_valid_scores(late, 0), _valid_scores(bj, 0),
                               rtol=1e-5, atol=1e-6)
