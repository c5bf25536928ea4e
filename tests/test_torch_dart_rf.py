"""DART and RF in the port against the JAX package on the CPU: the drop
lists of every iteration equal, the models node for node on weighted
rows, the training and validation scores against predict, RF's
refusals, the boosting aliases, and continued training of both
(tests/test_continued_training.py:123-156 mirrored)."""
import numpy as np
import pytest
import torch

import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt

from test_torch_train import _assert_same_structure

# one intra-op thread: the pytest-xdist workers share the cores, and
# torch's OpenMP regions spin in their barriers when oversubscribed
torch.set_num_threads(1)

N, F = 2000, 8
BASE = dict(objective="binary", num_leaves=15, max_bin=63, learning_rate=0.1,
            verbose=-1, metric="binary_logloss")
RF = dict(boosting="rf", bagging_freq=1, bagging_fraction=0.632,
          feature_fraction=0.7, min_gain_to_split=0.01)
DART_MODES = {
    "default": dict(boosting="dart"),
    "xgboost": dict(boosting="dart", drop_rate=0.5, skip_drop=0.0,
                    xgboost_dart_mode=True),
    "uniform": dict(boosting="dart", drop_rate=0.5, skip_drop=0.2,
                    uniform_drop=True),
    "max_drop": dict(boosting="dart", drop_rate=0.8, skip_drop=0.0,
                     max_drop=2),
}


def _data(seed=0, n=N):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, F))
    y = (X[:, 0] + 0.5 * X[:, 1] * X[:, 2] - 0.3 * np.abs(X[:, 3])
         + 0.3 * rng.standard_normal(n) > 0).astype(np.float64)
    w = np.random.default_rng(seed + 100).uniform(0.5, 1.5, n)
    return X, y, w


def _boosters(params, seed=0, valid=True):
    """A JAX and a port Booster on the same weighted rows (and a
    validation set each), not yet trained."""
    X, y, w = _data(seed)
    Xv, yv, _ = _data(seed + 50, 500)
    out = []
    for pkg in (lj, lt):
        p = dict(params) if pkg is lj else dict(params, device_type="cpu")
        ds = pkg.Dataset(X, label=y, weight=w)
        bst = pkg.Booster(p, ds)
        if valid:
            bst.add_valid(pkg.Dataset(Xv, label=yv, reference=ds), "valid")
        out.append(bst)
    return out[0], out[1], X, Xv


def _assert_scores_consistent(bt, X, Xv, rtol=2e-4, atol=2e-5):
    """The engine's training and validation scores equal the model's
    predictions."""
    raw = bt._engine.raw_train_score()[0]
    np.testing.assert_allclose(raw, bt.predict(X, raw_score=True),
                               rtol=rtol, atol=atol)
    np.testing.assert_allclose(bt._engine.raw_valid_score(0)[0],
                               bt.predict(Xv, raw_score=True), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("mode", list(DART_MODES))
def test_dart_matches_jax(mode):
    bj, bt, X, Xv = _boosters(dict(BASE, **DART_MODES[mode]))
    drops = 0
    for it in range(10):
        bj.update()
        bt.update()
        assert bt._engine.drop_index == bj._engine.drop_index, it
        assert bt._engine.shrinkage_rate == bj._engine.shrinkage_rate
        drops += len(bt._engine.drop_index)
        if mode == "max_drop":
            assert len(bt._engine.drop_index) <= 2
    if mode != "default":
        assert drops > 0
    assert bt._engine.tree_weight == pytest.approx(bj._engine.tree_weight)
    bj._engine.flush()
    _assert_same_structure(bj, bt, X)
    for tj, tt in zip(bj._model.trees, bt._model.trees):
        np.testing.assert_allclose(tt.leaf_value[:tt.num_leaves],
                                   tj.leaf_value[:tj.num_leaves], atol=1e-5)
    np.testing.assert_allclose(bt.predict(X, raw_score=True),
                               bj.predict(X, raw_score=True), atol=1e-5)
    # the validation scores are held to the port's own predict: a
    # held-out row in a bin no training row holds sits between exactly
    # tied thresholds, which each package breaks by its own ulps
    # (tests/test_torch_train.py:_assert_same_structure)
    _assert_scores_consistent(bt, X, Xv)


def test_rf_matches_jax():
    bj, bt, X, Xv = _boosters(dict(BASE, **RF))
    for _ in range(6):
        bj.update()
        bt.update()
    assert bt._model.average_output and bj._model.average_output
    assert bt._engine.shrinkage_rate == 1.0
    bj._engine.flush()
    _assert_same_structure(bj, bt, X)
    np.testing.assert_allclose(bt.predict(X), bj.predict(X), atol=1e-5)
    # the running average: the training scores are predict's average
    np.testing.assert_allclose(bt._engine.raw_train_score()[0],
                               bt.predict(X), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(bt._engine.raw_valid_score(0)[0],
                               bt.predict(Xv), rtol=1e-5, atol=1e-6)
    # RF's metrics read the averaged probabilities as they are
    (_, _, lj_loss, _), = bj.eval_valid()
    (_, _, lt_loss, _), = bt.eval_valid()
    assert lt_loss == pytest.approx(lj_loss, abs=1e-5)
    # reset_parameter moves no shrinkage of a forest
    bt.reset_parameter({"learning_rate": 0.3})
    assert bt._engine.shrinkage_rate == 1.0
    text = bt.model_to_string()
    assert "average_output" in text
    np.testing.assert_allclose(lt.Booster(model_str=text).predict(Xv),
                               bt.predict(Xv), rtol=1e-12)


def test_rf_stump_adds_nothing():
    """A forest of stumps (every split blocked): each stump's leaf is 0,
    and the scores stay 0."""
    X, y, _ = _data(3)
    bst = lt.train(dict(BASE, **RF, min_data_in_leaf=N, device_type="cpu"),
                   lt.Dataset(X, label=y), 3, verbose_eval=False)
    assert [t.num_leaves for t in bst._model.trees] == [1, 1, 1]
    assert all(t.leaf_value[0] == 0.0 for t in bst._model.trees)
    assert not np.any(bst._engine.raw_train_score())


@pytest.mark.parametrize("extra,match", [
    (dict(bagging_freq=0), "requires bagging"),
    (dict(bagging_fraction=1.0), "requires bagging"),
    (dict(feature_fraction=1.0), "feature_fraction"),
    (dict(objective="multiclass", num_class=3), "multi-class"),
    (dict(objective="none"), "objective function"),
])
def test_rf_config_checks(extra, match):
    X, y, _ = _data()
    with pytest.raises(lt.LightGBMError, match=match):
        lt.train(dict(BASE, **dict(RF, **extra), device_type="cpu"),
                 lt.Dataset(X, label=y), 1, verbose_eval=False)


def test_rf_refuses_init_score():
    X, y, _ = _data()
    with pytest.raises(lt.LightGBMError, match="init_score"):
        lt.train(dict(BASE, **RF, device_type="cpu"),
                 lt.Dataset(X, label=y, init_score=np.zeros(N)), 1,
                 verbose_eval=False)


def test_rf_trains_ranking():
    """RF with lambdarank trains on the payload: the zero score's
    gradients in original row order, where the query boundaries live
    (tests/test_torch_masked.py holds it against the JAX package)."""
    X, _, _ = _data()
    ds = lt.Dataset(X, label=np.floor(np.abs(X[:, 0]) * 2))
    ds.set_group([20] * (N // 20))
    bst = lt.train(dict(BASE, **RF, objective="lambdarank",
                        device_type="cpu"), ds, 2, verbose_eval=False)
    assert bst._engine._fast_active
    assert bst._model.average_output and bst.current_iteration() == 2


@pytest.mark.parametrize("alias,canonical", [("gbrt", {}),
                                             ("random_forest", RF)])
def test_boosting_aliases(alias, canonical):
    X, y, _ = _data(4)
    params = dict(BASE, **dict(canonical, device_type="cpu"))
    a = lt.train(dict(params, boosting=alias), lt.Dataset(X, label=y), 3,
                 verbose_eval=False)
    b = lt.train(params, lt.Dataset(X, label=y), 3, verbose_eval=False)
    assert type(a._engine) is type(b._engine)
    assert a.model_to_string().split("end of trees")[0] == \
        b.model_to_string().split("end of trees")[0]


def test_unknown_boosting_refused():
    X, y, _ = _data()
    with pytest.raises(lt.LightGBMError, match="Unknown boosting"):
        lt.train(dict(BASE, boosting="xgb", device_type="cpu"),
                 lt.Dataset(X, label=y), 1, verbose_eval=False)


def test_dart_and_rf_quantization_train_f32(capsys):
    X, y, _ = _data(6)
    for extra in (DART_MODES["xgboost"], RF):
        params = dict(BASE, **extra, device_type="cpu", verbose=0)
        q = lt.train(dict(params, gradient_quantization=True),
                     lt.Dataset(X, label=y), 3, verbose_eval=False)
        assert "training with f32 gradients" in capsys.readouterr().out
        f = lt.train(params, lt.Dataset(X, label=y), 3, verbose_eval=False)
        assert q.model_to_string().split("end of trees")[0] == \
            f.model_to_string().split("end of trees")[0]


# -- continued training (tests/test_continued_training.py:123-156) -------
def _continue(pkg, params, X, y):
    p = dict(params) if pkg is lj else dict(params, device_type="cpu")
    first = pkg.train(dict(p), pkg.Dataset(X, label=y), 5,
                      verbose_eval=False)
    again = pkg.train(dict(p), pkg.Dataset(X, label=y), 5,
                      init_model=first, verbose_eval=False)
    return first, again


def test_rf_continued_training():
    """The running average over the loaded and new trees equals predict
    over all 10, in both packages, and the models agree."""
    X, y, _ = _data(7)
    params = dict(BASE, **RF)
    _, bj = _continue(lj, params, X, y)
    _, bt = _continue(lt, params, X, y)
    assert bt.num_trees() == 10
    np.testing.assert_allclose(bt._engine.raw_train_score()[0],
                               bt.predict(X), rtol=1e-4, atol=1e-5)
    bj._engine.flush()
    np.testing.assert_allclose(bt.predict(X), bj.predict(X), atol=1e-4)


def test_dart_continued_training():
    """DART drops only this run's trees: the loaded trees' text is
    unchanged, and the scores equal predict."""
    X, y, _ = _data(8)
    params = dict(BASE, **DART_MODES["xgboost"])
    first, bt = _continue(lt, params, X, y)
    saved = first.model_to_string()
    assert bt.num_trees() == 10
    text = bt.model_to_string()
    loaded = saved.split("end of trees")[0].split("Tree=")[1:]
    assert text.split("end of trees")[0].split("Tree=")[1:6] == loaded
    np.testing.assert_allclose(bt._engine.raw_train_score()[0],
                               bt.predict(X, raw_score=True), rtol=2e-4,
                               atol=2e-5)
    _, bj = _continue(lj, params, X, y)
    bj._engine.flush()
    np.testing.assert_allclose(bt.predict(X, raw_score=True),
                               bj.predict(X, raw_score=True), atol=1e-4)
