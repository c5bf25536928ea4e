"""Continued training, rollback, parameter reset and refit in the port
against the JAX package on the CPU (the same seeded numpy inputs, weighted
rows so that no two candidate gains tie): init_model as a Booster, a file,
a loaded model string and a GBDTModel, K = 3 continuation, validation
scores after continuation, rollback fresh and after continuation, the bag
applied again after a rollback in the middle of a bagging period,
learning-rate schedules, reset_parameter and refit."""
import numpy as np
import pytest
import torch

import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt
from lightgbm_tpu.models.gbdt_model import GBDTModel as JModel
from lightgbm_tpu_torch import convert
from lightgbm_tpu_torch.models.gbdt_model import GBDTModel as TModel

# one intra-op thread: the pytest-xdist workers share the cores, and
# torch's OpenMP regions spin in their barriers when oversubscribed
torch.set_num_threads(1)

N, F, FIRST, MORE = 3000, 6, 3, 2
PARAMS = dict(objective="binary", num_leaves=15, learning_rate=0.1,
              min_data_in_leaf=20, verbose=-1)
#: leaves of two packages' models on the same inputs (f32 sums in another
#: order)
LEAF_RTOL, LEAF_ATOL = 1e-5, 2e-6


def _cpu(params):
    return dict(params, device_type="cpu")


def _data(seed=0, n=N, classes=2):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, F))
    s = X[:, 0] + 0.5 * X[:, 1] * X[:, 2] + 0.3 * rng.standard_normal(n)
    y = (s > 0).astype(np.float64) if classes == 2 else \
        np.digitize(s, [-0.4, 0.4]).astype(np.float64)
    return X, y, rng.uniform(0.5, 1.5, n)


def _trees(text):
    return text.split("end of trees")[0].split("Tree=")[1:]


def _assert_models_match(bj, bt, X):
    """Node for node: split features, topology, counts, every row in the
    same leaf, leaves at LEAF_RTOL / LEAF_ATOL."""
    assert bt.num_trees() == bj.num_trees()
    for tj, tt in zip(bj._model.trees, bt._model.trees):
        assert tt.num_leaves == tj.num_leaves
        nl = tj.num_leaves
        for k in ("split_feature", "left_child", "right_child",
                  "internal_count"):
            np.testing.assert_array_equal(getattr(tt, k)[:nl - 1],
                                          getattr(tj, k)[:nl - 1], err_msg=k)
        np.testing.assert_array_equal(tt.leaf_count[:nl], tj.leaf_count[:nl])
        np.testing.assert_allclose(tt.leaf_value[:nl], tj.leaf_value[:nl],
                                   rtol=LEAF_RTOL, atol=LEAF_ATOL)
    np.testing.assert_array_equal(bt._model.predict_leaf_index(X),
                                  bj._model.predict_leaf_index(X))


@pytest.fixture(scope="module")
def base(tmp_path_factory):
    """The port's FIRST-iteration model of the binary data, saved; both
    packages continue from this one text."""
    X, y, w = _data()
    bt = lt.train(_cpu(PARAMS), lt.Dataset(X, label=y, weight=w), FIRST,
                  verbose_eval=False)
    path = str(tmp_path_factory.mktemp("continued") / "base.txt")
    bt.save_model(path)
    with open(path) as fh:
        text = fh.read()
    return dict(X=X, y=y, w=w, bt=bt, path=path, text=text)


HOWS = ("booster", "file", "string", "model")


def _init_model(base, how):
    """The port's init_model spellings of the base model: the trained
    Booster, its file, a Booster loaded from its text, a GBDTModel."""
    if how == "booster":
        return base["bt"]
    if how == "file":
        return base["path"]
    if how == "string":
        return lt.Booster(_cpu({}), model_str=base["text"])
    return TModel.load_model(base["path"])


@pytest.fixture(scope="module")
def continued(base):
    """The JAX package and the port (once per init_model spelling)
    continued MORE iterations from the base model, a validation set
    scored every iteration and recorded."""
    X, y, w = base["X"], base["y"], base["w"]
    Xv, yv, _ = _data(2, n=800)
    params = dict(PARAMS, metric="binary_logloss")

    def run(pkg, params, init):
        ds = pkg.Dataset(X, label=y, weight=w)
        rec = {}
        bst = pkg.train(params, ds, MORE, init_model=init,
                        valid_sets=[pkg.Dataset(Xv, label=yv, reference=ds)],
                        callbacks=[pkg.record_evaluation(rec)],
                        verbose_eval=False)
        return bst, rec

    runs = {how: run(lt, _cpu(params), _init_model(base, how))
            for how in HOWS}
    runs["jax"] = run(lj, params, JModel.load_model(base["path"]))
    return runs, Xv


@pytest.mark.parametrize("how", HOWS)
def test_init_model_continues_like_jax(base, continued, how):
    runs, _ = continued
    bj, rec_j = runs["jax"]
    ct, rec_t = runs[how]
    X = base["X"]
    assert ct.current_iteration() == bj.current_iteration() == FIRST + MORE
    # the loaded trees are kept as they were written
    assert _trees(ct.model_to_string())[:FIRST] == _trees(base["text"])
    # the caller's model is copied, not extended
    assert base["bt"].num_trees() == FIRST
    _assert_models_match(bj, ct, X)
    np.testing.assert_allclose(ct.predict(X, raw_score=True),
                               bj.predict(X, raw_score=True), atol=1e-5)
    np.testing.assert_allclose(rec_t["valid_0"]["binary_logloss"],
                               rec_j["valid_0"]["binary_logloss"], rtol=1e-5)


def test_multiclass_continuation_matches_jax():
    X, y, w = _data(1, classes=3)
    params = dict(PARAMS, objective="multiclass", num_class=3)
    first = lt.train(_cpu(params), lt.Dataset(X, label=y, weight=w), 2,
                     verbose_eval=False)
    text = first.model_to_string()
    cj = lj.train(params, lj.Dataset(X, label=y, weight=w), MORE,
                  init_model=lj.Booster(model_str=text), verbose_eval=False)
    ct = lt.train(_cpu(params), lt.Dataset(X, label=y, weight=w), MORE,
                  init_model=first, verbose_eval=False)
    assert ct.num_trees() == 3 * (2 + MORE)
    assert _trees(ct.model_to_string())[:6] == _trees(text)
    _assert_models_match(cj, ct, X)


@pytest.mark.parametrize("how", HOWS)
def test_valid_scores_after_continuation(continued, how):
    """The validation set's scores on the device (the loaded trees
    replayed, then each new tree added) equal predict(raw_score=True)."""
    runs, Xv = continued
    bt = runs[how][0]
    raw = bt._engine.raw_valid_score(0)[0]
    pred = bt.predict(Xv, raw_score=True)
    np.testing.assert_allclose(raw, pred, rtol=1e-5,
                               atol=1e-5 * max(1.0, np.abs(pred).max()))


def _scores(bst):
    """(training, validation) raw scores of a booster's engine."""
    eng = bst._engine
    eng_flush = getattr(eng, "flush", None)
    if eng_flush is not None:
        eng_flush()
    return eng.raw_train_score(), eng.raw_valid_score(0)


@pytest.mark.parametrize("start", ["fresh", "continued"])
def test_rollback_matches_jax(base, start):
    X, y, w = base["X"], base["y"], base["w"]
    Xv, yv, _ = _data(3, n=500)
    boosters = []
    for pkg, params in ((lj, PARAMS), (lt, _cpu(PARAMS))):
        ds = pkg.Dataset(X, label=y, weight=w)
        init = None if start == "fresh" \
            else pkg.Booster(model_str=base["text"])._model
        bst = pkg.Booster(params, ds, init_model=init)
        bst.add_valid(pkg.Dataset(Xv, label=yv, reference=ds), "v")
        for _ in range(2):
            bst.update()
        bst.rollback_one_iter()
        boosters.append(bst)
    bj, bt = boosters
    n_init = 0 if start == "fresh" else FIRST
    assert bt.current_iteration() == bj.current_iteration() == n_init + 1
    for got, want in zip(_scores(bt), _scores(bj)):
        np.testing.assert_allclose(got, want, atol=1e-6)
    bj.update()
    bt.update()
    _assert_models_match(bj, bt, X)
    for got, want in zip(_scores(bt), _scores(bj)):
        np.testing.assert_allclose(got, want, atol=2e-6)


def test_rollback_reapplies_bag_mid_period(base):
    """bagging_freq=3: three updates (a resample at iteration 0), a
    rollback, and the next update (iteration 2, no resample) rebuilds the
    payload: its count column must be the host's bag again, not the plain
    valid mask the rebuild starts from; the model matches the JAX run."""
    X, y, w = base["X"], base["y"], base["w"]
    params = dict(PARAMS, bagging_fraction=0.5, bagging_freq=3, seed=3,
                  min_gain_to_split=0.01)
    bj = lj.Booster(params, lj.Dataset(X, label=y, weight=w))
    bt = lt.Booster(_cpu(params), lt.Dataset(X, label=y, weight=w))
    for bst in (bj, bt):
        for _ in range(3):
            bst.update()
        bst.rollback_one_iter()
        bst.update()
    eng = bt._engine
    assert eng.iter == 3
    fs = eng._fast
    bag = convert.bag_mask_from_payload(fs.payload.numpy(), fs.cnt_col,
                                        fs.idx_col, fs.n_pad)
    np.testing.assert_array_equal(bag, eng.bag_mask_host)
    assert bag.sum() == N // 2
    roots = [int(t.internal_count[0]) for t in bt._model.trees]
    assert roots == [N // 2] * 3
    np.testing.assert_array_equal(eng.bag_mask_host,
                                  bj._engine.bag_mask_host)
    _assert_models_match(bj, bt, X)


def test_learning_rates_and_reset_parameter_match_jax(base):
    X, y, w = base["X"], base["y"], base["w"]
    rates = [0.1, 0.05, 0.2, 0.15]
    runs = []
    for pkg, params in ((lj, PARAMS), (lt, _cpu(PARAMS))):
        bst = pkg.train(params, pkg.Dataset(X, label=y, weight=w),
                        len(rates), learning_rates=lambda i: rates[i],
                        verbose_eval=False)
        # then a Booster-level reset: a new rate and a feature fraction
        bst.reset_parameter({"learning_rate": 0.3,
                             "feature_fraction": 0.5})
        bst.update()
        runs.append(bst)
    bj, bt = runs
    shrink = [t.shrinkage for t in bt._model.trees]
    # the first tree folds the boost-from-average score (shrinkage 1)
    assert shrink[1:] == pytest.approx(rates[1:] + [0.3], rel=1e-12)
    assert shrink == [t.shrinkage for t in bj._model.trees]
    assert bt.params["learning_rate"] == 0.3
    _assert_models_match(bj, bt, X)


def test_refit_matches_jax(base):
    X, y, w = base["X"], base["y"], base["w"]
    X2, y2, w2 = _data(4, n=1500)
    bj = lj.Booster(params=PARAMS, model_str=base["text"])
    bt = lt.Booster(params=_cpu(PARAMS), model_str=base["text"])
    rj = bj.refit(X2, y2, weight=w2)
    rt = bt.refit(X2, y2, weight=w2)
    assert rt.num_trees() == FIRST
    for tj, tt in zip(rj._model.trees, rt._model.trees):
        nl = tj.num_leaves
        np.testing.assert_allclose(tt.leaf_value[:nl], tj.leaf_value[:nl],
                                   rtol=1e-6)
    # decay 1 keeps every leaf as it was
    kept = bt.refit(X2, y2, decay_rate=1.0)
    for t0, t1 in zip(bt._model.trees, kept._model.trees):
        np.testing.assert_allclose(t1.leaf_value, t0.leaf_value, rtol=1e-9)
    np.testing.assert_allclose(rt.predict(X), rj.predict(X), rtol=1e-6)
