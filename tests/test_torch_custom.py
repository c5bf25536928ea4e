"""Custom objectives and metrics in the port against the JAX package on
the CPU (the same seeded numpy inputs, weighted rows).  The JAX package
trains custom gradients on its masked grower, the port on its
partition-ordered fast path (the gradients gathered through the index
column), so the models are held to tests/test_fast_path_bagging.py's
_assert_models_match rule: the same structure, values to f32 ulps."""
import numpy as np
import pytest
import torch

import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.utils import log as tlog

from test_torch_bagging import _assert_same_structure_in_bag

# one intra-op thread: the pytest-xdist workers share the cores, and
# torch's OpenMP regions spin in their barriers when oversubscribed
torch.set_num_threads(1)

N, F, ROUNDS = 3000, 6, 4
PARAMS = dict(num_leaves=15, learning_rate=0.1, min_data_in_leaf=20,
              verbose=-1)


def _cpu(params):
    return dict(params, device_type="cpu")


def _data(seed=0, n=N, classes=2):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, F))
    s = X[:, 0] + 0.5 * X[:, 1] * X[:, 2] + 0.3 * rng.standard_normal(n)
    y = (s > 0).astype(np.float64) if classes == 2 else \
        np.digitize(s, [-0.4, 0.4]).astype(np.float64)
    return X, y, rng.uniform(0.5, 1.5, n)


def logloss_fobj(preds, dataset):
    """Binary logloss gradients of raw scores, weighted."""
    y = dataset.get_label()
    w = dataset.get_weight()
    p = 1.0 / (1.0 + np.exp(-preds))
    w = np.ones_like(p) if w is None else w
    return (p - y) * w, p * (1.0 - p) * w


def softmax_fobj(preds, dataset):
    """K = 3 softmax gradients of the class-major [3 * N] raw scores."""
    y = dataset.get_label().astype(np.int64)
    n = len(y)
    s = preds.reshape(3, n)
    e = np.exp(s - s.max(axis=0))
    p = e / e.sum(axis=0)
    onehot = np.zeros_like(p)
    onehot[y, np.arange(n)] = 1.0
    return (p - onehot).reshape(-1), (2.0 * p * (1.0 - p)).reshape(-1)


def error_feval(preds, dataset):
    """Weighted error of raw scores at 0."""
    y = dataset.get_label()
    w = dataset.get_weight()
    w = np.ones_like(y) if w is None else w
    return "error", float(np.sum(w * ((preds > 0) != (y > 0))) / w.sum()), \
        False


def sigmoid(raw):
    return 1.0 / (1.0 + np.exp(-raw))


def softmax(raw):
    e = np.exp(raw - raw.max(axis=1, keepdims=True))
    return e / e.sum(axis=1, keepdims=True)


def _assert_models_match(bj, bt, X, link=sigmoid):
    """tests/test_fast_path_bagging.py:_assert_models_match: identical
    structure, thresholds at rel 1e-6, counts exact, leaves at rel 1e-4 /
    abs 1e-7, predictions at rtol 1e-4 / atol 1e-6.  A custom objective's
    model predicts raw scores; the rule reads predictions through the
    objective's link, as it reads a builtin objective's."""
    dj, dt = bj.dump_model(), bt.dump_model()
    assert len(dj["tree_info"]) == len(dt["tree_info"])

    def walk(a, b):
        assert ("split_feature" in a) == ("split_feature" in b)
        if "split_feature" in a:
            assert a["split_feature"] == b["split_feature"]
            assert a["threshold"] == pytest.approx(b["threshold"], rel=1e-6)
            assert a["internal_count"] == b["internal_count"]
            walk(a["left_child"], b["left_child"])
            walk(a["right_child"], b["right_child"])
        else:
            assert a["leaf_count"] == b["leaf_count"]
            assert a["leaf_value"] == pytest.approx(b["leaf_value"],
                                                    rel=1e-4, abs=1e-7)

    for tj, tt in zip(dj["tree_info"], dt["tree_info"]):
        walk(tj["tree_structure"], tt["tree_structure"])
    np.testing.assert_allclose(link(bt.predict(X)), link(bj.predict(X)),
                               rtol=1e-4, atol=1e-6)


def _train_both(params, fobj, classes=2, rounds=ROUNDS, seed=0, **kwargs):
    X, y, w = _data(seed, classes=classes)
    bj = lj.train(params, lj.Dataset(X, label=y, weight=w), rounds,
                  fobj=fobj, verbose_eval=False, **kwargs)
    bt = lt.train(_cpu(params), lt.Dataset(X, label=y, weight=w), rounds,
                  fobj=fobj, verbose_eval=False, **kwargs)
    return bj, bt, X


@pytest.fixture(scope="module")
def logloss_pair():
    return _train_both(PARAMS, logloss_fobj)


def test_logloss_fobj_matches_jax(logloss_pair):
    bj, bt, X = logloss_pair
    assert bt.num_trees() == ROUNDS
    _assert_models_match(bj, bt, X)
    # the score fetch for fobj and the tree's own fetch
    assert bt.host_syncs_per_tree() == [2] * ROUNDS


def test_softmax_fobj_matches_jax():
    bj, bt, X = _train_both(dict(PARAMS, num_class=3), softmax_fobj,
                            classes=3)
    assert bt.num_model_per_iteration() == 3
    assert bt.num_trees() == 3 * ROUNDS
    _assert_models_match(bj, bt, X, softmax)
    # one score fetch an iteration, counted with its first class tree
    assert bt.host_syncs_per_tree() == [2, 1, 1] * ROUNDS


def test_fobj_with_bagging_matches_jax():
    """Both packages draw the same bags; the trees are compared as
    tests/test_torch_bagging.py compares bagged trees (every in-bag row in
    the same leaf: thresholds between bins that hold only out-of-bag rows
    tie exactly), with leaves at the rule's tolerance."""
    X, y, w = _data(1)
    params = dict(PARAMS, bagging_fraction=0.6, bagging_freq=2, seed=5,
                  min_gain_to_split=0.01)
    bj = lj.Booster(params, lj.Dataset(X, label=y, weight=w))
    bt = lt.Booster(_cpu(params), lt.Dataset(X, label=y, weight=w))
    bags = []
    for _ in range(ROUNDS):
        bj.update(fobj=logloss_fobj)
        bt.update(fobj=logloss_fobj)
        bags.append(bt._engine.bag_mask_host.copy())
        np.testing.assert_array_equal(bags[-1], bj._engine.bag_mask_host)
    roots = [int(t.internal_count[0]) for t in bt._model.trees]
    assert roots == [int(N * 0.6)] * ROUNDS
    _assert_same_structure_in_bag(bj, bt, X, bags)
    for tj, tt in zip(bj._model.trees, bt._model.trees):
        nl = tj.num_leaves
        np.testing.assert_allclose(tt.leaf_value[:nl], tj.leaf_value[:nl],
                                   rtol=1e-4, atol=1e-7)


def test_fobj_under_quantization_trains_f32(logloss_pair):
    """gradient_quantization with custom gradients: the JAX package's
    warning, and the model of the f32 run byte for byte."""
    X, y, w = _data(0)
    lines = []
    tlog.reset_callback(lines.append)
    try:
        bt = lt.train(_cpu(dict(PARAMS, verbose=0, gradient_quantization=True,
                                gradient_quant_dtype="int8")),
                      lt.Dataset(X, label=y, weight=w), ROUNDS,
                      fobj=logloss_fobj, verbose_eval=False)
    finally:
        tlog.reset_callback(None)
    warned = [ln for ln in lines if "trains with f32 gradients" in ln]
    assert len(warned) == 1
    assert bt.model_to_string() == logloss_pair[1].model_to_string()


def test_feval_on_train_and_valid_matches_jax():
    X, y, w = _data(2)
    Xv, yv, wv = _data(3, n=800)
    recs = []
    for pkg, params in ((lj, PARAMS), (lt, _cpu(PARAMS))):
        ds = pkg.Dataset(X, label=y, weight=w)
        dv = pkg.Dataset(Xv, label=yv, weight=wv, reference=ds)
        rec = {}
        pkg.train(dict(params, objective="binary"), ds, 3,
                  valid_sets=[ds, dv], valid_names=["train", "valid"],
                  feval=error_feval, callbacks=[pkg.record_evaluation(rec)],
                  verbose_eval=False)
        recs.append(rec)
    rj, rt = recs
    assert set(rt) == set(rj) == {"train", "valid"}
    for name in ("train", "valid"):
        assert set(rt[name]) == set(rj[name]) == {"binary_logloss", "error"}
        for metric in ("binary_logloss", "error"):
            np.testing.assert_allclose(rt[name][metric], rj[name][metric],
                                       rtol=1e-6)


def test_objective_none_model_text_loads_in_both(logloss_pair):
    bj, bt, X = logloss_pair
    for text in (bt.model_to_string(), bj.model_to_string()):
        assert "objective=regression" in text.split("Tree=0")[0]
        lj_pred = lj.Booster(model_str=text).predict(X)
        lt_pred = lt.Booster(_cpu({}), model_str=text).predict(X)
        np.testing.assert_allclose(lt_pred, lj_pred, rtol=1e-12)
    # a custom objective's model predicts raw scores
    np.testing.assert_allclose(bt.predict(X), bt.predict(X, raw_score=True))
