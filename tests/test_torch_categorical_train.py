"""Categorical features in whole training runs of the port against the JAX
package on the CPU, node for node (weighted rows: unweighted, tied
candidates are broken by each framework's ulps, tests/test_torch_train.py):
the one-leaf loop, the histogram pool and one-hot mode; the frontier
grower's model text against the one-leaf loop's; quantized training; the
model text across packages; and the validation traversal against predict
and against the JAX package's."""
import numpy as np
import pytest
import torch

import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt

# one intra-op thread: the pytest-xdist workers share the cores, and
# torch's OpenMP regions spin in their barriers when oversubscribed
torch.set_num_threads(1)

TN = 3000
TRAIN = dict(objective="binary", num_leaves=15, max_bin=63, learning_rate=0.1,
             verbose=-1, min_data_per_group=20, cat_smooth=5.0)


def _train_data(seed, n=TN):
    """Two categorical columns (40 and 3 levels, effects not monotone in
    the level id), three numeric ones, weighted rows."""
    rng = np.random.default_rng(seed)
    Xc = rng.integers(0, 40, n).astype(float)
    Xc2 = rng.integers(0, 3, n).astype(float)
    Xn = rng.standard_normal((n, 3))
    eff = rng.standard_normal(40)
    y = ((eff[Xc.astype(int)] + 0.5 * Xc2 + Xn[:, 0]
          + 0.3 * rng.standard_normal(n)) > 0).astype(float)
    return np.column_stack([Xc, Xc2, Xn]), y, rng.uniform(0.5, 1.5, n)


def _train(pkg, X, y, w, rounds=5, valid=None, **extra):
    mod = lj if pkg == "jax" else lt
    params = dict(TRAIN, **extra)
    if pkg == "torch":
        params["device_type"] = "cpu"
    ds = mod.Dataset(X, label=y, weight=w, categorical_feature=[0, 1])
    kw = {}
    if valid is not None:
        kw["valid_sets"] = [mod.Dataset(valid[0], label=valid[1],
                                        reference=ds)]
    return mod.train(params, ds, rounds, verbose_eval=False, **kw)


def _assert_models_alike(bj, bt, root_cat=True):
    assert len(bj._model.trees) == len(bt._model.trees)
    cats = 0
    for tj, tt in zip(bj._model.trees, bt._model.trees):
        nl = tj.num_leaves
        assert tt.num_leaves == nl
        ni = nl - 1
        for k in ("split_feature", "decision_type", "left_child",
                  "right_child", "leaf_count"):
            np.testing.assert_array_equal(getattr(tt, k)[:max(ni, 1)],
                                          getattr(tj, k)[:max(ni, 1)],
                                          err_msg=k)
        assert tt.num_cat == tj.num_cat
        for k in ("cat_threshold", "cat_boundaries", "cat_threshold_inner",
                  "cat_boundaries_inner"):
            assert list(getattr(tt, k)) == list(getattr(tj, k)), k
        np.testing.assert_allclose(tt.threshold[:ni], tj.threshold[:ni],
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(tt.leaf_value[:nl], tj.leaf_value[:nl],
                                   rtol=1e-5, atol=1e-5)
        cats += tt.num_cat
    assert cats > 0
    assert any(t.decision_type[0] & 1 for t in bt._model.trees) or \
        not root_cat


@pytest.mark.parametrize("mode", ["one_leaf", "pooled", "onehot"])
def test_training_matches_jax_node_for_node(mode):
    extra = {"pooled": dict(histogram_pool_size=0.02),
             "onehot": dict(max_cat_to_onehot=64),
             "one_leaf": {}}[mode]
    X, y, w = _train_data(1)
    bj = _train("jax", X, y, w, **extra)
    bt = _train("torch", X, y, w, **extra)
    if mode == "pooled":
        slots = bt._engine.grower_cfg.hist_pool_slots
        assert 2 <= slots < TRAIN["num_leaves"]
    _assert_models_alike(bj, bt, root_cat=mode != "onehot")
    np.testing.assert_allclose(bt.predict(X, raw_score=True),
                               bj.predict(X, raw_score=True), atol=1e-5)


def test_frontier_model_text_is_the_one_leaf_text():
    X, y, w = _train_data(2)
    one = _train("torch", X, y, w).model_to_string()
    assert "num_cat=0" not in one.split("Tree=0")[1].split("Tree=1")[0]
    assert _train("torch", X, y, w, tpu_frontier_batch=8) \
        .model_to_string() == one


def test_quantized_int16_training_trains_categories():
    """The torch generator cannot draw jax.random's numbers, so a
    quantized run is held to the port's f32 run by quality (its trees
    against the JAX grower's are held above, from one quantized
    payload)."""
    X, y, w = _train_data(3)
    f32 = _train("torch", X, y, w, rounds=8)
    q = _train("torch", X, y, w, rounds=8, gradient_quantization=True,
               gradient_quant_dtype="int16")
    assert q.quant_report["dtype"] == "int16"
    assert sum(t.num_cat for t in q._model.trees) > 0
    a, b = f32.predict(X), q.predict(X)
    assert np.corrcoef(a, b)[0, 1] > 0.99


def test_model_text_predicts_alike_in_both_packages():
    X, y, w = _train_data(4)
    bt = _train("torch", X, y, w)
    text = bt.model_to_string()
    bj = lj.Booster(model_str=text)
    Xq = X.copy()
    Xq[::11, 0] = 999.0          # unseen category
    Xq[::13, 0] = np.nan
    np.testing.assert_allclose(bj.predict(Xq), bt.predict(Xq), rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(bt.predict(Xq, device=True), bt.predict(Xq),
                               rtol=1e-5, atol=1e-6)
    assert lt.Booster(params=dict(device_type="cpu"),
                      model_str=text).model_to_string() == text


def test_valid_scores_equal_predict():
    X, y, w = _train_data(5)
    Xv, yv, _ = _train_data(6, n=800)
    bt = _train("torch", X, y, w, rounds=6, valid=(Xv, yv))
    got = bt._engine.raw_valid_score(0)[0]
    ref = bt.predict(Xv, raw_score=True)
    np.testing.assert_allclose(got, ref, rtol=1e-5,
                               atol=1e-5 * max(1.0, np.abs(ref).max()))


def test_valid_scores_of_unseen_categories_match_jax():
    """A category the training set never saw is binned to the last bin
    (bin.h ValueToBin), which the bin-level validation traversal routes
    by the bitset over bins, while predict routes the raw value right:
    both packages score such rows alike, apart from predict."""
    X, y, w = _train_data(5)
    Xv, yv, _ = _train_data(6, n=800)
    Xv[::9, 0] = 45.0
    bj = _train("jax", X, y, w, rounds=6, valid=(Xv, yv))
    bt = _train("torch", X, y, w, rounds=6, valid=(Xv, yv))
    ref = np.asarray(bj._engine.raw_valid_score(0))[0][:len(yv)]
    got = bt._engine.raw_valid_score(0)[0]
    np.testing.assert_allclose(got, ref, rtol=1e-5,
                               atol=1e-5 * max(1.0, np.abs(ref).max()))
