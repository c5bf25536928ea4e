"""Forced splits in the port against the JAX package on the CPU: the
host's BFS schedule array for array, the forced evaluation of a split,
and the root, nested, infeasible-fallback and bagging cases of
tests/test_forced_splits.py (:33-70, :141-155) held against the JAX
models node for node on weighted rows; frontier batching stays off."""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt
from lightgbm_tpu.boosting.forced import \
    build_forced_schedule as jax_schedule
from lightgbm_tpu.boosting.gbdt import _feature_meta_device
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.io.dataset import BinnedDataset as JBinnedDataset
from lightgbm_tpu.ops.split import evaluate_split_at as jax_evaluate
from lightgbm_tpu_torch import convert
from lightgbm_tpu_torch.boosting.forced import (PRIORITY_UNIT,
                                                build_forced_schedule)
from lightgbm_tpu_torch.ops.split import evaluate_split_at

from test_torch_train import _assert_same_structure

# one intra-op thread: the pytest-xdist workers share the cores, and
# torch's OpenMP regions spin in their barriers when oversubscribed
torch.set_num_threads(1)

NESTED = {"feature": 4, "threshold": 0.0,
          "left": {"feature": 1, "threshold": -0.5},
          "right": {"feature": 3, "threshold": 0.7}}
DEEP = {"feature": 0, "threshold": 0.1,
        "left": {"feature": 1, "threshold": 0.2,
                 "right": {"feature": 2, "threshold": -0.3,
                           "left": {"feature": 5, "threshold": 9.0}}},
        "right": {"feature": 1, "threshold": -0.7}}


def _data(n=800, f=6, seed=11):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, f)).astype(np.float32)
    y = (0.5 * X[:, 0] - X[:, 2] + 0.3 * rng.standard_normal(n) > 0)
    w = np.random.default_rng(seed + 100).uniform(0.5, 1.5, n)
    return X, y.astype(np.float64), w


def _train_both(tmp_path, forced_json, rounds=2, **extra):
    X, y, w = _data()
    fpath = tmp_path / "forced.json"
    fpath.write_text(json.dumps(forced_json))
    params = {"objective": "binary", "num_leaves": 16, "min_data_in_leaf": 5,
              "verbose": -1, "forcedsplits_filename": str(fpath)}
    params.update(extra)
    bj = lj.train(dict(params), lj.Dataset(X, label=y, weight=w), rounds,
                  verbose_eval=False)
    bt = lt.train(dict(params, device_type="cpu"),
                  lt.Dataset(X, label=y, weight=w), rounds,
                  verbose_eval=False)
    return bj, bt, X


def _assert_models_match(bj, bt, X):
    _assert_same_structure(bj, bt, X)
    for tj, tt in zip(bj._model.trees, bt._model.trees):
        ni = tj.num_leaves - 1
        np.testing.assert_array_equal(tt.threshold_in_bin[:ni],
                                      tj.threshold_in_bin[:ni])
        np.testing.assert_allclose(tt.split_gain[:ni], tj.split_gain[:ni],
                                   rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(bt.predict(X, raw_score=True),
                               bj.predict(X, raw_score=True), atol=1e-5)


@pytest.mark.parametrize("forced,num_leaves", [
    ({"feature": 4, "threshold": 0.25}, 16), (NESTED, 16), (DEEP, 16),
    (DEEP, 3), ({"feature": 2, "threshold": 1e9}, 16), ({}, 16)])
def test_schedule_matches_jax(forced, num_leaves):
    X, _, _ = _data()
    cfg = dict(max_bin=63, verbose=-1)
    dj = JBinnedDataset.from_matrix(X, JConfig(cfg))
    dt = lt.Dataset(X).construct(lt.Config(cfg)).binned
    sj = jax_schedule(forced, dj.bin_mappers, num_leaves)
    st = build_forced_schedule(forced, dt.bin_mappers, num_leaves)
    if sj is None:
        assert st is None
        return
    assert tuple(st) == tuple(sj)
    assert len(st.feat) <= num_leaves - 1
    assert st.gain[0] == len(st.feat) * PRIORITY_UNIT


def test_schedule_rejects_unknown_feature():
    X, _, _ = _data()
    dt = lt.Dataset(X).construct(lt.Config(dict(verbose=-1))).binned
    with pytest.raises(ValueError, match="feature 9"):
        build_forced_schedule({"feature": 9, "threshold": 0.0},
                              dt.bin_mappers, 16)


@pytest.mark.parametrize("min_data", [5, 300])
def test_evaluate_split_at_matches_jax(min_data):
    """The forced evaluation of two leaves at once against the JAX
    evaluate_split_at of each: the default direction by gain, the gain
    kept below min_gain_shift, and -inf where min_data is violated."""
    X, y, _ = _data()
    X[np.random.default_rng(3).random(X.shape) < 0.1] = np.nan
    dj = JBinnedDataset.from_matrix(X, JConfig(dict(max_bin=31, verbose=-1)))
    jmeta = _feature_meta_device(dj)
    F, B = X.shape[1], dj.max_num_bin
    rng = np.random.default_rng(min_data)
    hist = np.zeros((2, F, B, 3), np.float32)
    for q in range(2):
        rows = rng.random(len(X)) < 0.5
        g = rng.standard_normal(len(X)).astype(np.float32)
        h = rng.uniform(0.1, 1.0, len(X)).astype(np.float32)
        for f in range(F):
            b = dj.bins[f][:len(X)][rows].astype(np.int64)
            np.add.at(hist[q, f, :, 0], b, g[rows])
            np.add.at(hist[q, f, :, 1], b, h[rows])
            np.add.at(hist[q, f, :, 2], b, 1.0)
    sums = hist[:, 0].sum(axis=1)
    feat, thr = np.array([2, 4]), np.array([5, 11])
    kw = dict(l1=0.0, l2=0.5, max_delta_step=0.0, min_data_in_leaf=min_data,
              min_sum_hessian_in_leaf=1e-3)
    got = evaluate_split_at(
        torch.from_numpy(hist), torch.from_numpy(sums[:, 0]),
        torch.from_numpy(sums[:, 1]), torch.from_numpy(sums[:, 2]),
        torch.from_numpy(feat), torch.from_numpy(thr),
        meta=convert.feature_meta_from_numpy(jmeta), **kw)
    for q in range(2):
        ref = jax_evaluate(jnp.asarray(hist[q]), sums[q, 0], sums[q, 1],
                           sums[q, 2], int(feat[q]), int(thr[q]),
                           meta=jmeta, **kw)
        for name, a, b in zip(ref._fields, got, ref):
            np.testing.assert_allclose(a[q].numpy().astype(np.float64),
                                       np.asarray(b).astype(np.float64),
                                       rtol=1e-5, atol=1e-6, err_msg=name)
    if min_data == 300:
        assert not torch.isfinite(got.gain).all()


def test_forced_root_split(tmp_path):
    bj, bt, X = _train_both(tmp_path, {"feature": 4, "threshold": 0.25})
    for t in bt.dump_model()["tree_info"]:
        assert t["tree_structure"]["split_feature"] == 4
    _assert_models_match(bj, bt, X)


def test_forced_nested_splits(tmp_path):
    bj, bt, X = _train_both(tmp_path, NESTED, rounds=3)
    for t in bt.dump_model()["tree_info"]:
        root = t["tree_structure"]
        assert root["split_feature"] == 4
        assert root["left_child"]["split_feature"] == 1
        assert root["right_child"]["split_feature"] == 3
        # the recorded gains are the real ones, not the priorities
        assert abs(root["split_gain"]) < 1e6
    _assert_models_match(bj, bt, X)


def test_forced_deep_schedule(tmp_path):
    """Ranks past the first level: a forced grandchild whose threshold
    leaves one side empty is infeasible and falls back, its siblings
    stay forced."""
    bj, bt, X = _train_both(tmp_path, DEEP, rounds=2)
    t0 = bt._model.trees[0]
    assert t0.split_feature[0] == 0
    _assert_models_match(bj, bt, X)


def test_infeasible_forced_split_falls_back(tmp_path):
    bj, bt, X = _train_both(tmp_path, {"feature": 2, "threshold": 1e9})
    root = bt.dump_model()["tree_info"][0]["tree_structure"]
    assert "split_feature" in root
    assert np.isfinite(bt.predict(X)).all()
    _assert_models_match(bj, bt, X)


def test_forced_splits_with_bagging(tmp_path):
    bj, bt, X = _train_both(tmp_path, {"feature": 2, "threshold": 0.1},
                            bagging_freq=1, bagging_fraction=0.7,
                            min_gain_to_split=0.01)
    assert bt._engine._fast_active
    for t in bt.dump_model()["tree_info"]:
        assert t["tree_structure"]["split_feature"] == 2
    for tj, tt in zip(bj._model.trees, bt._model.trees):
        assert tt.num_leaves == tj.num_leaves
        np.testing.assert_array_equal(tt.split_feature[:tj.num_leaves - 1],
                                      tj.split_feature[:tj.num_leaves - 1])
        np.testing.assert_array_equal(tt.leaf_count[:tj.num_leaves],
                                      tj.leaf_count[:tj.num_leaves])


@pytest.mark.parametrize("extra", [dict(tpu_frontier_batch=8),
                                   dict(histogram_pool_size=0.01)])
def test_forced_grower_modes_write_one_leaf_text(tmp_path, extra):
    """Frontier 8 falls back on the one-leaf loop under forced splits
    (the JAX gate): the same model text byte for byte.  The pooled
    grower forces alike; it rebuilds evicted parents from rows, whose
    f32 sums round otherwise than the subtraction's on the CPU, so its
    trees are held node for node."""
    X, y, w = _data()
    fpath = tmp_path / "forced.json"
    fpath.write_text(json.dumps(NESTED))
    params = {"objective": "binary", "num_leaves": 16, "min_data_in_leaf": 5,
              "verbose": -1, "forcedsplits_filename": str(fpath),
              "device_type": "cpu"}
    one = lt.train(dict(params), lt.Dataset(X, label=y, weight=w), 3,
                   verbose_eval=False)
    other = lt.train(dict(params, **extra), lt.Dataset(X, label=y, weight=w),
                     3, verbose_eval=False)
    assert other.split_rounds_per_tree() == one.split_rounds_per_tree()
    if "tpu_frontier_batch" in extra:
        assert other.model_to_string().split("end of trees")[0] == \
            one.model_to_string().split("end of trees")[0]
        return
    assert other._engine.grower_cfg.hist_pool_slots == 2
    _assert_same_structure(one, other, X)
    for t in other.dump_model()["tree_info"]:
        root = t["tree_structure"]
        assert (root["split_feature"], root["left_child"]["split_feature"],
                root["right_child"]["split_feature"]) == (4, 1, 3)


def test_forced_quantization_trains_f32(tmp_path, capsys):
    X, y, w = _data()
    fpath = tmp_path / "forced.json"
    fpath.write_text(json.dumps(NESTED))
    params = {"objective": "binary", "num_leaves": 16, "verbose": 0,
              "forcedsplits_filename": str(fpath), "device_type": "cpu"}
    q = lt.train(dict(params, gradient_quantization=True),
                 lt.Dataset(X, label=y, weight=w), 2, verbose_eval=False)
    assert "training with f32 gradients" in capsys.readouterr().out
    assert q.quant_report is None
    f = lt.train(params, lt.Dataset(X, label=y, weight=w), 2,
                 verbose_eval=False)
    assert q.model_to_string().split("end of trees")[0] == \
        f.model_to_string().split("end of trees")[0]
