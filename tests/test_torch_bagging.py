"""Bagging in the port against the JAX package on the CPU (the same seeded
numpy inputs): the host RNG's bags, the count column that carries them
through the partition, bagged training node for node, bagging with leaf
renewal input for input, and the grower modes and quantized reruns under
bagging byte for byte."""
import numpy as np
import pytest
import torch

import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch import convert

from test_torch_categorical_train import TRAIN, _assert_models_alike
from test_torch_categorical_train import _train_data as _cat_data
from test_torch_regression_train import (_assert_leaves_close, _data,
                                         _params, _weights)

# one intra-op thread: the pytest-xdist workers share the cores, and
# torch's OpenMP regions spin in their barriers when oversubscribed
torch.set_num_threads(1)

N, ROUNDS = 2000, 5
#: min_gain_to_split: a leaf whose bagged rows share one label has a
#: constant grad / hess ratio, so its splits gain 0 exactly and f32 noise
#: would pick one (tests/test_torch_regression_train.py:_params)
BAG = dict(bagging_fraction=0.5, bagging_freq=1, min_gain_to_split=0.01)


def _assert_same_structure_in_bag(bj, bt, X, bags):
    """tests/test_torch_train.py:_assert_same_structure for bagged trees:
    the same split features, topology and leaf counts, and every row IN
    THE TREE'S BAG in the same leaf.  An out-of-bag row adds nothing to a
    histogram, so bins that hold only such rows leave the candidate
    thresholds around them tied exactly, each package breaks the tie by
    its own ulps, and the out-of-bag rows in those bins may go either
    way."""
    for tj, tt in zip(bj._model.trees, bt._model.trees):
        assert tt.num_leaves == tj.num_leaves
        nl = tj.num_leaves
        for k in ("split_feature", "left_child", "right_child",
                  "internal_count"):
            np.testing.assert_array_equal(getattr(tt, k)[:nl - 1],
                                          getattr(tj, k)[:nl - 1], err_msg=k)
        np.testing.assert_array_equal(tt.leaf_count[:nl], tj.leaf_count[:nl])
    lt_idx = bt._model.predict_leaf_index(X)
    lj_idx = bj._model.predict_leaf_index(X)
    for t, bag in enumerate(bags):
        rows = bag[:len(X)] > 0
        np.testing.assert_array_equal(lt_idx[rows, t], lj_idx[rows, t])


def _train_both_bagged(bj, bt, rounds=ROUNDS):
    """Update both boosters `rounds` times; after each tree the count
    column of both holds the host RNG's bag.  Returns the bags."""
    bags = []
    for _ in range(rounds):
        bj.update()
        bt.update()
        bag = _count_bag(bt._engine)
        np.testing.assert_array_equal(bag, bt._engine.bag_mask_host)
        np.testing.assert_array_equal(bag, _count_bag(bj._engine))
        bags.append(bag)
    bj._engine.flush()
    return bags


def _boosters(objective, seed=0, **extra):
    """A JAX and a port Booster on the same weighted rows, not yet
    trained."""
    X, y = _data(objective, seed)
    if objective == "binary":
        y = (y > 3.0).astype(np.float64)
    w = _weights(seed)
    params = _params(objective, **extra)
    bj = lj.Booster(params, lj.Dataset(X, label=y, weight=w))
    bt = lt.Booster(dict(params, device_type="cpu"),
                    lt.Dataset(X, label=y, weight=w))
    return bj, bt, X


def _count_bag(engine) -> np.ndarray:
    """An engine's count column in original row order."""
    fs = engine._fast
    return convert.bag_mask_from_payload(np.asarray(fs.payload), fs.cnt_col,
                                         fs.idx_col, fs.n_pad)


@pytest.mark.parametrize("bagging_seed", [3, 11])
@pytest.mark.parametrize("freq", [1, 3])
def test_bag_masks_match_jax(freq, bagging_seed):
    bj, bt, _ = _boosters("binary", bagging_fraction=0.6, bagging_freq=freq,
                          bagging_seed=bagging_seed)
    n = bt.train_set.binned.num_data
    prev = None
    for it in range(10):
        mj = bj._engine._bagging_host(it)
        mt = bt._engine._bagging_host(it)
        np.testing.assert_array_equal(mt, mj)
        assert mt.dtype == np.float32 and mt[:n].sum() == int(n * 0.6)
        assert not mt[n:].any()
        if it % freq:
            assert mt is prev     # kept between resamples
        prev = mt


@pytest.mark.parametrize("objective,extra", [
    ("binary", BAG),
    ("regression", dict(BAG, bagging_fraction=0.7, bagging_freq=3)),
    ("xentropy", dict(BAG, feature_fraction=0.75))])
def test_bagged_training_node_for_node(objective, extra):
    bj, bt, X = _boosters(objective, seed=1, **extra)
    bags = _train_both_bagged(bj, bt)
    _assert_same_structure_in_bag(bj, bt, X, bags)
    _assert_leaves_close(bj, bt)
    # out-of-bag rows do not count: every tree's root holds its bag
    assert [t.internal_count[0] for t in bt._model.trees] == \
        [int(b.sum()) for b in bags]
    rows = np.all([b[:len(X)] > 0 for b in bags], axis=0)
    np.testing.assert_allclose(bt.predict(X[rows], raw_score=True),
                               bj.predict(X[rows], raw_score=True),
                               rtol=1e-5, atol=1e-5)


def _record_renewal(objective, log):
    real = objective.renew_leaf_values

    def renew(leaf_values, leaf_ids, pred, in_bag):
        out = real(leaf_values, leaf_ids, pred, in_bag)
        log.append((np.array(leaf_values), np.array(leaf_ids),
                    np.array(pred), np.array(in_bag), np.array(out)))
        return out

    objective.renew_leaf_values = renew


@pytest.mark.parametrize("objective", ["regression_l1", "quantile"])
def test_bagging_with_renewal_matches_jax(objective):
    """The renewal's inputs agree row for row (the bag and the leaf of
    every row exactly, the pre-tree scores to f32 rounding), and the
    port's renewal of the JAX package's inputs is the JAX renewal bit for
    bit."""
    bj, bt, X = _boosters(objective, seed=2, alpha=0.3,
                          **dict(BAG, bagging_freq=2))
    logs = {"jax": [], "port": []}
    _record_renewal(bj._engine.objective, logs["jax"])
    _record_renewal(bt._engine.objective, logs["port"])
    bags = _train_both_bagged(bj, bt)
    assert len(logs["jax"]) == len(logs["port"]) == ROUNDS
    port_obj = bt._engine.objective
    for (lvj, lidj, predj, bagj, outj), (lvt, lidt, predt, bagt, _) in zip(
            logs["jax"], logs["port"]):
        np.testing.assert_array_equal(bagt, bagj)
        np.testing.assert_array_equal(lidt, lidj)
        np.testing.assert_allclose(predt, predj, rtol=1e-6, atol=1e-5)
        np.testing.assert_allclose(lvt, lvj, rtol=1e-5, atol=2e-6)
        np.testing.assert_array_equal(
            type(port_obj).renew_leaf_values(port_obj, lvj, lidj, predj,
                                             bagj), outj)
    _assert_same_structure_in_bag(bj, bt, X, bags)
    _assert_leaves_close(bj, bt)
    assert bt.host_syncs_per_tree() == [2] * ROUNDS


def _train_port(objective="binary", **extra):
    X, y = _data(objective, seed=4)
    if objective == "binary":
        y = (y > 3.0).astype(np.float64)
    params = dict(_params(objective, **extra), device_type="cpu")
    return lt.train(params, lt.Dataset(X, label=y, weight=_weights(4)),
                    ROUNDS, verbose_eval=False)


@pytest.mark.parametrize("qdtype", ["int8", "int16"])
def test_bagged_quantized_reruns_byte_identical(qdtype):
    kw = dict(BAG, gradient_quantization=True, gradient_quant_dtype=qdtype)
    a = _train_port(**kw).model_to_string()
    assert _train_port(**kw).model_to_string() == a
    assert a != _train_port(gradient_quantization=True,
                            gradient_quant_dtype=qdtype).model_to_string()


@pytest.mark.parametrize("extra", [{}, dict(gradient_quantization=True,
                                            gradient_quant_dtype="int8")])
def test_bagged_frontier_writes_one_leaf_text(extra):
    one = _train_port(**BAG, **extra)
    front = _train_port(tpu_frontier_batch=8, **BAG, **extra)
    assert front.split_rounds_per_tree() < one.split_rounds_per_tree()
    assert front.model_to_string() == one.model_to_string()


def test_bagged_quantized_pool_writes_one_leaf_text():
    kw = dict(BAG, gradient_quantization=True, gradient_quant_dtype="int16")
    one = _train_port(**kw)
    pooled = _train_port(histogram_pool_size=0.01, **kw)
    assert pooled._engine.grower_cfg.hist_pool_slots == 2
    assert pooled.model_to_string() == one.model_to_string()


def test_bagged_categorical_matches_jax():
    X, y, w = _cat_data(1)
    params = dict(TRAIN, **BAG)
    bj = lj.Booster(params, lj.Dataset(X, label=y, weight=w,
                                       categorical_feature=[0, 1]))
    bt = lt.Booster(dict(params, device_type="cpu"),
                    lt.Dataset(X, label=y, weight=w,
                               categorical_feature=[0, 1]))
    bags = _train_both_bagged(bj, bt)
    _assert_models_alike(bj, bt)
    _assert_same_structure_in_bag(bj, bt, X, bags)
