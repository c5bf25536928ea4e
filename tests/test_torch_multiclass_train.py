"""Training K > 1 in the port against the JAX package on the CPU (the same
seeded numpy inputs): the softmax and one-vs-all gradients on [K, N],
multiclass and multiclassova trained node for node with weighted rows
(K = 3, is_unbalance for OVA), bagged, the [K, N] validation scores of a
set added before and after training started with their multi_logloss /
multi_error records, the K > 1 payload row for row through convert.py,
and frontier 8 writing the one-leaf model text."""
import functools

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.objective import create_objective as j_create
from lightgbm_tpu.utils.log import LightGBMError as JError
from lightgbm_tpu_torch import convert
from lightgbm_tpu_torch.config import Config as TConfig
from lightgbm_tpu_torch.objective import create_objective as t_create

from test_torch_train import _assert_same_structure

# one intra-op thread: the pytest-xdist workers share the cores, and
# torch's OpenMP regions spin in their barriers when oversubscribed
torch.set_num_threads(1)

N, F, K, ROUNDS = 1500, 8, 3, 3
PARAMS = dict(num_class=K, num_leaves=7, max_bin=63, learning_rate=0.1,
              verbose=-1, metric=["multi_logloss", "multi_error"])
#: leaf values: rtol 1e-5, with an atol for leaves near 0, whose f32
#: gradient sums cancel (each package sums in its own order); as
#: test_torch_regression_train.py
LEAF_RTOL, LEAF_ATOL = 1e-5, 2e-6
#: gradients: rtol 1e-6, with an atol of two f32 ulps at 1 for p - 1 and
#: p (1 - p), where an ulp of XLA's exp against torch's meets cancellation
GRAD_RTOL, GRAD_ATOL = 1e-6, 2 ** -22
OBJECTIVES = [("multiclass", {}), ("multiclassova", dict(is_unbalance=True))]


def _data(seed=0, n=N):
    """Three classes from a noisy argmax of three signals of X, with
    continuous row weights so no two candidate gains tie exactly."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, F))
    z = np.stack([X[:, 0], X[:, 1] + 0.5 * X[:, 2], X[:, 3] - X[:, 0]], 1)
    y = np.argmax(z + 0.5 * rng.standard_normal((n, K)), 1).astype(float)
    return X, y, rng.uniform(0.5, 1.5, n)


@functools.lru_cache(maxsize=None)
def _trained(objective, seed, extra=()):
    """The JAX and port boosters of _data(seed), trained once per module
    for the tests that read them."""
    X, y, w = _data(seed)
    return _train_both(objective, X, y, w, **dict(extra))


def _train_both(objective, X, y, w, rounds=ROUNDS, **extra):
    params = dict(PARAMS, objective=objective, **extra)
    bj = lj.train(params, lj.Dataset(X, label=y, weight=w), rounds,
                  verbose_eval=False)
    bt = lt.train(dict(params, device_type="cpu"),
                  lt.Dataset(X, label=y, weight=w), rounds,
                  verbose_eval=False)
    return bj, bt


def _assert_leaves_close(bj, bt):
    for tj, tt in zip(bj._model.trees, bt._model.trees):
        nl = tj.num_leaves
        np.testing.assert_allclose(tt.leaf_value[:nl], tj.leaf_value[:nl],
                                   rtol=LEAF_RTOL, atol=LEAF_ATOL)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("objective,extra", OBJECTIVES,
                         ids=[o for o, _ in OBJECTIVES])
def test_gradients_match_jax(objective, extra, weighted):
    rng = np.random.default_rng(3 + weighted)
    n = 700
    label = rng.integers(0, K, n).astype(np.float32)
    weight = rng.uniform(0.5, 1.5, n).astype(np.float32) if weighted \
        else None
    cfg = dict(objective=objective, num_class=K, **extra)
    oj, ot = j_create(objective, JConfig(cfg)), t_create(objective,
                                                         TConfig(cfg))
    oj.init(label, weight)
    ot.init(label, weight)
    if objective == "multiclassova":
        np.testing.assert_array_equal(ot.label_weights, oj.label_weights)
    score = (rng.standard_normal((K, n)) * 3.0).astype(np.float32)
    w = weight if weighted else np.ones(n, np.float32)
    gj, hj = oj.get_gradients_multi(jnp.asarray(score), jnp.asarray(label),
                                    jnp.asarray(w))
    gt, ht = ot.get_gradients_multi(torch.from_numpy(score),
                                    torch.from_numpy(label),
                                    torch.from_numpy(w))
    assert gt.shape == ht.shape == (K, n) and gt.dtype == torch.float32
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=GRAD_RTOL,
                               atol=GRAD_ATOL)
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), rtol=GRAD_RTOL,
                               atol=GRAD_ATOL)


def test_class_label_checks_match_jax():
    """Labels out of [0, K) or not integers raise in both packages."""
    for label in ([0.0, 3.0, 1.0], [0.0, 1.5, 2.0], [-1.0, 0.0, 1.0]):
        for obj in ("multiclass", "multiclassova"):
            cfg = dict(objective=obj, num_class=K)
            with pytest.raises(JError):
                j_create(obj, JConfig(cfg)).init(np.asarray(label), None)
            with pytest.raises(lt.LightGBMError):
                t_create(obj, TConfig(cfg)).init(np.asarray(label), None)


@pytest.mark.parametrize("objective,extra", OBJECTIVES,
                         ids=[o for o, _ in OBJECTIVES])
def test_trains_node_for_node(objective, extra):
    X, _, _ = _data()
    bj, bt = _trained(objective, 0, tuple(extra.items()))
    assert len(bt._model.trees) == len(bj._model.trees) == K * ROUNDS
    assert bt._model.num_tree_per_iteration == K
    assert bt._model.objective_str == bj._model.objective_str
    _assert_same_structure(bj, bt, X)
    _assert_leaves_close(bj, bt)
    np.testing.assert_allclose(bt.predict(X, raw_score=True),
                               bj.predict(X, raw_score=True), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(bt._engine.raw_train_score(),
                               bj._engine.raw_train_score(), rtol=1e-5,
                               atol=1e-5)
    assert bt._engine.raw_train_score().shape == (K, N)
    np.testing.assert_allclose(bt.predict(X), bj.predict(X), rtol=1e-5,
                               atol=1e-6)
    assert bt.host_syncs_per_tree() == [1] * (K * ROUNDS)


def test_bagged_multiclass_node_for_node():
    """One bag per iteration (the JAX package's RNG stream) for all K
    class trees; routing compared on in-bag rows, as
    tests/test_torch_bagging.py does."""
    X, y, w = _data(1)
    bag = dict(bagging_fraction=0.6, bagging_freq=1, bagging_seed=3,
               min_gain_to_split=0.01)
    bj, bt = _train_both("multiclass", X, y, w, **bag)
    for it in range(ROUNDS):
        roots = [t.internal_count[0] for t in
                 bt._model.trees[it * K:(it + 1) * K]]
        assert roots == [int(N * 0.6)] * K
    for tj, tt in zip(bj._model.trees, bt._model.trees):
        assert tt.num_leaves == tj.num_leaves
        nl = tj.num_leaves
        for key in ("split_feature", "left_child", "right_child",
                    "internal_count"):
            np.testing.assert_array_equal(getattr(tt, key)[:nl - 1],
                                          getattr(tj, key)[:nl - 1])
    _assert_leaves_close(bj, bt)
    bag_rows = bt._engine.bag_mask_host[:N] > 0
    np.testing.assert_array_equal(
        bt._model.predict_leaf_index(X[bag_rows]),
        bj._model.predict_leaf_index(X[bag_rows]))


@pytest.mark.parametrize("case", ["before", "after"])
def test_valid_scores_and_records_match_jax(case):
    """[K, N] validation scores of a set added before training (scored
    after every tree, plane k for class k) or after it (every tree
    replayed onto plane i % K), and the multi_logloss / multi_error
    records of both sets, against the JAX package."""
    X, y, w = _data(2)
    perm = np.random.default_rng(10).permutation(N)[:600]
    Xv, yv = X[perm] + 0.05, y[perm]
    params = dict(PARAMS, objective="multiclass")
    out = []
    for pkg, extra in ((lj, {}), (lt, dict(device_type="cpu"))):
        ds = pkg.Dataset(X, label=y, weight=w)
        bst = pkg.Booster(dict(params, **extra), ds)
        records = []
        if case == "before":
            bst.add_valid(pkg.Dataset(Xv, label=yv, reference=ds), "v")
        for _ in range(ROUNDS):
            bst.update()
            if case == "before":
                records.append(bst.eval_valid())
            records.append(bst.eval_train())
        if case == "after":
            if pkg is lj:
                bst._engine.flush()
            bst.add_valid(pkg.Dataset(Xv, label=yv, reference=ds), "v")
            records.append(bst.eval_valid())
        out.append((bst, records))
    (bj, rj), (bt, rt) = out
    vj = bj._engine.raw_valid_score(0)
    vt = bt._engine.raw_valid_score(0)
    assert vt.shape == (K, len(yv))
    np.testing.assert_allclose(vt, vj, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(vt.T, bt.predict(Xv, raw_score=True),
                               rtol=1e-6, atol=1e-5)
    assert len(rt) == len(rj)
    for a, b in zip(rt, rj):
        assert [r[:2] for r in a] == [r[:2] for r in b]
        assert [r[1] for r in a] == ["multi_logloss", "multi_error"]
        np.testing.assert_allclose([r[2] for r in a], [r[2] for r in b],
                                   rtol=1e-6, atol=1e-7)


def test_payload_matches_jax_row_for_row():
    """After training, the K > 1 payload has the JAX layout (K score and
    K snapshot columns, P = G + 2K + 9) and holds the same label, weight,
    scores and snapshot in original row order."""
    bj, bt = _trained("multiclass", 0, ())
    fj, ft = bj._engine._fast, bt._engine._fast
    for attr in ("score0", "snap0", "grad_col", "hess_col", "value_col",
                 "bvalid_col", "gweight_col", "idx_col", "cnt_col",
                 "n_pad"):
        assert getattr(ft, attr) == getattr(fj, attr), attr
    assert ft.P == F + 2 * K + 9 == np.asarray(fj.payload).shape[1]
    assert ft.snap0 == ft.score0 + K
    pj = np.asarray(fj.payload)
    n_pad = ft.n_pad
    for col in (ft.label_col, ft.weight_col, ft.cnt_col):
        np.testing.assert_array_equal(
            convert.original_order(ft.payload, col, ft.idx_col, n_pad),
            convert.original_order(pj, col, fj.idx_col, n_pad))
    for start in (ft.score0, ft.snap0):
        st = convert.scores_from_payload(ft.payload, start, ft.idx_col,
                                         n_pad, num_class=K)
        sj = convert.scores_from_payload(pj, start, fj.idx_col, n_pad,
                                         num_class=K)
        assert st.shape == (K, n_pad)
        np.testing.assert_allclose(st, sj, rtol=1e-5, atol=1e-5)
    # the scores read back are the engine's training scores
    np.testing.assert_array_equal(
        convert.scores_from_payload(ft.payload, ft.score0, ft.idx_col, n_pad,
                                    num_class=K)[:, :N].astype(np.float32),
        bt._engine.raw_train_score())


def test_frontier_writes_one_leaf_text():
    X, y, w = _data(5, n=1000)
    params = dict(PARAMS, objective="multiclass", device_type="cpu",
                  num_leaves=15)
    one = lt.train(params, lt.Dataset(X, label=y, weight=w), ROUNDS,
                   verbose_eval=False)
    front = lt.train(dict(params, tpu_frontier_batch=8),
                     lt.Dataset(X, label=y, weight=w), ROUNDS,
                     verbose_eval=False)
    assert front.model_to_string() == one.model_to_string()
    assert front.split_rounds_per_tree() < one.split_rounds_per_tree()


def test_init_score_starts_every_class_plane():
    X, y, w = _data(6)
    init = np.random.default_rng(7).standard_normal(N) * 0.3
    params = dict(PARAMS, objective="multiclass")
    bj = lj.train(params, lj.Dataset(X, label=y, weight=w, init_score=init),
                  2, verbose_eval=False)
    bt = lt.train(dict(params, device_type="cpu"),
                  lt.Dataset(X, label=y, weight=w, init_score=init), 2,
                  verbose_eval=False)
    _assert_same_structure(bj, bt, X)
    raw = bt._engine.raw_train_score()
    np.testing.assert_allclose(raw, bt.predict(X, raw_score=True).T
                               + init[None, :], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(raw, bj._engine.raw_train_score(), rtol=1e-5,
                               atol=1e-5)
