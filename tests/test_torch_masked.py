"""The configurations the JAX package trains on its masked grower, in the
port against the JAX package on the CPU.  The port trains them on its
partitioned grower: GOSS's selection drawn over the rows in original
order (the masked grower's draw), against the JAX `_goss_masks` bit for
bit; GOSS with lambdarank, with L1 / quantile / mape renewal, with a
custom objective (binary and K = 3), with forced splits and with
monotone constraints, and RF with lambdarank, node for node against
`lj.train`; GOSS lambdarank with a validation set and early stopping;
the mesh modes refused."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt
from lightgbm_tpu.boosting.variants import _goss_masks as jax_goss_masks
from lightgbm_tpu_torch.boosting.variants import goss_masks
from lightgbm_tpu_torch.utils import threefry

from test_torch_custom import logloss_fobj, softmax_fobj
from test_torch_rank_train import _ragged_rank
from test_torch_train import _assert_same_structure

# one intra-op thread: the pytest-xdist workers share the cores, and
# torch's OpenMP regions spin in their barriers when oversubscribed
torch.set_num_threads(1)

#: GOSS at learning_rate 0.5: the warm-up lasts int(1 / 0.5) = 2
#: iterations, so iterations 3 to 5 sample
GOSS = dict(boosting="goss", learning_rate=0.5, num_leaves=15, max_bin=63,
            verbose=-1)
RF = dict(boosting="rf", bagging_fraction=0.632, bagging_freq=1,
          feature_fraction=0.7, num_leaves=15, max_bin=63, verbose=-1)
#: raw scores of the two packages' models, as tests/test_torch_goss.py
RAW_ATOL = 1e-4
#: tests/test_forced_splits.py:121's schedule: feature 4 at the root, 1
#: on its left
FORCED = {"feature": 4, "threshold": 0.0,
          "left": {"feature": 1, "threshold": -0.5}}


@pytest.mark.parametrize("K", [1, 3])
def test_goss_masks_original_order_match_jax(K):
    """The selection of rows in a shuffled order with their original
    rows given (the payload's layout: n_pad rows permuted, then guard
    rows that are never valid) equals the JAX selection over the rows in
    original order, gathered, bit for bit."""
    rng = np.random.default_rng(20 + K)
    n_pad, guard = 3000, 5
    g = rng.standard_normal((K, n_pad)).astype(np.float32)
    h = rng.uniform(0.1, 1.0, (K, n_pad)).astype(np.float32)
    valid = rng.random(n_pad) > 0.1
    top_k, other_k = 600, 300
    multiply = (n_pad - top_k) / other_k
    jw, jc = jax_goss_masks(jnp.asarray(g), jnp.asarray(h),
                            jnp.asarray(valid),
                            jax.random.fold_in(jax.random.PRNGKey(5), 3),
                            top_k, other_k, multiply)
    rows = np.concatenate([rng.permutation(n_pad),
                           np.full(guard, n_pad)])
    pad = np.zeros((K, 1), np.float32)
    tw, tc = goss_masks(
        torch.from_numpy(np.concatenate([g, pad], 1)[:, rows]),
        torch.from_numpy(np.concatenate([h, pad], 1)[:, rows]),
        torch.from_numpy(np.append(valid, False)[rows]),
        threefry.fold_in(threefry.prng_key(5), 3), top_k, other_k, multiply,
        rows=torch.from_numpy(rows), n_draw=n_pad)
    ref_w = np.append(np.asarray(jw), np.float32(0.0))[rows]
    ref_c = np.append(np.asarray(jc), np.float32(0.0))[rows]
    np.testing.assert_array_equal(tw.numpy().view(np.int32),
                                  ref_w.view(np.int32))
    np.testing.assert_array_equal(tc.numpy(), ref_c)
    assert int(tc.sum()) == top_k + other_k


def _rank_data(seed=3, n_q=60):
    X, rel, sizes = _ragged_rank(n_q, seed)
    return X, rel, sizes


def _regression_data(seed=7, n=3000, positive=False):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, 6))
    y = X[:, 0] + 0.5 * X[:, 1] * X[:, 2] + 0.3 * rng.standard_normal(n) \
        + 0.8 * rng.standard_t(3, n)
    if positive:
        y = np.abs(y) + 1.0
    return X, y, rng.uniform(0.5, 1.5, n)


#: the configurations the JAX package trains on its masked grower:
#: params, data kind, fobj
CONFIGS = {
    "goss lambdarank": (dict(GOSS, objective="lambdarank",
                             min_data_in_leaf=5), "rank", None),
    "goss l1": (dict(GOSS, objective="regression_l1",
                     min_gain_to_split=0.01), "regression", None),
    "goss quantile": (dict(GOSS, objective="quantile", alpha=0.7,
                           min_gain_to_split=0.01), "regression", None),
    "goss mape": (dict(GOSS, objective="mape", min_gain_to_split=0.01),
                  "positive", None),
    "goss fobj": (dict(GOSS, objective="none"), "binary", logloss_fobj),
    "goss fobj multiclass": (dict(GOSS, objective="none", num_class=3),
                             "multiclass", softmax_fobj),
    "goss l1 forced": (dict(GOSS, objective="regression_l1",
                            min_gain_to_split=0.01, min_data_in_leaf=5),
                       "regression", None),
    "goss quantile monotone": (dict(GOSS, objective="quantile", alpha=0.4,
                                    min_gain_to_split=0.01,
                                    monotone_constraints=[1, 0, -1, 0, 0,
                                                          0]),
                               "regression", None),
    "rf lambdarank": (dict(RF, objective="lambdarank", min_data_in_leaf=5),
                      "rank", None),
}


def _config_data(kind):
    if kind == "rank":
        X, y, g = _rank_data()
        return X, dict(label=y, group=g)
    if kind == "binary":
        X, y, w = _regression_data(11)
        return X, dict(label=(y > 0).astype(np.float64), weight=w)
    if kind == "multiclass":
        X, y, w = _regression_data(13)
        return X, dict(label=np.digitize(y, [-0.5, 0.5]).astype(np.float64))
    X, y, w = _regression_data(positive=kind == "positive")
    return X, dict(label=y, weight=w)


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_refused_configurations_match_jax(config, tmp_path):
    """Each configuration the JAX package trains on its masked grower
    trains in the port on the partitioned grower, node for node against
    lj.train over the GOSS warm-up and three sampled iterations (five
    forest trees for RF): the same splits, topology, leaf counts and
    routing of every row; raw scores within 1e-4.  One blocking sync a
    tree, a second where leaves are renewed and in each iteration's
    first tree where a custom objective reads the scores."""
    params, kind, fobj = CONFIGS[config]
    if config.endswith("forced"):
        fpath = tmp_path / "forced.json"
        fpath.write_text(json.dumps(FORCED))
        params = dict(params, forcedsplits_filename=str(fpath))
    X, fields = _config_data(kind)
    bj = lj.train(dict(params), lj.Dataset(X, **fields), 5, fobj=fobj)
    bt = lt.train(dict(params, device_type="cpu"), lt.Dataset(X, **fields),
                  5, fobj=fobj, verbose_eval=False)
    bj._engine.flush()
    assert bt._engine._fast_active
    K = bt._model.num_tree_per_iteration
    assert len(bt._model.trees) == len(bj._model.trees) == 5 * K
    _assert_same_structure(bj, bt, X)
    np.testing.assert_allclose(bt.predict(X, raw_score=True),
                               bj.predict(X, raw_score=True), atol=RAW_ATOL)
    renewing = params.get("objective") in ("regression_l1", "quantile",
                                           "mape")
    first = 2 if renewing or fobj else 1
    assert bt.host_syncs_per_tree() == \
        ([first] + [2 if renewing else 1] * (K - 1)) * 5
    trees = bt.dump_model()["tree_info"]
    if params["boosting"] == "goss":
        # the sampled iterations grow on a selection, the warm-up on all
        n = len(X)
        counts = [t["tree_structure"]["internal_count"] for t in trees]
        assert counts[:2 * K] == [n] * (2 * K) and max(counts[2 * K:]) < n
    if config.endswith("forced"):
        for t in trees:
            root = t["tree_structure"]
            assert root["split_feature"] == 4
            assert root["left_child"].get("split_feature") == 1


def test_goss_lambdarank_valid_and_early_stopping():
    """GOSS + lambdarank with a grouped validation set scored after every
    tree and early stopping: the valid scores equal predict(raw_score=
    True), NDCG@5 rises, and the best iteration is the record's best."""
    X, y, g = _rank_data(seed=4, n_q=80)
    Xv, yv, gv = _rank_data(seed=5, n_q=30)
    ds = lt.Dataset(X, label=y, group=g)
    dv = lt.Dataset(Xv, label=yv, group=gv, reference=ds)
    evals = {}
    params = dict(GOSS, objective="lambdarank", metric="ndcg", eval_at=[5],
                  min_data_in_leaf=5, learning_rate=0.3, device_type="cpu")
    bst = lt.train(params, ds, 40, valid_sets=[dv], valid_names=["v"],
                   evals_result=evals, early_stopping_rounds=4,
                   verbose_eval=False)
    assert bst._engine._fast_active
    curve = evals["v"]["ndcg@5"]
    assert max(curve) > curve[0]
    assert 0 < bst.best_iteration <= len(curve)
    assert bst.best_iteration == int(np.argmax(curve)) + 1
    raw = bst._engine.raw_valid_score(0)[0]
    np.testing.assert_allclose(
        raw, bst.predict(Xv, raw_score=True, num_iteration=len(curve)),
        rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mode", ["data", "feature", "voting"])
def test_mesh_modes_refused(mode):
    """The mesh modes, refused here until the distributed learners were
    ported: without a process group GOSS under each trains the serial
    learner (two ranks: tests/test_torch_tree_learner.py)."""
    X, y, _ = _regression_data(3, n=800)
    params = dict(objective="binary", boosting="goss", verbose=-1,
                  device_type="cpu")
    label = (y > 0).astype(np.float64)
    bst = lt.train(dict(params, tree_learner=mode),
                   lt.Dataset(X, label=label), 1, verbose_eval=False)
    assert bst._engine.parallel_mode is None
    ref = lt.train(params, lt.Dataset(X, label=label), 1, verbose_eval=False)
    assert bst.model_to_string() == ref.model_to_string()
