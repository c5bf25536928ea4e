"""GOSS in the port against the JAX package on the CPU: the threefry
stream against jax.random bit for bit, the selection masks against the
JAX _goss_masks bit for bit, binary and K = 3 GOSS models node for node
on weighted rows across the warm-up (with the count column of every
iteration equal), frontier 8 against the one-leaf loop, and the
refusals."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt
from lightgbm_tpu.boosting.variants import _goss_masks as jax_goss_masks
from lightgbm_tpu_torch import convert
from lightgbm_tpu_torch.boosting.variants import goss_masks
from lightgbm_tpu_torch.utils import threefry

from test_torch_train import _assert_same_structure

# one intra-op thread: the pytest-xdist workers share the cores, and
# torch's OpenMP regions spin in their barriers when oversubscribed
torch.set_num_threads(1)

N, F = 2000, 8
#: learning_rate 0.5: the warm-up lasts int(1 / 0.5) = 2 iterations
GOSS = dict(boosting="goss", learning_rate=0.5, num_leaves=15, max_bin=63,
            verbose=-1)


def _data(seed=0, classes=2):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((N, F))
    z = X[:, 0] + 0.5 * X[:, 1] * X[:, 2] - 0.3 * np.abs(X[:, 3]) \
        + 0.3 * rng.standard_normal(N)
    if classes == 2:
        y = (z > 0).astype(np.float64)
    else:
        y = np.digitize(z, np.quantile(z, np.linspace(0, 1, classes + 1)
                                       [1:-1])).astype(np.float64)
    w = np.random.default_rng(seed + 100).uniform(0.5, 1.5, N)
    return X, y, w


def _count_bag(engine) -> np.ndarray:
    fs = engine._fast
    return convert.bag_mask_from_payload(np.asarray(fs.payload), fs.cnt_col,
                                         fs.idx_col, fs.n_pad)


@pytest.mark.parametrize("seed,data,n", [
    (0, 0, 1), (7, 3, 4), (123456, 99, 70_000), (2**31 - 2, 12345, 1000),
    (42, 2**20 + 5, 65_537), (3, 0, 300_000)])
def test_threefry_uniform_matches_jax(seed, data, n):
    kj = jax.random.fold_in(jax.random.PRNGKey(seed), data)
    ref = np.asarray(jax.random.uniform(kj, (n,)))
    key = threefry.fold_in(threefry.prng_key(seed), data)
    assert key == tuple(int(v) for v in np.asarray(jax.random.key_data(kj)))
    got = threefry.uniform(key, n).numpy()
    np.testing.assert_array_equal(got.view(np.int32), ref.view(np.int32))
    np.testing.assert_array_equal(
        threefry.uniform_numpy(key, n).view(np.int32), ref.view(np.int32))


def test_prng_key_matches_jax():
    for s in (0, 1, 12345, 2**31 - 1):
        assert threefry.prng_key(s) == tuple(
            int(v) for v in np.asarray(jax.random.key_data(
                jax.random.PRNGKey(s))))


@pytest.mark.parametrize("K", [1, 3])
@pytest.mark.parametrize("ties", [False, True])
def test_goss_masks_match_jax(K, ties):
    """The selection of the same gradients under the same key, bit for
    bit; with `ties` the gradients take few values, so rows tie at the
    top-k threshold and all of them go in."""
    rng = np.random.default_rng(K + 10 * ties)
    n = 5000
    g = rng.standard_normal((K, n)).astype(np.float32)
    h = rng.uniform(0.1, 1.0, (K, n)).astype(np.float32)
    if ties:
        g = np.round(g * 2) / 2
        h = np.round(h * 4) / 4 + 0.25
    valid = rng.random(n) > 0.1
    top_k, other_k = 1000, 500
    multiply = (n - top_k) / other_k
    jw, jc = jax_goss_masks(jnp.asarray(g), jnp.asarray(h),
                            jnp.asarray(valid),
                            jax.random.fold_in(jax.random.PRNGKey(11), 4),
                            top_k, other_k, multiply)
    tw, tc = goss_masks(torch.from_numpy(g), torch.from_numpy(h),
                        torch.from_numpy(valid),
                        threefry.fold_in(threefry.prng_key(11), 4), top_k,
                        other_k, multiply)
    np.testing.assert_array_equal(tw.numpy().view(np.int32),
                                  np.asarray(jw).view(np.int32))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    kept = int(tc.sum())
    assert kept >= top_k + other_k
    if not ties:
        assert kept == top_k + other_k


@pytest.mark.parametrize("classes", [2, 3])
def test_goss_models_match_jax(classes):
    """Both packages trained side by side over the warm-up and four
    sampled iterations: after each, the count column (the selection)
    is equal in original row order; the trees agree node for node."""
    X, y, w = _data(classes, classes)
    params = dict(GOSS, objective="binary") if classes == 2 else \
        dict(GOSS, objective="multiclass", num_class=classes)
    bj = lj.Booster(dict(params), lj.Dataset(X, label=y, weight=w))
    bt = lt.Booster(dict(params, device_type="cpu"),
                    lt.Dataset(X, label=y, weight=w))
    n = bt.train_set.binned.num_data
    for it in range(6):
        bj.update()
        bt.update()
        mt, mj = _count_bag(bt._engine), _count_bag(bj._engine)
        np.testing.assert_array_equal(mt, mj, err_msg="iteration %d" % it)
        if it < 2:
            assert mt[:n].sum() == n
        else:
            kept = bt._engine._goss_top_k + bt._engine._goss_other_k
            assert kept <= mt.sum() <= kept + 2
    bj._engine.flush()
    _assert_same_structure(bj, bt, X)
    np.testing.assert_allclose(bt.predict(X, raw_score=True),
                               bj.predict(X, raw_score=True), atol=1e-4)


def test_goss_frontier_writes_one_leaf_text():
    X, y, w = _data(5)
    params = dict(GOSS, objective="binary", num_leaves=31, device_type="cpu")
    one = lt.train(dict(params), lt.Dataset(X, label=y, weight=w), 5,
                   verbose_eval=False)
    front = lt.train(dict(params, tpu_frontier_batch=8),
                     lt.Dataset(X, label=y, weight=w), 5, verbose_eval=False)
    assert front.split_rounds_per_tree() < one.split_rounds_per_tree()
    assert front.model_to_string() == one.model_to_string()
    assert front.host_syncs_per_tree() == [1] * 5


@pytest.mark.parametrize("extra,match", [
    (dict(top_rate=0.7, other_rate=0.5), "larger than 1.0"),
    (dict(other_rate=0.0), "must be positive"),
    (dict(bagging_freq=1, bagging_fraction=0.5), "bagging in GOSS"),
])
def test_goss_config_checks(extra, match):
    X, y, _ = _data()
    with pytest.raises(lt.LightGBMError, match=match):
        lt.train(dict(GOSS, objective="binary", device_type="cpu", **extra),
                 lt.Dataset(X, label=y), 1, verbose_eval=False)


@pytest.mark.parametrize("objective", ["regression_l1", "quantile",
                                       "lambdarank"])
def test_goss_renewal_and_ranking_train(objective):
    """GOSS with leaf-output renewal or a query-coupled objective, which
    the JAX package trains on its masked grower, trains on the payload,
    drawing its selection over the rows in original order
    (tests/test_torch_masked.py holds them node for node against the JAX
    package)."""
    X, y, _ = _data()
    ds = lt.Dataset(X, label=np.floor(np.abs(y * 3)))
    if objective == "lambdarank":
        ds.set_group([20] * (N // 20))
    bst = lt.train(dict(GOSS, objective=objective, device_type="cpu"), ds, 3,
                   verbose_eval=False)
    assert bst._engine._fast_active
    assert bst._engine.draws_in_original_order()
    assert bst.current_iteration() == 3 and bst._model.trees[0].num_leaves > 1
    counts = [int(t.internal_count[0]) for t in bst._model.trees]
    # quantile's |g h| takes two values here, and the top-k threshold
    # falls on the smaller one: every row ties in
    assert counts[:2] == [N, N] and (counts[2] < N) == (objective
                                                        != "quantile")


def test_goss_custom_gradients_train():
    """A custom objective's gradients under GOSS train on the payload,
    sampled from the third iteration on, drawn in original order."""
    X, y, _ = _data()
    bst = lt.Booster(dict(GOSS, objective="binary", device_type="cpu"),
                     lt.Dataset(X, label=y))

    def fobj(preds, ds):
        p = 1.0 / (1.0 + np.exp(-preds))
        return p - ds.get_label(), p * (1.0 - p)

    for _ in range(3):
        bst.update(fobj=fobj)
    assert bst._engine._fast_active
    assert bst._engine.draws_in_original_order(custom=True)
    assert not bst._engine.draws_in_original_order()
    counts = [int(t.internal_count[0]) for t in bst._model.trees]
    assert counts[:2] == [N, N] and counts[2] < N


def test_goss_quantization_trains_f32_with_warning(capsys):
    """gradient_quantization under GOSS: the JAX package's warning, and
    the f32 model."""
    X, y, w = _data(2)
    params = dict(GOSS, objective="binary", device_type="cpu")
    quant = lt.train(dict(params, gradient_quantization=True, verbose=0),
                     lt.Dataset(X, label=y, weight=w), 4, verbose_eval=False)
    assert "training with f32 gradients" in capsys.readouterr().out
    assert quant.quant_report is None
    f32 = lt.train(dict(params), lt.Dataset(X, label=y, weight=w), 4,
                   verbose_eval=False)
    assert quant.model_to_string().split("end of trees")[0] == \
        f32.model_to_string().split("end of trees")[0]
