"""The wide row-index layout in the port on the CPU: past 2^24 rows the
payload's f32 index column splits into radix-4096 (hi, lo) halves
(gbdt._IDX_WIDE_THRESHOLD, _IDX_RADIX, as in the JAX package).  Forcing
that layout at small N (the module constant, as
tests/test_fast_path_bagging.py:199-214 forces the JAX one) must give the
narrow layout's model text byte for byte through every reader and writer
of the index: the bag refresh, leaf renewal, lambdarank's original-order
fill, the multiclass snapshot, GOSS, a custom objective's gather, the
rollback rebuild and the score fetch; and the port's forced wide model
must match the JAX package's forced wide model node for node."""
import numpy as np
import pytest
import torch

import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt
from lightgbm_tpu.boosting import gbdt as jgbdt
from lightgbm_tpu_torch import convert
from lightgbm_tpu_torch.boosting import gbdt as tgbdt

from test_torch_train import _assert_same_structure

# one intra-op thread: the pytest-xdist workers share the cores, and
# torch's OpenMP regions spin in their barriers when oversubscribed
torch.set_num_threads(1)

N, F = 1500, 6
BASE = dict(num_leaves=15, max_bin=63, verbose=-1, seed=11,
            device_type="cpu")


def _data(seed=0):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((N, F))
    z = X[:, 0] + 0.5 * X[:, 1] * X[:, 2] + 0.3 * rng.standard_normal(N)
    w = rng.uniform(0.5, 1.5, N)
    return X, z, w


def _logloss_fobj(preds, dataset):
    y = dataset.get_label()
    p = 1.0 / (1.0 + np.exp(-preds))
    return p - y, p * (1.0 - p)


def _case(name):
    """The training run of one case."""
    X, z, w = _data()
    yb = (z > 0).astype(np.float64)
    if name == "bagging":
        params = dict(objective="binary", bagging_fraction=0.7,
                      bagging_freq=2)
        make = lambda: lt.Dataset(X, label=yb, weight=w)  # noqa: E731
    elif name == "l1_renewal":
        params = dict(objective="regression_l1", min_gain_to_split=0.01,
                      bagging_fraction=0.8, bagging_freq=1)
        make = lambda: lt.Dataset(X, label=z)  # noqa: E731
    elif name == "lambdarank":
        rel = np.clip(np.floor(z + 1.5), 0, 4)
        params = dict(objective="lambdarank", metric="ndcg", eval_at=[3])

        def make():
            ds = lt.Dataset(X, label=rel)
            ds.set_group([30] * (N // 30))
            return ds
    elif name == "multiclass":
        y3 = np.digitize(z, np.quantile(z, [1 / 3, 2 / 3])).astype(float)
        params = dict(objective="multiclass", num_class=3)
        make = lambda: lt.Dataset(X, label=y3, weight=w)  # noqa: E731
    elif name == "goss":
        params = dict(objective="binary", boosting="goss", learning_rate=0.5)
        make = lambda: lt.Dataset(X, label=yb, weight=w)  # noqa: E731
    elif name == "custom_fobj":
        params = dict(objective="none")
        make = lambda: lt.Dataset(X, label=yb)  # noqa: E731
    else:
        params = dict(objective="binary", bagging_fraction=0.6,
                      bagging_freq=2)
        make = lambda: lt.Dataset(X, label=yb, weight=w)  # noqa: E731

    def drive():
        if name == "custom_fobj":
            return lt.train(dict(BASE, **params), make(), 5,
                            fobj=_logloss_fobj, verbose_eval=False)
        bst = lt.Booster(dict(BASE, **params), make())
        for _ in range(4):
            bst.update()
        if name == "rollback":
            bst.rollback_one_iter()
            bst.update()
            bst.update()
        return bst
    return drive


CASES = ["bagging", "l1_renewal", "lambdarank", "multiclass", "goss",
         "custom_fobj", "rollback"]


@pytest.mark.parametrize("name", CASES)
def test_wide_layout_matches_narrow(name, monkeypatch):
    drive = _case(name)
    narrow = drive()
    fs_n = narrow._engine._fast
    assert not fs_n.wide_idx
    monkeypatch.setattr(tgbdt, "_IDX_WIDE_THRESHOLD", 1)
    wide = drive()
    fs = wide._engine._fast
    assert fs.wide_idx and fs.P == fs_n.P + 1
    assert fs.idxhi_col == fs.P - 1
    assert wide.model_to_string() == narrow.model_to_string()
    np.testing.assert_array_equal(wide._engine.raw_train_score(),
                                  narrow._engine.raw_train_score())
    # the index halves: lo < 4096, and lo + 4096 * hi the original row
    pay = fs.payload.numpy()
    assert pay[:, fs.idx_col].max() < convert.IDX_RADIX
    np.testing.assert_array_equal(
        np.sort(fs.row_index().numpy()[:fs.n_pad]), np.arange(fs.n_pad))
    np.testing.assert_array_equal(
        convert.scores_from_payload(pay, fs.score0, fs.idx_col, fs.n_pad,
                                    num_class=fs.K, idxhi_col=fs.idxhi_col),
        convert.scores_from_payload(fs_n.payload.numpy(), fs_n.score0,
                                    fs_n.idx_col, fs_n.n_pad,
                                    num_class=fs_n.K))


def test_index_halves_past_radix(monkeypatch):
    """Rows past 4096 carry a non-zero high half: with 5,000 rows the
    payload's index columns decode to the original rows in every order
    the trees leave them, and the bag read back through convert."""
    monkeypatch.setattr(tgbdt, "_IDX_WIDE_THRESHOLD", 1)
    rng = np.random.default_rng(5)
    X = rng.standard_normal((5000, 4))
    y = (X[:, 0] + 0.3 * rng.standard_normal(5000) > 0).astype(float)
    bst = lt.train(dict(BASE, objective="binary", bagging_fraction=0.5,
                        bagging_freq=1), lt.Dataset(X, label=y), 3,
                   verbose_eval=False)
    fs = bst._engine._fast
    pay = fs.payload.numpy()
    assert pay[:fs.n_pad, fs.idxhi_col].max() == (fs.n_pad - 1) // 4096
    bag = convert.bag_mask_from_payload(pay, fs.cnt_col, fs.idx_col,
                                        fs.n_pad, idxhi_col=fs.idxhi_col)
    np.testing.assert_array_equal(bag, bst._engine.bag_mask_host)


def test_wide_layout_matches_jax(monkeypatch):
    """The port's forced wide model against the JAX package's forced wide
    model (its test's bagging configuration), node for node."""
    X, z, w = _data(3)
    y = (z > 0).astype(np.float64)
    params = dict(objective="binary", num_leaves=15, verbose=-1,
                  bagging_fraction=0.7, bagging_freq=2, seed=11)
    monkeypatch.setattr(jgbdt, "_IDX_WIDE_THRESHOLD", 1)
    monkeypatch.setattr(tgbdt, "_IDX_WIDE_THRESHOLD", 1)
    bj = lj.train(dict(params), lj.Dataset(X, label=y, weight=w), 6)
    bt = lt.train(dict(params, device_type="cpu"),
                  lt.Dataset(X, label=y, weight=w), 6, verbose_eval=False)
    bj._engine.flush()
    assert bj._engine._fast.wide_idx and bt._engine._fast.wide_idx
    _assert_same_structure(bj, bt, X)
    np.testing.assert_allclose(bt.predict(X, raw_score=True),
                               bj.predict(X, raw_score=True), atol=1e-5)
