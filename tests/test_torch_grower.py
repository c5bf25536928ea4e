"""One tree grown by the port's partitioned grower against the JAX
package's, from the same payload carried across with convert.py."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from lightgbm_tpu.boosting import grower2 as jgrower2
from lightgbm_tpu.boosting.gbdt import _feature_meta_device
from lightgbm_tpu.boosting.grower import GrowerConfig as JGrowerConfig
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.io.dataset import BinnedDataset as JBinnedDataset
from lightgbm_tpu.ops import segment as jseg
from lightgbm_tpu_torch import convert
from lightgbm_tpu_torch.boosting import grower2 as tgrower2

N, F = 1500, 6


def _problem(seed, nan_frac):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((N, F))
    X[rng.random((N, F)) < nan_frac] = np.nan
    X[:, 3] = np.round(X[:, 3])          # few distinct values, zeros
    y = (np.nan_to_num(X[:, 0]) + 0.7 * np.nan_to_num(X[:, 1])
         * np.nan_to_num(X[:, 2]) + 0.4 * rng.standard_normal(N) > 0)
    return X, y.astype(np.float32)


def _payload(ds, y, seed):
    """The fast-path payload for K = 1 (gbdt._FastState layout) with
    seeded gradients in the grad/hess columns."""
    G, n_pad = ds.bins.shape
    P = G + 10
    rng = np.random.default_rng(seed)
    pay = np.zeros((n_pad + jseg.GUARD, P), np.float32)
    pay[:n_pad, :G] = ds.bins.T
    pay[:N, G] = y
    pay[:N, G + 1] = 1.0
    pay[:N, G + 2] = 1.0                       # cnt
    pay[:, G + 3] = n_pad                      # idx (guard rows: dead slot)
    pay[:n_pad, G + 3] = np.arange(n_pad)
    p = 1.0 / (1.0 + np.exp(-rng.standard_normal(N) * 0.3))
    pay[:N, G + 5] = (p - y).astype(np.float32)          # grad
    pay[:N, G + 6] = (p * (1 - p)).astype(np.float32)    # hess
    pay[:N, G + 8] = 1.0                       # bvalid
    cols = dict(grad=G + 5, hess=G + 6, cnt=G + 2, value=G + 7)
    return pay, cols


CASES = [
    dict(seed=0, nan_frac=0.0, num_leaves=15, max_depth=-1, max_bin=63),
    dict(seed=1, nan_frac=0.1, num_leaves=31, max_depth=-1, max_bin=63),
    dict(seed=2, nan_frac=0.05, num_leaves=31, max_depth=4, max_bin=31),
    dict(seed=3, nan_frac=0.0, num_leaves=7, max_depth=-1, max_bin=255,
         lambda_l2=1.0, min_data_in_leaf=50),
]


@pytest.mark.parametrize("case", CASES)
def test_tree_matches_jax_grower(case):
    X, y = _problem(case["seed"], case["nan_frac"])
    jcfg = JConfig(dict(max_bin=case["max_bin"], verbose=-1))
    ds = JBinnedDataset.from_matrix(X, jcfg)
    pay, cols = _payload(ds, y, case["seed"])
    grower_kw = dict(
        num_leaves=case["num_leaves"], max_depth=case["max_depth"],
        lambda_l1=0.0, lambda_l2=case.get("lambda_l2", 0.0),
        max_delta_step=0.0, min_data_in_leaf=case.get("min_data_in_leaf", 20),
        min_sum_hessian_in_leaf=1e-3, min_gain_to_split=0.0)
    jmeta = _feature_meta_device(ds)
    jgrow = jgrower2.make_partitioned_grower(
        jmeta, JGrowerConfig(**grower_kw), ds.max_num_bin,
        jgrower2.PayloadCols(**cols), F)
    fmask = np.ones(F, bool)
    jtree, jpay, _ = jgrow(jnp.asarray(pay), jnp.zeros_like(jnp.asarray(pay)),
                           jnp.asarray(fmask))

    tgrow = tgrower2.make_partitioned_grower(
        convert.feature_meta_from_numpy(jmeta),
        tgrower2.GrowerConfig(**grower_kw), ds.max_num_bin,
        tgrower2.PayloadCols(**cols), F)
    tpay = convert.payload_from_numpy(pay)
    ttree, tpay, _ = tgrow(tpay, torch.zeros_like(tpay),
                           torch.from_numpy(fmask))

    nl = int(jtree["num_leaves"])
    assert ttree["num_leaves"] == nl > 2
    ni = nl - 1
    # default_left is left out: where a leaf holds no missing rows the two
    # scan directions tie, and ulps of the two searches pick the winner;
    # the rows route the same either way (the payload check below)
    for k in ("split_feature", "split_bin", "left_child", "right_child"):
        np.testing.assert_array_equal(ttree[k][:ni].numpy(),
                                      np.asarray(jtree[k])[:ni], err_msg=k)
    for k in ("leaf_count", "seg_start", "seg_cnt"):
        np.testing.assert_array_equal(ttree[k][:nl].numpy(),
                                      np.asarray(jtree[k])[:nl], err_msg=k)
    np.testing.assert_array_equal(ttree["internal_count"][:ni].numpy(),
                                  np.asarray(jtree["internal_count"])[:ni])
    # f32 values: rtol 1e-5, and an atol of 1e-5 of the largest entry.
    # The histograms agree bit for bit, but XLA's CPU reduce and cumsum
    # add in another order than torch.sum / torch.cumsum, so leaf totals
    # differ by ulps of their parent's sums; a leaf whose gradient sum
    # cancels carries that as a larger relative error.
    def close(got, ref, name):
        np.testing.assert_allclose(got, ref, rtol=1e-5,
                                   atol=1e-5 * np.abs(ref).max(),
                                   err_msg=name)

    for k in ("leaf_value", "leaf_sum_g", "leaf_sum_h"):
        close(ttree[k][:nl].numpy(), np.asarray(jtree[k])[:nl], k)
    for k in ("split_gain", "internal_value"):
        close(ttree[k][:ni].numpy(), np.asarray(jtree[k])[:ni], k)
    # the rows end in the same order; only the leaf-value column carries
    # the f32 arithmetic of the two searches
    got, ref = convert.payload_to_numpy(tpay), np.asarray(jpay)
    v = cols["value"]
    keep = np.arange(pay.shape[1]) != v
    np.testing.assert_array_equal(got[:, keep], ref[:, keep])
    close(got[:, v], ref[:, v], "value column")
    assert ttree["host_syncs"] == min(nl, case["num_leaves"] - 1)


def test_stump_when_nothing_splits():
    X, y = _problem(0, 0.0)
    ds = JBinnedDataset.from_matrix(X, JConfig(dict(max_bin=15,
                                                    verbose=-1)))
    pay, cols = _payload(ds, y, 0)
    jmeta = _feature_meta_device(ds)
    grow = tgrower2.make_partitioned_grower(
        convert.feature_meta_from_numpy(jmeta),
        tgrower2.GrowerConfig(num_leaves=8, max_depth=-1, lambda_l1=0.0,
                              lambda_l2=0.0, max_delta_step=0.0,
                              min_data_in_leaf=N, min_sum_hessian_in_leaf=1e-3,
                              min_gain_to_split=0.0),
        ds.max_num_bin, tgrower2.PayloadCols(**cols), F)
    tpay = convert.payload_from_numpy(pay)
    tree, tpay, _ = grow(tpay, torch.zeros_like(tpay), torch.ones(F, dtype=bool))
    assert tree["num_leaves"] == 1
    g, h = pay[:N, cols["grad"]].sum(), pay[:N, cols["hess"]].sum()
    np.testing.assert_allclose(float(tree["leaf_value"][0]), -g / h,
                               rtol=1e-4)
    assert set(tgrower2.TREE_DEVICE_FIELDS) <= set(tree)
