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

# one intra-op thread: the pytest-xdist workers share the cores, and
# torch's OpenMP regions spin in their barriers when oversubscribed
torch.set_num_threads(1)

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


def _grower_kw(case):
    return dict(
        num_leaves=case["num_leaves"], max_depth=case["max_depth"],
        lambda_l1=0.0, lambda_l2=case.get("lambda_l2", 0.0),
        max_delta_step=0.0, min_data_in_leaf=case.get("min_data_in_leaf", 20),
        min_sum_hessian_in_leaf=1e-3, min_gain_to_split=0.0)


def _grow_both(case, pay, cols, ds, jextra=None, textra=None, qscale=None):
    """One tree from the same payload through the JAX grower and the
    port's; returns (jtree, jpay, ttree, tpay)."""
    jmeta = _feature_meta_device(ds)
    jextra, textra = dict(jextra or {}), dict(textra or {})
    jquant = {k: jextra.pop(k) for k in ("quantized", "qmax") if k in jextra}
    jgrow = jgrower2.make_partitioned_grower(
        jmeta, JGrowerConfig(**_grower_kw(case), **jextra), ds.max_num_bin,
        jgrower2.PayloadCols(**cols), F, **jquant)
    fmask = np.ones(F, bool)
    jargs = (jnp.asarray(pay), jnp.zeros_like(jnp.asarray(pay)),
             jnp.asarray(fmask))
    if qscale is not None:
        jargs += (jnp.asarray(qscale),)
    jtree, jpay, _ = jgrow(*jargs)

    tgrow = tgrower2.make_partitioned_grower(
        convert.feature_meta_from_numpy(jmeta),
        tgrower2.GrowerConfig(**_grower_kw(case), **textra), ds.max_num_bin,
        tgrower2.PayloadCols(**cols), F)
    tpay = convert.payload_from_numpy(pay)
    targs = (tpay, torch.zeros_like(tpay), torch.from_numpy(fmask))
    if qscale is not None:
        targs += (convert.qscale_from_numpy(qscale),)
    ttree, tpay, _ = tgrow(*targs)
    return jtree, np.asarray(jpay), ttree, convert.payload_to_numpy(tpay)


def _assert_trees_match(jtree, jpay, ttree, tpay, cols):
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
    v = cols["value"]
    keep = np.arange(jpay.shape[1]) != v
    np.testing.assert_array_equal(tpay[:, keep], jpay[:, keep])
    close(tpay[:, v], jpay[:, v], "value column")


@pytest.mark.parametrize("case", CASES)
def test_tree_matches_jax_grower(case):
    X, y = _problem(case["seed"], case["nan_frac"])
    jcfg = JConfig(dict(max_bin=case["max_bin"], verbose=-1))
    ds = JBinnedDataset.from_matrix(X, jcfg)
    pay, cols = _payload(ds, y, case["seed"])
    jtree, jpay, ttree, tpay = _grow_both(case, pay, cols, ds)
    _assert_trees_match(jtree, jpay, ttree, tpay, cols)
    nl = int(jtree["num_leaves"])
    # the tree is one device program: the grower never reads the device
    assert ttree["host_syncs"] == 0
    assert ttree["split_rounds"] == nl - 1


def _quantize_columns(pay, cols, qmax, seed):
    """Integer-valued grad/hess columns on the grid of half-range qmax
    (numpy stochastic rounding) and their [2] f32 scales: the state the
    quantized fill leaves, made once and handed to both packages."""
    rng = np.random.default_rng(seed)
    pay = pay.copy()
    g, h = pay[:, cols["grad"]], pay[:, cols["hess"]]
    scale = np.array([np.abs(g).max() / qmax, h.max() / qmax], np.float32)
    for col, sc, lo in ((cols["grad"], scale[0], -qmax),
                        (cols["hess"], scale[1], 0)):
        x = pay[:, col] / sc
        pay[:, col] = np.clip(np.floor(x + rng.random(len(x))), lo, qmax)
    return pay, scale


@pytest.mark.parametrize("qmax", [127, 2114])
@pytest.mark.parametrize("case", CASES[:3])
def test_quantized_tree_matches_jax_grower(case, qmax):
    X, y = _problem(case["seed"], case["nan_frac"])
    ds = JBinnedDataset.from_matrix(X, JConfig(dict(max_bin=case["max_bin"],
                                                    verbose=-1)))
    pay, cols = _payload(ds, y, case["seed"])
    pay, qscale = _quantize_columns(pay, cols, qmax, case["seed"])
    quant = dict(quantized=True, qmax=qmax)
    jtree, jpay, ttree, tpay = _grow_both(case, pay, cols, ds, jextra=quant,
                                          textra=quant, qscale=qscale)
    _assert_trees_match(jtree, jpay, ttree, tpay, cols)


def _grow_port(case, pay, cols, ds, qscale=None, **extra):
    grow = tgrower2.make_partitioned_grower(
        convert.feature_meta_from_numpy(_feature_meta_device(ds)),
        tgrower2.GrowerConfig(**_grower_kw(case), **extra), ds.max_num_bin,
        tgrower2.PayloadCols(**cols), F)
    tpay = convert.payload_from_numpy(pay)
    args = (tpay, torch.zeros_like(tpay), torch.ones(F, dtype=torch.bool))
    if qscale is not None:
        args += (convert.qscale_from_numpy(qscale),)
    tree, tpay, _ = grow(*args)
    return tree, convert.payload_to_numpy(tpay)


FRONTIER_CASES = [(dict(CASES[0]), 4), (dict(CASES[1]), 4), (dict(CASES[1]), 8),
                  (dict(CASES[2]), 8),
                  (dict(CASES[0], num_leaves=15, nan_frac=0.1), 14)]


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("case,fb", FRONTIER_CASES)
def test_frontier_grower_bit_identical_to_one_leaf_loop(case, fb, quantized):
    """Every output array and the payload bytes of the frontier-batched
    grower equal the one-leaf loop's (tests/test_frontier_batch.py:87-117
    for the port); it takes fewer rounds, and neither reads the device."""
    X, y = _problem(case["seed"], case["nan_frac"])
    ds = JBinnedDataset.from_matrix(X, JConfig(dict(max_bin=case["max_bin"],
                                                    verbose=-1)))
    pay, cols = _payload(ds, y, case["seed"])
    qscale, quant = None, {}
    if quantized:
        pay, qscale = _quantize_columns(pay, cols, 127, case["seed"])
        quant = dict(quantized=True, qmax=127)
    t1, p1 = _grow_port(case, pay, cols, ds, qscale, **quant)
    tk, pk = _grow_port(case, pay, cols, ds, qscale, frontier_batch=fb,
                        **quant)
    assert t1["num_leaves"] > 4
    for k, v in t1.items():
        if k in ("split_rounds", "host_syncs"):
            continue
        got = tk[k].numpy() if isinstance(tk[k], torch.Tensor) else tk[k]
        ref = v.numpy() if isinstance(v, torch.Tensor) else v
        np.testing.assert_array_equal(got, ref, err_msg=k)
    # row order feeds every later tree's sums: an uncommitted staged
    # candidate must leave its rows as they were
    assert pk.tobytes() == p1.tobytes()
    assert tk["split_rounds"] < t1["split_rounds"] == t1["num_leaves"] - 1
    assert tk["host_syncs"] == t1["host_syncs"] == 0


def test_frontier_tree_matches_jax_frontier_grower():
    case = CASES[1]
    X, y = _problem(case["seed"], case["nan_frac"])
    ds = JBinnedDataset.from_matrix(X, JConfig(dict(max_bin=case["max_bin"],
                                                    verbose=-1)))
    pay, cols = _payload(ds, y, case["seed"])
    fb = dict(frontier_batch=4)
    jtree, jpay, ttree, tpay = _grow_both(case, pay, cols, ds, jextra=fb,
                                          textra=fb)
    _assert_trees_match(jtree, jpay, ttree, tpay, cols)
    assert ttree["split_rounds"] == int(jtree["split_rounds"])


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
