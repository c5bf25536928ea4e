"""Categorical features in the port's training, against the JAX package on
the CPU: the categorical split search (`_categorical_best`, one-hot and
sorted-subset modes) on the same histograms, and one tree of each grower
mode from the same payload (whole training runs:
tests/test_torch_categorical_train.py)."""
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
from lightgbm_tpu.ops import split as jsplit
from lightgbm_tpu_torch import convert
from lightgbm_tpu_torch.boosting import grower2 as tgrower2
from lightgbm_tpu_torch.ops import split as tsplit
from lightgbm_tpu_torch.ops.quantize import derive_qmax

# one intra-op thread: the pytest-xdist workers share the cores, and
# torch's OpenMP regions spin in their barriers when oversubscribed
torch.set_num_threads(1)

# -- the split search on the same histograms -------------------------------

F, B = 6, 64
SEARCH_KW = dict(l1=0.0, l2=0.5, max_delta_step=0.0, min_data_in_leaf=5,
                 min_sum_hessian_in_leaf=1e-3)
CAT_KW = dict(max_cat_threshold=32, cat_l2=10.0, cat_smooth=5.0,
              max_cat_to_onehot=4, min_data_per_group=10)

#: (search knobs, categorical knobs, num_bin of the categorical features,
#: their missing type, whether bins are made to tie exactly)
SEARCH_CASES = {
    "sorted": ({}, {}, (40, 25, 60), 0, False),
    "onehot": ({}, dict(max_cat_to_onehot=8), (3, 8, 5), 0, False),
    "mixed_modes": ({}, {}, (4, 30, 2), 0, False),
    "group_binds": ({}, dict(min_data_per_group=150), (40, 25, 60), 0,
                    False),
    "starved_right": (dict(min_data_in_leaf=300), {}, (40, 25, 60), 0,
                      False),
    "ties": ({}, {}, (40, 25, 60), 0, True),
    "nan_missing": ({}, {}, (41, 26, 61), 2, False),
    "few_cats": ({}, dict(max_cat_threshold=4), (40, 25, 60), 0, False),
    "l1_mds": (dict(l1=0.4, max_delta_step=0.3), {}, (40, 25, 60), 0,
               False),
}


def _search_problem(seed, cat_bins, missing, ties, n=1200):
    """A [F, B, 3] histogram made from rows (every row in one bin of each
    feature), with features 0, 2 and 4 categorical, and its meta."""
    rng = np.random.default_rng(seed)
    num_bin = np.array([cat_bins[0], 30, cat_bins[1], 17, cat_bins[2], 50],
                       np.int32)
    is_cat = np.array([True, False, True, False, True, False])
    g = rng.standard_normal(n).astype(np.float32)
    h = rng.uniform(0.05, 0.25, n).astype(np.float32)
    hist = np.zeros((F, B, 3), np.float32)
    for f in range(F):
        # skewed categories: some bins fall below cat_smooth rows
        p = rng.dirichlet(np.full(num_bin[f], 0.6))
        bins = rng.choice(num_bin[f], n, p=p)
        np.add.at(hist[f, :, 0], bins, g)
        np.add.at(hist[f, :, 1], bins, h)
        np.add.at(hist[f, :, 2], bins, 1.0)
    if ties:
        # equal g / (h + cat_smooth) in several bins: the stable sort keeps
        # them in bin order
        for f in np.nonzero(is_cat)[0]:
            for b in (5, 9, 13):
                hist[f, b] = hist[f, 2]
    meta = dict(num_bin=num_bin,
                missing_type=np.where(is_cat, missing, 0).astype(np.int32),
                default_bin=np.zeros(F, np.int32),
                is_trivial=np.zeros(F, bool), is_categorical=is_cat,
                penalty=rng.uniform(0.5, 1.0, F).astype(np.float32),
                monotone=np.zeros(F, np.int32))
    c = hist[:, :, 2]
    return hist, np.float32(hist[0, :, 0].sum()), \
        np.float32(hist[0, :, 1].sum()), np.float32(c[0].sum()), meta


def _jmeta(meta):
    return jsplit.FeatureMeta(**{k: jnp.asarray(v) for k, v in meta.items()})


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("case", sorted(SEARCH_CASES))
def test_categorical_best_matches_jax(case, seed):
    skw, ckw, cat_bins, missing, ties = SEARCH_CASES[case]
    skw, ckw = dict(SEARCH_KW, **skw), dict(CAT_KW, **ckw)
    hist, sg, sh, n, meta = _search_problem(seed, cat_bins, missing, ties)
    total_h = np.float32(sh + 2 * tsplit.K_EPSILON)
    cat_mask = meta["is_categorical"]
    ref = jsplit._categorical_best(
        *[jnp.asarray(hist[:, :, i]) for i in range(3)], jnp.float32(sg),
        jnp.float32(total_h), jnp.float32(n), jnp.asarray(cat_mask),
        meta=_jmeta(meta), **skw, **ckw)
    got = tsplit._categorical_best(
        *[torch.from_numpy(hist[None, :, :, i].copy()) for i in range(3)],
        torch.tensor([sg]), torch.tensor([total_h]), torch.tensor([n]),
        torch.from_numpy(cat_mask), meta=convert.feature_meta_from_numpy(meta),
        **skw, **ckw)
    raw, bits, lg, lh, lc, sorted_mode = [np.asarray(a) for a in ref]
    graw, gbits, glg, glh, glc = [a[0].numpy() for a in got[:5]]
    np.testing.assert_array_equal(got[5].numpy(), sorted_mode)
    np.testing.assert_array_equal(gbits, bits)
    finite = np.isfinite(raw)
    np.testing.assert_array_equal(np.isfinite(graw), finite)
    assert finite[cat_mask].any()
    np.testing.assert_allclose(graw[finite], raw[finite], rtol=1e-6)
    for got_a, ref_a in ((glg, lg), (glh, lh), (glc, lc)):
        np.testing.assert_allclose(got_a[finite], ref_a[finite], rtol=1e-6,
                                   atol=1e-6 * np.abs(ref_a).max())
    if case == "onehot":
        assert not sorted_mode[cat_mask].any()
    if case == "mixed_modes":
        assert sorted_mode[cat_mask].any() and not sorted_mode[cat_mask].all()


def _assert_same_split(got, ref):
    for k in ("feature", "threshold_bin", "default_left", "is_cat",
              "cat_bitset"):
        np.testing.assert_array_equal(np.asarray(getattr(got, k)),
                                      np.asarray(getattr(ref, k)), err_msg=k)
    for k in ("gain", "left_sum_g", "left_sum_h", "left_count",
              "left_output", "right_output"):
        r = np.asarray(getattr(ref, k), np.float64)
        np.testing.assert_allclose(np.asarray(getattr(got, k), np.float64),
                                   r, rtol=1e-5, atol=1e-6 * max(1.0, abs(r)),
                                   err_msg=k)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("case", ["sorted", "onehot", "mixed_modes", "ties",
                                  "nan_missing"])
def test_find_best_split_with_categories_matches_jax(case, seed):
    skw, ckw, cat_bins, missing, ties = SEARCH_CASES[case]
    skw = dict(SEARCH_KW, min_gain_to_split=0.0, **skw)
    ckw = dict(CAT_KW, **ckw)
    hist, sg, sh, n, meta = _search_problem(seed, cat_bins, missing, ties)
    fmask = np.ones(F, bool)
    ref = jsplit.find_best_split(jnp.asarray(hist), sg, sh, n,
                                 jnp.asarray(fmask), meta=_jmeta(meta),
                                 with_categorical=True, **skw, **ckw)
    got = tsplit.find_best_split(torch.from_numpy(hist), float(sg), float(sh),
                                 float(n), torch.from_numpy(fmask),
                                 meta=convert.feature_meta_from_numpy(meta),
                                 with_categorical=True, **skw, **ckw)
    _assert_same_split(got, ref)


def test_categorical_search_same_bits_at_any_q():
    """A histogram's row of the batched search is the same bits at Q = 1
    and Q = 4 (the frontier's byte identity rests on it)."""
    skw = dict(SEARCH_KW, min_gain_to_split=0.0)
    probs = [_search_problem(s, (40, 25, 60), 0, s == 3) for s in range(4)]
    meta = convert.feature_meta_from_numpy(probs[0][4])
    hists = torch.from_numpy(np.stack([p[0] for p in probs]))
    sums = [torch.tensor([p[i] for p in probs]) for i in (1, 2, 3)]
    fmask = torch.ones(F, dtype=torch.bool)
    batched = tsplit.find_best_split_batched(hists, *sums, fmask, meta=meta,
                                             with_categorical=True, **skw,
                                             **CAT_KW)
    assert batched.is_cat.any()
    for q in range(4):
        one = tsplit.find_best_split_batched(
            hists[q:q + 1], *[s[q:q + 1] for s in sums], fmask, meta=meta,
            with_categorical=True, **skw, **CAT_KW)
        for k, a, b in zip(one._fields, one, batched):
            assert a[0].numpy().tobytes() == b[q].numpy().tobytes(), k


def test_search_without_categories_is_the_numerical_search():
    """with_categorical on a meta with no categorical feature gives the
    numerical search's bits: a grower without categories is unchanged."""
    skw = dict(SEARCH_KW, min_gain_to_split=0.0)
    hist, sg, sh, n, meta = _search_problem(5, (40, 25, 60), 0, False)
    meta["is_categorical"][:] = False
    args = (torch.from_numpy(hist), float(sg), float(sh), float(n),
            torch.ones(F, dtype=torch.bool))
    tm = convert.feature_meta_from_numpy(meta)
    on = tsplit.find_best_split(*args, meta=tm, with_categorical=True, **skw,
                                **CAT_KW)
    off = tsplit.find_best_split(*args, meta=tm, **skw)
    for k, a, b in zip(on._fields, on, off):
        assert a.numpy().tobytes() == b.numpy().tobytes(), k


# -- one tree of each grower mode from the same payload --------------------

GN, GF = 1500, 5
CAT_COLS = [0, 1]


def _grower_problem(seed, max_bin=63):
    """Two categorical columns (30 and 3 categories, per-level effects not
    monotone in the level id) and three numeric ones, binned by the JAX
    package, and a payload with seeded gradients."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((GN, GF))
    X[:, 0] = rng.integers(0, 30, GN)
    X[:, 1] = rng.integers(0, 3, GN)
    # the categorical effect dominates: the root splits on a category
    eff = 2.0 * rng.standard_normal(30)
    y = (eff[X[:, 0].astype(int)] + 0.5 * X[:, 1] + X[:, 2]
         + 0.3 * rng.standard_normal(GN) > 0).astype(np.float32)
    ds = JBinnedDataset.from_matrix(X, JConfig(dict(max_bin=max_bin,
                                                    verbose=-1)),
                                    categorical_feature=CAT_COLS)
    G, n_pad = ds.bins.shape
    P = G + 10
    pay = np.zeros((n_pad + jseg.GUARD, P), np.float32)
    pay[:n_pad, :G] = ds.bins.T
    pay[:GN, G] = y
    pay[:GN, G + 1] = 1.0
    pay[:GN, G + 2] = 1.0
    pay[:, G + 3] = n_pad
    pay[:n_pad, G + 3] = np.arange(n_pad)
    p = 1.0 / (1.0 + np.exp(-rng.standard_normal(GN) * 0.3))
    w = rng.uniform(0.5, 1.5, GN)
    pay[:GN, G + 5] = ((p - y) * w).astype(np.float32)
    pay[:GN, G + 6] = (p * (1 - p) * w).astype(np.float32)
    pay[:GN, G + 8] = 1.0
    cols = dict(grad=G + 5, hess=G + 6, cnt=G + 2, value=G + 7)
    return ds, pay, cols


def _grower_cfg(**extra):
    return dict(dict(num_leaves=15, max_depth=-1, lambda_l1=0.0,
                     lambda_l2=0.0, max_delta_step=0.0, min_data_in_leaf=20,
                     min_sum_hessian_in_leaf=1e-3, min_gain_to_split=0.0,
                     with_categorical=True, min_data_per_group=20,
                     cat_smooth=5.0), **extra)


def _quantize(pay, cols, qmax, seed):
    rng = np.random.default_rng(seed)
    pay = pay.copy()
    scale = np.array([np.abs(pay[:, cols["grad"]]).max() / qmax,
                      pay[:, cols["hess"]].max() / qmax], np.float32)
    for col, sc, lo in ((cols["grad"], scale[0], -qmax),
                        (cols["hess"], scale[1], 0)):
        x = pay[:, col] / sc
        pay[:, col] = np.clip(np.floor(x + rng.random(len(x))), lo, qmax)
    return pay, scale


def _grow(pkg, ds, pay, cols, cfg, qscale=None, quant=None):
    meta = _feature_meta_device(ds)
    quant = quant or {}
    if pkg == "jax":
        grow = jgrower2.make_partitioned_grower(
            meta, JGrowerConfig(**cfg), ds.max_num_bin,
            jgrower2.PayloadCols(**cols), GF, **quant)
        args = (jnp.asarray(pay), jnp.zeros_like(jnp.asarray(pay)),
                jnp.ones(GF, bool))
        if qscale is not None:
            args += (jnp.asarray(qscale),)
        tree, out, _ = grow(*args)
        return {k: np.asarray(v) for k, v in tree.items()}, np.asarray(out)
    grow = tgrower2.make_partitioned_grower(
        convert.feature_meta_from_numpy(meta),
        tgrower2.GrowerConfig(**cfg, **quant), ds.max_num_bin,
        tgrower2.PayloadCols(**cols), GF)
    tpay = convert.payload_from_numpy(pay)
    args = (tpay, torch.zeros_like(tpay), torch.ones(GF, dtype=torch.bool))
    if qscale is not None:
        args += (convert.qscale_from_numpy(qscale),)
    tree, out, _ = grow(*args)
    return ({k: v.numpy() if isinstance(v, torch.Tensor) else v
             for k, v in tree.items()}, convert.payload_to_numpy(out))


def _assert_grown_alike(jt, jpay, tt, tpay, cols, root_cat=True):
    nl = int(jt["num_leaves"])
    assert int(tt["num_leaves"]) == nl > 4
    ni = nl - 1
    # the root's bitset is the first the partition reads
    assert jt["split_is_cat"][0] if root_cat else jt["split_is_cat"].any()
    for k in ("split_feature", "split_is_cat", "left_child", "right_child",
              "internal_count"):
        np.testing.assert_array_equal(tt[k][:ni], jt[k][:ni], err_msg=k)
    cat = jt["split_is_cat"][:ni].astype(bool)
    np.testing.assert_array_equal(tt["split_bin"][:ni][~cat],
                                  jt["split_bin"][:ni][~cat])
    np.testing.assert_array_equal(tt["split_cat_bitset"][:ni],
                                  jt["split_cat_bitset"][:ni])
    np.testing.assert_array_equal(tt["leaf_count"][:nl], jt["leaf_count"][:nl])
    for k in ("leaf_value", "leaf_sum_g", "leaf_sum_h"):
        ref = jt[k][:nl]
        np.testing.assert_allclose(tt[k][:nl], ref, rtol=1e-5,
                                   atol=1e-5 * np.abs(ref).max(), err_msg=k)
    keep = np.arange(jpay.shape[1]) != cols["value"]
    np.testing.assert_array_equal(tpay[:, keep], jpay[:, keep])


# int8's coarse grid makes mirrored one-hot candidates common (a leaf with
# two nonempty categories: left = a, right = b or left = b, right = a, the
# same partition with the same gain), and the two frameworks break such an
# exact tie by the ulps of their sums (ROADMAP queue C); int8 training is
# held to the one-leaf loop below instead
@pytest.mark.parametrize("mode", ["one_leaf", "pooled", "frontier4",
                                  "quant_int16", "onehot_only"])
def test_tree_matches_jax_grower(mode):
    ds, pay, cols = _grower_problem(3)
    cfg, quant, qscale = _grower_cfg(), None, None
    if mode == "pooled":
        cfg["hist_pool_slots"] = 4
    elif mode == "frontier4":
        cfg["frontier_batch"] = 4
    elif mode.startswith("quant"):
        qmax = derive_qmax(pay.shape[0], mode.split("_")[1])
        pay, qscale = _quantize(pay, cols, qmax, 3)
        quant = dict(quantized=True, qmax=qmax)
    elif mode == "onehot_only":
        cfg["max_cat_to_onehot"] = 64
    jt, jpay = _grow("jax", ds, pay, cols, cfg, qscale, quant)
    tt, tpay = _grow("torch", ds, pay, cols, cfg, qscale, quant)
    _assert_grown_alike(jt, jpay, tt, tpay, cols,
                        root_cat=mode != "onehot_only")
    if mode == "frontier4":
        assert int(tt["split_rounds"]) == int(jt["split_rounds"])


@pytest.mark.parametrize("fb,quantized", [(4, False), (8, False), (8, True)])
def test_frontier_tree_is_the_one_leaf_tree(fb, quantized):
    ds, pay, cols = _grower_problem(4)
    qscale, quant = None, None
    if quantized:
        pay, qscale = _quantize(pay, cols, 127, 4)
        quant = dict(quantized=True, qmax=127)
    t1, p1 = _grow("torch", ds, pay, cols, _grower_cfg(), qscale, quant)
    tk, pk = _grow("torch", ds, pay, cols, _grower_cfg(frontier_batch=fb),
                   qscale, quant)
    assert t1["split_is_cat"][0]
    for k, v in t1.items():
        if k not in ("split_rounds", "host_syncs"):
            np.testing.assert_array_equal(tk[k], v, err_msg=k)
    assert pk.tobytes() == p1.tobytes()
    assert tk["split_rounds"] < t1["split_rounds"]
