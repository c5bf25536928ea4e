"""EFB-bundled training in the port against the JAX package on the CPU:
`expand_histogram` against the JAX one on real bundle maps (f32, and
int32 after dequantization), bundled training node for node on weighted
rows (tests/test_efb.py's perfectly exclusive _sparse_problem) in every
grower mode and boosting variant, the port's bundled model equivalent to
its unbundled one (conftest's assert_models_equivalent) in each of them,
a bundled validation set with early stopping, the Expo and Allstate
widths at 8,000 rows (tests/test_wide_sparse.py's G bounds) node for node
against the JAX package, and bundled lambdarank: node for node against
the JAX package on tie-free continuous columns, and equivalent to the
port's unbundled run on the low-cardinality sparse problem."""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt
from conftest import assert_models_equivalent
from lightgbm_tpu.boosting import grower2 as jgrower2
from lightgbm_tpu.boosting.gbdt import _feature_meta_device
from lightgbm_tpu.boosting.grower import GrowerConfig as JGrowerConfig
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.io.dataset import BinnedDataset as JBinnedDataset
from lightgbm_tpu.ops import segment as jseg
from lightgbm_tpu.ops.bundle import bundle_map_from_info as jax_bmap
from lightgbm_tpu.ops.bundle import expand_histogram as jax_expand
from lightgbm_tpu.ops.split import dequantize_hist as jax_deq
from lightgbm_tpu_torch import convert
from lightgbm_tpu_torch.boosting import grower2 as tgrower2
from lightgbm_tpu_torch.io.dataset import BinnedDataset
from lightgbm_tpu_torch.ops import cuda_segment
from lightgbm_tpu_torch.ops.bundle import (bundle_map_from_info,
                                           expand_histogram,
                                           histogram_expansion)
from lightgbm_tpu_torch.ops.split import dequantize_hist

from test_torch_grower import _assert_trees_match
from test_torch_rank_train import _ragged_rank
from test_torch_train import _assert_same_structure

# one intra-op thread: the pytest-xdist workers share the cores, and
# torch's OpenMP regions spin in their barriers when oversubscribed
torch.set_num_threads(1)

PARAMS = {"objective": "binary", "metric": "binary_logloss",
          "num_leaves": 15, "learning_rate": 0.1, "min_data_in_leaf": 20,
          "max_bin": 63, "verbose": -1}
CPU = dict(PARAMS, device_type="cpu")


def _sparse_problem(n=4000, blocks=6, per_block=6, seed=0):
    """tests/test_efb.py's: features in blocks, exactly one non-zero per
    row in each block (zero conflicts), low-cardinality values."""
    rng = np.random.default_rng(seed)
    X = np.zeros((n, blocks * per_block))
    logit = np.zeros(n)
    for b in range(blocks):
        which = rng.integers(0, per_block, size=n)
        vals = rng.integers(1, 8, size=n).astype(np.float64)
        X[np.arange(n), b * per_block + which] = vals
        logit += 0.3 * (which - per_block / 2) + 0.2 * vals * (which == 0)
    y = (logit + rng.standard_normal(n) * 0.5 > 0).astype(np.float32)
    return X, y


def _weights(n, seed=1):
    return np.random.default_rng(seed).uniform(0.5, 1.5, n)


def _onehot_problem(n, n_vars, cards, seed=0, noise_cols=0):
    """tests/test_wide_sparse.py's Allstate / Expo preprocessing shape."""
    rng = np.random.default_rng(seed)
    cols, logit = [], np.zeros(n)
    for v in range(n_vars):
        card = int(cards[v % len(cards)])
        which = rng.integers(0, card, size=n)
        block = np.zeros((n, card), np.float32)
        block[np.arange(n), which] = 1.0
        cols.append(block)
        if v % 7 == 0:
            logit += 0.4 * (which % 3 - 1)
    for _ in range(noise_cols):
        cols.append(rng.standard_normal((n, 1)).astype(np.float32))
    X = np.concatenate(cols, axis=1)
    y = (logit + rng.standard_normal(n) * 0.7 > 0).astype(np.float32)
    return X, y


def _widths(width, cards):
    n_vars, total = 0, 0
    while total < width - (8 if width < 1000 else 64):
        total += cards[n_vars % len(cards)]
        n_vars += 1
    return n_vars, width - total


@pytest.fixture(scope="module")
def sparse_binned():
    X, y = _sparse_problem()
    ds = BinnedDataset.from_matrix(X, lt.Config(dict(CPU)))
    assert ds.bundle_info is not None
    return ds


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("integral", [False, True])
def test_expand_histogram_matches_jax(sparse_binned, quantized, integral):
    """The [G, B, 3] -> [F, B, 3] views of random bundle histograms: the
    gathers bit for bit; the default bin (total - own, an f32 sum of up to
    B cells in each package's order) within rtol 1e-5 / atol 1e-4, and
    bit for bit where every cell is an integer (exact sums).  An int32
    histogram is dequantized first by each package (bit for bit)."""
    ds = sparse_binned
    G, B = ds.bins.shape[0], ds.max_num_bin
    rng = np.random.default_rng(3 + quantized + 2 * integral)
    if quantized:
        h = rng.integers(-500, 500, size=(G, B, 3)).astype(np.int32)
        h[..., 2] = np.abs(h[..., 2])
        scales = np.float32(0.0173), np.float32(0.0041)
        jh = jax_deq(jnp.asarray(h), *scales)
        th = dequantize_hist(torch.from_numpy(h), *scales)
        np.testing.assert_array_equal(th.numpy().view(np.int32),
                                      np.asarray(jh).view(np.int32))
        if integral:
            jh, th = jnp.asarray(h, jnp.float32), torch.from_numpy(
                h.astype(np.float32))
    else:
        h = (rng.integers(-300, 300, size=(G, B, 3)) if integral
             else rng.standard_normal((G, B, 3)) * 50).astype(np.float32)
        jh, th = jnp.asarray(h), torch.from_numpy(h)
    num_bin = np.asarray([m.num_bin for m in ds.bin_mappers], np.int32)
    default_bin = np.asarray([m.default_bin for m in ds.bin_mappers],
                             np.int32)
    ref = np.asarray(jax_expand(jh, jax_bmap(ds.bundle_info),
                                jnp.asarray(num_bin), jnp.asarray(default_bin),
                                B))
    tables = histogram_expansion(bundle_map_from_info(ds.bundle_info),
                                 torch.from_numpy(num_bin),
                                 torch.from_numpy(default_bin), B, B)
    got = expand_histogram(th, tables).numpy()
    assert got.shape == ref.shape == (ds.num_features, B, 3)
    if integral:
        np.testing.assert_array_equal(got, ref)
    else:
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-4)
        fix = tables.fix[..., 0].numpy()
        np.testing.assert_array_equal(got[~fix], ref[~fix])
    # a leading batch dimension (the frontier's stacked children)
    both = expand_histogram(torch.stack([th, th * 2]), tables).numpy()
    np.testing.assert_array_equal(both[0], got)


def _forced(tmp_path):
    path = tmp_path / "forced.json"
    path.write_text(json.dumps({"feature": 0, "threshold": 0.5,
                                "left": {"feature": 7, "threshold": 2.5}}))
    return {"forcedsplits_filename": str(path)}


MODES = {
    "plain": {},
    "bagging": dict(bagging_fraction=0.7, bagging_freq=1),
    "goss": dict(boosting="goss"),
    "dart": dict(boosting="dart"),
    "rf": dict(boosting="rf", bagging_fraction=0.6, bagging_freq=1,
               feature_fraction=0.8),
    "frontier8": dict(tpu_frontier_batch=8),
    "int8": dict(gradient_quantization=True, gradient_quant_dtype="int8"),
    "pool": dict(histogram_pool_size=0.05),
    "forced": "forced",
    "monotone": dict(monotone_constraints=[1, -1, 0, 0, 0, 0, 1]),
}


def _grow_bundled_both(quantized_seed):
    """One bundled tree from the same int8-quantized payload through the
    JAX grower and the port's (test_torch_grower's quantized case on the
    G storage columns): each package quantizes with its own random
    stream, so end-to-end int8 models are not comparable, but the same
    quantized columns must grow the same tree."""
    X, y = _sparse_problem()
    jds = JBinnedDataset.from_matrix(X, JConfig(dict(PARAMS)))
    tds = BinnedDataset.from_matrix(X, lt.Config(dict(CPU)))
    np.testing.assert_array_equal(jds.bins, tds.bins)
    G, n_pad = jds.bins.shape
    n, F = len(y), jds.num_features
    rng = np.random.default_rng(quantized_seed)
    pay = np.zeros((n_pad + jseg.GUARD, G + 10), np.float32)
    pay[:n_pad, :G] = jds.bins.T
    pay[:n, G] = y
    pay[:n, G + 1] = 1.0
    pay[:n, G + 2] = 1.0                       # cnt
    pay[:, G + 3] = n_pad                      # idx (guard rows: dead slot)
    pay[:n_pad, G + 3] = np.arange(n_pad)
    pay[:n, G + 8] = 1.0                       # bvalid
    cols = dict(grad=G + 5, hess=G + 6, cnt=G + 2, value=G + 7)
    p = 1.0 / (1.0 + np.exp(-rng.standard_normal(n) * 0.3))
    g, h = (p - y).astype(np.float32), (p * (1 - p)).astype(np.float32)
    qmax = 127
    scale = np.array([np.abs(g).max() / qmax, h.max() / qmax], np.float32)
    for col, v, sc, lo in ((cols["grad"], g, scale[0], -qmax),
                           (cols["hess"], h, scale[1], 0)):
        pay[:n, col] = np.clip(np.floor(v / sc + rng.random(n)), lo, qmax)
    kw = dict(num_leaves=15, max_depth=-1, lambda_l1=0.0, lambda_l2=0.0,
              max_delta_step=0.0, min_data_in_leaf=20,
              min_sum_hessian_in_leaf=1e-3, min_gain_to_split=0.0)
    jmeta = _feature_meta_device(jds)
    jgrow = jgrower2.make_partitioned_grower(
        jmeta, JGrowerConfig(**kw), jds.max_num_bin,
        jgrower2.PayloadCols(**cols), F, bundle_map=jax_bmap(jds.bundle_info),
        num_columns=G, quantized=True, qmax=qmax)
    fmask = np.ones(F, bool)
    jtree, jpay, _ = jgrow(jnp.asarray(pay), jnp.zeros_like(jnp.asarray(pay)),
                           jnp.asarray(fmask), jnp.asarray(scale))
    tgrow = tgrower2.make_partitioned_grower(
        convert.feature_meta_from_numpy(jmeta),
        tgrower2.GrowerConfig(**kw, quantized=True, qmax=qmax),
        jds.max_num_bin, tgrower2.PayloadCols(**cols), F,
        bundle_map=bundle_map_from_info(tds.bundle_info), num_columns=G)
    tpay = convert.payload_from_numpy(pay)
    ttree, tpay, _ = tgrow(tpay, torch.zeros_like(tpay),
                           torch.from_numpy(fmask),
                           convert.qscale_from_numpy(scale))
    return jtree, np.asarray(jpay), ttree, convert.payload_to_numpy(tpay), cols


@pytest.mark.parametrize("mode", sorted(MODES))
def test_bundled_training_matches_jax(mode, tmp_path):
    """Bundled training, port against JAX, node for node on weighted rows
    in every grower mode and boosting variant: the same bundles, splits,
    topology, leaf counts and routing; raw scores within 1e-5.  int8 is
    held tree for tree at the grower (`_grow_bundled_both`)."""
    if mode == "int8":
        _assert_trees_match(*_grow_bundled_both(quantized_seed=5))
        return
    X, y = _sparse_problem()
    w = _weights(len(y))
    extra = _forced(tmp_path) if MODES[mode] == "forced" else MODES[mode]
    bj = lj.train(dict(PARAMS, **extra), lj.Dataset(X, label=y, weight=w), 5)
    bt = lt.train(dict(CPU, **extra), lt.Dataset(X, label=y, weight=w), 5,
                  verbose_eval=False)
    bj._engine.flush()
    jb, tb = bj._engine.train_set, bt.train_set.binned
    assert [list(g) for g in jb.bundle_info.groups] == \
        [list(g) for g in tb.bundle_info.groups]
    np.testing.assert_array_equal(jb.bins, tb.bins)
    fs = bt._engine._fast
    assert fs.G == tb.bins.shape[0] < tb.num_features
    _assert_same_structure(bj, bt, X)
    np.testing.assert_allclose(bt.predict(X, raw_score=True),
                               bj.predict(X, raw_score=True), atol=1e-5)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_bundled_equivalent_to_unbundled(mode, tmp_path):
    """The port's bundled model against its unbundled one: the same
    structure, values within assert_models_equivalent's tolerances (a
    default bin is total - own in f32, not a summed bin).  The grower's
    histogram state stays [.., G, B, 3]; frontier 8 writes the one-leaf
    model's text byte for byte."""
    X, y = _sparse_problem(seed=2)
    extra = _forced(tmp_path) if MODES[mode] == "forced" else MODES[mode]
    params = dict(CPU, **extra)
    bundled = lt.train(dict(params), lt.Dataset(X, label=y), 5,
                       verbose_eval=False)
    plain = lt.train(dict(params, enable_bundle=False), lt.Dataset(X, label=y),
                     5, verbose_eval=False)
    G = bundled.train_set.binned.bins.shape[0]
    assert G < X.shape[1]
    assert plain.train_set.binned.bundle_info is None
    assert_models_equivalent(bundled.model_to_string(),
                             plain.model_to_string())
    np.testing.assert_allclose(bundled.predict(X), plain.predict(X),
                               rtol=1e-4, atol=1e-6)
    prog = bundled._engine.grower.program
    if prog.HIST is not None:
        assert prog.HIST.shape[1] == G
    if mode == "frontier8":
        one = lt.train(dict(CPU), lt.Dataset(X, label=y), 5,
                       verbose_eval=False)
        assert bundled.split_rounds_per_tree() < one.split_rounds_per_tree()
        assert bundled.model_to_string() == one.model_to_string()


def test_bundled_valid_and_early_stopping():
    """A validation set binned with the training set's bundles, scored
    after every tree by the bundle-decoding traversal: its scores equal
    predict(raw_score=True), its loss falls, and early stopping keeps the
    best iteration."""
    X, y = _sparse_problem(seed=3)
    Xv, yv = _sparse_problem(n=1500, seed=4)
    ds = lt.Dataset(X, label=y)
    dv = lt.Dataset(Xv, label=yv, reference=ds)
    evals = {}
    bst = lt.train(dict(CPU, learning_rate=0.3), ds, 60, valid_sets=[dv],
                   valid_names=["v"], evals_result=evals,
                   early_stopping_rounds=3, verbose_eval=False)
    assert dv.binned.bundle_info is ds.binned.bundle_info
    ll = evals["v"]["binary_logloss"]
    assert ll[-1] < ll[0]
    assert 0 < bst.best_iteration < 60
    assert bst.best_iteration == int(np.argmin(ll)) + 1
    raw = bst._engine.raw_valid_score(0)[0]
    np.testing.assert_allclose(
        raw, bst.predict(Xv, raw_score=True, num_iteration=len(ll)),
        rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape", ["expo", "allstate"])
def test_wide_sparse_widths(shape, tmp_path):
    """tests/test_wide_sparse.py's Expo (700 columns, G <= 120) and
    Allstate (4,228 columns, G <= F / 8, conflict rates <= 0.05) widths at
    8,000 rows: bundled, trained on the G storage columns (the payload is
    G + 10 wide and the routes take G: Allstate's 4,228 features leave the
    column-block histogram), and node for node the JAX package's model
    trained from the port's binary cache of the same Dataset (raw scores
    within 1e-5)."""
    if shape == "expo":
        cards, width, seed = [2, 4, 8, 16, 28], 700, 3
    else:
        cards, width, seed = [2, 3, 5, 9, 17, 33, 65], 4228, 0
    n_vars, noise = _widths(width, cards)
    X, y = _onehot_problem(8000, n_vars, cards, seed=seed, noise_cols=noise)
    params = dict(CPU, num_leaves=31, max_bin=255)
    ds = lt.Dataset(X, label=y, params=params).construct()
    G, F = ds.binned.bins.shape[0], ds.binned.num_features
    assert ds.binned.bundle_info is not None
    if shape == "expo":
        assert G <= 120, G
    else:
        assert G <= F // 8, (G, F)
        assert ds.binned.bundle_info.conflict_rates.max() <= 0.05
    path = str(tmp_path / "train.bin")
    ds.save_binary(path)
    bst = lt.train(dict(params), ds, 2, verbose_eval=False)
    fs = bst._engine._fast
    assert fs.G == G and fs.P == G + 10
    grow = bst._engine.grower
    assert grow.hist_engine == cuda_segment.histogram_route(G).__name__
    assert grow.part_engine == cuda_segment.partition_route(G + 10).__name__
    bj = lj.train(dict(PARAMS, num_leaves=31, max_bin=255), lj.Dataset(path),
                  2)
    bj._engine.flush()
    _assert_same_structure(bj, bst, X)
    np.testing.assert_allclose(bst.predict(X, raw_score=True),
                               bj.predict(X, raw_score=True), atol=1e-5)


@pytest.mark.parametrize("rate", [0.0, 0.02])
def test_find_bundles_matches_jax(rate):
    """The greedy conflict-bounded grouping (reference FindGroups): the
    port counts a feature's conflicts by gathering each bundle's row mask,
    the JAX package by intersecting sorted row lists; the bundles are the
    same, with and without a conflict budget."""
    from lightgbm_tpu.io.bundling import find_bundles as jax_find
    from lightgbm_tpu_torch.io.bundling import find_bundles
    rng = np.random.default_rng(9)
    n, F = 3000, 120
    nonzero = [np.sort(rng.choice(n, int(rng.integers(5, 400)),
                                  replace=False)) for _ in range(F)]
    num_bins = rng.integers(2, 40, F)
    bundleable = rng.random(F) < 0.9
    kw = dict(max_conflict_rate=rate, max_bundle_bins=255)
    got = find_bundles(nonzero, n, num_bins, [0] * F, bundleable,
                       rng=np.random.default_rng(4), **kw)
    ref = jax_find(nonzero, n, num_bins, [0] * F, bundleable,
                   rng=np.random.default_rng(4), **kw)
    assert got == ref
    assert any(len(g) > 1 for g in got)


def _bundled_rank(n_q=150, seed=6, blocks=4, per_block=5):
    """_ragged_rank's heavy-tailed queries and continuous columns, beside
    blocks of mutually exclusive sparse columns with continuous non-zero
    values (one per row in each block): bundled, and free of the near-tied
    per-query scores that flip lambdarank's sorts (ROADMAP queue C)."""
    X, rel, sizes = _ragged_rank(n_q, seed)
    rng = np.random.default_rng(seed + 1)
    n = len(rel)
    sparse = np.zeros((n, blocks * per_block))
    for b in range(blocks):
        which = rng.integers(0, per_block, n)
        sparse[np.arange(n), b * per_block + which] = \
            rng.uniform(0.5, 3.0, n)
    rel = np.clip(rel + (sparse[:, 0] > 1.5) - (sparse[:, 6] > 2.0), 0, 3)
    return np.concatenate([X, sparse], 1), rel, sizes


RANK = dict(PARAMS, objective="lambdarank", metric="ndcg", eval_at=[3])


def test_bundled_lambdarank_matches_jax():
    """Bundled lambdarank node for node against lj.train (the queue C
    record's first remedy): the same bundles, splits, topology, leaf
    counts and routing; raw scores within 1e-5."""
    X, rel, sizes = _bundled_rank()
    bj = lj.train(dict(RANK), lj.Dataset(X, label=rel, group=sizes), 5)
    bt = lt.train(dict(RANK, device_type="cpu"),
                  lt.Dataset(X, label=rel, group=sizes), 5,
                  verbose_eval=False)
    bj._engine.flush()
    jb, tb = bj._engine.train_set, bt.train_set.binned
    assert tb.bundle_info is not None
    assert bt._engine._fast.G == tb.bins.shape[0] < tb.num_features
    assert [list(g) for g in jb.bundle_info.groups] == \
        [list(g) for g in tb.bundle_info.groups]
    _assert_same_structure(bj, bt, X)
    np.testing.assert_allclose(bt.predict(X, raw_score=True),
                               bj.predict(X, raw_score=True), atol=1e-5)


def test_bundled_lambdarank_equivalent_to_unbundled():
    """The queue C record's low-cardinality input (_sparse_problem in 200
    queries of 20, labels clip((X0 + X7) // 3, 0, 4)), bundled against the
    port's own unbundled run: assert_models_equivalent."""
    X, _ = _sparse_problem(seed=2)
    rel = np.clip((X[:, 0] + X[:, 7]) // 3, 0, 4)
    sizes = np.full(200, 20)
    w = _weights(len(rel))
    params = dict(RANK, device_type="cpu")
    bundled = lt.train(dict(params), lt.Dataset(X, label=rel, group=sizes,
                                                weight=w), 5,
                       verbose_eval=False)
    plain = lt.train(dict(params, enable_bundle=False),
                     lt.Dataset(X, label=rel, group=sizes, weight=w), 5,
                     verbose_eval=False)
    assert bundled.train_set.binned.bins.shape[0] < X.shape[1]
    assert plain.train_set.binned.bundle_info is None
    assert_models_equivalent(bundled.model_to_string(),
                             plain.model_to_string())
