"""Monotone constraints in the port against the JAX package on the CPU:
the children's bounds, the constrained split search against the JAX
find_best_split with min / max constraints, the dumped trees and the
predictions of tests/test_monotone_missing.py (:37-64) and monotone
with forced splits (:129-145) held against the JAX models, and, under
tests/test_torch_device_loop.py's harness, every grower mode the gate
admits grown with host reads patched to raise, against the JAX
grower."""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt
from lightgbm_tpu.boosting import grower2 as jgrower2
from lightgbm_tpu.boosting.forced import \
    build_forced_schedule as jax_schedule
from lightgbm_tpu.boosting.gbdt import _feature_meta_device
from lightgbm_tpu.boosting.grower import GrowerConfig as JGrowerConfig
from lightgbm_tpu.boosting.grower import \
    propagate_monotone_bounds as jax_propagate
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.io.dataset import BinnedDataset as JBinnedDataset
from lightgbm_tpu.ops.split import find_best_split as jax_find
from lightgbm_tpu_torch import convert
from lightgbm_tpu_torch.boosting import grower2 as tgrower2
from lightgbm_tpu_torch.boosting.forced import build_forced_schedule
from lightgbm_tpu_torch.ops.split import find_best_split_batched

from test_torch_device_loop import _every_step, no_host_reads
from test_torch_grower import (_assert_trees_match, _grower_kw, _payload,
                               _problem)
from test_torch_train import _assert_same_structure

# one intra-op thread: the pytest-xdist workers share the cores, and
# torch's OpenMP regions spin in their barriers when oversubscribed
torch.set_num_threads(1)

MONO = [1, -1, 0]
PARAMS = {"objective": "regression", "num_leaves": 31, "verbose": -1,
          "monotone_constraints": MONO, "min_data_in_leaf": 10}


def _mono_data(n=1200, seed=0):
    rng = np.random.default_rng(seed)
    x0 = rng.random(n)                      # constrained +1
    x1 = rng.random(n)                      # constrained -1
    x2 = rng.standard_normal(n)             # free
    y = (5 * x0 - 5 * x1 + 0.5 * np.sin(8 * x2)
         + rng.standard_normal(n) * 0.05)
    w = np.random.default_rng(seed + 100).uniform(0.5, 1.5, n)
    return np.column_stack([x0, x1, x2]).astype(np.float64), y, w


def _walk_monotone(node, constraint, feature):
    """tests/test_monotone_missing.py:19-34: every split on `feature`
    orders its children's subtree outputs per the constraint."""
    if "split_feature" not in node:
        return node["leaf_value"], node["leaf_value"]
    lmin, lmax = _walk_monotone(node["left_child"], constraint, feature)
    rmin, rmax = _walk_monotone(node["right_child"], constraint, feature)
    if node["split_feature"] == feature:
        if constraint > 0:
            assert lmax <= rmin + 1e-10
        elif constraint < 0:
            assert lmin >= rmax - 1e-10
    return min(lmin, rmin), max(lmax, rmax)


def _train_both(rounds, **extra):
    X, y, w = _mono_data()
    params = dict(PARAMS, **extra)
    bj = lj.train(dict(params), lj.Dataset(X, label=y, weight=w), rounds,
                  verbose_eval=False)
    bt = lt.train(dict(params, device_type="cpu"),
                  lt.Dataset(X, label=y, weight=w), rounds,
                  verbose_eval=False)
    return bj, bt, X


def _assert_monotone(bst):
    for t in bst.dump_model()["tree_info"]:
        root = t["tree_structure"]
        if "split_feature" in root:
            _walk_monotone(root, 1, 0)
            _walk_monotone(root, -1, 1)


def test_propagate_bounds_match_jax():
    rng = np.random.default_rng(0)
    n = 64
    blo, bro = (rng.standard_normal(n).astype(np.float32) for _ in range(2))
    is_num = rng.random(n) > 0.2
    mono = rng.integers(-1, 2, n).astype(np.int32)
    pmin = np.where(rng.random(n) > 0.5, -np.inf,
                    rng.standard_normal(n) - 1).astype(np.float32)
    pmax = np.where(rng.random(n) > 0.5, np.inf,
                    rng.standard_normal(n) + 1).astype(np.float32)
    ref = jax_propagate(*(jnp.asarray(a) for a in
                          (blo, bro, is_num, mono, pmin, pmax)))
    got = tgrower2.propagate_monotone_bounds(
        *(torch.from_numpy(a) for a in (blo, bro, is_num, mono, pmin, pmax)))
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def _search_inputs(seed=1, Q=3):
    X, y, _ = _mono_data(seed=seed)
    X[np.random.default_rng(seed).random(X.shape) < 0.05] = np.nan
    ds = JBinnedDataset.from_matrix(X, JConfig(dict(
        max_bin=31, verbose=-1, monotone_constraints=MONO)))
    meta = _feature_meta_device(ds)
    F, B = X.shape[1], ds.max_num_bin
    rng = np.random.default_rng(seed)
    hist = np.zeros((Q, F, B, 3), np.float32)
    for q in range(Q):
        rows = rng.random(len(X)) < 0.6
        g = (rng.standard_normal(len(X)) - y * 0.3).astype(np.float32)
        h = rng.uniform(0.5, 1.0, len(X)).astype(np.float32)
        for f in range(F):
            b = ds.bins[f][:len(X)][rows].astype(np.int64)
            np.add.at(hist[q, f, :, 0], b, g[rows])
            np.add.at(hist[q, f, :, 1], b, h[rows])
            np.add.at(hist[q, f, :, 2], b, 1.0)
    sums = hist[:, 0].sum(axis=1)
    return meta, hist, sums


KW = dict(l1=0.0, l2=0.1, max_delta_step=0.0, min_data_in_leaf=10,
          min_sum_hessian_in_leaf=1e-3, min_gain_to_split=0.0)


def test_constrained_search_matches_jax():
    """Three leaves with bounds (open, tight on both sides, tight above)
    in one batched search against the JAX find_best_split of each."""
    meta, hist, sums = _search_inputs()
    mins = np.array([-np.inf, -0.05, -np.inf], np.float32)
    maxs = np.array([np.inf, 0.05, 0.01], np.float32)
    got = find_best_split_batched(
        torch.from_numpy(hist), *(torch.from_numpy(sums[:, i])
                                  for i in range(3)),
        torch.ones(hist.shape[1], dtype=torch.bool),
        meta=convert.feature_meta_from_numpy(meta), monotone=True,
        min_constraint=torch.from_numpy(mins),
        max_constraint=torch.from_numpy(maxs), **KW)
    for q in range(hist.shape[0]):
        ref = jax_find(jnp.asarray(hist[q]), sums[q, 0], sums[q, 1],
                       sums[q, 2], jnp.ones(hist.shape[1], bool), meta=meta,
                       min_constraint=jnp.float32(mins[q]),
                       max_constraint=jnp.float32(maxs[q]), **KW)
        for name, a, b in zip(ref._fields, got, ref):
            if name in ("feature", "threshold_bin", "default_left",
                        "is_cat", "cat_bitset"):
                np.testing.assert_array_equal(a[q].numpy(), np.asarray(b),
                                              err_msg=name)
            else:
                np.testing.assert_allclose(
                    a[q].numpy().astype(np.float64),
                    np.asarray(b).astype(np.float64), rtol=1e-5, atol=1e-6,
                    err_msg=name)
        assert maxs[q] >= got.left_output[q] >= mins[q]


def test_open_bounds_without_monotone_features_keep_the_bits():
    """With no monotone feature and bounds (-inf, inf) the constrained
    search returns today's search bit for bit."""
    meta, hist, sums = _search_inputs(seed=2)
    meta = convert.feature_meta_from_numpy(meta)
    meta = meta._replace(monotone=torch.zeros_like(meta.monotone))
    args = (torch.from_numpy(hist), *(torch.from_numpy(sums[:, i])
                                      for i in range(3)),
            torch.ones(hist.shape[1], dtype=torch.bool))
    plain = find_best_split_batched(*args, meta=meta, **KW)
    inf = torch.full((hist.shape[0],), float("inf"))
    bounded = find_best_split_batched(*args, meta=meta, monotone=True,
                                      min_constraint=-inf,
                                      max_constraint=inf, **KW)
    for a, b in zip(plain, bounded):
        assert torch.equal(a, b)


def test_monotone_constraints_hold_and_match_jax():
    bj, bt, X = _train_both(15)
    assert len(bt.dump_model()["tree_info"]) == 15
    _assert_monotone(bt)
    _assert_same_structure(bj, bt, X)
    np.testing.assert_allclose(bt.predict(X), bj.predict(X), atol=1e-5)


def test_monotone_prediction_direction():
    _, bt, _ = _train_both(15)
    base = np.tile(np.array([[0.5, 0.5, 0.0]]), (50, 1))
    sweep = np.linspace(0.0, 1.0, 50)
    up = base.copy()
    up[:, 0] = sweep
    assert (np.diff(bt.predict(up)) >= -1e-10).all()
    down = base.copy()
    down[:, 1] = sweep
    assert (np.diff(bt.predict(down)) <= 1e-10).all()


def test_monotone_with_forced_splits(tmp_path):
    fpath = tmp_path / "forced.json"
    # a forced root on the FREE feature; constrained growth follows
    fpath.write_text(json.dumps({"feature": 2, "threshold": 0.0}))
    bj, bt, X = _train_both(8, forcedsplits_filename=str(fpath))
    for t in bt.dump_model()["tree_info"]:
        assert t["tree_structure"]["split_feature"] == 2
    _assert_monotone(bt)
    _assert_same_structure(bj, bt, X)
    np.testing.assert_allclose(bt.predict(X), bj.predict(X), atol=1e-5)


def test_monotone_frontier_request_writes_one_leaf_text():
    X, y, w = _mono_data()
    params = dict(PARAMS, device_type="cpu")
    one = lt.train(dict(params), lt.Dataset(X, label=y, weight=w), 5,
                   verbose_eval=False)
    front = lt.train(dict(params, tpu_frontier_batch=8),
                     lt.Dataset(X, label=y, weight=w), 5, verbose_eval=False)
    assert front.model_to_string().split("end of trees")[0] == \
        one.model_to_string().split("end of trees")[0]
    assert front.split_rounds_per_tree() == one.split_rounds_per_tree()


def test_monotone_quantized_trains_quantized():
    """Monotone constraints keep gradient_quantization (plain gbdt, as
    in the JAX package) and still hold."""
    X, y, w = _mono_data()
    bst = lt.train(dict(PARAMS, device_type="cpu", gradient_quantization=True,
                        gradient_quant_dtype="int16"),
                   lt.Dataset(X, label=y, weight=w), 5, verbose_eval=False)
    assert bst.quant_report["dtype"] == "int16"
    _assert_monotone(bst)


# -- the tree as one device program (tests/test_torch_device_loop.py) ----
FORCED_JSON = {"feature": 1, "threshold": 0.0,
               "left": {"feature": 4, "threshold": 0.3}}
#: grower modes the gate admits under monotone / forced: (GrowerConfig
#: extras, merged_hist); a frontier request runs the one-leaf loop
MODES = {
    "one-leaf": ({}, None),
    "frontier 8 requested": (dict(frontier_batch=8), None),
    "pooled, 2 slots": (dict(hist_pool_slots=2), None),
    "merged": ({}, True),
}


@pytest.mark.parametrize("forced", [False, True])
@pytest.mark.parametrize("mode", list(MODES))
def test_constrained_grower_no_host_read_and_the_jax_tree(mode, forced,
                                                          monkeypatch):
    """Monotone (and forced) growers with the card's driver forced on the
    CPU: every step runs with no host read, and the tree is the JAX
    grower's."""
    extra, merged = MODES[mode]
    case = dict(seed=1, nan_frac=0.1, num_leaves=31, max_depth=-1,
                max_bin=63)
    X, y = _problem(case["seed"], case["nan_frac"])
    F = X.shape[1]
    mono = [1, 0, -1, 0, 1, 0]
    ds = JBinnedDataset.from_matrix(X, JConfig(dict(
        max_bin=case["max_bin"], verbose=-1, monotone_constraints=mono)))
    pay, cols = _payload(ds, y, case["seed"])
    jmeta = _feature_meta_device(ds)
    jforced = jax_schedule(FORCED_JSON, ds.bin_mappers, 31) if forced \
        else None
    jgrow = jgrower2.make_partitioned_grower(
        jmeta, JGrowerConfig(**_grower_kw(case), with_monotone=True,
                             **extra),
        ds.max_num_bin, jgrower2.PayloadCols(**cols), F, merged_hist=merged,
        forced=jforced)
    jtree, jpay, _ = jgrow(jnp.asarray(pay), jnp.zeros_like(jnp.asarray(pay)),
                           jnp.ones(F, bool))
    dt = lt.Dataset(X).construct(lt.Config(dict(
        max_bin=case["max_bin"], verbose=-1))).binned
    tforced = build_forced_schedule(FORCED_JSON, dt.bin_mappers, 31) \
        if forced else None
    tgrow = tgrower2.make_partitioned_grower(
        convert.feature_meta_from_numpy(jmeta),
        tgrower2.GrowerConfig(**_grower_kw(case), with_monotone=True,
                              **extra),
        ds.max_num_bin, tgrower2.PayloadCols(**cols), F, merged_hist=merged,
        forced=tforced)
    monkeypatch.setattr(tgrower2, "_drive", _every_step)
    tpay = convert.payload_from_numpy(pay)
    with no_host_reads():
        ttree, tpay, _ = tgrow(tpay, torch.zeros_like(tpay),
                               torch.ones(F, dtype=torch.bool))
    _assert_trees_match(jtree, np.asarray(jpay), ttree,
                        convert.payload_to_numpy(tpay), cols=cols)
    nl = int(ttree["num_leaves"])
    assert int(ttree["split_rounds"]) == nl - 1
    if forced:
        assert ttree["split_feature"][0] == 1
        assert abs(float(ttree["split_gain"][0])) < 1e20
