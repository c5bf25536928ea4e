"""The port's tree as one device program, on the CPU: grow() reads no
tensor on the host in any of the grower's modes (every value read is
patched to raise while it runs with the card's driver forced), its trees
are the JAX grower's node for node, the forced driver (every step, no
early exit) grows the eager early-exit driver's trees bit for bit, and
the sync seam counts one tree fetch per iteration, as the JAX package
pins for its synchronous dispatch."""
import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt
from lightgbm_tpu.boosting import grower2 as jgrower2
from lightgbm_tpu.boosting.gbdt import _feature_meta_device
from lightgbm_tpu.boosting.grower import GrowerConfig as JGrowerConfig
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.io.dataset import BinnedDataset as JBinnedDataset
from lightgbm_tpu.runtime import syncs as jsyncs
from lightgbm_tpu_torch import convert
from lightgbm_tpu_torch.boosting import grower2 as tgrower2
from lightgbm_tpu_torch.runtime import syncs as tsyncs

from test_torch_grower import (CASES, F, _assert_trees_match, _grower_kw,
                               _payload, _problem, _quantize_columns)

# one intra-op thread: the pytest-xdist workers share the cores, and
# torch's OpenMP regions spin in their barriers when oversubscribed
torch.set_num_threads(1)

#: the host reads of a tensor's value that grow() must not make
READS = ("item", "cpu", "numpy", "tolist", "__bool__", "__int__",
         "__float__", "__index__")

#: the grower's modes: (case, GrowerConfig extras, merged_hist)
MODES = {
    "one-leaf, full tree": (CASES[0], {}, None),
    "one-leaf, early stop": (dict(CASES[1], min_data_in_leaf=120), {}, None),
    "pooled, 2 slots": (CASES[1], dict(hist_pool_slots=2), None),
    "merged": (CASES[1], {}, True),
    "quantized int8": (CASES[1], dict(quantized=True, qmax=127), None),
    "frontier 8": (CASES[1], dict(frontier_batch=8), None),
    "categorical": (CASES[1], dict(with_categorical=True,
                                   min_data_per_group=20, cat_smooth=5.0),
                    None),
}


@contextlib.contextmanager
def no_host_reads():
    """Every host read of a tensor's value raises inside the block."""
    saved = {name: getattr(torch.Tensor, name) for name in READS}

    def refuse(name):
        def read(*args, **kwargs):
            raise AssertionError("host read of a tensor: Tensor.%s" % name)
        return read

    try:
        for name in READS:
            setattr(torch.Tensor, name, refuse(name))
        yield
    finally:
        for name, fn in saved.items():
            setattr(torch.Tensor, name, fn)


def _inputs(mode):
    case, extra, merged = MODES[mode]
    X, y = _problem(case["seed"], case["nan_frac"])
    cats = ()
    if extra.get("with_categorical"):
        # ~20 and 4 categories (NaN among them): the sorted-subset and the
        # one-hot searches
        X[:, 2] = np.floor(np.abs(X[:, 2]) * 8)
        X[:, 3] = np.abs(X[:, 3])
        cats = (2, 3)
    ds = JBinnedDataset.from_matrix(X, JConfig(dict(max_bin=case["max_bin"],
                                                    verbose=-1)),
                                    categorical_feature=cats)
    pay, cols = _payload(ds, y, case["seed"])
    qscale = None
    if extra.get("quantized"):
        pay, qscale = _quantize_columns(pay, cols, extra["qmax"],
                                        case["seed"])
    return case, extra, merged, ds, pay, cols, qscale


def _grow_jax(case, extra, merged, ds, pay, cols, qscale):
    extra = dict(extra)
    quant = {k: extra.pop(k) for k in ("quantized", "qmax") if k in extra}
    grow = jgrower2.make_partitioned_grower(
        _feature_meta_device(ds), JGrowerConfig(**_grower_kw(case), **extra),
        ds.max_num_bin, jgrower2.PayloadCols(**cols), F, merged_hist=merged,
        **quant)
    args = (jnp.asarray(pay), jnp.zeros_like(jnp.asarray(pay)),
            jnp.ones(F, bool))
    if qscale is not None:
        args += (jnp.asarray(qscale),)
    tree, jpay, _ = grow(*args)
    return tree, np.asarray(jpay)


def _grow_port(case, extra, merged, ds, pay, cols, qscale,
               guard=contextlib.nullcontext):
    """One tree through the port's grower, grow() inside `guard()`;
    returns (tree, payload, number of split searches run)."""
    grow = tgrower2.make_partitioned_grower(
        convert.feature_meta_from_numpy(_feature_meta_device(ds)),
        tgrower2.GrowerConfig(**_grower_kw(case), **extra), ds.max_num_bin,
        tgrower2.PayloadCols(**cols), F, merged_hist=merged)
    tpay = convert.payload_from_numpy(pay)
    args = (tpay, torch.zeros_like(tpay), torch.ones(F, dtype=torch.bool))
    if qscale is not None:
        args += (convert.qscale_from_numpy(qscale),)
    searches = []
    real = tgrower2.find_best_split_batched

    def counted(*a, **kw):
        searches.append(1)
        return real(*a, **kw)

    tgrower2.find_best_split_batched = counted
    try:
        with guard():
            tree, tpay, _ = grow(*args)
    finally:
        tgrower2.find_best_split_batched = real
    return tree, convert.payload_to_numpy(tpay), len(searches)


def _every_step(step, n, flag, device):
    """The card's driver with no early exit: every one of the n steps is
    enqueued and the stop flag is never read."""
    for _ in range(n):
        step()


@pytest.mark.parametrize("mode", list(MODES))
def test_no_host_read_and_the_jax_tree(mode, monkeypatch):
    """The card's driver forced on the CPU: every step runs (no early
    exit) with no host read, and the tree is the JAX grower's."""
    inputs = _inputs(mode)
    case, extra = inputs[0], inputs[1]
    monkeypatch.setattr(tgrower2, "_drive", _every_step)
    ttree, tpay, searches = _grow_port(*inputs, guard=no_host_reads)
    L = case["num_leaves"]
    # the root's search, then one per step: all L - 1 of them
    assert searches == L
    jtree, jpay = _grow_jax(*inputs)
    nl = int(jtree["num_leaves"])
    if mode == "one-leaf, full tree":
        assert nl == L
    if mode == "one-leaf, early stop":
        assert 2 < nl < L // 2
    _assert_trees_match(jtree, jpay, ttree, tpay, cols=inputs[5])
    assert int(ttree["split_rounds"]) == int(jtree["split_rounds"])
    assert ttree["host_syncs"] == 0
    if extra.get("frontier_batch"):
        assert int(ttree["split_rounds"]) < nl - 1
    if extra.get("with_categorical"):
        assert bool(ttree["split_is_cat"].any())
        np.testing.assert_array_equal(ttree["split_cat_bitset"].numpy(),
                                      np.asarray(jtree["split_cat_bitset"]))


@pytest.mark.parametrize("mode", list(MODES))
def test_forced_driver_bit_identical_to_early_exit(mode, monkeypatch):
    """The driver that runs every step grows, bit for bit, the tree and
    payload of the CPU driver that stops once the stop flag is clear;
    the steps past the tree's last split are no-ops."""
    inputs = _inputs(mode)
    eager, eager_pay, eager_searches = _grow_port(*inputs)
    monkeypatch.setattr(tgrower2, "_drive", _every_step)
    forced, forced_pay, forced_searches = _grow_port(*inputs)
    assert forced_searches == inputs[0]["num_leaves"]
    assert eager_searches == 1 + int(eager["split_rounds"])
    assert set(forced) == set(eager)
    for k, v in eager.items():
        if isinstance(v, torch.Tensor):
            assert v.dtype == forced[k].dtype, k
            assert torch.equal(v, forced[k]), k
        else:
            assert v == forced[k], k
    assert forced_pay.tobytes() == eager_pay.tobytes()


def _sync_data():
    rng = np.random.default_rng(5)
    X = rng.standard_normal((2000, 6))
    y = (X[:, 0] + 0.5 * X[:, 1] * X[:, 2] + 0.3 * rng.standard_normal(2000)
         > 0).astype(np.float64)
    return X, y


@pytest.mark.parametrize("extra", [{}, dict(tpu_frontier_batch=8),
                                   dict(histogram_pool_size=0.01)])
def test_one_tree_fetch_per_iteration(extra):
    """tests/test_pipeline.py's pin of the synchronous dispatch
    (pipeline_depth=0), for the port on every grower path and for the
    JAX package on the default one: over 3 iterations after a warm-up,
    the only blocking syncs on the critical path are one tree_fetch per
    iteration, and host_syncs_per_tree() reads 1."""
    X, y = _sync_data()
    params = {"objective": "binary", "num_leaves": 15, "verbose": -1,
              "pipeline_depth": 0, **extra}
    packages = ((lj, jsyncs), (lt, tsyncs)) if not extra else ((lt, tsyncs),)
    for pkg, syncs in packages:
        p = dict(params, device_type="cpu") if pkg is lt else dict(params)
        bst = pkg.Booster(p, pkg.Dataset(X, label=y))
        bst.update()
        syncs.reset()
        for _ in range(3):
            bst.update()
        snap = syncs.snapshot()
        assert snap["critical_by_label"] == {"tree_fetch": 3}, (pkg, snap)
        assert snap["critical_path"] == 3
    assert bst.host_syncs_per_tree() == [1] * 4
    assert bst.split_rounds_per_tree() > 0


@pytest.mark.parametrize("objective,extra,renew", [
    ("regression", {}, False),
    ("regression", dict(bagging_fraction=0.5, bagging_freq=1), False),
    ("regression_l1", {}, True),
    ("regression_l1", dict(tpu_frontier_batch=8), True),
    ("quantile", dict(bagging_fraction=0.5, bagging_freq=2,
                      histogram_pool_size=0.01), True)])
def test_renewal_adds_one_renew_fetch_per_iteration(objective, extra, renew):
    """Every trainable objective keeps the one tree_fetch per iteration;
    leaf renewal (L1, quantile, MAPE) adds exactly one more blocking
    fetch, renew_fetch (the pre-tree scores, the bag and the index
    column), and bagging none."""
    X, y = _sync_data()
    params = {"objective": objective, "num_leaves": 15, "verbose": -1,
              "pipeline_depth": 0, "device_type": "cpu", **extra}
    bst = lt.Booster(params, lt.Dataset(X, label=y + X[:, 3]))
    bst.update()
    tsyncs.reset()
    for _ in range(3):
        bst.update()
    snap = tsyncs.snapshot()
    expect = {"tree_fetch": 3, "renew_fetch": 3} if renew \
        else {"tree_fetch": 3}
    assert snap["critical_by_label"] == expect, snap
    assert snap["total"] == snap["critical_path"] == sum(expect.values())
    assert bst.host_syncs_per_tree() == [1 + renew] * 4


def test_eval_fetch_counted_apart():
    """Scores fetched for metrics go through the seam as eval_fetch, not
    into the tree's count."""
    X, y = _sync_data()
    params = {"objective": "binary", "num_leaves": 15, "verbose": -1,
              "metric": "auc", "device_type": "cpu"}
    tsyncs.reset()
    evals = {}
    bst = lt.train(params, lt.Dataset(X[:1500], label=y[:1500]), 3,
                   valid_sets=[lt.Dataset(X[1500:], label=y[1500:])],
                   evals_result=evals, verbose_eval=False)
    by = tsyncs.snapshot()["by_label"]
    # the trees' fetches: the assembler's at the default pipeline_depth=1
    assert by["pipeline_drain"] == 3
    assert "tree_fetch" not in by
    assert by.get("eval_fetch", 0) >= 3
    assert bst.host_syncs_per_tree() == [1] * 3
