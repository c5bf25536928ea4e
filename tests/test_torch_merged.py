"""The merged partition + histogram mode of the port against the JAX
package on the CPU: the plain `partition_segment_hist` (B6's reference)
against the Pallas kernel in interpret mode and against the JAX package's
portable composition, the gate against the JAX VMEM gate, the grower's
merged mode against the JAX grower's, and training through `train`.  On a
CPU tensor the B6 wrapper runs its plain version (ops/segment.py)."""
import functools

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import lightgbm_tpu as lj
from lightgbm_tpu.boosting import grower2 as jgrower2
from lightgbm_tpu.boosting.gbdt import _feature_meta_device
from lightgbm_tpu.boosting.grower import GrowerConfig as JGrowerConfig
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.io.dataset import BinnedDataset as JBinnedDataset
from lightgbm_tpu.ops import pallas_segment as pseg
from lightgbm_tpu.ops import segment as jseg
from lightgbm_tpu_torch import convert
from lightgbm_tpu_torch.boosting import gbdt as tgbdt
from lightgbm_tpu_torch.boosting import grower2 as tgrower2
from lightgbm_tpu_torch.ops import cuda_segment
from lightgbm_tpu_torch.ops import segment as tseg

from test_torch_grower import _assert_trees_match
from test_torch_segment import (B, COLS, F, VALUE_COL, _jax_pred, _payload,
                                _pred_fields)
from test_torch_train import _assert_same_structure, _data, _train_both

# one intra-op thread: the pytest-xdist workers share the cores, and
# torch's OpenMP regions spin in their barriers when oversubscribed
torch.set_num_threads(1)

# the segments of tests/test_pallas_segment.py:234-236
SEGMENTS = [(0, 1000), (256, 700), (100, 37), (513, 256), (7, 1), (0, 0)]
# numerical, NaN-missing and zero-missing routing, with default_left
PREDICATES = {
    "numerical": {},
    "nan_missing": dict(feature=2, missing_type=2, default_left=True,
                        threshold=3),
    "zero_missing": dict(feature=1, threshold=6, missing_type=1,
                         default_bin=4, default_left=True),
}


def _port_merged(pay, start, count, fields):
    return cuda_segment.partition_segment_hist(
        convert.payload_from_numpy(pay), torch.zeros(pay.shape), start,
        count, convert.split_predicate_from_numpy(fields),
        torch.tensor(-0.25), torch.tensor(0.75), VALUE_COL, B,
        num_features=F, **COLS)


@pytest.mark.parametrize("pred", list(PREDICATES))
@pytest.mark.parametrize("start,count", SEGMENTS)
def test_plain_matches_pallas_interpret(start, count, pred):
    pay = _payload(1024, seed=start + count + 1)
    fields = _pred_fields(**PREDICATES[pred])
    ref_pay, _, ref_nl, ref_hl, ref_hr = pseg.partition_segment_hist(
        jnp.asarray(pay), jnp.zeros_like(jnp.asarray(pay)), jnp.int32(start),
        jnp.int32(count), _jax_pred(fields), jnp.float32(-0.25),
        jnp.float32(0.75), VALUE_COL, B, num_features=F, interpret=True,
        **COLS)
    got_pay, _, got_nl, hl, hr = _port_merged(pay, start, count, fields)
    assert int(got_nl) == int(ref_nl)
    np.testing.assert_array_equal(got_pay.numpy(), np.asarray(ref_pay))
    for got, ref in ((hl, ref_hl), (hr, ref_hr)):
        got, ref = got.numpy(), np.asarray(ref)
        np.testing.assert_array_equal(got[..., 2], ref[..., 2])
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("pred", list(PREDICATES))
@pytest.mark.parametrize("start,count", SEGMENTS)
def test_plain_matches_jax_composition_bit_for_bit(start, count, pred):
    """The JAX grower's portable merged step (part_hist_fn): the
    partition, then both children's histograms walked in row order."""
    pay = _payload(1024, seed=start + count + 2)
    fields = _pred_fields(**PREDICATES[pred])
    jpay, jaux, jnl = jseg.partition_segment(
        jnp.asarray(pay), jnp.zeros_like(jnp.asarray(pay)), jnp.int32(start),
        jnp.int32(count), _jax_pred(fields), jnp.float32(-0.25),
        jnp.float32(0.75), VALUE_COL)
    hk = dict(num_features=F, num_bins=B, **COLS)
    jhl = jseg.segment_histogram(jpay, jnp.int32(start), jnl, **hk)
    jhr = jseg.segment_histogram(jpay, jnp.int32(start) + jnl,
                                 jnp.int32(count) - jnl, **hk)
    got_pay, got_aux, got_nl, hl, hr = _port_merged(pay, start, count,
                                                    fields)
    assert int(got_nl) == int(jnl)
    assert got_pay.numpy().tobytes() == np.asarray(jpay).tobytes()
    np.testing.assert_array_equal(got_aux.numpy()[start:start + count],
                                  np.asarray(jaux)[start:start + count])
    assert hl.numpy().tobytes() == np.asarray(jhl).tobytes()
    assert hr.numpy().tobytes() == np.asarray(jhr).tobytes()


def test_wrapper_counts_no_launch_on_cpu():
    before = cuda_segment.partition_segment_hist.launches
    _port_merged(_payload(1024), 9, 1015, _pred_fields())
    assert cuda_segment.partition_segment_hist.launches == before


@pytest.mark.parametrize("f,num_bins", [
    (28, 256), (28, 255), (28, 64), (136, 256), (137, 256), (137, 64),
    (246, 128), (247, 128), (246, 16), (500, 64), (968, 255), (6, 300)])
def test_gate_matches_jax_vmem_gate(f, num_bins):
    # the fast path's payload: f bin columns and 10 value columns, which
    # the JAX package pads to 128 lanes
    p = f + 10
    assert cuda_segment.partition_hist_fits(p, f, num_bins) == \
        pseg.partition_hist_fits_vmem(pseg._pad128(p), f, num_bins)


def test_gate_pins_of_the_jax_tests():
    # tests/test_pallas_segment.py:283-287
    assert cuda_segment.partition_hist_fits(128, 28, 256)
    assert cuda_segment.partition_hist_fits(128, 137, 64)
    assert not cuda_segment.partition_hist_fits(256, 137, 256)
    assert not cuda_segment.partition_hist_fits(896, 700, 256)
    assert cuda_segment.PARTITION_HIST_VALIDATED is False
    assert pseg.PARTITION_HIST_VALIDATED is False


# -- the grower's merged mode -------------------------------------------------

def _make_problem(seed, near_tie):
    """The problems of tests/test_grower2.py:229-315: the benign one and
    the adversarial near-tie one (duplicated, near-duplicated and mirrored
    features, coarse plateaus)."""
    rng = np.random.default_rng(seed)
    if not near_tie:
        n = 3000
        X = rng.standard_normal((n, 6))
        y = (X[:, 0] + 0.5 * X[:, 1] + rng.standard_normal(n) * 0.1 > 0)
        return X, y.astype(np.float32)
    n = 4000
    base = rng.integers(0, 8, size=n).astype(np.float64)
    X = np.stack([base, base.copy(), base + rng.normal(0, 1e-9, n),
                  rng.integers(0, 4, size=n).astype(np.float64),
                  rng.standard_normal(n).round(1), -base], axis=1)
    y = ((base + 0.3 * X[:, 3] + rng.standard_normal(n) * 0.5) > 4)
    return X, y.astype(np.float32)


GROWER_CASES = [dict(seed=13, near_tie=False, num_leaves=31, min_data=20,
                     lambda_l2=0.1)] + [
    dict(seed=s, near_tie=True, num_leaves=63, min_data=5, lambda_l2=0.0)
    for s in (0, 1, 2)]


def _grower_setup(case):
    X, y = _make_problem(case["seed"], case["near_tie"])
    ds = JBinnedDataset.from_matrix(
        X, JConfig({"objective": "binary", "max_bin": 63,
                    "num_leaves": case["num_leaves"],
                    "min_data_in_leaf": case["min_data"]}), row_chunk=1024)
    n, f, n_pad = len(y), ds.num_features, ds.num_data_padded
    cols = dict(grad=f, hess=f + 1, cnt=f + 2, value=f + 3)
    pay = np.zeros((n_pad + jseg.GUARD, f + 4), np.float32)
    pay[:n_pad, :f] = ds.bins.T
    pay[:n, cols["grad"]] = 0.5 - y
    pay[:n, cols["hess"]] = 0.25
    pay[:n, cols["cnt"]] = 1.0
    kw = dict(num_leaves=case["num_leaves"], max_depth=-1, lambda_l1=0.0,
              lambda_l2=case["lambda_l2"], max_delta_step=0.0,
              min_data_in_leaf=case["min_data"],
              min_sum_hessian_in_leaf=1e-3, min_gain_to_split=0.0)
    return ds, pay, cols, kw


def _grow_port(ds, pay, cols, kw, qscale=None, **extra):
    merged = extra.pop("merged_hist", None)
    grow = tgrower2.make_partitioned_grower(
        convert.feature_meta_from_numpy(_feature_meta_device(ds)),
        tgrower2.GrowerConfig(**kw, **extra), ds.max_num_bin,
        tgrower2.PayloadCols(**cols), ds.num_features, merged_hist=merged)
    tpay = convert.payload_from_numpy(pay)
    args = (tpay, torch.zeros_like(tpay),
            torch.ones(ds.num_features, dtype=torch.bool))
    if qscale is not None:
        args += (convert.qscale_from_numpy(qscale),)
    tree, tpay, _ = grow(*args)
    return tree, convert.payload_to_numpy(tpay), grow


@pytest.mark.parametrize("case", GROWER_CASES)
def test_merged_grower_matches_jax_merged_grower(case):
    ds, pay, cols, kw = _grower_setup(case)
    jgrow = jgrower2.make_partitioned_grower(
        _feature_meta_device(ds),
        JGrowerConfig(**kw, row_chunk=ds.num_data_padded,
                      with_categorical=False),
        ds.max_num_bin, jgrower2.PayloadCols(**cols), ds.num_features,
        merged_hist=True)
    jtree, jpay, _ = jgrow(jnp.asarray(pay), jnp.zeros_like(jnp.asarray(pay)),
                           jnp.ones(ds.num_features, bool))
    ttree, tpay, grow = _grow_port(ds, pay, cols, kw, merged_hist=True)
    assert grow.part_engine == grow.hist_engine == "partition_segment_hist"
    _assert_trees_match(jtree, np.asarray(jpay), ttree, tpay, cols)


@pytest.mark.parametrize("case", GROWER_CASES)
def test_merged_grower_same_tree_as_subtraction(case):
    ds, pay, cols, kw = _grower_setup(case)
    t0, p0, _ = _grow_port(ds, pay, cols, kw)
    t1, p1, _ = _grow_port(ds, pay, cols, kw, merged_hist=True)
    nl = t0["num_leaves"]
    assert t1["num_leaves"] == nl > 4
    for k in ("split_feature", "split_bin", "left_child", "right_child"):
        np.testing.assert_array_equal(t1[k][:nl - 1].numpy(),
                                      t0[k][:nl - 1].numpy(), err_msg=k)
    for k in ("seg_start", "seg_cnt", "leaf_count"):
        np.testing.assert_array_equal(t1[k][:nl].numpy(), t0[k][:nl].numpy(),
                                      err_msg=k)
    keep = np.arange(pay.shape[1]) != cols["value"]
    np.testing.assert_array_equal(p1[:, keep], p0[:, keep])


def test_merged_mode_auto_rule(monkeypatch):
    """Off by default; the flag alone does not take a CPU payload into
    the merged mode (the rule asks for a CUDA payload); quantized turns a
    forced mode off."""
    ds, pay, cols, kw = _grower_setup(GROWER_CASES[0])
    _, _, grow = _grow_port(ds, pay, cols, kw)
    assert grow.part_engine == "partition_segment"
    monkeypatch.setattr(cuda_segment, "PARTITION_HIST_VALIDATED", True)
    _, _, grow = _grow_port(ds, pay, cols, kw)
    assert grow.part_engine == "partition_segment"


def test_merged_quantized_resolves_off():
    ds, pay, cols, kw = _grower_setup(GROWER_CASES[0])
    qmax = 127
    scale = np.array([0.5 / qmax, 0.25 / qmax], np.float32)
    qpay = pay.copy()
    qpay[:, cols["grad"]] = np.round(pay[:, cols["grad"]] / scale[0])
    qpay[:, cols["hess"]] = np.round(pay[:, cols["hess"]] / scale[1])
    quant = dict(quantized=True, qmax=qmax)
    t0, p0, _ = _grow_port(ds, qpay, cols, kw, scale, **quant)
    t1, p1, grow = _grow_port(ds, qpay, cols, kw, scale, merged_hist=True,
                              **quant)
    assert grow.hist_engine == "segment_histogram_quant"
    assert grow.part_engine == "partition_segment"
    for k, v in t0.items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(t1[k], v), k
    assert p1.tobytes() == p0.tobytes()


def test_merged_frontier_runs_one_leaf_loop():
    ds, pay, cols, kw = _grower_setup(GROWER_CASES[0])
    t1, _, grow = _grow_port(ds, pay, cols, kw, merged_hist=True,
                             frontier_batch=8)
    assert grow.part_engine == "partition_segment_hist"
    assert t1["split_rounds"] == t1["num_leaves"] - 1 > 4
    t0, _, _ = _grow_port(ds, pay, cols, kw, merged_hist=True)
    for k, v in t0.items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(t1[k], v), k


def test_merged_past_the_gate_walks_both_children():
    """Past B6's gate (here 300 bins) the merged split partitions through
    the route and walks both children, as part_hist_fn does."""
    ds, pay, cols, kw = _grower_setup(GROWER_CASES[0])
    grow = tgrower2.make_partitioned_grower(
        convert.feature_meta_from_numpy(_feature_meta_device(ds)),
        tgrower2.GrowerConfig(**kw), 300, tgrower2.PayloadCols(**cols),
        ds.num_features, merged_hist=True)
    tpay = convert.payload_from_numpy(pay)
    tree, _, _ = grow(tpay, torch.zeros_like(tpay),
                      torch.ones(ds.num_features, dtype=torch.bool))
    assert (grow.hist_engine, grow.part_engine) == ("segment_histogram",
                                                    "partition_segment")
    ref, _, _ = _grow_port(ds, pay, cols, kw, merged_hist=True)
    nl = ref["num_leaves"]
    assert tree["num_leaves"] == nl
    for k in ("split_feature", "split_bin", "seg_start", "seg_cnt"):
        np.testing.assert_array_equal(tree[k].numpy(), ref[k].numpy(),
                                      err_msg=k)


# -- training through train ---------------------------------------------------

def test_merged_training_through_train(monkeypatch):
    """The flag set and the mode forced (a CPU payload never meets the
    auto rule): `train` runs the merged grower, whose trees are the JAX
    package's, and its model text loads in the JAX package."""
    monkeypatch.setattr(cuda_segment, "PARTITION_HIST_VALIDATED", True)
    monkeypatch.setattr(tgbdt, "make_partitioned_grower", functools.partial(
        tgrower2.make_partitioned_grower, merged_hist=True))
    X, y = _data(5, nan_frac=0.05)
    bj, bt = _train_both(X, y, seed=5)
    g = bt._engine.grower
    assert (g.hist_engine, g.part_engine) == ("partition_segment_hist",) * 2
    _assert_same_structure(bj, bt, X)
    np.testing.assert_allclose(bt.predict(X, raw_score=True),
                               bj.predict(X, raw_score=True), atol=1e-5)
    loaded = lj.Booster(model_str=bt.model_to_string())
    np.testing.assert_allclose(loaded.predict(X, raw_score=True),
                               bt.predict(X, raw_score=True), rtol=1e-12,
                               atol=1e-12)
