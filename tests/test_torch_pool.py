"""The histogram pool of the port (histogram_pool_size) against the JAX
package on the CPU: pool sizing, the LRU grower against the JAX one, the
rebuilds of evicted parents, and pooled training through `train`."""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt
from lightgbm_tpu.boosting import gbdt as jgbdt
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.io.dataset import BinnedDataset as JBinnedDataset
from lightgbm_tpu_torch.boosting import gbdt as tgbdt
from lightgbm_tpu_torch.ops import cuda_segment

from test_torch_grower import (CASES, _assert_trees_match, _grow_both,
                               _grow_port, _payload, _problem,
                               _quantize_columns)
from test_torch_train import _assert_same_structure

# the fault's input: 3000 x 6 weighted rows from numpy seed 0, 31 leaves,
# 3 rounds; 0.01 MB gives the JAX package 2 pool slots
N, F = 3000, 6
POOL_PARAMS = dict(objective="binary", num_leaves=31, min_data_in_leaf=5,
                   verbose=-1)
POOL_MB = 0.01


def _fault_data():
    rng = np.random.default_rng(0)
    X = rng.standard_normal((N, F))
    y = (X[:, 0] + 0.5 * X[:, 1] * X[:, 2] + 0.3 * rng.standard_normal(N)
         > 0).astype(np.float64)
    w = rng.uniform(0.5, 1.5, N)
    return X, y, w


def _train(pkg, X, y, w, rounds=3, **extra):
    params = dict(POOL_PARAMS, **extra)
    if pkg is lt:
        params["device_type"] = "cpu"
    return pkg.train(params, pkg.Dataset(X, label=y, weight=w), rounds,
                     verbose_eval=False)


def _trees(text):
    return text.split("end of trees")[0].split("Tree=")[1:]


def test_pooled_model_matches_jax_pooled_model():
    """histogram_pool_size is honoured: the port rebuilds evicted parents
    as the JAX package does, so its pooled trees are the JAX package's,
    node for node, and differ from its unpooled trees wherever the JAX
    package's do."""
    X, y, w = _fault_data()
    jp = _train(lj, X, y, w, histogram_pool_size=POOL_MB)
    ju = _train(lj, X, y, w)
    tp = _train(lt, X, y, w, histogram_pool_size=POOL_MB)
    tu = _train(lt, X, y, w)
    _assert_same_structure(jp, tp, X)
    np.testing.assert_allclose(tp.predict(X, raw_score=True),
                               jp.predict(X, raw_score=True), atol=1e-5)
    differs_j = [a != b for a, b in zip(_trees(jp.model_to_string()),
                                        _trees(ju.model_to_string()))]
    differs_t = [a != b for a, b in zip(_trees(tp.model_to_string()),
                                        _trees(tu.model_to_string()))]
    assert any(differs_j)
    assert differs_t == differs_j
    assert tp._engine.grower_cfg.hist_pool_slots == 2
    # the pooled model text loads in the JAX package
    loaded = lj.Booster(model_str=tp.model_to_string())
    np.testing.assert_allclose(loaded.predict(X, raw_score=True),
                               tp.predict(X, raw_score=True), rtol=1e-12,
                               atol=1e-12)


@pytest.mark.parametrize("L,f,num_bins,pool_mb", [
    (31, 6, 256, -1.0), (31, 6, 256, 0.01), (31, 6, 256, 0.1),
    (31, 6, 64, 0.05), (255, 28, 256, 2.0), (255, 28, 256, 1000.0),
    (255, 28, 256, 0.0), (1023, 2000, 256, -1.0), (1023, 2000, 64, -1.0),
    (4095, 968, 256, -1.0), (127, 968, 256, -1.0), (2, 6, 16, 0.001)])
def test_pool_slots_match_jax(L, f, num_bins, pool_mb, monkeypatch):
    """_hist_pool_slots over (leaves, features, bins, MB), the 4 GB
    auto-cap and its warning included."""
    warned = {}
    for name, mod in (("jax", jgbdt), ("port", tgbdt)):
        monkeypatch.setattr(mod.Log, "warning", staticmethod(
            lambda msg, *a, _n=name: warned.__setitem__(_n, msg % a)))
    config = SimpleNamespace(num_leaves=L, histogram_pool_size=pool_mb)
    ds = SimpleNamespace(bins=np.empty((f, 0), np.uint8),
                         max_num_bin=num_bins)
    want = jgbdt.GBDT._hist_pool_slots(config, ds)
    assert tgbdt.GBDT._hist_pool_slots(config, ds) == want
    assert warned.get("port") == warned.get("jax")
    capped = pool_mb <= 0 and L * f * num_bins * 12 > 4 << 30
    assert ("jax" in warned) == capped


def test_parent_rebuilds_with_two_slots(monkeypatch):
    """A spy on the histogram wrapper: with 2 slots the grower walks an
    evicted parent's rows again, beyond the root and one smaller child
    per split; the tree is still the JAX pooled grower's."""
    calls = []
    real = cuda_segment.segment_histogram

    def spy(payload, start, count, **kw):
        calls.append(int(count))
        return real(payload, start, count, **kw)

    spy.launches = 0
    monkeypatch.setattr(cuda_segment, "segment_histogram", spy)
    case = CASES[1]
    X, y = _problem(case["seed"], case["nan_frac"])
    ds = JBinnedDataset.from_matrix(X, JConfig(dict(max_bin=case["max_bin"],
                                                    verbose=-1)))
    pay, cols = _payload(ds, y, case["seed"])
    pool = dict(hist_pool_slots=2)
    jtree, jpay, ttree, tpay = _grow_both(case, pay, cols, ds, jextra=pool,
                                          textra=pool)
    _assert_trees_match(jtree, jpay, ttree, tpay, cols)
    splits = ttree["num_leaves"] - 1
    assert splits > 4
    assert len(calls) > 1 + splits
    calls.clear()
    unpooled, _ = _grow_port(case, pay, cols, ds)
    assert len(calls) == 1 + unpooled["num_leaves"] - 1


@pytest.mark.parametrize("qmax", [127, 2114])
def test_quantized_pool_is_exact(qmax):
    """int32 histograms never round, so a rebuilt parent is the stored
    one: the quantized pooled tree is the unpooled one, byte for byte,
    and the JAX package's quantized pooled tree."""
    case = CASES[1]
    X, y = _problem(case["seed"], case["nan_frac"])
    ds = JBinnedDataset.from_matrix(X, JConfig(dict(max_bin=case["max_bin"],
                                                    verbose=-1)))
    pay, cols = _payload(ds, y, case["seed"])
    pay, qscale = _quantize_columns(pay, cols, qmax, case["seed"])
    quant = dict(quantized=True, qmax=qmax)
    pooled = dict(quant, hist_pool_slots=2)
    jtree, jpay, ttree, tpay = _grow_both(case, pay, cols, ds, jextra=pooled,
                                          textra=pooled, qscale=qscale)
    _assert_trees_match(jtree, jpay, ttree, tpay, cols)
    ref, ref_pay = _grow_port(case, pay, cols, ds, qscale, **quant)
    for k, v in ref.items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(ttree[k], v), k
    assert tpay.tobytes() == ref_pay.tobytes()


def test_quantized_pooled_training_byte_identical():
    X, y, w = _fault_data()
    quant = dict(gradient_quantization=True, gradient_quant_dtype="int8")
    pooled = _train(lt, X, y, w, histogram_pool_size=POOL_MB, **quant)
    plain = _train(lt, X, y, w, **quant)
    assert pooled._engine.grower_cfg.hist_pool_slots == 2
    assert pooled.model_to_string() == plain.model_to_string()


def test_pool_keeps_the_one_leaf_loop_under_frontier():
    """tpu_frontier_batch asks for rounds of 8 leaves; a pooled grower
    keeps the one-leaf loop (the JAX gate), one round per split."""
    X, y, w = _fault_data()
    bst = _train(lt, X, y, w, histogram_pool_size=POOL_MB,
                 tpu_frontier_batch=8)
    splits = np.mean([t.num_leaves - 1 for t in bst._model.trees])
    assert splits > 4
    assert bst.split_rounds_per_tree() == splits
    assert bst._engine.grower.part_engine == "partition_segment"
    ref = _train(lt, X, y, w, histogram_pool_size=POOL_MB)
    assert bst.model_to_string() == ref.model_to_string()
