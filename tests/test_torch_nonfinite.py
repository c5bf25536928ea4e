"""A non-finite gradient burst under the card's arithmetic, on the CPU.

The card's f32 histograms (B1, B7) sum fixed-point integers: a NaN or inf
gradient converts to an extreme int64 and the sums came out finite, so the
card grew a tree of finite leaves where the JAX package (and the port on
the CPU, summing f32 in row order) grows a stump whose leaf value is NaN
or inf.  Here the grower's histogram is the card's plain version
(`segment.segment_histogram_fixed`, the root totals taken from it) and a
host logloss objective's every 7th gradient is NaN or +inf at iteration 2:
the port's tree must be the JAX package's, a non-finite stump, and the
sentinel must name the JAX package's field.
"""
import numpy as np
import pytest
import torch

import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.ops import cuda_segment
from lightgbm_tpu_torch.ops import segment as tseg
from lightgbm_tpu_torch.runtime import resilience

torch.set_num_threads(1)

BURST_AT = 2


def _card_route(num_features):
    """The f32 histogram route with the card's fixed-point arithmetic."""
    def segment_histogram(payload, start, count, *, scale=None,
                          workspace=None, raw=False, **kw):
        if raw:
            return tseg.fixed_cells(payload, start, count, scale=scale, **kw)
        return tseg.segment_histogram_fixed(payload, start, count,
                                            scale=scale, **kw)
    return segment_histogram


def _burst_fobj(value):
    calls = {"n": 0}

    def fobj(preds, ds):
        p = 1.0 / (1.0 + np.exp(-preds))
        g, h = p - ds.get_label(), p * (1.0 - p)
        if calls["n"] == BURST_AT:
            g = g.copy()
            g[::7] = value
        calls["n"] += 1
        return g, h
    return fobj


def _data():
    rng = np.random.default_rng(0)
    X = rng.standard_normal((3000, 5)).astype(np.float32)
    y = (X[:, 0] + 0.3 * rng.standard_normal(3000) > 0).astype(np.float32)
    return X, y


PARAMS = {"objective": "none", "num_leaves": 7, "verbose": -1}


def _tree(text, i):
    return text.split("end of trees")[0].split("Tree=")[1:][i]


@pytest.mark.parametrize("value", [np.nan, np.inf], ids=["nan", "inf"])
def test_burst_under_card_arithmetic_is_the_jax_stump(monkeypatch, value):
    monkeypatch.setattr(cuda_segment, "histogram_route", _card_route)
    X, y = _data()
    bt = lt.Booster(dict(PARAMS, device_type="cpu"), lt.Dataset(X, label=y))
    bj = lj.Booster(dict(PARAMS), lj.Dataset(X, label=y))
    for b in (bt, bj):
        fobj = _burst_fobj(value)
        for _ in range(BURST_AT + 1):
            b.update(fobj=fobj)
    tt = _tree(bt.model_to_string(), BURST_AT)
    tj = _tree(bj.model_to_string(), BURST_AT)
    lines = [ln for ln in tt.splitlines()
             if ln.startswith(("num_leaves=", "leaf_value="))]
    assert lines == [ln for ln in tj.splitlines()
                     if ln.startswith(("num_leaves=", "leaf_value="))]
    assert lines[0] == "num_leaves=1"
    assert not np.isfinite(float(lines[1].split("=")[1]))


def test_sentinel_names_the_jax_field_under_card_arithmetic(monkeypatch):
    monkeypatch.setattr(cuda_segment, "histogram_route", _card_route)
    X, y = _data()
    bt = lt.Booster(dict(PARAMS, device_type="cpu",
                         sentinel_nonfinite="abort"),
                    lt.Dataset(X, label=y))
    fobj = _burst_fobj(np.nan)
    with pytest.raises(resilience.NonFiniteDetected) as err:
        for _ in range(BURST_AT + 1):
            bt.update(fobj=fobj)
    assert err.value.iteration == BURST_AT
    assert err.value.field == "leaf values"


def test_finite_gradients_keep_the_card_trees():
    """The predicate is selected, not branched on: with finite gradients
    the card's arithmetic grows its own tree (not a stump)."""
    X, y = _data()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cuda_segment, "histogram_route", _card_route)
        bt = lt.train(dict(PARAMS, objective="binary", device_type="cpu"),
                      lt.Dataset(X, label=y), 3)
    assert all(t.num_leaves == 7 for t in bt._model.trees)
