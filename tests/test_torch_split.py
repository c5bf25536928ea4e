"""The port's split search and binary objective against the JAX package
on the same seeded numpy inputs."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.objective.binary import BinaryLogloss as JBinary
from lightgbm_tpu.ops import split as jsplit
from lightgbm_tpu_torch import convert
from lightgbm_tpu_torch.config import Config as TConfig
from lightgbm_tpu_torch.objective.binary import BinaryLogloss as TBinary
from lightgbm_tpu_torch.ops import split as tsplit

F, B = 7, 32

KW = dict(l1=0.0, l2=0.0, max_delta_step=0.0, min_data_in_leaf=5,
          min_sum_hessian_in_leaf=1e-3, min_gain_to_split=0.0)


def _meta(seed):
    """Per-feature metadata covering every missing type, a 2-bin NaN
    feature, narrow features and a trivial one."""
    rng = np.random.default_rng(seed)
    return dict(
        num_bin=np.asarray([B, B, 12, 2, B, 9, 1], np.int32),
        missing_type=np.asarray([0, 2, 1, 2, 1, 0, 0], np.int32),
        default_bin=np.asarray([0, 0, 3, 0, 7, 2, 0], np.int32),
        is_trivial=np.asarray([0, 0, 0, 0, 0, 0, 1], bool),
        is_categorical=np.zeros(F, bool),
        penalty=rng.uniform(0.5, 1.0, F).astype(np.float32),
        monotone=np.zeros(F, np.int32))


def _hist(seed, meta):
    """A consistent histogram: every row lands in one bin per feature."""
    rng = np.random.default_rng(seed)
    n = 600
    g = rng.standard_normal(n).astype(np.float32)
    h = rng.uniform(0.05, 0.25, n).astype(np.float32)
    hist = np.zeros((F, B, 3), np.float32)
    for f in range(F):
        bins = rng.integers(0, meta["num_bin"][f], n)
        np.add.at(hist[f, :, 0], bins, g)
        np.add.at(hist[f, :, 1], bins, h)
        np.add.at(hist[f, :, 2], bins, 1.0)
    return hist, np.float32(g.sum()), np.float32(h.sum()), np.float32(n)


def _jax_meta(meta):
    return jsplit.FeatureMeta(**{k: jnp.asarray(v) for k, v in meta.items()})


def _assert_same_split(got, ref, i=None):
    pick = (lambda a: np.asarray(a)) if i is None else \
        (lambda a: np.asarray(a)[i])
    g = {k: np.asarray(v.numpy() if isinstance(v, torch.Tensor) else v)
         for k, v in got._asdict().items()}
    if i is not None:
        g = {k: v[i] for k, v in g.items()}
    assert int(g["feature"]) == int(pick(ref.feature))
    assert int(g["threshold_bin"]) == int(pick(ref.threshold_bin))
    assert bool(g["default_left"]) == bool(pick(ref.default_left))
    np.testing.assert_allclose(g["gain"], pick(ref.gain), rtol=1e-5)
    for k in ("left_sum_g", "left_sum_h", "left_count", "left_output",
              "right_output"):
        np.testing.assert_allclose(g[k], pick(getattr(ref, k)), rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("kw", [
    {},
    dict(l1=0.5, l2=1.0),
    dict(max_delta_step=0.3, min_data_in_leaf=40),
    dict(min_gain_to_split=0.5, min_sum_hessian_in_leaf=5.0),
])
def test_find_best_split_matches(seed, kw):
    meta = _meta(seed)
    hist, sg, sh, n = _hist(seed, meta)
    fmask = np.ones(F, bool)
    fmask[seed % F] = seed % 2 == 0
    kwargs = dict(KW, **kw)
    ref = jsplit.find_best_split(jnp.asarray(hist), sg, sh, n,
                                 jnp.asarray(fmask), meta=_jax_meta(meta),
                                 **kwargs)
    got = tsplit.find_best_split(torch.from_numpy(hist), float(sg), float(sh),
                                 float(n), torch.from_numpy(fmask),
                                 meta=convert.feature_meta_from_numpy(meta),
                                 **kwargs)
    _assert_same_split(got, ref)


@pytest.mark.parametrize("seed", range(4))
def test_find_best_split_batched_matches(seed):
    meta = _meta(seed)
    q = [_hist(seed * 10 + i, meta) for i in range(3)]
    hists = np.stack([x[0] for x in q])
    sgs, shs, ns = (np.asarray([x[i] for x in q], np.float32)
                    for i in (1, 2, 3))
    fmask = np.ones(F, bool)
    ref = jsplit.find_best_split_batched(
        jnp.asarray(hists), jnp.asarray(sgs), jnp.asarray(shs),
        jnp.asarray(ns), jnp.asarray(fmask), meta=_jax_meta(meta), **KW)
    got = tsplit.find_best_split_batched(
        torch.from_numpy(hists), torch.from_numpy(sgs), torch.from_numpy(shs),
        torch.from_numpy(ns), torch.from_numpy(fmask),
        meta=convert.feature_meta_from_numpy(meta), **KW)
    for i in range(3):
        _assert_same_split(got, ref, i)
    # a row of the batch is the single-leaf search of that histogram
    one = tsplit.find_best_split(
        torch.from_numpy(hists[1]), float(sgs[1]), float(shs[1]),
        float(ns[1]), torch.from_numpy(fmask),
        meta=convert.feature_meta_from_numpy(meta), **KW)
    assert float(one.gain) == float(got.gain[1])


def test_no_valid_split_reports_minus_inf():
    meta = _meta(0)
    hist, sg, sh, n = _hist(0, meta)
    got = tsplit.find_best_split(torch.from_numpy(hist), float(sg),
                                 float(sh), float(n), torch.zeros(F, dtype=bool),
                                 meta=convert.feature_meta_from_numpy(meta),
                                 **KW)
    assert float(got.gain) == float("-inf")


def test_categorical_search_raises():
    meta = _meta(0)
    hist, sg, sh, n = _hist(0, meta)
    with pytest.raises(NotImplementedError):
        tsplit.find_best_split(torch.from_numpy(hist), float(sg), float(sh),
                               float(n), torch.ones(F, dtype=bool),
                               meta=convert.feature_meta_from_numpy(meta),
                               with_categorical=True, **KW)


@pytest.mark.parametrize("l1,l2,mds", [(0.0, 0.0, 0.0), (0.3, 2.0, 0.0),
                                       (0.0, 1.0, 0.05)])
def test_leaf_output_matches(l1, l2, mds):
    rng = np.random.default_rng(1)
    g = rng.standard_normal(50).astype(np.float32)
    h = rng.uniform(0.1, 5.0, 50).astype(np.float32)
    ref = np.asarray(jsplit.leaf_output(jnp.asarray(g), jnp.asarray(h), l1,
                                        l2, mds))
    got = tsplit.leaf_output(torch.from_numpy(g), torch.from_numpy(h), l1,
                             l2, mds).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0)


@pytest.mark.parametrize("params", [{}, dict(sigmoid=2.0),
                                    dict(is_unbalance=True),
                                    dict(scale_pos_weight=3.0)])
def test_binary_gradients_match(params):
    rng = np.random.default_rng(7)
    n = 4000
    score = (rng.standard_normal(n) * 2).astype(np.float32)
    label = (rng.random(n) < 0.3).astype(np.float32)
    weight = rng.uniform(0.5, 2.0, n).astype(np.float32)
    jo, to = JBinary(JConfig(params)), TBinary(TConfig(params))
    jo.init(label, weight)
    to.init(label, weight)
    gj, hj = jo.get_gradients_multi(jnp.asarray(score)[None],
                                    jnp.asarray(label), jnp.asarray(weight))
    gt, ht = to.get_gradients_multi(torch.from_numpy(score)[None],
                                    torch.from_numpy(label),
                                    torch.from_numpy(weight))
    assert gt.dtype == ht.dtype == torch.float32
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=1e-6,
                               atol=1e-7)
    # the two frameworks' f32 exp differ by an ulp; the hessian
    # |r| * (sigmoid - |r|) cancels as |r| nears sigmoid, so an ulp of the
    # response (at most ulp(sigmoid)) moves it by up to sigmoid * ulp * w
    sig = to.sigmoid
    atol = 2 * sig * float(np.spacing(np.float32(sig))) * float(weight.max())
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), rtol=1e-6,
                               atol=atol)
    assert to.boost_from_score() == jo.boost_from_score()
    assert to.to_string() == jo.to_string()
    raw = np.linspace(-3, 3, 11)
    np.testing.assert_array_equal(to.convert_output(raw),
                                  jo.convert_output(raw))
