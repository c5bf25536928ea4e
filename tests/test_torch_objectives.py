"""The port's single-model objectives against the JAX package's on the CPU,
on the same seeded numpy inputs: gradients and hessians (weighted and
unweighted, with reg_sqrt where it applies, padded rows with w = 0
included; bit for bit where no transcendental function enters, else
rtol 1e-6 / atol 1e-7 but where cancellation widens it, see TOL),
BoostFromScore and the percentiles
(to 1e-12), the leaf-output renewal (equal), and the label checks."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import lightgbm_tpu_torch as lt
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.objective import create_objective as j_create
from lightgbm_tpu.objective import regression as jreg
from lightgbm_tpu.utils.log import LightGBMError as JError
from lightgbm_tpu_torch.config import Config as TConfig
from lightgbm_tpu_torch.objective import create_objective as t_create
from lightgbm_tpu_torch.objective import regression as treg

# one intra-op thread: the pytest-xdist workers share the cores, and
# torch's OpenMP regions spin in their barriers when oversubscribed
torch.set_num_threads(1)

N, PAD = 700, 68
#: objectives whose labels pass through reg_sqrt (the others disable it)
SQRT = ("regression", "regression_l1", "fair", "quantile", "mape")
#: the single-model objectives (multiclass, multiclassova and lambdarank
#: are held in test_torch_multiclass_train.py / test_torch_rank_train.py)
NEW = ("regression", "regression_l1", "huber", "fair", "poisson",
       "quantile", "mape", "gamma", "tweedie", "xentropy", "xentlambda")
#: no transcendental function in their gradients: the same f32 operations
#: in the same order, so the same bits
EXACT = ("regression", "regression_l1", "huber", "fair", "quantile", "mape")
#: where the two frameworks' f32 exp (an ulp apart) meet cancellation, the
#: rule rtol 1e-6 / atol 1e-7 widens: gamma's 1 - y exp(-s) and tweedie's
#: -y e1 + e2 to two ulps at 1 (atol 2^-22); the weighted xentlambda
#: hessian divides by (c - 1)^2 with c from 1 - exp(-w log1p(e^s)), and
#: in f32 both packages' values stand up to 6e-5 (relative) from its f64
#: evaluation at these inputs, so the two are held to rtol 2e-4
TOL = {("gamma", False): (1e-6, 2 ** -22), ("gamma", True): (1e-6, 2 ** -22),
       ("tweedie", False): (1e-6, 2 ** -22),
       ("tweedie", True): (1e-6, 2 ** -22),
       ("xentlambda", True): (2e-4, 1e-7)}


def _labels(objective, rng, n=N):
    f = rng.standard_normal(n)
    if objective in ("poisson", "gamma", "tweedie"):
        return np.exp(0.6 * f)
    if objective in ("xentropy", "xentlambda"):
        return 1.0 / (1.0 + np.exp(-2.0 * f))
    return 3.0 * f + 1.0


def _pair(objective, label, weight, **params):
    params = dict(objective=objective, **params)
    oj = j_create(objective, JConfig(params))
    ot = t_create(objective, TConfig(params))
    oj.init(label, weight)
    ot.init(label, weight)
    return oj, ot


def _cases():
    for obj in NEW:
        for weighted in (False, True):
            yield obj, weighted, False
            if obj in SQRT:
                yield obj, weighted, True


@pytest.mark.parametrize("objective,weighted,sqrt", list(_cases()))
def test_gradients_match_jax(objective, weighted, sqrt):
    rng = np.random.default_rng(len(objective) * 7 + weighted + 2 * sqrt)
    label = _labels(objective, rng).astype(np.float32)
    weight = rng.uniform(0.5, 1.5, N).astype(np.float32) if weighted \
        else None
    oj, ot = _pair(objective, label, weight, reg_sqrt=sqrt,
                   alpha=0.7 if objective == "quantile" else 0.9)
    # the padded layout the trainers pass: padded rows carry label 0 and
    # weight 0, scores spread wide enough to reach the exp tails
    lab = np.concatenate([label, np.zeros(PAD, np.float32)])
    w = np.concatenate([weight if weighted else np.ones(N, np.float32),
                        np.zeros(PAD, np.float32)])
    score = (rng.standard_normal(N + PAD) * 2.0).astype(np.float32)
    gj, hj = oj.get_gradients_multi(jnp.asarray(score)[None],
                                    jnp.asarray(lab), jnp.asarray(w))
    gt, ht = ot.get_gradients_multi(torch.from_numpy(score)[None],
                                    torch.from_numpy(lab),
                                    torch.from_numpy(w))
    assert gt.dtype == ht.dtype == torch.float32
    assert gt.shape == ht.shape == (1, N + PAD)
    rtol, atol = TOL.get((objective, weighted), (1e-6, 1e-7))
    for got, ref in ((gt, gj), (ht, hj)):
        got = got.numpy()
        assert np.isfinite(got).all()
        if objective in EXACT and not sqrt:
            np.testing.assert_array_equal(got, np.asarray(ref))
        else:
            np.testing.assert_allclose(got, np.asarray(ref), rtol=rtol,
                                       atol=atol)
    if objective == "xentlambda" and weighted:
        # w = 0 rows select 0, they do not multiply a 0/0 into NaN
        assert not gt[0, N:].any() and not ht[0, N:].any()


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("objective", NEW)
def test_boost_from_score_matches_jax(objective, weighted):
    rng = np.random.default_rng(len(objective) + 3 * weighted)
    label = _labels(objective, rng).astype(np.float32)
    weight = rng.uniform(0.5, 1.5, N).astype(np.float32) if weighted \
        else None
    oj, ot = _pair(objective, label, weight)
    assert ot.boost_from_score() == pytest.approx(oj.boost_from_score(),
                                                  rel=1e-12, abs=1e-12)


@pytest.mark.parametrize("n", [0, 1, 2, 5, 64, 501])
@pytest.mark.parametrize("alpha", [0.05, 0.25, 0.5, 0.9, 0.999])
def test_percentiles_match_jax(n, alpha):
    rng = np.random.default_rng(n * 31 + int(alpha * 1000))
    data = rng.standard_normal(n)
    data[: n // 4] = 0.5      # ties
    weights = rng.uniform(0.1, 2.0, n)
    assert treg.percentile(data, alpha) == pytest.approx(
        jreg.percentile(data, alpha), rel=1e-12, abs=1e-12)
    assert treg.weighted_percentile(data, weights, alpha) == pytest.approx(
        jreg.weighted_percentile(data, weights, alpha), rel=1e-12,
        abs=1e-12)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("objective", ["regression_l1", "quantile", "mape"])
def test_renew_leaf_values_match_jax(objective, weighted):
    rng = np.random.default_rng(11 + weighted)
    n_pad, L = N + PAD, 9
    label = _labels(objective, rng).astype(np.float32)
    weight = rng.uniform(0.5, 1.5, N).astype(np.float32) if weighted \
        else None
    oj, ot = _pair(objective, label, weight, alpha=0.3)
    assert ot.renew_tree_output_required() and oj.renew_tree_output_required()
    leaf_values = rng.standard_normal(L)
    leaf_ids = rng.integers(0, L - 1, n_pad)   # the last leaf stays empty
    pred = rng.standard_normal(n_pad)
    in_bag = rng.random(n_pad) < 0.6
    got = ot.renew_leaf_values(leaf_values, leaf_ids, pred, in_bag)
    ref = oj.renew_leaf_values(leaf_values, leaf_ids, pred, in_bag)
    np.testing.assert_array_equal(got, ref)
    assert got[L - 1] == leaf_values[L - 1]
    assert not np.array_equal(got, leaf_values)


@pytest.mark.parametrize("objective", sorted(set(NEW) - {"regression_l1",
                                                         "quantile",
                                                         "mape"}))
def test_other_objectives_renew_nothing(objective):
    ot = t_create(objective, TConfig(dict(objective=objective)))
    assert not ot.renew_tree_output_required()


@pytest.mark.parametrize("objective,label,weight,params", [
    ("poisson", [1.0, -0.5, 2.0], None, {}),
    ("poisson", [0.0, 0.0, 0.0], None, {}),
    ("gamma", [1.0, -2.0, 3.0], None, {}),
    ("tweedie", [0.0, 0.0, 0.0], None, {}),
    ("xentropy", [0.2, 1.5, 0.3], None, {}),
    ("xentropy", [0.2, 0.5, 0.3], [1.0, -1.0, 1.0], {}),
    ("xentropy", [0.2, 0.5, 0.3], [0.0, 0.0, 0.0], {}),
    ("xentlambda", [-0.1, 0.5, 0.3], None, {}),
    ("xentlambda", [0.2, 0.5, 0.3], [1.0, 0.0, 1.0], {}),
])
def test_check_label_errors(objective, label, weight, params):
    label = np.asarray(label)
    weight = None if weight is None else np.asarray(weight)
    cfg = dict(objective=objective, **params)
    with pytest.raises(JError):
        j_create(objective, JConfig(cfg)).init(label, weight)
    with pytest.raises(lt.LightGBMError):
        t_create(objective, TConfig(cfg)).init(label, weight)


def test_quantile_alpha_out_of_range_raises():
    with pytest.raises(lt.LightGBMError):
        t_create("quantile", TConfig(dict(objective="quantile", alpha=1.0)))


def test_mape_label_weight_matches_jax():
    rng = np.random.default_rng(5)
    label = (rng.standard_normal(N) * 3.0).astype(np.float32)
    weight = rng.uniform(0.5, 1.5, N).astype(np.float32)
    for w in (None, weight):
        oj, ot = _pair("mape", label, w)
        np.testing.assert_array_equal(ot.label_weight, oj.label_weight)
