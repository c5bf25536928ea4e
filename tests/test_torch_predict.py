"""The port's prediction against the JAX package on the CPU: models the
JAX package trains are passed as model text to the port's Booster, then
predicted by the JAX DevicePredictor and the port's (the same f32
traversal: rtol 1e-6 / atol 1e-6, only the order of the sum over trees
may differ), and by the port's Booster.predict(device=True) against its
exact f64 host predict (rtol 1e-5 / atol 1e-6,
tests/test_device_predictor.py's rule).  Also the engine's plumbing:
early stop, depth bound, the scan engine, micro-batching, row buckets,
out_dtype, int8 leaves, pred_leaf / pred_contrib, every objective's
output transform, engine.predict, the device rule, and one training
iteration of every registered objective."""
import numpy as np
import pytest
import torch

import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.models.device_predictor import DevicePredictor as JDP
from lightgbm_tpu.objective import _REGISTRY as J_REGISTRY
from lightgbm_tpu_torch.config import Config as TConfig
from lightgbm_tpu_torch.models import device_predictor as tdpr
from lightgbm_tpu_torch.models.device_predictor import DevicePredictor as TDP
from lightgbm_tpu_torch.objective import _REGISTRY as T_REGISTRY

# one intra-op thread: the pytest-xdist workers share the cores, and
# torch's OpenMP regions spin in their barriers when oversubscribed
torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6          # device vs host (the JAX test's rule)
X_RTOL, X_ATOL = 1e-6, 1e-6      # the port's engine vs the JAX engine
N = 400


def _x(seed, n=N, f=6, nan_rate=0.0):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, f))
    if nan_rate:
        X[rng.random(X.shape) < nan_rate] = np.nan
    return X


def _labels(objective, X):
    base = np.nan_to_num(X)
    if objective in ("multiclass", "multiclassova"):
        return ((base[:, 0] > 0).astype(int) + (base[:, 1] > 0.5)).astype(
            float)
    if objective == "regression":
        return base[:, 0] * 2.0 + 0.3 * base[:, 1]
    if objective == "poisson":
        return np.abs(base[:, 0] * 2.0 + 0.3 * base[:, 1])
    if objective == "xentropy":
        return 1.0 / (1.0 + np.exp(-base[:, 0] - 0.4 * base[:, 1]))
    if objective == "lambdarank":
        return np.clip(np.round(base[:, 0] + 1.0), 0, 3)
    return (base[:, 0] + 0.4 * base[:, 1] > 0).astype(float)


def _jax_model(objective="binary", seed=0, rounds=6, nan_rate=0.0,
               **extra):
    """(JAX booster, X) trained on the CPU."""
    X = _x(seed, nan_rate=nan_rate)
    y = _labels(objective, X)
    params = dict(dict(objective=objective, num_leaves=15, verbose=-1,
                       min_data_in_leaf=5), **extra)
    if objective in ("multiclass", "multiclassova"):
        params["num_class"] = 3
    group = [40] * (N // 40) if objective == "lambdarank" else None
    bst = lj.train(params, lj.Dataset(X, label=y, group=group), rounds)
    return bst, X


def _jax_categorical(n=900, n_cat=140, seed=8, rounds=6):
    """A categorical model whose bitsets span several 32-bit words."""
    rng = np.random.default_rng(seed)
    Xc = rng.integers(0, n_cat, n).astype(float)
    Xn = rng.standard_normal(n)
    X = np.column_stack([Xc, Xn])
    eff = rng.standard_normal(n_cat)
    y = (eff[Xc.astype(int)] + 0.5 * Xn > 0).astype(float)
    bst = lj.train(dict(objective="binary", num_leaves=15, verbose=-1,
                        min_data_per_group=5, cat_smooth=1.0),
                   lj.Dataset(X, label=y, categorical_feature=[0]), rounds)
    X = X.copy()
    X[::11, 0] = 999.0          # an unseen category: right child
    X[::13, 0] = np.nan
    X[::17, 0] = -3.0           # negative: right child
    return bst, X


MODELS = {
    "binary": lambda: _jax_model("binary", rounds=30),
    "regression": lambda: _jax_model("regression", seed=1, rounds=10),
    "poisson": lambda: _jax_model("poisson", seed=2),
    "multiclass": lambda: _jax_model("multiclass", seed=3, rounds=25),
    "multiclassova": lambda: _jax_model("multiclassova", seed=4),
    "xentropy": lambda: _jax_model("xentropy", seed=5),
    "lambdarank": lambda: _jax_model("lambdarank", seed=6),
    "nan": lambda: _jax_model("binary", seed=7, nan_rate=0.15),
    "zero_as_missing": lambda: _jax_model("binary", seed=8,
                                          zero_as_missing=True,
                                          use_missing=True),
    "missing_none": lambda: _jax_model("binary", seed=9, use_missing=False),
    "categorical": _jax_categorical,
    "two_leaves": lambda: _jax_model("binary", seed=10, num_leaves=2),
}

_cache = {}


def _model(name):
    """(JAX booster, port booster loaded from its model text on the CPU,
    X), made once per test process."""
    if name not in _cache:
        bj, X = MODELS[name]()
        if name == "zero_as_missing":
            X = X.copy()
            X[::7, 0] = 0.0              # exact zeros take the missing path
        bt = lt.Booster(params=dict(device_type="cpu"),
                        model_str=bj.model_to_string())
        _cache[name] = (bj, bt, X)
    return _cache[name]


def _tdp(bt, **kw):
    return TDP(bt._model, device="cpu", **kw)


@pytest.mark.parametrize("name", ["binary", "regression", "poisson",
                                  "multiclass", "multiclassova", "xentropy",
                                  "lambdarank", "nan", "zero_as_missing",
                                  "missing_none", "categorical",
                                  "two_leaves"])
def test_engine_matches_jax_engine_and_host(name):
    bj, bt, X = _model(name)
    ref = JDP(bj._model).predict_raw(X)
    got = _tdp(bt).predict_raw(X)
    assert got.shape == ref.shape == (len(X), bt._model.num_tree_per_iteration)
    np.testing.assert_allclose(got, ref, rtol=X_RTOL, atol=X_ATOL)
    for kw in ({}, dict(raw_score=True)):
        np.testing.assert_allclose(bt.predict(X, device=True, **kw),
                                   bt.predict(X, **kw), rtol=RTOL, atol=ATOL)
    # the host predictions of the loaded text are the JAX package's
    np.testing.assert_allclose(bt.predict(X), bj.predict(X), rtol=1e-12,
                               atol=1e-12)


def test_categorical_model_spans_words():
    _, bt, _ = _model("categorical")
    words = max(len(t.cat_words_for_node(n)) for t in bt._model.trees
                for n in range(t.num_leaves - 1))
    assert words > 1


def test_two_leaf_trees_vary():
    _, bt, X = _model("two_leaves")
    assert all(t.num_leaves == 2 for t in bt._model.trees)
    assert len(np.unique(np.round(bt.predict(X, device=True), 8))) > 1


@pytest.mark.parametrize("start,num", [(2, 3), (0, -1), (5, -1), (3, 2),
                                       (0, 2)])
def test_iteration_ranges(start, num):
    bj, bt, X = _model("binary")
    kw = dict(start_iteration=start, num_iteration=num, raw_score=True)
    np.testing.assert_allclose(bt.predict(X, device=True, **kw),
                               bt.predict(X, **kw), rtol=RTOL, atol=ATOL)
    ref = JDP(bj._model, start, num).predict_raw(X)[:, 0]
    np.testing.assert_allclose(_tdp(bt, start_iteration=start,
                                    num_iteration=num).predict_raw(X)[:, 0],
                               ref, rtol=X_RTOL, atol=X_ATOL)


@pytest.mark.parametrize("name,freq,margin", [("binary", 5, 2.0),
                                              ("binary", 1, 0.5),
                                              ("binary", 10, 10.0),
                                              ("multiclass", 5, 2.0)])
def test_early_stop_truncates_as_host(name, freq, margin):
    _, bt, X = _model(name)
    kw = dict(pred_early_stop=True, pred_early_stop_freq=freq,
              pred_early_stop_margin=margin, raw_score=True)
    dev = bt.predict(X, device=True, **kw)
    np.testing.assert_allclose(dev, bt.predict(X, **kw), rtol=RTOL,
                               atol=ATOL)
    if freq == 1:
        # it really truncates
        assert np.abs(dev - bt.predict(X, device=True, raw_score=True)) \
            .max() > 0


def test_early_stop_ignored_for_regression():
    _, bt, X = _model("regression")
    a = bt.predict(X, device=True, pred_early_stop=True,
                   pred_early_stop_freq=1, pred_early_stop_margin=0.1)
    np.testing.assert_array_equal(a, bt.predict(X, device=True))


def test_depth_iterations_are_packed_max_depth():
    bj, bt, _ = _model("binary")
    dp = _tdp(bt)

    def ref_depth(t, node=0, d=0):
        if node < 0 or t.num_leaves <= 1:
            return d
        return max(ref_depth(t, int(t.left_child[node]), d + 1),
                   ref_depth(t, int(t.right_child[node]), d + 1))

    assert 0 < dp.depth_iters <= dp._scan_depth_iters
    assert dp.depth_iters == max(ref_depth(t) for t in bt._model.trees)
    assert dp.depth_iters == JDP(bj._model).depth_iters


@pytest.mark.parametrize("name", ["binary", "multiclass", "nan"])
def test_scan_engine_agrees_with_tree_parallel(name):
    _, bt, X = _model(name)
    dp = _tdp(bt)
    np.testing.assert_allclose(dp.predict_raw_scan(X), dp.predict_raw(X),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", ["binary", "multiclass", "categorical"])
def test_micro_batching_equals_single_shot(name):
    _, bt, X = _model(name)
    one = _tdp(bt).predict_raw(X)
    seen = []
    micro = _tdp(bt, batch_rows=128).predict_raw(
        X, batch_hook=lambda i, n: seen.append((i, n)))
    np.testing.assert_array_equal(micro, one)
    n_batches = -(-len(X) // 128)
    assert seen == [(i, n_batches) for i in range(n_batches)]


def test_row_buckets_share_programs():
    _, bt, X = _model("binary")
    dp = _tdp(bt)
    full = dp.predict_raw(X[:400])               # bucket 512
    base = dp.capture_count()
    for n in (257, 300, 389, 400):
        np.testing.assert_array_equal(dp.predict_raw(X[:n]), full[:n])
    assert dp.capture_count() == base == 1
    np.testing.assert_array_equal(dp.predict_raw(X[:100]), full[:100])
    assert dp.capture_count() == base + 1        # bucket 128
    assert tdpr._bucket_rows(1) == 16 and tdpr._bucket_rows(513) == 1024


def test_narrow_input_raises():
    _, bt, X = _model("binary")
    with pytest.raises(ValueError):
        bt.predict(X[:, :2], device=True)


@pytest.mark.parametrize("name", ["binary", "multiclass"])
def test_f32_surface_is_exact_downcast(name):
    _, bt, X = _model(name)
    for kw in ({}, dict(raw_score=True)):
        f64 = bt.predict(X, device=True, **kw)
        f32 = bt.predict(X, device=True, out_dtype=np.float32, **kw)
        assert f32.dtype == np.float32 and f32.shape == f64.shape
        assert np.array_equal(f32, f64.astype(np.float32))


def test_int8_leaves_within_grid_bound():
    _, bt, X = _model("binary")
    dp = _tdp(bt, leaf_quant="int8")
    assert dp._arrs["value_q"].dtype == torch.int8
    host = bt.predict(X, raw_score=True)
    q = dp.predict_raw(X)[:, 0]
    amax = np.abs(np.asarray(dp._packed["leaf"], np.float64)).max(axis=1)
    bound = float(np.where(amax > 0, amax, 127.0).sum() / 127.0)
    err = float(np.abs(q - host).max())
    assert 0.0 < err <= bound
    # transformed predictions keep the bound through the sigmoid
    qp = bt.predict(X, device=True, leaf_quant="int8")
    assert float(np.abs(qp - bt.predict(X)).max()) <= bound / 4 + 1e-12


def test_int8_flag_flips_default(monkeypatch):
    _, bt, X = _model("binary")
    assert tdpr.LEAF_QUANT_VALIDATED is False
    plain = bt.predict(X, device=True)
    explicit = bt.predict(X, device=True, leaf_quant="int8")
    assert not np.array_equal(plain, explicit)
    for opt_out in ("none", "float32"):
        assert np.array_equal(bt.predict(X, device=True, leaf_quant=opt_out),
                              plain)
    monkeypatch.setattr(tdpr, "LEAF_QUANT_VALIDATED", True)
    assert np.array_equal(bt.predict(X, device=True), explicit)
    assert np.array_equal(bt.predict(X, device=True, leaf_quant="none"),
                          plain)


@pytest.mark.parametrize("name", ["binary", "multiclass", "categorical"])
def test_pred_leaf_and_contrib_match_jax(name):
    bj, bt, X = _model(name)
    np.testing.assert_array_equal(bt.predict(X, pred_leaf=True),
                                  bj.predict(X, pred_leaf=True))
    np.testing.assert_allclose(bt.predict(X, pred_contrib=True),
                               bj.predict(X, pred_contrib=True),
                               rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("name", sorted(J_REGISTRY))
def test_convert_output_matches_jax(name):
    params = dict(objective=name, verbose=-1)
    if name in ("multiclass", "multiclassova"):
        params["num_class"] = 3
    jo = J_REGISTRY[name](JConfig(params))
    to = T_REGISTRY[name](TConfig(dict(params, device_type="cpu")))
    assert to.to_string() == jo.to_string()
    assert to.num_model_per_iteration == jo.num_model_per_iteration
    raw = np.random.default_rng(3).standard_normal(
        (50, to.num_model_per_iteration)) * 3
    if to.num_model_per_iteration == 1:
        raw = raw[:, 0]
    np.testing.assert_allclose(to.convert_output(raw), jo.convert_output(raw),
                               rtol=1e-12, atol=0)


def test_registries_match():
    assert sorted(T_REGISTRY) == sorted(J_REGISTRY)


def test_reg_sqrt_model_text_round_trips():
    cfg = TConfig(dict(objective="regression", reg_sqrt=True,
                       device_type="cpu"))
    to = T_REGISTRY["regression"](cfg)
    assert to.to_string() == "regression sqrt"
    raw = np.array([-2.0, 0.5, 3.0])
    np.testing.assert_array_equal(to.convert_output(raw),
                                  np.sign(raw) * raw * raw)


def test_engine_predict_takes_booster_file_and_string(tmp_path):
    bj, bt, X = _model("binary")
    text = bj.model_to_string()
    f = tmp_path / "m.txt"
    f.write_text(text)
    cpu = dict(params=dict(device_type="cpu"))
    ref = bt.predict(X)
    for model in (str(f), f, text):
        np.testing.assert_allclose(lt.predict(model, X, **cpu), ref,
                                   rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(lt.predict(bt, X), ref, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(lt.predict(bt, X, device=False), ref)
    with pytest.raises(lt.LightGBMError):
        lt.predict(12, X)


def test_loaded_model_needs_a_card_unless_cpu_is_asked():
    bj, _, X = _model("binary")
    bst = lt.Booster(model_str=bj.model_to_string())
    # the host traversal needs no device
    np.testing.assert_array_equal(bst.predict(X), bj.predict(X))
    if torch.cuda.is_available():
        assert bst.predict_device().type == "cuda"
        return
    with pytest.raises(lt.LightGBMError, match="CUDA"):
        bst.predict(X, device=True)
    with pytest.raises(lt.LightGBMError, match="CUDA"):
        lt.predict(bj.model_to_string(), X)


def test_trained_booster_predicts_on_its_training_device():
    X = _x(20)
    y = _labels("binary", X)
    bst = lt.train(dict(objective="binary", num_leaves=7, verbose=-1,
                        device_type="cpu"), lt.Dataset(X, label=y), 3,
                   verbose_eval=False)
    assert bst.predict_device() == torch.device("cpu")
    np.testing.assert_allclose(bst.predict(X, device=True), bst.predict(X),
                               rtol=RTOL, atol=ATOL)
    # the cached predictor follows the model as it grows
    bst.update()
    np.testing.assert_allclose(bst.predict(X, device=True), bst.predict(X),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("objective", sorted(T_REGISTRY))
def test_every_registered_objective_trains(objective):
    """One CPU iteration of every objective of the registry (all are
    trainable): K trees for the multiclass ones, lambdarank on query
    groups; the model text loads back and predicts the same."""
    X = _x(21)
    params = dict(objective=objective, num_leaves=7, verbose=-1,
                  device_type="cpu")
    base = X[:, 0] + 0.4 * X[:, 1]
    y = _labels(objective, X)
    if objective in ("poisson", "gamma", "tweedie"):
        y = np.exp(0.5 * base)
    elif objective in ("xentropy", "xentlambda"):
        y = _labels("xentropy", X)
    elif objective in ("regression_l1", "huber", "fair", "quantile",
                       "mape"):
        y = _labels("regression", X)
    K = 1
    if objective in ("multiclass", "multiclassova"):
        params["num_class"] = K = 3
    group = [40] * (N // 40) if objective == "lambdarank" else None
    bst = lt.train(params, lt.Dataset(X, label=y, group=group), 1,
                   verbose_eval=False)
    assert bst.current_iteration() == 1
    assert len(bst._model.trees) == K
    assert bst._model.num_tree_per_iteration == K
    loaded = lt.Booster(params={"device_type": "cpu"},
                        model_str=bst.model_to_string())
    np.testing.assert_array_equal(loaded.predict(X), bst.predict(X))
