"""The whole slice: lightgbm_tpu_torch.train against lightgbm_tpu.train on
the same data (CPU), model text interchange, the device rule, and the
package's independence from JAX."""
import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch import convert

# one intra-op thread: the pytest-xdist workers share the cores, and
# torch's OpenMP regions spin in their barriers when oversubscribed
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "lightgbm_tpu_torch"

N, F = 2000, 8
PARAMS = dict(objective="binary", num_leaves=31, max_bin=63,
              learning_rate=0.1, verbose=-1)


def _data(seed=0, nan_frac=0.0):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((N, F))
    y = (X[:, 0] + 0.5 * X[:, 1] * X[:, 2] - 0.3 * np.abs(X[:, 3])
         + 0.3 * rng.standard_normal(N) > 0).astype(np.float64)
    X[rng.random((N, F)) < nan_frac] = np.nan
    return X, y


def _weights(seed):
    """Row weights for the parity runs.  Unweighted, the first tree's
    gradients take two values (one per label), so two candidate splits
    with the same row and positive counts tie EXACTLY, and each package
    breaks the tie by the rounding of its own sums (the two frameworks'
    f32 exp differ by an ulp, and XLA's CPU reduce and cumsum add in
    another order than torch's).  Continuous weights make every
    candidate's gain distinct, so the trees can be compared node by node."""
    return np.random.default_rng(seed + 100).uniform(0.5, 1.5, N)


def _train_both(X, y, rounds=5, seed=0, **extra):
    params = dict(PARAMS, **extra)
    w = _weights(seed)
    bj = lj.train(params, lj.Dataset(X, label=y, weight=w), rounds,
                  verbose_eval=False)
    bt = lt.train(dict(params, device_type="cpu"),
                  lt.Dataset(X, label=y, weight=w), rounds,
                  verbose_eval=False)
    return bj, bt


def _assert_same_structure(bj, bt, X):
    """Same split features, topology and leaf counts in every tree, and
    every training row lands in the same leaf.  Thresholds are compared
    through that routing: where a leaf's rows leave the bins between two
    thresholds empty, the candidates tie exactly, and which one wins is
    decided by ulps (XLA's CPU cumsum adds in blocks, torch's in
    sequence), so the chosen bin may differ while no row moves."""
    for tj, tt in zip(bj._model.trees, bt._model.trees):
        assert tt.num_leaves == tj.num_leaves
        nl = tj.num_leaves
        for k in ("split_feature", "left_child", "right_child",
                  "internal_count"):
            np.testing.assert_array_equal(getattr(tt, k)[:nl - 1],
                                          getattr(tj, k)[:nl - 1], err_msg=k)
        np.testing.assert_array_equal(tt.leaf_count[:nl], tj.leaf_count[:nl])
    np.testing.assert_array_equal(bt._model.predict_leaf_index(X),
                                  bj._model.predict_leaf_index(X))


@pytest.mark.parametrize("case", [dict(seed=0), dict(seed=1, nan_frac=0.05),
                                  dict(seed=2, min_data_in_leaf=40,
                                       lambda_l2=1.0),
                                  dict(seed=3, feature_fraction=0.6,
                                       max_depth=4)])
def test_training_matches_jax(case):
    case = dict(case)
    seed = case.pop("seed")
    X, y = _data(seed, case.pop("nan_frac", 0.0))
    bj, bt = _train_both(X, y, seed=seed, **case)
    assert bt.device == torch.device("cpu")
    assert bt.current_iteration() == bj.current_iteration() == 5
    _assert_same_structure(bj, bt, X)
    np.testing.assert_allclose(bt.predict(X, raw_score=True),
                               bj.predict(X, raw_score=True), atol=1e-5)
    np.testing.assert_allclose(bt.predict(X), bj.predict(X), atol=1e-5)


def test_host_binning_matches():
    X, y = _data(3, nan_frac=0.1)
    cfg = dict(PARAMS)
    dj = lj.Dataset(X, label=y).construct(lj.Config(cfg)).binned
    dt = lt.Dataset(X, label=y).construct(lt.Config(cfg)).binned
    np.testing.assert_array_equal(dt.bins, dj.bins)
    assert dt.feature_infos() == dj.feature_infos()
    assert dt.num_data_padded == dj.num_data_padded


def test_model_text_loads_across_packages():
    X, y = _data(4)
    bj, bt = _train_both(X, y, seed=4)
    sj, st = bj.model_to_string(), bt.model_to_string()
    # Not byte-identical: leaf values, gains and internal values differ in
    # the last f32 digits, because the two frameworks' exp differ by an
    # ulp in the binary gradients and XLA's CPU reduce and cumsum add in
    # another order than torch.sum / torch.cumsum; the same ulps can pick
    # another of two exactly tied thresholds (see _assert_same_structure).
    # The header and feature lines are identical.
    _assert_same_structure(bj, bt, X)
    lines_j, lines_t = sj.splitlines(), st.splitlines()
    assert len(lines_j) == len(lines_t)
    head = lines_j.index("tree_sizes=" + sj.split("tree_sizes=")[1]
                         .splitlines()[0])
    assert lines_t[:head] == lines_j[:head]
    # each package loads the other's model and predicts what its author does
    tj_from_t = lj.Booster(model_str=st)
    tt_from_j = lt.Booster(model_str=sj)
    np.testing.assert_array_equal(tt_from_j.predict(X, raw_score=True),
                                  bj.predict(X, raw_score=True))
    np.testing.assert_array_equal(tj_from_t.predict(X, raw_score=True),
                                  bt.predict(X, raw_score=True))
    # and a round trip through the port is the identity on the text
    assert lt.Booster(model_str=st).model_to_string() == st


def test_save_model_and_train_metric(tmp_path):
    X, y = _data(5)
    ds = lt.Dataset(X, label=y)
    bst = lt.train(dict(PARAMS, device_type="cpu", metric="auc,binary_logloss"),
                   ds, 3, valid_sets=[ds], verbose_eval=False)
    names = {m: v for m, v in bst.best_score["training"].items()}
    assert names["auc"] > 0.8 and names["binary_logloss"] < 0.69
    path = tmp_path / "model.txt"
    bst.save_model(str(path))
    loaded = lt.Booster(model_file=str(path))
    np.testing.assert_array_equal(loaded.predict(X), bst.predict(X))
    # training scores kept in the payload match the model's predictions
    raw = bst._engine.raw_train_score()[0]
    np.testing.assert_allclose(raw, bst.predict(X, raw_score=True),
                               atol=1e-5)


def test_train_without_cpu_request_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    X, y = _data(6)
    for params in (PARAMS, dict(PARAMS, device_type="cuda"),
                   dict(PARAMS, device="gpu")):
        with pytest.raises(lt.LightGBMError, match="no CUDA device"):
            lt.train(params, lt.Dataset(X, label=y), 1, verbose_eval=False)
    with pytest.raises(lt.LightGBMError, match="device_type"):
        lt.train(dict(PARAMS, device_type="tpu"), lt.Dataset(X, label=y), 1,
                 verbose_eval=False)


@pytest.mark.parametrize("params", [
    # the parallel learners, refused here until they were ported: without
    # a process group each trains the serial learner, with the JAX
    # package's warning (two ranks: tests/test_torch_parallel.py)
    dict(tree_learner="feature"),
    dict(tree_learner="data"),
    dict(tree_learner="voting")])
def test_unported_options_raise(params):
    X, y = _data(7)
    bst = lt.train(dict(PARAMS, device_type="cpu", **params),
                   lt.Dataset(X, label=y), 1, verbose_eval=False)
    assert bst._engine.parallel_mode is None
    ref = lt.train(dict(PARAMS, device_type="cpu"), lt.Dataset(X, label=y),
                   1, verbose_eval=False)
    assert bst.model_to_string() == ref.model_to_string()


def test_payload_conversion_roundtrip():
    rng = np.random.default_rng(8)
    pay = rng.standard_normal((300, 38)).astype(np.float32)
    pay[5, 3] = np.nan
    t = convert.payload_from_numpy(pay)
    assert t.dtype == torch.float32 and t.is_contiguous()
    back = convert.payload_to_numpy(t)
    assert back.tobytes() == pay.tobytes()


def test_import_leaves_jax_out():
    code = ("import sys, lightgbm_tpu_torch\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'lightgbm_tpu' or "
            "m.startswith('lightgbm_tpu.')]\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT), env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_port_source_imports_jax_or_the_jax_package():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 15
    for path in files:
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "lightgbm_tpu"), \
                "%s imports %s" % (path.relative_to(ROOT), name)


def _run_chip_smoke(cwd):
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=str(cwd),
                          env=env, capture_output=True, text=True,
                          timeout=300)


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_card_or_checkout(alone, tmp_path):
    """chip_smoke.py exits non-zero and prints no result on a machine
    without a CUDA device, and in a directory holding only itself."""
    if torch.cuda.is_available():
        pytest.skip("this check is for machines without a CUDA device")
    cwd = ROOT
    if alone:
        (tmp_path / "chip_smoke.py").write_text(
            (ROOT / "chip_smoke.py").read_text())
        cwd = tmp_path
    out = _run_chip_smoke(cwd)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


# -- quantized gradients and frontier batching ---------------------------

def _auc(y, p):
    order = np.argsort(p)
    ranks = np.empty(len(p))
    ranks[order] = np.arange(1, len(p) + 1)
    npos = y.sum()
    return (ranks[y > 0].sum() - npos * (npos + 1) / 2) / max(
        npos * (len(y) - npos), 1)


def _binary_problem(n, f=20, seed=7):
    """tests/test_quantized.py's problem."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, f)).astype(np.float32)
    w = rng.standard_normal(f)
    logit = (X @ w) * 0.5 + 0.4 * X[:, 0] * X[:, 1] + 0.3 * np.abs(X[:, 2])
    logit += rng.standard_normal(n).astype(np.float32) * 0.8
    return X, (logit > 0).astype(np.float64)


QBASE = dict(objective="binary", verbose=-1, seed=11, device_type="cpu")


def _text(X, y, rounds=5, **params):
    return lt.train(dict(QBASE, num_leaves=15, **params),
                    lt.Dataset(X, label=y), rounds,
                    verbose_eval=False).model_to_string()


@pytest.fixture(scope="module")
def auc_parity_baseline():
    """The port's f32 run that both quantized grids are held against."""
    X, y = _binary_problem(24_000)
    Xtr, ytr, Xte, yte = X[:20_000], y[:20_000], X[20_000:], y[20_000:]
    params = dict(QBASE, num_leaves=31)
    bf = lt.train(dict(params), lt.Dataset(Xtr, label=ytr), 11,
                  verbose_eval=False)
    return Xtr, ytr, Xte, yte, params, _auc(yte, bf.predict(Xte))


@pytest.mark.parametrize("qdtype", ["int16", "int8"])
def test_quant_training_auc_parity(qdtype, auc_parity_baseline):
    """tests/test_quantized.py:215-250 for the port: 20k x 20, 31 leaves,
    11 iterations, |dAUC| <= 0.002 against the port's f32 run."""
    Xtr, ytr, Xte, yte, params, auc_f = auc_parity_baseline
    bq = lt.train(dict(params, gradient_quantization=True,
                       gradient_quant_dtype=qdtype),
                  lt.Dataset(Xtr, label=ytr), 11, verbose_eval=False)
    auc_q = _auc(yte, bq.predict(Xte))
    assert auc_f > 0.75
    assert abs(auc_q - auc_f) <= 0.002, (auc_q, auc_f)
    rep = bq.quant_report
    assert rep["qmax"] == (127 if qdtype == "int8" else 32767)
    assert rep["hist_gh_bytes_per_row"] == (2 if qdtype == "int8" else 4)
    assert rep["hist_bytes_reduction_vs_f32"] == \
        (4.0 if qdtype == "int8" else 2.0)


def test_quant_default_off_byte_identity():
    """tests/test_quantized.py:272 for the port: unset and False give the
    f32 model byte for byte, and True changes it (the knob engages)."""
    X, y = _binary_problem(3_000, f=6)
    m_unset = _text(X, y)
    assert _text(X, y, gradient_quantization=False) == m_unset
    assert _text(X, y, gradient_quantization="false") == m_unset
    m_quant = _text(X, y, gradient_quantization=True,
                    gradient_quant_dtype="int8")
    assert m_quant != m_unset


def test_quant_reruns_byte_identical():
    X, y = _binary_problem(3_000, f=6)
    kw = dict(gradient_quantization=True, gradient_quant_dtype="int8")
    assert _text(X, y, **kw) == _text(X, y, **kw)
    # another seed draws other roundings
    assert _text(X, y, **kw) != _text(X, y, **dict(kw, seed=12))


@pytest.mark.parametrize("quant", [{}, dict(gradient_quantization=True,
                                            gradient_quant_dtype="int8")])
def test_frontier_model_text_byte_identical(quant):
    """tests/test_frontier_batch.py:130-148 for the port: the
    frontier-batched grower writes the one-leaf loop's model byte for
    byte, in f32 and composed with quantization, in fewer rounds."""
    rng = np.random.default_rng(11)
    X = rng.standard_normal((3000, 8)).astype(np.float32)
    y = (X[:, 0] + 0.4 * X[:, 1] * X[:, 2] +
         rng.standard_normal(3000) * 0.3 > 0).astype(np.float32)
    params = dict(QBASE, num_leaves=31, **quant)
    b1 = lt.train(dict(params), lt.Dataset(X, label=y), 10,
                  verbose_eval=False)
    b2 = lt.train(dict(params, tpu_frontier_batch="4"),
                  lt.Dataset(X, label=y), 10, verbose_eval=False)
    assert b1.model_to_string() == b2.model_to_string()
    r1, r2 = b1.split_rounds_per_tree(), b2.split_rounds_per_tree()
    assert r2 < r1 <= 30
    # one blocking fetch per tree either way: the tree's own
    assert b2.host_syncs_per_tree() == b1.host_syncs_per_tree() == [1] * 10


def test_dispatch_knobs_are_accepted_no_ops():
    """pipeline_depth, boost_window, tpu_histogram_impl and
    tpu_profile_phases leave the model as it is."""
    X, y = _binary_problem(3_000, f=6)
    assert _text(X, y, pipeline_depth=0, boost_window="4",
                 tpu_histogram_impl="lax",
                 tpu_profile_phases="true") == _text(X, y)
    with pytest.raises(ValueError, match="tpu_histogram_impl"):
        _text(X, y, tpu_histogram_impl="xla")


def test_jax_knobs_coerce_cli_strings():
    """tests/test_frontier_batch.py:156 for the port's Config."""
    c = lt.Config({"tpu_frontier_batch": "4", "gradient_quantization": "false",
                   "tpu_profile_phases": "1", "boost_window": "2"})
    assert c.tpu_frontier_batch == 4 and isinstance(c.tpu_frontier_batch, int)
    assert c.gradient_quantization is False
    assert c.tpu_profile_phases is True and c.boost_window == 2
    d = lt.Config({})
    assert (d.tpu_histogram_impl, d.tpu_profile_phases, d.tpu_frontier_batch,
            d.gradient_quantization, d.gradient_quant_dtype,
            d.sentinel_nonfinite, d.pipeline_depth, d.boost_window) == \
        ("auto", False, 1, False, "int16", "off", 1, 1)


@pytest.mark.parametrize("policy", ["abort", "rollback"])
def test_sentinel_nonfinite_trains(policy):
    """The sentinel trains a clean run byte for byte as "off" does (it
    reads the tree's one fetch and a device flag beside it)."""
    X, y = _binary_problem(1_000, f=4)
    assert _text(X, y, rounds=3, sentinel_nonfinite=policy) == \
        _text(X, y, rounds=3, sentinel_nonfinite="off")
