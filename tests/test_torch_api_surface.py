"""The Booster / Dataset surface of the port against the JAX package on
the CPU (mirroring tests/test_api_surface.py, tests/test_engine.py and
tests/test_pandas.py): one model text loaded in both packages gives the
same dump, importances, evaluation, shuffled order and leaf outputs;
pickling, copies and model_from_string keep the model; the Dataset's
fields, setters, subsets and validation sets, scipy sparse input, and
categorical DataFrames with their pandas_categorical line."""
import copy
import pickle

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt

# one intra-op thread: the pytest-xdist workers share the cores, and
# torch's OpenMP regions spin in their barriers when oversubscribed
torch.set_num_threads(1)

N, F = 1000, 6
PARAMS = {"objective": "binary", "metric": ["auc", "binary_logloss"],
          "num_leaves": 15, "min_data_in_leaf": 10, "verbose": -1}


def _cpu(params):
    return dict(params, device_type="cpu")


def _data(n=N, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, F))
    y = (X[:, 0] + 0.4 * X[:, 1] + 0.3 * rng.standard_normal(n) > 0)
    return X, y.astype(np.float64), rng.uniform(0.5, 1.5, n)


@pytest.fixture(scope="module")
def loaded():
    """One port-trained model text, loaded in both packages."""
    X, y, w = _data()
    bst = lt.train(_cpu(PARAMS), lt.Dataset(X, label=y, weight=w), 5,
                   verbose_eval=False)
    text = bst.model_to_string()
    return dict(X=X, y=y, w=w, bst=bst, text=text,
                bj=lj.Booster(params=PARAMS, model_str=text),
                bt=lt.Booster(params=_cpu(PARAMS), model_str=text))


def test_dump_and_importance_equal_jax(loaded):
    bj, bt = loaded["bj"], loaded["bt"]
    assert bt.dump_model() == bj.dump_model()
    assert bt.dump_model(num_iteration=2) == bj.dump_model(num_iteration=2)
    for kind in ("split", "gain"):
        np.testing.assert_array_equal(bt.feature_importance(kind),
                                      bj.feature_importance(kind))
    assert bt.feature_name() == bj.feature_name()
    assert (bt.num_trees(), bt.num_model_per_iteration(), bt.num_feature(),
            bt.current_iteration()) == (5, 1, F, 5)


def test_eval_on_any_dataset_equals_jax(loaded):
    bj, bt = loaded["bj"], loaded["bt"]
    X2, y2, w2 = _data(300, seed=1)

    def feval(preds, ds):
        return "mean_raw", float(np.mean(preds)), False

    got = bt.eval(lt.Dataset(X2, label=y2, weight=w2), "holdout", feval)
    want = bj.eval(lj.Dataset(X2, label=y2, weight=w2), "holdout", feval)
    assert [r[:2] for r in got] == [r[:2] for r in want] == [
        ("holdout", "auc"), ("holdout", "binary_logloss"),
        ("holdout", "mean_raw")]
    np.testing.assert_allclose([r[2] for r in got], [r[2] for r in want],
                               rtol=1e-12)


def test_shuffle_models_and_leaf_output_equal_jax(loaded):
    texts = []
    for pkg, params in ((lj, PARAMS), (lt, _cpu(PARAMS))):
        bst = pkg.Booster(params=params, model_str=loaded["text"])
        np.random.seed(42)
        bst.shuffle_models(start_iteration=1)
        texts.append(bst.model_to_string())
        assert bst.get_leaf_output(2, 1) == pytest.approx(
            float(bst._model.trees[2].leaf_value[1]))
    assert texts[0] == texts[1]
    assert texts[1] != loaded["text"]
    for t in range(5):
        assert loaded["bt"].get_leaf_output(t, 3) == \
            loaded["bj"].get_leaf_output(t, 3)
    X = loaded["X"]
    np.testing.assert_allclose(
        lt.Booster(_cpu({}), model_str=texts[1]).predict(X),
        loaded["bt"].predict(X), rtol=1e-12)
    with pytest.raises(lt.LightGBMError):
        lt.Booster(_cpu({}), model_str=loaded["text"]).shuffle_models(4, 2)


def test_pickle_copy_and_model_from_string_keep_the_model(loaded):
    bst, X = loaded["bst"], loaded["X"]
    want = bst.predict(X)
    for other in (pickle.loads(pickle.dumps(bst)), copy.copy(bst),
                  copy.deepcopy(bst),
                  lt.Booster(_cpu({}), model_str=loaded["text"])
                  .model_from_string(bst.model_to_string(), verbose=False)):
        assert other.model_to_string() == bst.model_to_string()
        np.testing.assert_array_equal(other.predict(X), want)
    # a training booster pickles as its model; it can no longer train
    again = pickle.loads(pickle.dumps(bst))
    assert again._engine is None
    with pytest.raises(lt.LightGBMError):
        again.update()


def test_attr_network_and_reset_on_a_loaded_booster(loaded):
    bst = lt.Booster(_cpu({}), model_str=loaded["text"])
    assert bst.attr("note") is None
    bst.set_attr(note="hello")
    assert bst.attr("note") == "hello"
    bst.set_attr(note=None)
    assert bst.attr("note") is None
    with pytest.raises(lt.LightGBMError):
        bst.set_attr(note=1)
    assert bst.free_network() is bst and bst.set_network() is bst
    assert bst.set_train_data_name("t") is bst
    bst.reset_parameter({"learning_rate": 0.05})
    assert bst.config.learning_rate == 0.05
    assert bst.params["learning_rate"] == 0.05


def test_dataset_fields_and_setters_match_jax():
    X, y, w = _data(300)
    group = np.array([100, 120, 80])
    init = np.linspace(-1, 1, 300)
    dsj, dst = lj.Dataset(X, label=y), lt.Dataset(X, label=y)
    for ds in (dsj, dst):
        ds.construct()
        ds.set_weight(w)
        ds.set_field("init_score", init)
        ds.set_group(group)
        ds.set_label(1.0 - y)
        assert ds.num_data() == 300 and ds.num_feature() == F
    for field in ("label", "weight", "init_score", "group", "query"):
        np.testing.assert_array_equal(dst.get_field(field),
                                      dsj.get_field(field))
    np.testing.assert_array_equal(dst.get_group(), group)
    with pytest.raises(lt.LightGBMError):
        dst.get_field("nope")
    with pytest.raises(lt.LightGBMError):
        dst.set_field("nope", y)
    with pytest.raises(lt.LightGBMError):
        dst.set_categorical_feature([0])
    dst.set_feature_name(["f%d" % i for i in range(F)])
    assert dst.binned.feature_names == ["f%d" % i for i in range(F)]
    with pytest.raises(lt.LightGBMError):
        dst.set_feature_name(["a"])
    other = lt.Dataset(X)
    with pytest.raises(lt.LightGBMError):
        dst.set_reference(other)
    valid = dst.create_valid(X[:50], label=y[:50])
    chain = valid.get_ref_chain()
    assert chain == {valid, dst}
    assert lt.Dataset(X).set_reference(dst).reference is dst


def test_subset_and_create_valid_bin_like_jax():
    X, y, w = _data(600, seed=2)
    X[::7, 2] = np.nan
    idx = np.arange(0, 600, 3)
    dsj = lj.Dataset(X, label=y, weight=w)
    dst = lt.Dataset(X, label=y, weight=w)
    for a, b in ((dst.subset(idx), dsj.subset(idx)),
                 (dst.create_valid(X[idx], label=y[idx]),
                  dsj.create_valid(X[idx], label=y[idx]))):
        a.construct()
        b.construct()
        np.testing.assert_array_equal(a.binned.bins, b.binned.bins)
        np.testing.assert_array_equal(a.get_label(), b.get_label())
        assert a.binned.bin_mappers is dst.binned.bin_mappers
    np.testing.assert_array_equal(dst.subset(idx).get_weight(),
                                  w[idx].astype(np.float32))


def test_train_feature_and_categorical_names_match_jax():
    X, y, w = _data(800, seed=4)
    X[:, 3] = np.random.default_rng(4).integers(0, 5, 800)
    names = ["a", "b", "c", "cat", "e", "f"]
    texts = []
    for pkg, params in ((lj, PARAMS), (lt, _cpu(PARAMS))):
        bst = pkg.train(dict(params, min_data_per_group=5),
                        pkg.Dataset(X, label=y, weight=w), 3,
                        feature_name=names, categorical_feature=[3],
                        verbose_eval=False)
        assert bst.feature_name() == names
        texts.append(bst.model_to_string())
    # the header up to the tree sizes (the trees' gains are f32 sums)
    head = [t.split("tree_sizes=")[0] for t in texts]
    assert head[0] == head[1]
    assert "feature_names=a b c cat e f" in head[1]


def test_scipy_sparse_input_matches_dense():
    X = sp.random(600, 20, density=0.15, format="csr", random_state=0,
                  dtype=np.float64)
    y = (np.asarray(X.sum(axis=1)).ravel() > 0.5).astype(np.float64)
    params = _cpu(dict(PARAMS, min_data_in_leaf=5))
    sparse = lt.train(params, lt.Dataset(X, label=y), 3, verbose_eval=False)
    dense = lt.train(params, lt.Dataset(X.toarray(), label=y), 3,
                     verbose_eval=False)
    assert sparse.model_to_string() == dense.model_to_string()
    np.testing.assert_array_equal(sparse.predict(X.tocsc()),
                                  dense.predict(X.toarray()))
    dok = sp.dok_matrix(X)
    np.testing.assert_array_equal(sparse.predict(dok),
                                  dense.predict(X.toarray()))


def test_scipy_sparse_subsets_stay_sparse(monkeypatch):
    """A subset of a sparse matrix is sliced while sparse: toarray sees
    the full matrix once (binning) and the slices after."""
    X = sp.random(900, 25, density=0.1, format="csr", random_state=2,
                  dtype=np.float64)
    y = (np.asarray(X.sum(axis=1)).ravel() > 0.5).astype(np.float64)
    densified = []
    orig = sp.csr_matrix.toarray

    def spy(self, *a, **k):
        densified.append(self.shape[0])
        return orig(self, *a, **k)

    monkeypatch.setattr(sp.csr_matrix, "toarray", spy)
    ds = lt.Dataset(X, label=y)
    ds.construct()
    parts = [ds.subset(np.arange(i, 900, 3)) for i in range(3)]
    for p in parts:
        p.construct()
    assert densified.count(900) == 1
    assert densified.count(300) == 3


def _frame(n=600, seed=0):
    pd = pytest.importorskip("pandas")
    rng = np.random.default_rng(seed)
    color = pd.Categorical(rng.choice(["red", "green", "blue"], n),
                           categories=["red", "green", "blue"])
    size = pd.Categorical(rng.choice([3, 1, 2], n), categories=[3, 1, 2])
    df = pd.DataFrame({"num0": rng.standard_normal(n), "color": color,
                       "num1": rng.standard_normal(n), "size": size})
    y = ((df["color"] == "red").to_numpy()
         ^ (df["num0"].to_numpy() > 0)).astype(np.float64)
    return df, y, rng.uniform(0.5, 1.5, n)


def test_categorical_frame_matches_jax(tmp_path):
    pd = pytest.importorskip("pandas")
    df, y, w = _frame()
    params = dict(PARAMS, min_data_per_group=5, cat_smooth=1.0)
    runs = []
    for pkg, p in ((lj, params), (lt, _cpu(params))):
        ds = pkg.Dataset(df, label=y, weight=w)
        bst = pkg.train(p, ds, 4, valid_sets=[pkg.Dataset(
            df.iloc[:200], label=y[:200], reference=ds)], verbose_eval=False)
        runs.append(bst)
    bj, bt = runs
    tail = [b.model_to_string().split("end of trees")[1] for b in runs]
    assert "\npandas_categorical:" in tail[1]
    assert tail[0].split("pandas_categorical:")[1] == \
        tail[1].split("pandas_categorical:")[1]
    assert bt.pandas_categorical == [["red", "green", "blue"], [3, 1, 2]]
    # unseen and reordered categories, through the training lists
    df2 = df.copy()
    df2["color"] = pd.Categorical(["purple"] + list(
        df["color"].astype(str))[1:])
    df2["size"] = df2["size"].cat.set_categories([1, 2, 3])
    np.testing.assert_allclose(bt.predict(df2), bj.predict(df2), rtol=1e-5)
    np.testing.assert_allclose(bt.predict(df2)[1:], bt.predict(df)[1:],
                               rtol=1e-12)
    path = str(tmp_path / "m.txt")
    bt.save_model(path)
    again = lt.Booster(_cpu({}), model_file=path)
    assert again.pandas_categorical == bt.pandas_categorical
    np.testing.assert_array_equal(again.predict(df2), bt.predict(df2))
    assert pickle.loads(pickle.dumps(bt)).pandas_categorical == \
        bt.pandas_categorical


def test_numeric_frame_writes_no_pandas_line():
    pd = pytest.importorskip("pandas")
    X, y, w = _data(300)
    df = pd.DataFrame(X, columns=["c%d" % i for i in range(F)])
    bst = lt.train(_cpu(PARAMS), lt.Dataset(df, label=y), 2,
                   verbose_eval=False)
    assert "pandas_categorical" not in bst.model_to_string()
    assert bst.feature_name() == list(df.columns)
