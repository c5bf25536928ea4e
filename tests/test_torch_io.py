"""Text and streamed ingest in the port against the JAX package on the
CPU: parse_file on CSV, TSV and LibSVM with and without a header line
(missing-value markers too) and the .weight / .query / .init sidecars;
Dataset(path) trains the in-memory model; the StreamingDatasetBuilder
against the JAX one on the same dense, CSR and CSC chunks (bins, mappers,
the bounded reservoir, positioned pushes by reference); push_rows /
push_rows_csr, binned subsets of streamed and path-backed Datasets, cv
over a path, and the stream's errors."""
import numpy as np
import pytest
import torch

import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt
from lightgbm_tpu.io import parser as jparser
from lightgbm_tpu.io.stream import StreamingDatasetBuilder as JBuilder
from lightgbm_tpu_torch.io import parser
from lightgbm_tpu_torch.io.dataset import BinnedDataset
from lightgbm_tpu_torch.io.stream import StreamingDatasetBuilder

from test_torch_binary_cache import _assert_same_binned

# one intra-op thread: the pytest-xdist workers share the cores, and
# torch's OpenMP regions spin in their barriers when oversubscribed
torch.set_num_threads(1)

PARAMS = dict(objective="binary", num_leaves=15, max_bin=63,
              min_data_in_leaf=20, verbose=-1)
CPU = dict(PARAMS, device_type="cpu")


def _data(n=1500, f=8, seed=0, nan=True):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, f))
    X[:, 2] = np.where(rng.random(n) < 0.6, 0.0, X[:, 2])
    if nan:
        X[rng.random((n, f)) < 0.04] = np.nan
    y = (np.nan_to_num(X[:, 0]) + 0.4 * np.nan_to_num(X[:, 1]) > 0)
    return X, y.astype(np.float64)


def _write(path, X, y, fmt, header):
    """%.17g values (the text round trip reproduces the doubles), NaN as
    'na' in the delimited formats; LibSVM leaves zeros out."""
    with open(path, "w") as fh:
        if fmt == "libsvm":
            for lab, row in zip(y, X):
                fh.write("%g %s\n" % (lab, " ".join(
                    "%d:%.17g" % (j, v) for j, v in enumerate(row)
                    if v != 0.0)))
            return
        sep = "," if fmt == "csv" else "\t"
        if header:
            fh.write(sep.join(["label"] + ["c%d" % j
                                           for j in range(X.shape[1])])
                     + "\n")
        for lab, row in zip(y, X):
            fh.write(sep.join(["%g" % lab] + ["na" if np.isnan(v)
                                              else "%.17g" % v
                                              for v in row]) + "\n")


@pytest.mark.parametrize("fmt,header", [("csv", True), ("csv", False),
                                        ("tsv", True), ("tsv", False),
                                        ("libsvm", False)])
def test_parse_file_matches_jax(fmt, header, tmp_path):
    X, y = _data(nan=fmt != "libsvm")
    path = str(tmp_path / ("rows." + fmt))
    _write(path, X, y, fmt, header)
    assert parser.sniff(path)[:3] == jparser.sniff(path)[:3]
    assert parser.sniff(path)[2] is header
    Xt, yt = parser.parse_file(path)
    Xj, yj = jparser.parse_file(path)
    np.testing.assert_array_equal(Xt, Xj)
    np.testing.assert_array_equal(yt, yj)
    np.testing.assert_array_equal(np.isnan(Xt), np.isnan(X))
    np.testing.assert_array_equal(np.nan_to_num(Xt), np.nan_to_num(X))


def test_detect_format_and_sidecars(tmp_path):
    lines = ["1 3:0.5 7:2", "0\t1.5\t2", "1,2,3", "a,b 12:00:01"]
    for ln in lines:
        assert parser.detect_format([ln]) == jparser.detect_format([ln])
    for name, vals in (("w.weight", [0.5, 1.0, 2.5]),
                       ("q.query", [3, 4]), ("i.init", [0.1, -0.2])):
        (tmp_path / name).write_text("\n".join(map(str, vals)) + "\n")
        got = parser.load_sidecar(str(tmp_path / name))
        np.testing.assert_array_equal(got, jparser.load_sidecar(
            str(tmp_path / name)))
        np.testing.assert_array_equal(got, vals)
    assert parser.load_sidecar(str(tmp_path / "none.weight")) is None


def test_dataset_from_path_trains_in_memory_model(tmp_path):
    """Dataset(path) (CSV with a header, and its .weight sidecar) trains
    the model of the same rows and weights in memory byte for byte."""
    X, y = _data(seed=1)
    w = np.random.default_rng(2).uniform(0.5, 1.5, len(y))
    path = str(tmp_path / "train.csv")
    _write(path, X, y, "csv", True)
    np.savetxt(path + ".weight", w, fmt="%.17g")
    from_path = lt.train(dict(CPU), lt.Dataset(path), 5, verbose_eval=False)
    memory = lt.train(dict(CPU), lt.Dataset(X, label=y, weight=w), 5,
                      verbose_eval=False)
    np.testing.assert_array_equal(from_path.train_set.get_weight(),
                                  w.astype(np.float32))
    assert from_path.model_to_string() == memory.model_to_string()


def _to_csr(M):
    mask = (M != 0.0) | np.isnan(M)
    indptr = np.concatenate([[0], np.cumsum(mask.sum(1))]).astype(np.int64)
    return indptr, np.nonzero(mask)[1].astype(np.int32), M[mask]


def _to_csc(M):
    mask = (M != 0.0) | np.isnan(M)
    col_ptr = np.concatenate([[0], np.cumsum(mask.sum(0))]).astype(np.int64)
    rows = np.nonzero(mask.T)[1]
    return col_ptr, rows, M.T[mask.T]


def _push_all(builder, X, y, kind, step=500):
    if kind == "csc":
        builder.push_csc(*_to_csc(X), X.shape[0], label=y)
        return builder
    for s in range(0, len(X), step):
        if kind == "dense":
            builder.push_dense(X[s:s + step], label=y[s:s + step])
        else:
            builder.push_csr(*_to_csr(X[s:s + step]), X.shape[1],
                             label=y[s:s + step])
    return builder


@pytest.mark.parametrize("kind", ["dense", "csr", "csc"])
@pytest.mark.parametrize("cap", [200000, 600])
def test_stream_matches_jax(kind, cap):
    """The same chunks pushed into both packages' builders give the same
    binned set; past the reservoir's cap (bin_construct_sample_cnt) both
    bin from the same bounded reservoir; below it the bins are
    from_matrix's."""
    X, y = _data(n=1800, seed=3)
    params = dict(PARAMS, bin_construct_sample_cnt=cap)
    tb = _push_all(StreamingDatasetBuilder(params=params), X, y, kind)
    jb = _push_all(JBuilder(params=params), X, y, kind)
    assert tb.reservoir_rows == jb.reservoir_rows == min(cap, len(X))
    if cap < len(X):
        np.testing.assert_array_equal(tb._res[:cap], jb._res[:cap])
    t = tb.finalize(lt.Config(params))
    j = jb.finalize(lj.Config(params))
    _assert_same_binned(t, j)
    if cap >= len(X):
        ref = BinnedDataset.from_matrix(X, lt.Config(params))
        np.testing.assert_array_equal(t.bins, ref.bins)


def test_stream_by_reference_matches_jax():
    """Positioned pushes into a builder made by reference: encoded at push
    time with the reference's mappers (and bundles), in any order, to the
    bins from_matrix gives with them; the same in the JAX package."""
    X, y = _data(n=1600, seed=4)
    Xr, yr = _data(n=1200, seed=5)
    ref_t = lt.Dataset(Xr, label=yr, params=PARAMS).construct()
    ref_j = lj.Dataset(Xr, label=yr, params=PARAMS)
    ref_j.construct(lj.Config(dict(PARAMS)))
    tb = StreamingDatasetBuilder(params=PARAMS, reference=ref_t,
                                 num_total_rows=len(X))
    jb = JBuilder(params=PARAMS, reference=ref_j, num_total_rows=len(X))
    for s in (1200, 400, 0, 800):
        tb.push_dense(X[s:s + 400], label=y[s:s + 400], start_row=s)
        jb.push_dense(X[s:s + 400], label=y[s:s + 400], start_row=s)
    assert tb.streaming and tb.num_pushed_rows == len(X)
    t, j = tb.finalize(lt.Config(PARAMS)), jb.finalize(lj.Config(PARAMS))
    _assert_same_binned(t, j)
    mem = BinnedDataset.from_matrix(X, lt.Config(PARAMS),
                                    bin_mappers=ref_t.binned.bin_mappers)
    np.testing.assert_array_equal(t.bins, mem.bins)


def test_push_rows_trains_in_memory_model():
    """Dataset(StreamingDatasetBuilder) fed by push_rows and push_rows_csr
    (labels given to the Dataset) trains the in-memory model byte for
    byte; an iterator of (X, y) chunks does too."""
    X, y = _data(n=2000, seed=6)
    ds = lt.Dataset(StreamingDatasetBuilder(params=PARAMS), label=y,
                    params=PARAMS)
    for k, s in enumerate(range(0, len(X), 500)):
        if k % 2:
            ds.push_rows_csr(*_to_csr(X[s:s + 500]), X.shape[1])
        else:
            ds.push_rows(X[s:s + 500])
    pushed = lt.train(dict(CPU), ds, 5, verbose_eval=False)
    chunks = ((X[s:s + 700], y[s:s + 700]) for s in range(0, len(X), 700))
    iterated = lt.train(dict(CPU), lt.Dataset(chunks, params=PARAMS), 5,
                        verbose_eval=False)
    memory = lt.train(dict(CPU), lt.Dataset(X, label=y), 5,
                      verbose_eval=False)
    assert pushed.model_to_string() == memory.model_to_string()
    assert iterated.model_to_string() == memory.model_to_string()
    with pytest.raises(lt.LightGBMError, match="after the dataset"):
        ds.push_rows(X[:10])


def test_subsets_of_streamed_and_path_datasets(tmp_path):
    """A streamed or path-backed Dataset has no raw matrix: its subset is
    the binned rows gathered (reference GetSubset), equal to the in-memory
    subset's bins, labels and query groups."""
    X, y = _data(n=1200, seed=7)
    idx = np.sort(np.random.default_rng(0).choice(len(y), 500,
                                                  replace=False))
    memory = lt.Dataset(X, label=y, params=PARAMS).construct()
    mem_sub = memory.subset(idx).construct()
    streamed = lt.Dataset(iter([(X[:600], y[:600]), (X[600:], y[600:])]),
                          params=PARAMS)
    path = str(tmp_path / "rows.tsv")
    _write(path, X, y, "tsv", False)
    for ds in (streamed, lt.Dataset(path, params=PARAMS)):
        assert not ds.has_raw_matrix()
        sub = ds.subset(idx)
        assert sub.num_data() == 500
        np.testing.assert_array_equal(sub.binned.bins[:, :500],
                                      memory.binned.bins[:, idx])
        np.testing.assert_array_equal(sub.get_label(), mem_sub.get_label())


def test_cv_over_a_path_dataset(tmp_path):
    """cv over a path-backed Dataset: its folds are binned subsets, and
    the results equal cv over the same rows in memory."""
    X, y = _data(n=1500, seed=8)
    path = str(tmp_path / "rows.csv")
    _write(path, X, y, "csv", False)
    kw = dict(nfold=3, seed=1, verbose_eval=False)
    from_path = lt.cv(dict(CPU), lt.Dataset(path), 4, **kw)
    memory = lt.cv(dict(CPU), lt.Dataset(X, label=y), 4, **kw)
    assert from_path.keys() == memory.keys()
    for k in memory:
        np.testing.assert_allclose(from_path[k], memory[k], rtol=1e-6)


@pytest.mark.parametrize("case,match", [
    ("mixed", "cannot mix"),
    ("width", "features"),
    ("incomplete", "incomplete"),
    ("overlap", "already pushed"),
    ("quarantine", "quarantine"),
    ("not_a_stream", "streaming Dataset"),
    ("empty", "empty stream"),
])
def test_stream_errors(case, match):
    X, y = _data(n=400, seed=9)
    ref = lt.Dataset(X, label=y, params=PARAMS).construct()
    with pytest.raises(lt.LightGBMError, match=match):
        if case == "mixed":
            b = StreamingDatasetBuilder(params=PARAMS)
            b.push_dense(X[:100])
            b.push_dense(X[100:200], start_row=100)
        elif case == "width":
            b = StreamingDatasetBuilder(params=PARAMS)
            b.push_dense(X[:100])
            b.push_dense(X[100:200, :5])
        elif case == "incomplete":
            b = StreamingDatasetBuilder(params=PARAMS, reference=ref,
                                        num_total_rows=400)
            b.push_dense(X[:300], start_row=0)
            b.finalize(lt.Config(PARAMS))
        elif case == "overlap":
            b = StreamingDatasetBuilder(params=PARAMS, reference=ref,
                                        num_total_rows=400)
            b.push_dense(X[:300], start_row=0)
            b.push_dense(X[200:], start_row=200)
        elif case == "quarantine":
            # quarantine is armed (runtime/quality.py); a by-reference
            # stream cannot renumber rows, so a positioned push carrying
            # a non-finite label is refused
            b = StreamingDatasetBuilder(params=PARAMS, reference=ref,
                                        num_total_rows=400, quarantine=True)
            bad = y[:100].copy()
            bad[7] = np.nan
            b.push_dense(X[:100], label=bad, start_row=0)
        elif case == "not_a_stream":
            lt.Dataset(X, label=y).push_rows(X[:10])
        else:
            StreamingDatasetBuilder(params=PARAMS).finalize(
                lt.Config(PARAMS))


@pytest.mark.parametrize("fmt", ["csv", "tsv", "libsvm"])
def test_numpy_readers_match_jax(fmt, tmp_path):
    """An all-numeric file goes through numpy's readers, value for value
    as the JAX package's parser reads it; a missing-value marker sends
    the file to the pure-Python parser instead, with the same result."""
    X, y = _data(n=800, seed=11, nan=False)
    path = str(tmp_path / ("rows." + fmt))
    _write(path, X, y, fmt, False)
    got = parser.parse_file(path)
    ref = jparser.parse_file(path)
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[1], ref[1])
    np.testing.assert_array_equal(got[0], X)
    with open(path, "a") as fh:
        fh.write("1 0:na 3:2.5\n" if fmt == "libsvm" else
                 ("," if fmt == "csv" else "\t").join(
                     ["1", "na"] + ["0.5"] * (X.shape[1] - 1)) + "\n")
    got = parser.parse_file(path)
    ref = jparser.parse_file(path)
    np.testing.assert_array_equal(got[0], ref[0])
    assert np.isnan(got[0][-1, 0])
