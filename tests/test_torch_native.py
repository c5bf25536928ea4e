"""The native ingest of the PyTorch port (lightgbm_tpu_torch/io/native.py
over cpp/ingest.cc, built by capi.ensure_built) against the numpy and
pure-Python readers and the JAX package on the CPU: parse_dense's arrays
equal the numpy reader's and the JAX parse_file's, missing-value markers
read as NaN as the pure-Python parser reads them, a text token or a row
wider than the first is declined and parse_file's fallback gives the JAX
package's arrays; encode_bins writes the Python binning's bins bit for
bit (NaN, zero-as-missing and trivial features), into a column slice of
a wider store too, and declines categorical features; a library that
does not build raises from parse_file with the compiler's output; and
the platform probe (resilience.probe_platform) with its two faults."""
import os

import numpy as np
import pytest
import torch

from lightgbm_tpu.io import parser as jparser
from lightgbm_tpu_torch import Config
from lightgbm_tpu_torch.io import native, parser
from lightgbm_tpu_torch.io.dataset import BinnedDataset
from lightgbm_tpu_torch.runtime import resilience

# one intra-op thread: the pytest-xdist workers share the cores
torch.set_num_threads(1)


def _matrix(n=600, f=6, seed=0, nan=0.0):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, f))
    X[:, 1] = np.round(X[:, 1] * 3)          # few distinct values
    X[:, 2] = np.where(rng.random(n) < 0.6, 0.0, X[:, 2])   # sparse
    X[:, 5] = 0.0                            # trivial (all zeros)
    if nan:
        X[rng.random((n, f)) < nan] = np.nan
        X[:, 5] = 0.0
    y = (X[:, 0] > 0).astype(np.float64)
    return X, y


def _write(path, X, y, sep, header):
    with open(path, "w") as fh:
        if header:
            fh.write(sep.join(["label"] + ["f%d" % j
                                           for j in range(X.shape[1])]) + "\n")
        for lab, row in zip(y.tolist(), X.tolist()):
            fh.write(sep.join(repr(v) for v in [lab] + row) + "\n")


@pytest.fixture(scope="module", autouse=True)
def built():
    """Build the base library once for the file; a build failure fails
    every test here with the compiler's output."""
    from lightgbm_tpu_torch import capi
    capi.ensure_built()
    assert native._load() is not None


@pytest.mark.parametrize("sep,header", [(",", True), (",", False),
                                        ("\t", True), ("\t", False)])
def test_parse_dense_equals_numpy_reader_and_jax(tmp_path, sep, header):
    X, y = _matrix(seed=1)
    path = str(tmp_path / "d.txt")
    _write(path, X, y, sep, header)
    got = native.parse_dense(path, sep, 0, header, X.shape[1] + 1)
    assert got is not None
    Xn, yn = parser._parse_delimited_numpy(path, sep, 0, None, header)
    np.testing.assert_array_equal(got[0], Xn)
    np.testing.assert_array_equal(got[1], yn)
    np.testing.assert_array_equal(got[0], X)
    Xp, yp = parser.parse_file(path)
    Xj, yj = jparser.parse_file(path)
    np.testing.assert_array_equal(Xp, Xj)
    np.testing.assert_array_equal(yp, yj)


def test_missing_markers_read_as_the_python_parser_reads_them(tmp_path):
    path = tmp_path / "m.csv"
    path.write_text("label,a,b,c\n1,na,2.5,NULL\n0,,1e300,?\n1,3,-0.0,n/a\n")
    got = native.parse_dense(str(path), ",", 0, True, 4)
    assert got is not None
    with open(path) as fh:
        body = [ln for ln in fh.readlines() if ln.strip()][1:]
    Xp, yp = parser._parse_delimited(body, ",", 0, None)
    np.testing.assert_array_equal(got[0], Xp)
    np.testing.assert_array_equal(got[1], yp)
    X, y = parser.parse_file(str(path))
    Xj, yj = jparser.parse_file(str(path))
    np.testing.assert_array_equal(X, Xj)
    np.testing.assert_array_equal(y, yj)


@pytest.mark.parametrize("text", ["1,2.5,3.0\n0,abc,2.0\n",
                                  "1,2.5\n0,1.0,2.0,3.0\n"])
def test_declined_files_fall_back_to_the_readers(tmp_path, text):
    path = tmp_path / "bad.csv"
    path.write_text(text)
    assert native.parse_dense(str(path), ",", 0, False, 3 if "abc" in text
                              else 2) is None
    if "abc" in text:
        # the pure-Python parser refuses it loudly, as the JAX package's
        with pytest.raises(ValueError):
            parser.parse_file(str(path))
        with pytest.raises(ValueError):
            jparser.parse_file(str(path))
        return
    X, y = parser.parse_file(str(path))
    Xj, yj = jparser.parse_file(str(path))
    np.testing.assert_array_equal(X, Xj)
    np.testing.assert_array_equal(y, yj)


def test_parse_file_tries_native_first(tmp_path, monkeypatch):
    X, y = _matrix(seed=2)
    path = str(tmp_path / "d.tsv")
    _write(path, X, y, "\t", False)
    calls = []
    real = native.parse_dense
    monkeypatch.setattr(native, "parse_dense",
                        lambda *a: calls.append(a) or real(*a))
    Xp, yp = parser.parse_file(path, num_features=X.shape[1] + 2)
    assert len(calls) == 1
    assert Xp.shape == (len(y), X.shape[1] + 2)
    np.testing.assert_array_equal(Xp[:, :X.shape[1]], X)
    assert np.isnan(Xp[:, X.shape[1]:]).all()


@pytest.mark.parametrize("extra", [dict(), dict(zero_as_missing=True),
                                   dict(use_missing=False),
                                   dict(max_bin=15)])
def test_encode_bins_is_the_python_binning_bit_for_bit(extra):
    X, _ = _matrix(n=3000, seed=3, nan=0.1)
    cfg = Config(dict(verbose=-1, **extra))
    mappers = BinnedDataset._find_bin_mappers(X, cfg, ())
    assert any(m.is_trivial for m in mappers)
    native_bins = np.zeros((X.shape[1], 3072), np.uint8)
    assert native.encode_bins(X, mappers, native_bins)
    python_bins = np.zeros_like(native_bins)
    for j, m in enumerate(mappers):
        if not m.is_trivial:
            python_bins[j, :len(X)] = m.values_to_bins(X[:, j])
    np.testing.assert_array_equal(native_bins, python_bins)


def test_encode_bins_declines_categorical_and_wide_bins():
    X, _ = _matrix(n=800, seed=4)
    X[:, 1] = np.abs(X[:, 1])
    cfg = Config(dict(verbose=-1))
    cat = BinnedDataset._find_bin_mappers(X, cfg, (1,))
    assert not native.encode_bins(X, cat, np.zeros((6, 896), np.uint8))
    num = BinnedDataset._find_bin_mappers(X, cfg, ())
    assert not native.encode_bins(X, num, np.zeros((6, 896), np.uint16))


def test_encode_bins_writes_a_column_slice_of_a_wider_store():
    # the C encoder takes the row stride of the store it writes: a slice
    # of columns [start, start + n) of a wider feature-major store gets
    # the whole-store bins there and leaves every other column alone
    X, _ = _matrix(n=1000, seed=5, nan=0.05)
    cfg = Config(dict(verbose=-1, max_bin=63))
    mappers = BinnedDataset._find_bin_mappers(X, cfg, ())
    # trivial features are not written (the store's value stays)
    whole = np.full((X.shape[1], 1000), 7, np.uint8)
    assert native.encode_bins(X, mappers, whole)
    store = np.full((X.shape[1], 3000), 7, np.uint8)
    assert native.encode_bins(X, mappers, store[:, 1200:2200])
    np.testing.assert_array_equal(store[:, 1200:2200], whole)
    assert (store[:, :1200] == 7).all() and (store[:, 2200:] == 7).all()
    # a store whose columns are not contiguous is declined
    assert not native.encode_bins(X, mappers, store[:, ::2])


def test_a_library_that_does_not_build_raises_from_parse_file(
        tmp_path, monkeypatch):
    # never a quiet fall back to the numpy readers: the compiler's
    # output reaches the caller
    from lightgbm_tpu_torch import capi
    X, y = _matrix(n=50, seed=6)
    path = str(tmp_path / "d.csv")
    _write(path, X, y, ",", True)
    monkeypatch.setattr(capi, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(capi, "CXX_FLAGS",
                        capi.CXX_FLAGS + ("-fno-such-option-here",))
    monkeypatch.setattr(capi, "_lib", None)
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="(?s)building the C API library "
                       "failed.*no-such-option-here"):
        parser.parse_file(path)
    with pytest.raises(RuntimeError, match="no-such-option-here"):
        native.parse_dense(path, ",", 0, True, X.shape[1] + 1)


# ---------------------------------------------------------------------------
# the platform probe and its faults
# ---------------------------------------------------------------------------

KEYS = {"ok", "platform", "backend", "devices", "device_name", "rc",
        "reason", "t_start", "dur_s"}


def test_probe_cpu_binds(monkeypatch):
    monkeypatch.delenv("LGBM_TPU_FAULT", raising=False)
    rec = resilience.probe_platform("cpu", deadline=60)
    assert KEYS <= set(rec)
    assert rec["ok"] and rec["backend"] == "cpu" and rec["rc"] == 0, rec


def test_probe_default_is_the_card(monkeypatch):
    monkeypatch.delenv("LGBM_TPU_FAULT", raising=False)
    rec = resilience.probe_platform(deadline=60)
    assert rec["platform"] == "cuda"
    if torch.cuda.is_available():
        assert rec["ok"] and rec["device_name"], rec
    else:
        assert not rec["ok"] and rec["reason"].startswith("init failed")
        assert "no CUDA device" in rec["tail"]


def test_probe_bogus_platform_fault(monkeypatch):
    monkeypatch.setenv("LGBM_TPU_FAULT", "bogus_platform")
    rec = resilience.probe_platform(deadline=60)
    assert rec["platform"] == "bogus" and not rec["ok"]
    assert "unknown platform" in rec["tail"]
    # a cpu request is never rewritten
    assert resilience.probe_platform("cpu", deadline=60)["ok"]


def test_probe_hang_import_fault_dies_at_the_deadline(monkeypatch):
    monkeypatch.setenv("LGBM_TPU_FAULT", "hang_import:30")
    assert resilience.maybe_probe_hang_seconds("cuda") == 30.0
    assert resilience.maybe_probe_hang_seconds("cpu") == 0.0
    rec = resilience.probe_platform("cuda", deadline=4.0)
    assert not rec["ok"] and rec["reason"].startswith("hang"), rec
    assert rec["dur_s"] < 10.0
    assert "Thread" in rec["tail"] or "parent killed" in rec["reason"]
    assert os.environ["LGBM_TPU_FAULT"] == "hang_import:30"
