"""The binary dataset cache in the port against the JAX package on the
CPU: a cache written by either package loads in the other (the npz
format with its JSON header: bins, mappers, EFB bundles, nibble packing
and metadata), a path-loaded cache trains the in-memory model, a stale
format version is refused, is_binary_file tells caches from text, and a
validation set given as a path is binned with its reference's mappers
and bundles."""
import json

import numpy as np
import pytest
import torch

import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt
from lightgbm_tpu.io.dataset import BinnedDataset as JBinned
from lightgbm_tpu_torch.io.dataset import BinnedDataset

# one intra-op thread: the pytest-xdist workers share the cores, and
# torch's OpenMP regions spin in their barriers when oversubscribed
torch.set_num_threads(1)

N = 2400


def _problem(kind, seed=0):
    """(X, Dataset kwargs, params) of one kind of cache: EFB bundles with
    weights and an init score, <= 16-bin columns (nibble-packed), or query
    groups."""
    rng = np.random.default_rng(seed)
    params = dict(objective="binary", num_leaves=15, verbose=-1, max_bin=63)
    if kind == "bundled":
        X = np.zeros((N, 24))
        for b in range(4):
            which = rng.integers(0, 6, N)
            X[np.arange(N), 6 * b + which] = rng.integers(1, 8, N)
        y = (X[:, 0] + X[:, 7] - X[:, 14] + rng.standard_normal(N) > 0)
        kw = dict(weight=rng.uniform(0.5, 1.5, N),
                  init_score=rng.normal(0, 0.1, N))
    elif kind == "nbits":
        X = rng.standard_normal((N, 7))
        y = X[:, 0] + 0.3 * rng.standard_normal(N) > 0
        params["max_bin"] = 15
        kw = {}
    else:
        X = rng.standard_normal((N, 5))
        y = np.clip(np.floor(X[:, 0] + 2), 0, 4)
        params["objective"] = "lambdarank"
        kw = dict(group=[40] * (N // 40))
    return X, dict(kw, label=np.asarray(y, np.float64)), params


def _assert_same_binned(a, b):
    """Two binned datasets (either package's) hold the same cache."""
    for k in ("num_data", "num_total_features", "num_data_padded",
              "max_num_bin", "feature_names"):
        assert getattr(a, k) == getattr(b, k), k
    np.testing.assert_array_equal(a.bins, b.bins)
    assert a.bins.dtype == b.bins.dtype
    for ma, mb in zip(a.bin_mappers, b.bin_mappers):
        da, db = ma.to_arrays(), mb.to_arrays()
        assert da.keys() == db.keys()
        for k in da:
            np.testing.assert_array_equal(da[k], db[k], err_msg=k)
    assert (a.bundle_info is None) == (b.bundle_info is None)
    if a.bundle_info is not None:
        assert [list(g) for g in a.bundle_info.groups] == \
            [list(g) for g in b.bundle_info.groups]
        for k in ("f_group", "f_offset", "f_identity", "group_num_bin",
                  "conflict_rates"):
            np.testing.assert_array_equal(getattr(a.bundle_info, k),
                                          getattr(b.bundle_info, k))
    for k in ("label", "weight", "init_score", "query_boundaries"):
        va, vb = getattr(a.metadata, k), getattr(b.metadata, k)
        assert (va is None) == (vb is None), k
        if va is not None:
            np.testing.assert_array_equal(va, vb, err_msg=k)
    np.testing.assert_array_equal(a.monotone_constraints,
                                  b.monotone_constraints)
    np.testing.assert_array_equal(a.feature_penalty, b.feature_penalty)


@pytest.mark.parametrize("kind", ["bundled", "nbits", "query"])
def test_caches_interchange_with_jax(kind, tmp_path):
    """The port loads the JAX package's cache and the JAX package the
    port's; both equal the in-memory binned set.  The nibble-packed kind
    stores half the bin bytes."""
    X, kw, params = _problem(kind)
    jds = lj.Dataset(X, **kw).construct(lj.Config(dict(params))).binned
    tds = lt.Dataset(X, **kw).construct(lt.Config(dict(params))).binned
    _assert_same_binned(tds, jds)
    jpath, tpath = str(tmp_path / "jax.bin"), str(tmp_path / "port.bin")
    jds.save_binary(jpath)
    tds.save_binary(tpath)
    _assert_same_binned(BinnedDataset.load_binary(jpath), jds)
    _assert_same_binned(JBinned.load_binary(tpath), tds)
    with np.load(tpath) as z:
        header = json.loads(bytes(z["header"].tobytes()).decode())
        assert bool(header.get("nbits4")) is (kind == "nbits")
        if kind == "nbits":
            assert z["bins"].shape[0] == (tds.bins.shape[0] + 1) // 2
        assert ("bundle_groups" in header) is (kind == "bundled")


def test_jax_cache_trains_the_in_memory_model(tmp_path):
    """Dataset(path) over the JAX package's cache (bundles, weights, init
    score) trains the port's in-memory model text byte for byte."""
    X, kw, params = _problem("bundled", seed=1)
    path = str(tmp_path / "train.bin")
    lj.Dataset(X, **kw).construct(lj.Config(dict(params))).binned \
        .save_binary(path)
    params = dict(params, device_type="cpu")
    cached = lt.train(dict(params), lt.Dataset(path), 4, verbose_eval=False)
    memory = lt.train(dict(params), lt.Dataset(X, **kw), 4,
                      verbose_eval=False)
    assert cached.train_set.binned.bundle_info is not None
    assert cached.model_to_string() == memory.model_to_string()


def test_save_binary_round_trip(tmp_path):
    """Dataset.save_binary, then Dataset(path): the same binned set, and
    fields given to the path Dataset override the cache's."""
    X, kw, params = _problem("nbits", seed=2)
    ds = lt.Dataset(X, **kw, params=params)
    path = tmp_path / "ds.bin"
    assert ds.save_binary(path) is ds
    back = lt.Dataset(str(path)).construct()
    _assert_same_binned(back.binned, ds.binned)
    w = np.full(N, 2.0)
    again = lt.Dataset(str(path), weight=w).construct()
    np.testing.assert_array_equal(again.get_weight(), w.astype(np.float32))


def _rewrite_header(path, **changes):
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    header = json.loads(bytes(arrays["header"].tobytes()).decode())
    header.update(changes)
    arrays["header"] = np.frombuffer(json.dumps(header).encode(), np.uint8)
    with open(path, "wb") as fh:
        np.savez_compressed(fh, **arrays)


def test_stale_version_refused(tmp_path):
    X, kw, params = _problem("nbits")
    path = str(tmp_path / "old.bin")
    lt.Dataset(X, **kw).construct(lt.Config(params)).binned.save_binary(path)
    _rewrite_header(path, format_version=1)
    with pytest.raises(lt.LightGBMError, match="stale"):
        BinnedDataset.load_binary(path)
    with pytest.raises(lt.LightGBMError, match="stale"):
        lt.Dataset(path).construct()


def test_is_binary_file(tmp_path):
    X, kw, params = _problem("nbits")
    text = tmp_path / "rows.csv"
    np.savetxt(text, np.column_stack([kw["label"], X]), delimiter=",")
    cache = str(tmp_path / "rows.bin")
    lt.Dataset(X, **kw).construct(lt.Config(params)).binned \
        .save_binary(cache)
    other = tmp_path / "other.npz"
    np.savez(other, a=np.zeros(3))
    assert BinnedDataset.is_binary_file(cache)
    assert not BinnedDataset.is_binary_file(str(text))
    assert not BinnedDataset.is_binary_file(str(other))
    assert not BinnedDataset.is_binary_file(str(tmp_path / "missing"))


def test_path_valid_set_aligned_to_reference(tmp_path):
    """A validation set given as a text path is binned with its
    reference's mappers and bundles (Dataset::CreateValid), as the same
    rows in memory are; a cache, which carries its own mappers, is
    refused as a validation set."""
    X, kw, params = _problem("bundled", seed=3)
    Xv, kwv, _ = _problem("bundled", seed=4)
    ds = lt.Dataset(X, **kw, params=params)
    path = tmp_path / "valid.tsv"
    np.savetxt(path, np.column_stack([kwv["label"], Xv]), delimiter="\t",
               fmt="%.17g")
    dv = lt.Dataset(str(path), reference=ds).construct()
    mem = lt.Dataset(Xv, label=kwv["label"], reference=ds).construct()
    assert dv.binned.bundle_info is ds.binned.bundle_info
    np.testing.assert_array_equal(dv.binned.bins, mem.binned.bins)
    np.testing.assert_array_equal(dv.get_label(), mem.get_label())
    cache = str(tmp_path / "valid.bin")
    mem.save_binary(cache)
    with pytest.raises(lt.LightGBMError, match="reference"):
        lt.Dataset(cache, reference=ds).construct()
    evals = {}
    lt.train(dict(params, device_type="cpu"), ds, 3, valid_sets=[dv],
             evals_result=evals, verbose_eval=False)
    assert len(evals["valid_0"]["binary_logloss"]) == 3
