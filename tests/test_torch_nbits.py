"""4-bit bin storage in the port against the JAX package on the CPU: the
nibble packing and unpacking byte for byte at even and odd column
counts, the gate, and training from the nibble-packed binary cache
identical to training from memory."""
import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as lt
from lightgbm_tpu.io import nbits as jnbits
from lightgbm_tpu_torch.io import nbits
from lightgbm_tpu_torch.io.dataset import BinnedDataset

# one intra-op thread: the pytest-xdist workers share the cores, and
# torch's OpenMP regions spin in their barriers when oversubscribed
torch.set_num_threads(1)


@pytest.mark.parametrize("G", [2, 7, 12])
def test_pack_unpack_match_jax(G):
    rng = np.random.default_rng(G)
    bins = rng.integers(0, 16, size=(G, 777)).astype(np.uint8)
    packed = nbits.pack_nibbles(bins)
    np.testing.assert_array_equal(packed, jnbits.pack_nibbles(bins))
    assert packed.shape == ((G + 1) // 2, 777)
    np.testing.assert_array_equal(nbits.unpack_nibbles(packed, G), bins)
    np.testing.assert_array_equal(jnbits.unpack_nibbles(packed, G), bins)


def test_pack_refuses_wide_bins():
    with pytest.raises(ValueError):
        nbits.pack_nibbles(np.full((2, 4), 16, np.uint8))


def _data(n=3000, f=9, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, f))
    y = (X[:, 0] - 0.7 * X[:, 3] + 0.4 * rng.standard_normal(n) > 0)
    return X, y.astype(np.float64)


@pytest.mark.parametrize("max_bin,packs", [(15, True), (63, False)])
def test_gate_matches_jax(max_bin, packs):
    X, y = _data()
    params = dict(max_bin=max_bin, verbose=-1)
    ds = BinnedDataset.from_matrix(X, lt.Config(params))
    assert nbits.should_pack(ds) is packs
    assert jnbits.packable(ds.storage_num_bins()) is packs


def test_packed_cache_trains_the_unpacked_model(tmp_path):
    """A <= 16-bin dataset's binary cache holds its bins nibble-packed;
    Dataset(path) unpacks them, and the model text equals the one
    trained from the in-memory Dataset."""
    X, y = _data()
    params = dict(objective="binary", num_leaves=15, max_bin=15, verbose=-1,
                  device_type="cpu")
    ds = lt.Dataset(X, label=y, params=params)
    path = str(tmp_path / "train.bin")
    ds.save_binary(path)
    with np.load(path) as z:
        assert z["bins"].shape == ((X.shape[1] + 1) // 2, ds.binned.bins
                                   .shape[1])
    cached = lt.train(dict(params), lt.Dataset(path), 4, verbose_eval=False)
    np.testing.assert_array_equal(cached.train_set.binned.bins,
                                  ds.binned.bins)
    memory = lt.train(dict(params), lt.Dataset(X, label=y), 4,
                      verbose_eval=False)
    assert cached.model_to_string() == memory.model_to_string()
