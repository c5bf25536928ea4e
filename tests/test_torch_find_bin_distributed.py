"""Distributed find-bin of the port (lightgbm_tpu_torch/parallel/
find_bin.py) on two gloo ranks, against the JAX package's on a 2-device
mesh: every rank gets the same boundaries, the JAX package's, ascending,
near the true quantiles, with NaNs and skewed blocks, strictly ascending
on low cardinality (the port's counterpart of
tests/test_find_bin_distributed.py).  One spawn serves every case."""
import jax
import numpy as np
import pytest
from jax.sharding import Mesh

from lightgbm_tpu.parallel.find_bin import (DATA_AXIS,
                                            make_distributed_find_bin,
                                            shard_sample)

import torch_dist_worker as W


def _samples():
    rng = np.random.default_rng(0)
    normal = rng.standard_normal((4096, 6)).astype(np.float32)
    rng = np.random.default_rng(1)
    wide = rng.standard_normal((8192, 3)).astype(np.float32)
    rng = np.random.default_rng(2)
    nans = rng.standard_normal((4096, 2)).astype(np.float32)
    nans[rng.random(nans.shape) < 0.2] = np.nan
    # each rank sees a disjoint value range (the multi-host worst case)
    nans = nans[np.argsort(np.nan_to_num(nans[:, 0]))]
    rng = np.random.default_rng(3)
    low = np.where(rng.random((4096, 2)) < 0.9, 0.0,
                   rng.standard_normal((4096, 2))).astype(np.float32)
    return {"normal": (normal, 32), "wide": (wide, 16), "nans": (nans, 16),
            "low": (low, 16)}


@pytest.fixture(scope="module")
def bounds(tmp_path_factory):
    cases = _samples()
    out = W.run_ranks(tmp_path_factory.mktemp("find_bin"), "find_bin",
                      (list(cases.values()),), world=2)
    mesh = Mesh(np.array(jax.devices()[:2]), (DATA_AXIS,))
    ref = {}
    for name, (sample, max_bin) in cases.items():
        find = make_distributed_find_bin(mesh, max_bin=max_bin)
        ref[name] = np.asarray(find(shard_sample(mesh, sample)))
    names = list(cases)
    return cases, {n: (out[0][i], out[1][i]) for i, n in enumerate(names)}, \
        ref


@pytest.mark.parametrize("name", ["normal", "wide", "nans", "low"])
def test_every_rank_gets_the_jax_boundaries(bounds, name):
    _, got, ref = bounds
    a, b = got[name]
    np.testing.assert_array_equal(a, b)
    assert a.shape == ref[name].shape
    np.testing.assert_allclose(a, ref[name], rtol=1e-6, atol=1e-6)


def test_bounds_replicated_and_monotone(bounds):
    _, got, _ = bounds
    a = got["normal"][0]
    assert a.shape == (6, 32)
    assert np.isposinf(a[:, -1]).all()
    assert (np.diff(a[:, :-1], axis=1) >= 0).all()


def test_bounds_approximate_true_quantiles(bounds):
    cases, got, _ = bounds
    sample = cases["wide"][0]
    truth = np.quantile(sample, np.arange(1, 16) / 16, axis=0).T
    assert np.abs(got["wide"][0][:, :-1] - truth).max() < 0.1


def test_handles_nans_and_skewed_shards(bounds):
    cases, got, _ = bounds
    sample = cases["nans"][0]
    finite = sample[np.isfinite(sample[:, 1]), 1]
    truth = np.quantile(finite, np.arange(1, 16) / 16)
    a = got["nans"][0]
    assert np.abs(a[1, :-1] - truth).max() < 0.15
    assert np.isfinite(a[:, :-1]).all()


def test_bounds_strictly_ascending_on_low_cardinality(bounds):
    _, got, _ = bounds
    assert (np.diff(got["low"][0][:, :-1], axis=1) > 0).all()
