"""The wide-payload slice of the port against the JAX package on the CPU:
the route by width against the JAX package's VMEM gates, the column-block
histogram (B7), the RMW partition (B3) and the column-block partition
(B8) against the Pallas kernels in interpret mode, and training at 1,000
and 1,800 features against lightgbm_tpu.train.  On a CPU tensor each
wrapper runs its kernel's plain version (ops/segment.py)."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import lightgbm_tpu as lj
import lightgbm_tpu_torch as lt
from lightgbm_tpu.ops import pallas_segment as pseg
from lightgbm_tpu.ops import segment as jseg
from lightgbm_tpu.ops.segment import SplitPredicate as JPred
from lightgbm_tpu_torch.ops import cuda_segment
from lightgbm_tpu_torch.ops.segment import SplitPredicate as TPred

from test_torch_train import _assert_same_structure

B = 16


def _jax_route(f: int, num_bins: int):
    """The engines the JAX grower picks for F features at max_bin 255 on
    its lane-padded payload (P = pad128(F + 10)), staged flags taken as
    on (grower2.py:191-255)."""
    p = pseg._pad128(f + 10)
    cols = dict(grad_col=f + 5, hess_col=f + 6, cnt_col=f + 2)
    if pseg.fits_vmem(f, num_bins, p):
        hist = "segment_histogram"
    else:
        assert pseg.fits_vmem_colblock(f, num_bins, p, **cols)
        hist = "segment_histogram_colblock"
    if pseg.partition_acc_fits_vmem(p, num_bins):
        part = "partition_segment"
    elif pseg.partition_fits_vmem(p, num_bins):
        part = "partition_segment_rmw"
    else:
        assert pseg.partition_blocks_fits_vmem(p, num_bins)
        part = "partition_segment_blocks"
    return hist, part


@pytest.mark.parametrize("f", [28, 137, 502, 503, 700, 888, 889, 968, 1654,
                               1655, 2000, 4228])
def test_route_matches_jax_gates(f):
    # max_bin 255 gives 255 bins, or 256 with a NaN bin
    for num_bins in (255, 256):
        port = (cuda_segment.histogram_route(f).__name__,
                cuda_segment.partition_route(f + 10).__name__)
        assert port == _jax_route(f, num_bins)


def _wide_payload(n_pad, f, num_bins, seed):
    """tests/test_pallas_segment.py's _wide_payload: f bin columns, then
    grad / hess / count, lane-padded like the JAX fast path's payload."""
    rng = np.random.default_rng(seed)
    p = -(-(f + 8) // 128) * 128
    pay = np.zeros((n_pad + jseg.GUARD, p), np.float32)
    pay[:n_pad, :f] = rng.integers(0, num_bins, size=(n_pad, f))
    pay[:n_pad, f] = rng.standard_normal(n_pad)
    pay[:n_pad, f + 1] = rng.random(n_pad)
    pay[:n_pad, f + 2] = 1.0
    return pay, dict(grad_col=f, hess_col=f + 1, cnt_col=f + 2)


# the segments of tests/test_pallas_segment.py:421-422
@pytest.mark.parametrize("start,count", [(0, 1000), (256, 700), (100, 37),
                                         (0, 0), (7, 1), (9, 1015)])
def test_colblock_histogram_matches_jax(start, count):
    fw, bw = 1500, 16
    pay, cols = _wide_payload(1024, fw, bw, seed=5)
    ref = pseg.segment_histogram_colblock(
        jnp.asarray(pay), jnp.int32(start), jnp.int32(count),
        num_features=fw, num_bins=bw, interpret=True, **cols)
    got = cuda_segment.segment_histogram_colblock(
        torch.from_numpy(pay), start, count, num_features=fw, num_bins=bw,
        **cols)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def _preds(feature=1, threshold=B // 2, default_left=False, is_cat=False,
           bitset=None, missing_type=0, num_bin=B, default_bin=0, offset=0,
           identity=True):
    """The same predicate for both packages."""
    bits = np.asarray(bitset if bitset is not None else np.zeros(B, bool))
    jp = JPred(col=jnp.int32(feature), threshold=jnp.int32(threshold),
               default_left=jnp.bool_(default_left),
               is_cat=jnp.bool_(is_cat), bitset=jnp.asarray(bits),
               missing_type=jnp.int32(missing_type),
               num_bin=jnp.int32(num_bin), default_bin=jnp.int32(default_bin),
               offset=jnp.int32(offset), identity=jnp.bool_(identity))
    tp = TPred(col=torch.tensor(feature), threshold=torch.tensor(threshold),
               default_left=torch.tensor(default_left),
               is_cat=torch.tensor(is_cat), bitset=torch.from_numpy(bits),
               missing_type=torch.tensor(missing_type),
               num_bin=torch.tensor(num_bin),
               default_bin=torch.tensor(default_bin),
               offset=torch.tensor(offset), identity=torch.tensor(identity))
    return jp, tp


def _partition_both(jax_fn, port_fn, pay, start, count, predkw, vcol):
    """Partition one payload with the JAX kernel (interpret mode), the JAX
    portable partition and the port's wrapper; num_left must agree across
    the three and the port's payload equal the portable one byte for byte.
    Returns the kernel's and the port's payloads."""
    jp, tp = _preds(**predkw)
    lv, rv = -0.25, 0.75
    j_pay, _, j_nl = jax_fn(jnp.asarray(pay), jnp.zeros_like(pay),
                            jnp.int32(start), jnp.int32(count), jp,
                            jnp.float32(lv), jnp.float32(rv), vcol, B,
                            interpret=True)
    r_pay, _, r_nl = jseg.partition_segment(
        jnp.asarray(pay), jnp.zeros_like(pay), jnp.int32(start),
        jnp.int32(count), jp, jnp.float32(lv), jnp.float32(rv), vcol)
    t_pay, _, t_nl = port_fn(torch.from_numpy(pay.copy()),
                             torch.zeros(pay.shape), start, count, tp,
                             torch.tensor(lv), torch.tensor(rv), vcol)
    assert int(t_nl) == int(j_nl) == int(r_nl)
    # the plain partition is the portable one, byte for byte
    np.testing.assert_array_equal(t_pay.numpy().view(np.int32),
                                  np.asarray(r_pay).view(np.int32))
    return np.asarray(j_pay), t_pay.numpy()


# the cases of tests/test_pallas_segment.py:128-140
@pytest.mark.parametrize("start,count,predkw", [
    (0, 1000, {}),
    (256, 700, dict(feature=3, threshold=4)),
    (100, 37, dict(missing_type=2, default_left=True, threshold=3)),
    (0, 600, dict(is_cat=True, bitset=(np.arange(B) % 3 == 0))),
    (513, 256, dict(feature=0, threshold=0)),
    (7, 1, {}),
    (9, 1015, dict(feature=2, threshold=B // 3)),
    (255, 513, dict(feature=4, threshold=1)),
    (64, 500, dict(feature=2, threshold=3, offset=5, identity=False,
                   num_bin=9, default_bin=0)),
])
def test_rmw_partition_matches_jax(start, count, predkw):
    f = 5
    rng = np.random.default_rng(start + count)
    pay = np.zeros((1024 + jseg.GUARD, f + 4), np.float32)
    pay[:1024, :f] = rng.integers(0, B, size=(1024, f))
    pay[:1024, f] = rng.standard_normal(1024)
    pay[:1024, f + 1] = rng.random(1024)
    pay[:1024, f + 2] = 1.0
    got_j, got_t = _partition_both(pseg.partition_segment,
                                   cuda_segment.partition_segment_rmw, pay,
                                   start, count, predkw, f + 3)
    np.testing.assert_allclose(got_t, got_j, rtol=1e-6, atol=0)


# the cases of tests/test_pallas_segment.py:478-490, on its 1,200-feature
# payload of 1,280 lanes
@pytest.mark.parametrize("start,count,predkw", [
    (0, 1000, {}),
    (256, 700, dict(feature=3, threshold=4)),
    (100, 37, dict(missing_type=2, default_left=True, threshold=3)),
    (0, 600, dict(is_cat=True, bitset=(np.arange(B) % 3 == 0))),
    (7, 1, {}),
    (9, 1015, dict(feature=2, threshold=B // 3)),
    (64, 500, dict(feature=2, threshold=3, offset=5, identity=False,
                   num_bin=9, default_bin=0)),
])
def test_blocks_partition_matches_jax(start, count, predkw):
    fw = 1200
    pay, _ = _wide_payload(1024, fw, B, seed=start + count)
    got_j, got_t = _partition_both(pseg.partition_segment_acc_blocks,
                                   cuda_segment.partition_segment_blocks,
                                   pay, start, count, predkw, fw + 3)
    np.testing.assert_allclose(got_t, got_j, rtol=1e-6, atol=0)


@pytest.mark.parametrize("f,engines", [
    (1000, ("segment_histogram_colblock", "partition_segment_rmw")),
    (1800, ("segment_histogram_colblock", "partition_segment_blocks")),
])
def test_wide_training_matches_jax(f, engines):
    n = 3000
    rng = np.random.default_rng(f)
    X = rng.standard_normal((n, f))
    sig = np.linspace(0, f - 1, 16).round().astype(int)
    y = (X[:, sig] @ rng.standard_normal(16) + 0.5 * rng.standard_normal(n)
         > 0).astype(np.float64)
    X[:, 1::2][rng.random((n, f // 2)) < 0.2] = np.nan
    w = rng.uniform(0.5, 1.5, n)
    params = dict(objective="binary", num_leaves=15, max_bin=63,
                  learning_rate=0.1, verbose=-1)
    bj = lj.train(params, lj.Dataset(X, label=y, weight=w), 3,
                  verbose_eval=False)
    bt = lt.train(dict(params, device_type="cpu"),
                  lt.Dataset(X, label=y, weight=w), 3, verbose_eval=False)
    grower = bt._engine.grower
    assert (grower.hist_engine, grower.part_engine) == engines
    assert bt.current_iteration() == bj.current_iteration() == 3
    _assert_same_structure(bj, bt, X)
    np.testing.assert_allclose(bt.predict(X, raw_score=True),
                               bj.predict(X, raw_score=True), atol=1e-5)


def test_wide_wrappers_count_no_launch_on_cpu_and_refuse_meta():
    pay, cols = _wide_payload(256, 40, B, seed=3)
    pay = torch.from_numpy(pay)
    _, pred = _preds()
    counters = [cuda_segment.segment_histogram_colblock,
                cuda_segment.partition_segment_rmw,
                cuda_segment.partition_segment_blocks]
    before = [c.launches for c in counters]
    hist = cuda_segment.segment_histogram_colblock(
        pay, 3, 200, num_features=40, num_bins=B, **cols)
    assert hist.shape == (40, B, 3)
    for fn in counters[1:]:
        fn(pay.clone(), torch.zeros_like(pay), 3, 200, pred, 0.0, 1.0, 43)
    assert [c.launches for c in counters] == before
    # neither a CPU nor a CUDA tensor: refused before any kernel is built
    meta = torch.zeros(pay.shape, device="meta")
    with pytest.raises(ValueError):
        cuda_segment.segment_histogram_colblock(meta, 0, 10, num_features=40,
                                                num_bins=B, **cols)
    for fn in counters[1:]:
        with pytest.raises(ValueError):
            fn(meta, meta, 0, 10, pred, 0.0, 1.0, 43)
