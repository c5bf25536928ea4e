"""The fixed-point f32 histogram, the plain version of the card's kernels.

On the card the f32 histograms (B1, B5 f32, B6 and B7 of
lightgbm_tpu_torch/csrc) round each grad / hess value to a multiple of
2^-s, sum the integers exactly in int64 and round the sum once to f32, so
their result does not depend on the order of the adds; chip_smoke.py holds
each bit for bit to ops/segment.segment_histogram_fixed.  Here that plain
version is held against the JAX package's histogram
(lightgbm_tpu.ops.segment.segment_histogram) and its Pallas kernel in
interpret mode (count exact, grad / hess at rtol 1e-5, atol 1e-5), on
weighted rows, negative grads and grads spanning six decades; it is held
bit-identical under a permutation of a segment's rows; and the exponents
(fixed_scale) are checked at their edges: all-zero channels, one row, and
the largest magnitude the exponent allows, summed without overflow.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgbm_tpu.ops import pallas_segment as pseg
from lightgbm_tpu.ops import segment as jseg
from lightgbm_tpu_torch.ops import cuda_segment as cs
from lightgbm_tpu_torch.ops import segment as tseg

# one intra-op thread: the pytest-xdist workers share the cores, and
# torch's OpenMP regions spin in their barriers when oversubscribed
torch.set_num_threads(1)

F, B = 6, 16
COLS = dict(grad_col=F, hess_col=F + 1, cnt_col=F + 2)
HK = dict(num_features=F, num_bins=B, **COLS)


def _payload(n, seed, decades=6):
    """n rows of F bins and weighted, signed grads spanning `decades`
    decades, positive hessians and a 0/1 count mask (masked rows' grad and
    hess zero, as the fast path fills them), lane-padded like the JAX fast
    path's payload, GUARD zero rows after."""
    rng = np.random.default_rng(seed)
    pay = np.zeros((n + jseg.GUARD, 128), np.float32)
    pay[:n, :F] = rng.integers(0, B, size=(n, F))
    weight = rng.uniform(0.5, 2.0, n)
    mag = 10.0 ** rng.uniform(-decades, 0, n)
    mask = (rng.random(n) < 0.9).astype(np.float32)
    pay[:n, F] = rng.choice([-1.0, 1.0], n) * mag * weight * mask
    pay[:n, F + 1] = rng.uniform(0.01, 0.25, n) * weight * mask
    pay[:n, F + 2] = mask
    return pay


def _fixed(pay, start, count, scale=None):
    return tseg.segment_histogram_fixed(torch.from_numpy(pay), start, count,
                                        scale=scale, **HK).numpy()


def _check(got, ref):
    np.testing.assert_array_equal(got[..., 2], ref[..., 2])
    np.testing.assert_allclose(got[..., :2], ref[..., :2], rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("start,count", [(0, 700), (13, 1), (0, 0),
                                         (101, 333)])
@pytest.mark.parametrize("decades", [1, 6])
def test_matches_jax(start, count, decades):
    pay = _payload(800, seed=count + decades, decades=decades)
    ref = np.asarray(jseg.segment_histogram(
        jnp.asarray(pay), jnp.int32(start), jnp.int32(count), **HK))
    _check(_fixed(pay, start, count), ref)


def test_matches_pallas_interpret():
    start, count = 5, 419
    pay = _payload(512, seed=9)
    ref = pseg.segment_histogram(jnp.asarray(pay), jnp.int32(start),
                                 jnp.int32(count), interpret=True, **HK)
    _check(_fixed(pay, start, count), np.asarray(ref))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_order_free(seed):
    """A permutation of the segment's rows gives the same bits."""
    pay = _payload(600, seed=seed)
    start, count = 40, 500
    perm = np.random.default_rng(seed + 100).permutation(count)
    shuffled = pay.copy()
    shuffled[start:start + count] = pay[start:start + count][perm]
    a, b = _fixed(pay, start, count), _fixed(shuffled, start, count)
    assert np.array_equal(a.view(np.int32), b.view(np.int32))


def test_zero_channels_and_one_row():
    pay = _payload(64, seed=4)
    pay[:, F] = 0.0                         # every grad zero
    got = _fixed(pay, 0, 64)
    assert not got[..., 0].any()
    _check(got, np.asarray(jseg.segment_histogram(
        jnp.asarray(pay), jnp.int32(0), jnp.int32(64), **HK)))
    pay[:, F + 1] = 0.0                     # and every hess
    assert not _fixed(pay, 0, 64)[..., :2].any()
    one = _payload(8, seed=5)
    one[3, F + 2] = 1.0
    got = _fixed(one, 3, 1)
    b = one[3, :F].astype(int)
    for f in range(F):                      # one row: its own values
        assert got[f, b[f], 0] == one[3, F] and got[f, b[f], 1] == one[3, F + 1]
        assert got[f, b[f], 2] == 1.0
    assert got.sum(axis=1)[:, 2].tolist() == [1.0] * F


@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_largest_magnitude_without_overflow(sign):
    """Every row in one bin at the largest |grad| its exponent admits:
    rows * max * 2^s just below 2^62, so the int64 sum neither wraps nor
    loses its sign."""
    n = 1000
    pay = np.zeros((n + jseg.GUARD, 128), np.float32)
    pay[:n, F] = sign * np.nextafter(np.float32(1.0), np.float32(0.0))
    pay[:n, F + 1] = np.nextafter(np.float32(2.0), np.float32(0.0))
    pay[:n, F + 2] = 1.0
    t = torch.from_numpy(pay)
    scale = tseg.fixed_scale(t, 0, n, **{k: COLS[k]
                                         for k in ("grad_col", "hess_col")})
    assert scale.tolist() == [52, 51]       # 62 - 10 (rows) - 0 / 1
    q = tseg.to_fixed(t[:n, [F, F + 1]], scale[None, :]).sum(dim=0)
    assert (q.abs().double() < 2.0 ** 62).all()
    assert q.abs().double().max() > 2.0 ** 61
    got = _fixed(pay, 0, n, scale)
    np.testing.assert_allclose(got[0, 0], [n * pay[0, F],
                                           n * pay[0, F + 1], n], rtol=1e-6)


def test_exponents():
    """fixed_exponents: rows * max * 2^s < 2^62, the largest such s, and
    the clamp to +-FIXED_MAX_EXP; on device tensors as on host values."""
    amax = torch.tensor([0.999, 0.25, 0.0, 1e-38, 3e38], dtype=torch.float32)
    for rows in (1, 1000, 1_016_072):
        s = tseg.fixed_exponents(amax, rows)
        assert s.dtype == torch.int32
        assert torch.equal(s, tseg.fixed_exponents(amax, torch.tensor(rows)))
        bound = rows * amax.double() * torch.ldexp(torch.ones(5).double(),
                                                   s.long())
        assert (bound < 2.0 ** 62).all()
        grown = rows * amax.double() * torch.ldexp(torch.ones(5).double(),
                                                   s.long() + 1)
        free = s < tseg.FIXED_MAX_EXP
        assert (grown[free & (amax > 0)] >= 2.0 ** 60).all()
        assert (s.abs() <= tseg.FIXED_MAX_EXP).all()
    assert tseg.fixed_exponents(amax[:2], 1_016_072).tolist() == [42, 43]


def test_scale_of_segments():
    """The exponents of K segments: their rows' largest magnitudes and
    their total count, the same for host values and device tensors, and
    the wrappers' default (cuda_segment._scale_of) is this."""
    pay = torch.from_numpy(_payload(900, seed=6))
    starts, counts = [0, 300, 700], [100, 0, 50]
    want_max = torch.cat([pay[s:s + c, [F, F + 1]] for s, c in
                          zip(starts, counts)]).abs().amax(dim=0)
    want = tseg.fixed_exponents(want_max, sum(counts))
    got = tseg.fixed_scale(pay, starts, counts, F, F + 1)
    assert torch.equal(got, want)
    assert torch.equal(got, tseg.fixed_scale(
        pay, torch.tensor(starts, dtype=torch.int32),
        torch.tensor(counts, dtype=torch.int32), F, F + 1))
    assert torch.equal(cs._scale_of(pay, None, torch.tensor(starts),
                                    torch.tensor(counts), F, F + 1), want)
    assert torch.equal(cs._scale_of(pay, [3, 4], None, None, F, F + 1),
                       torch.tensor([3, 4], dtype=torch.int32))


def test_children_at_the_parents_exponents():
    """B6 and B5 round every segment of a call at one exponent pair (the
    parent's, or all K segments'): the children's histograms at the
    parent's exponents sum to the parent's within f32 rounding, and each
    agrees with the JAX package's."""
    pay = torch.from_numpy(_payload(700, seed=8))
    scale = tseg.fixed_scale(pay, 0, 700, F, F + 1)
    kids = ((0, 250), (250, 1), (251, 449))
    whole = tseg.segment_histogram_fixed(pay, 0, 700, scale=scale, **HK)
    parts = [tseg.segment_histogram_fixed(pay, s, c, scale=scale, **HK)
             for s, c in kids]
    np.testing.assert_allclose(whole.double().numpy(),
                               sum(p.double() for p in parts).numpy(),
                               rtol=1e-6, atol=1e-9)
    for got, (s, c) in zip(parts, kids):
        _check(got.numpy(), np.asarray(jseg.segment_histogram(
            jnp.asarray(pay.numpy()), jnp.int32(s), jnp.int32(c), **HK)))

