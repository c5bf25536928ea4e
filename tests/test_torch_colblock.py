"""The column-block histogram's (B7) order of summation, emulated on the CPU.

On the card, B7 (lightgbm_tpu_torch/csrc/segment_hist_colblock.cu) keeps
one shared-memory histogram per block of bin columns and row chunk; its
16 warps take the rows of a staged tile in turn (warp w rows w, w + 16,
...), the lanes of a warp one row's consecutive features, and add each
row into its cells.  A lane sums the rows of one hot bin in registers (in
the kernel, the first bin whose compare-and-swap met another warp's) and
adds that sum once, after the block's rows.  The blocks' partial
histograms go into the output with global atomics.  A CUDA kernel cannot
run here, and the atomics admit many orders, so this file emulates one of
them in f32 with numpy: rows one at a time in row order, each warp's hot
bin per feature the one that holds most of its rows.  The kernel's tile,
warp and chunk sizes are read from its source.  The emulation is held
against the JAX package's Pallas kernel in interpret mode
(lightgbm_tpu.ops.pallas_segment.segment_histogram_colblock) and the
port's plain version (ops/segment.segment_histogram): the count channel
exactly, grad and hess within f32 summation-order tolerance.  A
concentrated case puts every row of a feature in one bin and a fifth in
the missing bin, so the hot bins carry most of the rows.  The emulation
is not used by the port.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgbm_tpu.ops import pallas_segment as pseg
from lightgbm_tpu.ops import segment as jseg
from lightgbm_tpu_torch.ops import segment as tseg

SOURCE = (Path(__file__).resolve().parent.parent / "lightgbm_tpu_torch"
          / "csrc" / "segment_hist_colblock.cu").read_text()


def _constant(name: str) -> int:
    return int(re.search(r"constexpr int %s = (\d+);" % name,
                         SOURCE).group(1))


ROW_TILE = _constant("kRowTile")
WARPS = _constant("kThreads") // 32
MIN_ROWS_PER_BLOCK = _constant("kMinRowsPerBlock")
FW, BW = 1500, 16


def _hot_bins(bins, warp, num_bins):
    """Each warp's hot bin per feature: the valid bin that holds most of
    the warp's rows (the lowest on a tie), or -1 where it has none."""
    hot = np.full((WARPS, bins.shape[1]), -1)
    for w in range(WARPS):
        mine = bins[warp == w]
        for f in range(bins.shape[1]):
            b = mine[:, f]
            b = b[(b >= 0) & (b < num_bins)]
            if b.size:
                hot[w, f] = np.bincount(b, minlength=num_bins).argmax()
    return hot


def emulate_colblock(pay, start, count, num_features, num_bins, grad_col,
                     hess_col, cnt_col, grid_x, hot=True):
    """B7's sums in one order its atomics admit: row chunk x of the nblk
    active ones takes tiles x, x + nblk, ...; its rows are added one at a
    time in row order, except that each warp's rows in its hot bin of a
    feature are summed apart, in row order, and added after the chunk's
    rows, warp by warp; the chunks' partials are added into the zeroed
    output in chunk order.  hot=False adds every row in row order."""
    F, B = num_features, num_bins
    out = np.zeros((F, B, 3), np.float32)
    want = -(-count // MIN_ROWS_PER_BLOCK)
    nblk = min(want, grid_x)
    ntiles = -(-count // ROW_TILE)
    feats = np.arange(F)
    for x in range(nblk):
        tiles = range(x, ntiles, nblk)
        idx = np.concatenate([np.arange(t * ROW_TILE,
                                        min((t + 1) * ROW_TILE, count))
                              for t in tiles]).astype(int)
        rows = pay[start + idx]
        bins = rows[:, :F].astype(np.int64)
        warp = idx % ROW_TILE % WARPS
        hots = _hot_bins(bins, warp, B) if hot else \
            np.full((WARPS, F), -1)
        part = np.zeros((2, F, B), np.float32)
        counts = np.zeros((F, B), np.int64)
        hot_sum = np.zeros((2, WARPS, F), np.float32)
        for k in range(rows.shape[0]):
            b, w = bins[k], warp[k]
            ok = (b >= 0) & (b < B)
            counts[feats[ok], b[ok]] += int(rows[k, cnt_col] != 0)
            in_hot = ok & (b == hots[w])
            hot_sum[0, w, in_hot] += rows[k, grad_col]
            hot_sum[1, w, in_hot] += rows[k, hess_col]
            cold = ok & ~in_hot
            part[0, feats[cold], b[cold]] += rows[k, grad_col]
            part[1, feats[cold], b[cold]] += rows[k, hess_col]
        for w in range(WARPS):
            has = hots[w] >= 0
            part[0, feats[has], hots[w, has]] += hot_sum[0, w, has]
            part[1, feats[has], hots[w, has]] += hot_sum[1, w, has]
        # the flush: each block's non-zero cells into the output
        out[..., 0] += part[0]
        out[..., 1] += part[1]
        out[..., 2] += counts.astype(np.float32)
    return out


def _wide_payload(n_pad, f, num_bins, seed, concentrated=False):
    """tests/test_torch_wide.py's payload: f bin columns, then grad / hess
    / count mask, lane-padded like the JAX fast path's payload.
    concentrated: every row of a feature in one bin, a fifth in the
    missing (last) bin."""
    rng = np.random.default_rng(seed)
    p = -(-(f + 8) // 128) * 128
    pay = np.zeros((n_pad + jseg.GUARD, p), np.float32)
    if concentrated:
        pay[:n_pad, :f] = rng.integers(0, num_bins - 1, size=f)[None, :]
        missing = rng.random((n_pad, f)) < 0.2
        pay[:n_pad, :f][missing] = num_bins - 1
    else:
        pay[:n_pad, :f] = rng.integers(0, num_bins, size=(n_pad, f))
    pay[:n_pad, f] = rng.standard_normal(n_pad)
    pay[:n_pad, f + 1] = rng.random(n_pad)
    pay[:n_pad, f + 2] = (rng.random(n_pad) < 0.9).astype(np.float32)
    return pay, dict(grad_col=f, hess_col=f + 1, cnt_col=f + 2)


def _plain(pay, start, count, cols):
    return tseg.segment_histogram(
        torch.from_numpy(pay), start, count, num_features=FW, num_bins=BW,
        **cols).numpy()


def _magnitudes(pay, start, count, cols):
    """Per cell, the sums of |grad| and |hess| (f64)."""
    rows = pay[start:start + count].astype(np.float64)
    vals = np.abs(rows[:, [cols["grad_col"], cols["hess_col"]]])
    mag = np.zeros((FW, BW, 2))
    for j in range(FW):
        b = rows[:, j].astype(int)
        for c in range(2):
            np.add.at(mag[j, :, c], b, vals[:, c])
    return mag


def _check(got, ref, mag=None):
    """Count exact; grad and hess at rtol 1e-5, atol 1e-5, or, given the
    cells' sums of magnitudes, within B1's bound on the card."""
    np.testing.assert_array_equal(got[..., 2], ref[..., 2])
    if mag is None:
        np.testing.assert_allclose(got[..., :2], ref[..., :2], rtol=1e-5,
                                   atol=1e-5)
    else:
        assert (np.abs(got[..., :2] - ref[..., :2])
                <= 1e-5 * mag + 1e-6).all()


@pytest.mark.parametrize("concentrated", [False, True])
@pytest.mark.parametrize("start,count", [(0, 300), (100, 37), (0, 0),
                                         (7, 1), (9, 515)])
def test_emulated_order_matches_jax(start, count, concentrated):
    """The concentrated cells sum hundreds of rows, and the hot bins'
    late sums round otherwise than JAX's order: there grad and hess are
    held to B1's bound (1e-5 of the cell's sum of magnitudes, plus
    1e-6), elsewhere to rtol 1e-5, atol 1e-5."""
    pay, cols = _wide_payload(1024, FW, BW, seed=start + count,
                              concentrated=concentrated)
    got = emulate_colblock(pay, start, count, FW, BW, grid_x=4, **cols)
    ref = pseg.segment_histogram_colblock(
        jnp.asarray(pay), jnp.int32(start), jnp.int32(count),
        num_features=FW, num_bins=BW, interpret=True, **cols)
    mag = _magnitudes(pay, start, count, cols) if concentrated else None
    _check(got, np.asarray(ref), mag)
    _check(got, _plain(pay, start, count, cols), mag)


@pytest.mark.parametrize("grid_x", [1, 2, 3])
@pytest.mark.parametrize("concentrated", [False, True])
def test_emulated_order_over_row_chunks(grid_x, concentrated):
    """A segment of three row chunks, on one to three blocks per column
    block: the count exact against the plain version, grad and hess
    against f64 sums within B1's bound on the card (chip_smoke.py's
    hist_errors: 1e-5 of the cell's sum of magnitudes, plus 1e-6), since
    the concentrated cells cancel over thousands of rows."""
    start, count = 5, 2 * MIN_ROWS_PER_BLOCK + 300
    pay, cols = _wide_payload(count + 16, FW, BW, seed=grid_x,
                              concentrated=concentrated)
    got = emulate_colblock(pay, start, count, FW, BW, grid_x=grid_x, **cols)
    np.testing.assert_array_equal(got[..., 2],
                                  _plain(pay, start, count, cols)[..., 2])
    _check_bound(got, pay, start, count, cols)


def _check_bound(got, pay, start, count, cols):
    """grad and hess within B1's bound on the card against f64 sums."""
    rows = pay[start:start + count].astype(np.float64)
    vals = rows[:, [cols["grad_col"], cols["hess_col"]]]
    ref = np.zeros((FW, BW, 2))
    for j in range(FW):
        b = rows[:, j].astype(int)
        for c in range(2):
            np.add.at(ref[j, :, c], b, vals[:, c])
    mag = _magnitudes(pay, start, count, cols)
    assert (np.abs(got[..., :2] - ref) <= 1e-5 * mag + 1e-6).all()


def test_hot_bins_change_the_order():
    """In the concentrated case the hot bins' late sums give other bits
    than adding every row in row order, and both stay within B1's bound
    against f64 sums: the order is seen to matter, and to stay within
    the tolerance."""
    start, count = 0, 2 * MIN_ROWS_PER_BLOCK
    pay, cols = _wide_payload(count + 16, FW, BW, seed=11, concentrated=True)
    hot = emulate_colblock(pay, start, count, FW, BW, grid_x=2, **cols)
    flat = emulate_colblock(pay, start, count, FW, BW, grid_x=2, hot=False,
                            **cols)
    assert not np.array_equal(hot[..., :2], flat[..., :2])
    np.testing.assert_array_equal(hot[..., 2], flat[..., 2])
    for got in (hot, flat):
        _check_bound(got, pay, start, count, cols)
