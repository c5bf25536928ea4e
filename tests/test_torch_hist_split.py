"""The histograms' work split on the device, emulated on the CPU.

On the card, B1, B4 and B5 (lightgbm_tpu_torch/csrc/segment_hist.cu) and
B6's histogram launch (csrc/segment_partition_hist.cu) run one body
(csrc/segment_hist.cuh): a fixed grid, sized on the host from the card
alone, and each block derives its work from the segments' counts: row
chunks of HIST_CHUNK_ROWS, and feature groups of at most the shared
memory's features when there are fewer chunks than blocks.  The port's
Python twin of that split (ops/cuda_segment.hist_work_split and
hist_block_work) is held here to cover every (row, feature) of one
segment, or of B6's two, exactly once, at the sizes the grower passes and
at two grid sizes; its constants are read from the CUDA header.  Then the
histogram is summed in one order the split and the atomics admit (block
by block, each block's rows in row order, the blocks' partials added in
block order) and held against the JAX package's histogram
(lightgbm_tpu.ops.segment.segment_histogram) and its Pallas kernel in
interpret mode: the count exactly, grad / hess at rtol 1e-5, atol 1e-5.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

from lightgbm_tpu.ops import pallas_segment as pseg
from lightgbm_tpu.ops import segment as jseg
from lightgbm_tpu_torch.ops import cuda_segment as cs

HEADER = (Path(__file__).resolve().parent.parent / "lightgbm_tpu_torch"
          / "csrc" / "segment_hist.cuh").read_text()

COUNTS = [0, 1, 37, 255, 256, 4095, 4096, 4097, 131072, 1015808]
#: two blocks per SM of an H100, and a grid of 16
GRIDS = [264, 16]
B = 256


def _constant(name: str) -> int:
    return int(re.search(r"constexpr int %s = (\d+);" % name,
                         HEADER).group(1))


def test_constants_match_the_kernel():
    assert cs.HIST_CHUNK_ROWS == _constant("kHistChunkRows")
    assert cs.HIST_GROUP_COLS == _constant("kHistGroupCols")


def _coverage(count0, count1, grid, f):
    """Each block's work; returns (split, {(group f0, fn): [chunk, ...]}
    with the chunks of every block of the group), after checking that
    every block's group is one of the split's."""
    cap = cs.hist_group_cap(B)
    assert grid >= -(-f // cap)
    split = cs.hist_work_split(count0, count1, grid, f, cap)
    assert 1 <= split.group_cols <= cap
    by_group = {}
    for block in range(grid):
        f0, fn, chunks = cs.hist_block_work(split, block, grid, f)
        assert chunks == sorted(chunks)
        by_group.setdefault((f0, fn), []).extend(chunks)
    return split, by_group


def _check_once(count0, count1, grid, f):
    split, by_group = _coverage(count0, count1, grid, f)
    # the groups cut [0, F) into spans, each worked by at least one block
    spans = sorted(by_group)
    assert len(spans) == split.groups
    assert [s[0] for s in spans] == [sum(s[1] for s in spans[:k])
                                     for k in range(len(spans))]
    assert sum(s[1] for s in spans) == f and all(s[1] > 0 for s in spans)
    # each group's blocks take every chunk of both segments once
    for chunks in by_group.values():
        got = np.bincount(np.asarray(chunks, int),
                          minlength=split.chunks)
        assert got.shape[0] == split.chunks and (got == 1).all()
    # the chunks cut each segment's rows [0, count) into spans
    r = cs.HIST_CHUNK_ROWS
    assert split.chunks0 == -(-count0 // r)
    assert split.chunks - split.chunks0 == -(-count1 // r)
    return split


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("f", [1, 28, 137])
@pytest.mark.parametrize("count", COUNTS)
def test_every_row_and_feature_once(count, f, grid):
    split = _check_once(count, 0, grid, f)
    chunks = -(-count // cs.HIST_CHUNK_ROWS)
    if chunks >= grid:  # the root: as few groups as the memory allows
        assert split.groups == -(-f // cs.hist_group_cap(B))
    elif chunks:  # a small segment spreads its features over the grid
        least = -(-f // cs.hist_group_cap(B))
        assert split.groups * chunks <= max(grid, least * chunks)
        assert 2 * split.groups >= min(f, grid // chunks)


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("counts", [(0, 0), (0, 37), (37, 0), (255, 4097),
                                    (4096, 1), (400_000, 615_808)])
def test_both_children_once(counts, grid):
    """B6's two segments: the left child's chunks, then the right's."""
    _check_once(counts[0], counts[1], grid, 28)


def test_grid_sizing():
    assert cs.hist_grid(132, 28, 29) == 264
    assert cs.hist_grid(2, 137, 29) == 5
    assert cs.hist_group_cap(256) == 29
    assert cs.hist_group_cap(9000) == 1
    assert cs.hist_group_cap(10 ** 6) == 0


# --- the histogram in the split's order ------------------------------------

def _payload(n_pad, f, num_bins, seed):
    """f bin columns, then grad / hess / count mask, lane-padded like the
    JAX fast path's payload."""
    rng = np.random.default_rng(seed)
    p = -(-(f + 8) // 128) * 128
    pay = np.zeros((n_pad + jseg.GUARD, p), np.float32)
    pay[:n_pad, :f] = rng.integers(0, num_bins, size=(n_pad, f))
    pay[:n_pad, f] = rng.standard_normal(n_pad)
    pay[:n_pad, f + 1] = rng.random(n_pad)
    pay[:n_pad, f + 2] = (rng.random(n_pad) < 0.9).astype(np.float32)
    return pay, dict(grad_col=f, hess_col=f + 1, cnt_col=f + 2)


def emulate_split(pay, segments, grid, f, num_bins, grad_col, hess_col,
                  cnt_col):
    """The kernel's sums in one order it admits: block by block, each
    block's chunks in order and their rows in row order into its f32
    partial of its feature group (counts as integers), flushed into the
    zeroed output of the chunk's segment, in block order, when the block
    passes to the other segment and after its chunks.  segments: one or
    two (start, count); returns one [F, B, 3] f32 histogram each."""
    cap = cs.hist_group_cap(num_bins)
    counts = [c for _, c in segments] + [0]
    split = cs.hist_work_split(counts[0], counts[1], grid, f, cap)
    outs = [np.zeros((f, num_bins, 3), np.float32) for _ in segments]
    r = cs.HIST_CHUNK_ROWS
    for block in range(grid):
        f0, fn, chunks = cs.hist_block_work(split, block, grid, f)
        part, side = None, None
        for j in chunks:
            s = 0 if j < split.chunks0 else 1
            if s != side:
                if part is not None:
                    _flush(outs[side], part, f0, fn)
                part = (np.zeros((2, fn, num_bins), np.float32),
                        np.zeros((fn, num_bins), np.int64))
                side = s
            start, count = segments[s]
            r0 = (j - (split.chunks0 if s else 0)) * r
            for row in pay[start + r0:start + min(r0 + r, count)]:
                b = row[f0:f0 + fn].astype(np.int64)
                ok = (b >= 0) & (b < num_bins)
                k = np.arange(fn)[ok]
                part[0][0, k, b[ok]] += row[grad_col]
                part[0][1, k, b[ok]] += row[hess_col]
                part[1][k, b[ok]] += int(row[cnt_col])
        if part is not None:
            _flush(outs[side], part, f0, fn)
    return outs


def _flush(out, part, f0, fn):
    out[f0:f0 + fn, :, 0] += part[0][0]
    out[f0:f0 + fn, :, 1] += part[0][1]
    out[f0:f0 + fn, :, 2] += part[1].astype(np.float32)


def _jax(pay, start, count, f, num_bins, cols):
    return np.asarray(jseg.segment_histogram(
        jnp.asarray(pay), jnp.int32(start), jnp.int32(count),
        num_features=f, num_bins=num_bins, **cols))


def _check(got, ref):
    np.testing.assert_array_equal(got[..., 2], ref[..., 2])
    np.testing.assert_allclose(got[..., :2], ref[..., :2], rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("grid", [264, 7])
@pytest.mark.parametrize("f", [5, 31])
@pytest.mark.parametrize("start,count", [(0, 300), (100, 37), (0, 0),
                                         (7, 1), (9, 515)])
def test_split_order_matches_jax(start, count, f, grid):
    """31 features at 16 bins take two groups at the root's split."""
    pay, cols = _payload(600, f, 16, seed=start + count + f)
    got, = emulate_split(pay, [(start, count)], grid, f, 16, **cols)
    _check(got, _jax(pay, start, count, f, 16, cols))


@pytest.mark.parametrize("grid", [264, 7])
def test_split_order_matches_pallas_interpret(grid):
    start, count, f = 3, 401, 6
    pay, cols = _payload(512, f, 16, seed=11)
    got, = emulate_split(pay, [(start, count)], grid, f, 16, **cols)
    ref = pseg.segment_histogram(jnp.asarray(pay), jnp.int32(start),
                                 jnp.int32(count), num_features=f,
                                 num_bins=16, interpret=True, **cols)
    _check(got, np.asarray(ref))


@pytest.mark.parametrize("grid", [264, 5])
@pytest.mark.parametrize("nl", [0, 1, 130, 300])
def test_two_segments_match_jax(nl, grid):
    """B6's launch: the left child's rows then the right's, each into its
    own histogram."""
    start, count, f = 11, 300, 7
    pay, cols = _payload(400, f, 16, seed=nl)
    left, right = emulate_split(pay, [(start, nl), (start + nl, count - nl)],
                                grid, f, 16, **cols)
    _check(left, _jax(pay, start, nl, f, 16, cols))
    _check(right, _jax(pay, start + nl, count - nl, f, 16, cols))
