"""The histograms' work split on the device, emulated on the CPU.

On the card, B1, B4 and B5 (lightgbm_tpu_torch/csrc/segment_hist.cu) and
B6's histogram launch (csrc/segment_partition_hist.cu) run one body
(csrc/segment_hist.cuh): a fixed grid, sized on the host from the card
alone, and each block derives its work from the K segments' counts: row
chunks of HIST_CHUNK_ROWS numbered over the segments one after another,
one run of consecutive chunks per block, and feature groups of at most
the shared memory's features when there are fewer chunks than blocks.
The port's Python twin of that split (ops/cuda_segment.hist_work_split
and hist_block_work) is held here to cover every (segment, row, feature)
exactly once, for one segment, B6's two and B5's K with empty and
one-row segments, at the sizes the grower passes and at two grid sizes;
its constants are read from the CUDA header.  Then the f32 histogram is
summed as the kernel sums it (each block's rows into its int64
fixed-point partial, flushed into the int64 total where its run passes
to the next segment and after its run, converted once) and held bit for
bit to the plain fixed-point version
(lightgbm_tpu_torch.ops.segment.segment_histogram_fixed), and against the
JAX package's histogram (lightgbm_tpu.ops.segment.segment_histogram) and
its Pallas kernel in interpret mode: the count exactly, grad / hess at
rtol 1e-5, atol 1e-5.
"""
import re
from pathlib import Path

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
    assert cs.HIST_CELL_BYTES_INT == _constant("kHistCellBytesInt")
    assert cs.HIST_CELL_BYTES_FIXED == _constant("kHistCellBytesFixed")
    assert tseg.FIXED_MAX_EXP == _constant("kFixedMaxExp")


def _coverage(counts, grid, f):
    """Each block's work; returns (split, {(group f0, fn): [(segment,
    chunk), ...]} with the chunks of every block of the group), after
    checking that every block's group is one of the split's, its chunks
    one run in order, and that the group's working blocks number its
    `workers` (the ticket count of the fixed-point conversion)."""
    cap = cs.hist_group_cap(B)
    assert grid >= -(-f // cap)
    split = cs.hist_work_split(counts, grid, f, cap)
    assert 1 <= split.group_cols <= cap
    by_group, workers = {}, {}
    for block in range(grid):
        f0, fn, work = cs.hist_block_work(split, block, grid, f)
        run = cs.hist_run(split, block, grid)
        glob = [split.offsets[k] + j for k, j in work]
        assert glob == list(range(run.first, run.first + len(glob)))
        by_group.setdefault((f0, fn), []).extend(work)
        w = workers.setdefault((f0, fn), [run.workers, 0])
        assert w[0] == run.workers
        w[1] += int(run.works)
    assert all(a == b for a, b in workers.values())
    return split, by_group


def _check_once(counts, grid, f):
    split, by_group = _coverage(counts, grid, f)
    # the groups cut [0, F) into spans, each worked by at least one block
    spans = sorted(by_group)
    assert len(spans) == split.groups
    assert [s[0] for s in spans] == [sum(s[1] for s in spans[:k])
                                     for k in range(len(spans))]
    assert sum(s[1] for s in spans) == f and all(s[1] > 0 for s in spans)
    # each group's blocks take every chunk of every segment once, and the
    # chunks cut each segment's rows [0, count) into spans
    r = cs.HIST_CHUNK_ROWS
    want = sorted((k, j) for k, c in enumerate(counts)
                  for j in range(-(-c // r)))
    for work in by_group.values():
        assert sorted(work) == want
    assert split.chunks == len(want)
    # each segment's cells of each group are converted once: by the last
    # of the working runs that flushed into them, or for an empty segment
    # by one working run
    for block in range(grid):
        run = cs.hist_run(split, block, grid)
        if not run.works:
            continue
        segs = {k for k, _ in cs.hist_block_work(split, block, grid, f)[2]}
        for k in range(len(counts)):
            owners = cs.hist_owners(split, run, k)
            assert len(owners) >= 1 and owners[-1] < run.workers
            if counts[k]:
                assert (run.q in owners) == (k in segs)
    return split


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("f", [1, 28, 137])
@pytest.mark.parametrize("count", COUNTS)
def test_every_row_and_feature_once(count, f, grid):
    split = _check_once([count], grid, f)
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
    _check_once(list(counts), grid, 28)


#: B5's K segments (a frontier round's smaller children), with empty and
#: one-row ones
K_COUNTS = {1: [4097], 2: [0, 1], 3: [1, 0, 130_000],
            8: [200_000, 1, 0, 37, 111_111, 4099, 0, 101_603]}


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("f", [5, 28])
@pytest.mark.parametrize("k", sorted(K_COUNTS))
def test_k_segments_once(k, f, grid):
    """One grid over K segments: every (segment, row, feature) once, and
    a block's run crosses few segment boundaries (it holds at most one
    chunk of every segment it only passes through)."""
    counts = K_COUNTS[k]
    split = _check_once(counts, grid, f)
    for block in range(grid):
        segs = [sk for sk, _ in cs.hist_block_work(split, block, grid, f)[2]]
        inner = set(segs[1:-1]) - {segs[0], segs[-1]} if segs else set()
        assert all(-(-counts[sk] // cs.HIST_CHUNK_ROWS) == segs.count(sk)
                   for sk in inner)


def test_grid_sizing():
    assert cs.hist_grid(132, 28, 29) == 264
    assert cs.hist_grid(2, 137, 29) == 5
    assert cs.hist_stride(255) == cs.hist_stride(256) == 257
    assert cs.hist_group_cap(256, quantized=True) == 29
    assert cs.hist_group_cap(256) == 21  # fixed point: 20 bytes a cell
    assert cs.hist_group_cap(9000, quantized=True) == 1
    assert cs.hist_group_cap(5000) == 1
    assert cs.hist_group_cap(10 ** 6) == 0


# --- the histogram as the kernel sums it ------------------------------------

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
                  cnt_col, scale):
    """The kernel's sums: block by block, each block's run of chunks in
    order, their rows into its int64 fixed-point partial of its feature
    group (counts as integers), flushed into the segment's int64 total
    where the run passes to the next segment and after the run; each
    total converted once (times 2^-s, rounded to f32).  segments: K
    (start, count); returns one [F, B, 3] f32 histogram each."""
    cap = cs.hist_group_cap(num_bins)
    split = cs.hist_work_split([c for _, c in segments], grid, f, cap)
    totals = [np.zeros((f, num_bins, 3), np.int64) for _ in segments]
    r = cs.HIST_CHUNK_ROWS
    pt = torch.from_numpy(pay)
    q = tseg.to_fixed(pt[:, [grad_col, hess_col]], scale[None, :]).numpy()
    for block in range(grid):
        f0, fn, work = cs.hist_block_work(split, block, grid, f)
        part, side = None, None
        for k, j in work:
            if k != side:
                if part is not None:
                    totals[side][f0:f0 + fn] += part
                part = np.zeros((fn, num_bins, 3), np.int64)
                side = k
            start, count = segments[k]
            for row in range(start + j * r, start + min(j * r + r, count)):
                b = pay[row, f0:f0 + fn].astype(np.int64)
                ok = (b >= 0) & (b < num_bins)
                kk = np.arange(fn)[ok]
                part[kk, b[ok], 0] += q[row, 0]
                part[kk, b[ok], 1] += q[row, 1]
                part[kk, b[ok], 2] += int(round(pay[row, cnt_col]))
        if part is not None:
            totals[side][f0:f0 + fn] += part
    inv = torch.ldexp(torch.ones(2), -scale.to(torch.int32)).numpy()
    outs = []
    for t in totals:
        o = torch.from_numpy(t).to(torch.float32).numpy()
        o[..., 0] *= inv[0]
        o[..., 1] *= inv[1]
        outs.append(o)
    return outs


def _fixed(pay, start, count, f, num_bins, cols, scale):
    return tseg.segment_histogram_fixed(
        torch.from_numpy(pay), start, count, num_features=f,
        num_bins=num_bins, scale=scale, **cols).numpy()


def _jax(pay, start, count, f, num_bins, cols):
    return np.asarray(jseg.segment_histogram(
        jnp.asarray(pay), jnp.int32(start), jnp.int32(count),
        num_features=f, num_bins=num_bins, **cols))


def _check(got, ref):
    np.testing.assert_array_equal(got[..., 2], ref[..., 2])
    np.testing.assert_allclose(got[..., :2], ref[..., :2], rtol=1e-5,
                               atol=1e-5)


def _scale(pay, segments, cols):
    return tseg.fixed_scale(torch.from_numpy(pay), [s for s, _ in segments],
                            [c for _, c in segments], cols["grad_col"],
                            cols["hess_col"])


@pytest.mark.parametrize("grid", [264, 7])
@pytest.mark.parametrize("f", [5, 31])
@pytest.mark.parametrize("start,count", [(0, 300), (100, 37), (0, 0),
                                         (7, 1), (9, 515)])
def test_split_order_matches_jax(start, count, f, grid):
    """31 features at 16 bins take two groups at the root's split."""
    pay, cols = _payload(600, f, 16, seed=start + count + f)
    scale = _scale(pay, [(start, count)], cols)
    got, = emulate_split(pay, [(start, count)], grid, f, 16, **cols,
                         scale=scale)
    fixed = _fixed(pay, start, count, f, 16, cols, scale)
    assert np.array_equal(got.view(np.int32), fixed.view(np.int32))
    _check(got, _jax(pay, start, count, f, 16, cols))


@pytest.mark.parametrize("grid", [264, 7])
def test_split_order_matches_pallas_interpret(grid):
    start, count, f = 3, 401, 6
    pay, cols = _payload(512, f, 16, seed=11)
    scale = _scale(pay, [(start, count)], cols)
    got, = emulate_split(pay, [(start, count)], grid, f, 16, **cols,
                         scale=scale)
    ref = pseg.segment_histogram(jnp.asarray(pay), jnp.int32(start),
                                 jnp.int32(count), num_features=f,
                                 num_bins=16, interpret=True, **cols)
    _check(got, np.asarray(ref))


@pytest.mark.parametrize("grid", [264, 5])
@pytest.mark.parametrize("nl", [0, 1, 130, 300])
def test_two_segments_match_jax(nl, grid):
    """B6's launch: the left child's rows then the right's, each into its
    own histogram, at the parent's exponents."""
    start, count, f = 11, 300, 7
    pay, cols = _payload(400, f, 16, seed=nl)
    kids = [(start, nl), (start + nl, count - nl)]
    scale = _scale(pay, [(start, count)], cols)
    left, right = emulate_split(pay, kids, grid, f, 16, **cols, scale=scale)
    for got, (s, c) in zip((left, right), kids):
        fixed = _fixed(pay, s, c, f, 16, cols, scale)
        assert np.array_equal(got.view(np.int32), fixed.view(np.int32))
        _check(got, _jax(pay, s, c, f, 16, cols))


@pytest.mark.parametrize("grid", [264, 9])
def test_k_segments_match_jax(grid):
    """B5's launch: K = 8 segments, empty and one-row ones among them, at
    the exponents of all their rows."""
    f = 6
    pay, cols = _payload(900, f, 16, seed=3)
    counts = [130, 1, 0, 37, 300, 0, 129, 200]
    segments, s = [], 0
    for c in counts:
        segments.append((s, c))
        s += c + 5
    scale = _scale(pay, segments, cols)
    outs = emulate_split(pay, segments, grid, f, 16, **cols, scale=scale)
    for got, (s, c) in zip(outs, segments):
        fixed = _fixed(pay, s, c, f, 16, cols, scale)
        assert np.array_equal(got.view(np.int32), fixed.view(np.int32))
        _check(got, _jax(pay, s, c, f, 16, cols))
