// The histogram body that B1, B4 and B5 (segment_hist.cu) and the merged
// partition + histogram B6 (segment_partition_hist.cu) share, and the
// order-free cell update and flush that B7 (segment_hist_colblock.cu)
// shares too.
//
// Contract of the body: sums of (grad, hess, count mask) per (feature,
// bin) over the payload rows of K segments, each into its own [F, B, 3]
// slice of the output: B1's one segment, B5's K disjoint segments, B6's two
// children of a split.  Bin columns hold integer-valued floats in [0, B);
// a bin outside that range is skipped.  The count mask holds small
// integers (0 or 1 in the grower, which has no bagging weights): each is
// rounded to int32 and summed exactly, so a fractional mask would be
// rounded, unlike the plain version's float sum.
//
// Two cell types, and neither result depends on the order of the adds:
//   - int32 (B4, B5 int32: gradient_quantization): each grad/hess value is
//     an integer by construction, converted exactly and summed with native
//     shared adds; the blocks' partials go into the zeroed int32 output
//     with int32 atomics.
//   - fixed point (B1, B5 f32, B6, B7): each grad / hess value v is first
//     rounded to a multiple of 2^-s, q = rint(v * 2^s) as int64, with one
//     exponent s per channel (ops/segment.fixed_scale: as large as keeps
//     rows * max|v| * 2^s below 2^62, so no sum overflows), and the q are
//     summed exactly as 64-bit integers: in shared memory as two 32-bit
//     words with two native adds, the carry out of the low word read from
//     its old value (sm_90 has no native 64-bit or f32 add on shared
//     memory; either is a compare-and-swap loop); each block's partials
//     go into an int64 scratch with native 64-bit global atomics; and of
//     the blocks that flushed into one segment's cells of a feature group,
//     the last (a ticket) writes them as f32, the exact sum times 2^-s
//     rounded once, and clears the scratch and its ticket for the next
//     call.  The result is
//     ops/segment.segment_histogram_fixed bit for bit, at any grid and in
//     any order of warps and blocks.
//
// The work is split on the device, from the segments' counts, so the host
// sizes a fixed grid from the card alone (hist_split; the port's Python
// twin is ops/cuda_segment.hist_work_split, which the CPU tests hold to
// cover every (segment, row, feature) once):
//   - each segment's rows are cut into chunks of kHistChunkRows, and the
//     chunks of the K segments are numbered one after another, segment 0's
//     first (a prefix sum over the counts that every block computes alike);
//   - the features into groups of at most `cap` (<= kHistGroupCols, and as
//     many as a block's shared memory holds at B bins): as few groups as
//     that allows when there are at least as many chunks as the grid has
//     blocks (the root: every block takes every feature, as in a plain
//     per-block histogram), and otherwise as many as fill the grid, up to
//     one feature per group (a leaf of 2,000 rows then runs on ~200
//     blocks instead of one);
//   - block b takes group b % groups and, of the group's blocks, the
//     (b / groups)-th run of consecutive chunks, the chunks split into as
//     few equal runs as the group's blocks allow.  A run crosses few
//     segment boundaries, so K small segments cost about as many flushes
//     as one segment of their rows.
// A block keeps its group's histogram in shared memory, [fn, stride]
// cells with stride = (B + 1) | 1: an odd stride keeps the lanes that add
// one row's consecutive features in different banks when their bins
// agree.  Each warp takes kHistRowsPerWarp consecutive rows of a chunk;
// one warp-wide load reads a row's three value columns and its group's
// bin columns (lanes 0-2 the values, lanes 3.. the bins; 2, 4 or 8 rows
// per load for groups of <= 13, <= 5 or 1 feature), and the next chunk's
// loads are issued before the current chunk is added, so they are in
// flight meanwhile.  A lane takes its row's values from lanes 0-2 by
// shuffle and adds them to its (feature, bin) cell.  When a block's run
// passes from one segment to the next it flushes and clears.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "segment_check.cuh"

namespace {

constexpr int kHistThreads = 512;
constexpr int kHistWarps = kHistThreads / 32;
constexpr int kHistChunkRows = 128;  // rows per work item
constexpr int kHistRowsPerWarp = kHistChunkRows / kHistWarps;  // 8
// a warp-wide load takes up to 8 rows (groups of one feature)
static_assert(kHistRowsPerWarp % 8 == 0, "a warp's rows: a multiple of 8");
// bin columns per feature group at most: with the three value columns, a
// row fits one warp-wide load
constexpr int kHistGroupCols = 29;
// shared memory a cell takes: int32 (grad, hess, count); fixed point grad
// and hess in two 32-bit words each, and the count
constexpr int kHistCellBytesInt = 12;
constexpr int kHistCellBytesFixed = 20;
// the fixed-point exponents lie in [-kFixedMaxExp, kFixedMaxExp], so 2^s
// and 2^-s are normal f32 (ops/segment.FIXED_MAX_EXP)
constexpr int kFixedMaxExp = 126;

// Cells a feature takes at B bins: B + 1, made odd.
__host__ __device__ inline int hist_stride(int B) { return (B + 1) | 1; }

// Shared memory of a block whose groups have at most cap features at B
// bins.
__host__ __device__ inline int hist_smem_bytes(int cap, int B, bool fixed) {
  return cap * hist_stride(B) *
         (fixed ? kHistCellBytesFixed : kHistCellBytesInt);
}

// 2^e as f32, for e in [-126, 127].
__device__ __forceinline__ float pow2f(int e) {
  return __int_as_float((e + 127) << 23);
}

// rint(v * 2^s) as an int64, the rounding ops/segment.to_fixed repeats.
__device__ __forceinline__ long long to_fixed(float v, float scale) {
  return __float2ll_rn(__fmul_rn(v, scale));
}

// (hi:lo) += q: a 64-bit two's-complement sum kept in two 32-bit words in
// shared memory, with native adds.  The low word's add returns its old
// value, which shows whether it wrapped; the carry joins the high word's
// add.  Every wrap of the low word adds one carry, so the pair holds the
// sum modulo 2^64 whatever the order of the adds.
__device__ __forceinline__ void add_fixed(unsigned* lo, unsigned* hi,
                                          long long q) {
  const unsigned l = static_cast<unsigned>(q);
  unsigned h = static_cast<unsigned>(static_cast<unsigned long long>(q) >> 32);
  if (l != 0u) {
    const unsigned old = atomicAdd(lo, l);
    h += (old + l < old) ? 1u : 0u;
  }
  if (h != 0u) atomicAdd(hi, h);
}

__device__ __forceinline__ long long fixed_value(unsigned lo, unsigned hi) {
  return static_cast<long long>((static_cast<unsigned long long>(hi) << 32) |
                                lo);
}

// The int32 cells: (grad, hess) pairs and counts, [ncell] each.
struct IntCells {
  int2* gh;
  int* cnt;
  __device__ IntCells(unsigned char* smem, int ncell)
      : gh(reinterpret_cast<int2*>(smem)),
        cnt(reinterpret_cast<int*>(gh + ncell)) {}
  __device__ void clear(int ncell) {
    for (int i = threadIdx.x; i < ncell; i += blockDim.x) {
      gh[i] = make_int2(0, 0);
      cnt[i] = 0;
    }
  }
  // grad / hess are integers by construction (gradient_quantization)
  __device__ void add(int k, float g, float h, float c) {
    const int gi = __float2int_rn(g), hi = __float2int_rn(h);
    const int ci = __float2int_rn(c);
    if (gi) atomicAdd(&gh[k].x, gi);
    if (hi) atomicAdd(&gh[k].y, hi);
    if (ci) atomicAdd(cnt + k, ci);
  }
};

// The fixed-point cells: the low and high words of grad and of hess, and
// the counts, five planar [ncell] arrays of 32-bit words.
struct FixedCells {
  unsigned* g_lo;
  unsigned* g_hi;
  unsigned* h_lo;
  unsigned* h_hi;
  int* cnt;
  float mg, mh;  // 2^s of grad and of hess
  __device__ FixedCells(unsigned char* smem, int ncell, float mg_, float mh_)
      : g_lo(reinterpret_cast<unsigned*>(smem)),
        g_hi(g_lo + ncell),
        h_lo(g_hi + ncell),
        h_hi(h_lo + ncell),
        cnt(reinterpret_cast<int*>(h_hi + ncell)),
        mg(mg_),
        mh(mh_) {}
  __device__ void clear(int ncell) {
    for (int i = threadIdx.x; i < 5 * ncell; i += blockDim.x) g_lo[i] = 0u;
  }
  // values already in fixed point, and the count
  __device__ void add_q(int k, long long qg, long long qh, int c) {
    add_fixed(g_lo + k, g_hi + k, qg);
    add_fixed(h_lo + k, h_hi + k, qh);
    if (c) atomicAdd(cnt + k, c);
  }
  __device__ void add(int k, float g, float h, float c) {
    add_q(k, to_fixed(g, mg), to_fixed(h, mh), __float2int_rn(c));
  }
  __device__ long long grad(int k) const { return fixed_value(g_lo[k], g_hi[k]); }
  __device__ long long hess(int k) const { return fixed_value(h_lo[k], h_hi[k]); }
};

// Where the fixed-point sums go: the int64 scratch [K, F, B, 2] (grad,
// hess) and int32 [K, F, B] (count), zero on entry and left zero; the f32
// output [K, F, B, 3], every cell written by the conversion; tickets [K,
// groups] (one per segment and feature group), zero on entry and left
// zero; the [2] exponents s.  raw != 0 (B1's and B7's raw output, for the
// distributed learners' exact exchange): `out` is int64 [K, F, B, 3]
// instead, each cell's exact integer sums (grad, hess, count) as they
// are, with no conversion to f32 (ops/segment.fixed_sums' integers).
struct FixedOut {
  unsigned long long* gh;
  int* cnt;
  float* out;
  int* tickets;
  const int* scale;
  int raw;
};

// Adds a group's non-zero int32 cells into its output span dst[0, fn * B *
// 3) (zeroed by the caller), one element a thread, so a warp's atomics
// land on consecutive words.
__device__ __forceinline__ void flush_int(const IntCells& cells, int* dst,
                                          int fn, int B) {
  const int stride = hist_stride(B);
  const int n = fn * B * 3;
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const int i = e / 3;
    const int ch = e - 3 * i;
    const int j = i / B;
    const int k = j * stride + (i - j * B);
    const int v = ch == 0 ? cells.gh[k].x
                          : (ch == 1 ? cells.gh[k].y : cells.cnt[k]);
    if (v) atomicAdd(dst + e, v);
  }
}

// Adds cells [fn, stride] of fixed-point sums into the scratch at cell
// `base` ([fn, B] cells from there) with native 64- and 32-bit atomics,
// one element a thread, so a warp's atomics land on consecutive words.
__device__ __forceinline__ void flush_fixed(const FixedCells& cells,
                                            const FixedOut& o, long long base,
                                            int fn, int B, int stride) {
  for (int e = threadIdx.x; e < 2 * fn * B; e += blockDim.x) {
    const int i = e >> 1;
    const int j = i / B;
    const int k = j * stride + (i - j * B);
    const long long v = (e & 1) ? cells.hess(k) : cells.grad(k);
    if (v) atomicAdd(o.gh + 2 * base + e, static_cast<unsigned long long>(v));
  }
  for (int i = threadIdx.x; i < fn * B; i += blockDim.x) {
    const int j = i / B;
    const int c = cells.cnt[j * stride + (i - j * B)];
    if (c) atomicAdd(o.cnt + base + i, c);
  }
}

// The f32 cells of the scratch's cells [base, base + n) in each of K
// slices (`slice` cells apart): each the exact sum times 2^-s rounded once
// to f32 (or, raw, the int64 sums themselves); the scratch is cleared
// behind.  Reads bypass L1: the other
// blocks' atomics landed in L2.
__device__ __forceinline__ void convert_fixed(const FixedOut& o, int K,
                                              long long slice, long long base,
                                              int n) {
  const float ig = pow2f(-o.scale[0]);
  const float ih = pow2f(-o.scale[1]);
  for (int k = 0; k < K; ++k) {
    const long long b0 = k * slice + base;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const long long e = b0 + i;
      const long long g = static_cast<long long>(__ldcg(o.gh + 2 * e));
      const long long h = static_cast<long long>(__ldcg(o.gh + 2 * e + 1));
      const int c = __ldcg(o.cnt + e);
      if (o.raw) {
        long long* d = reinterpret_cast<long long*>(o.out) + 3 * e;
        d[0] = g;
        d[1] = h;
        d[2] = c;
      } else {
        float* d = o.out + 3 * e;
        d[0] = __fmul_rn(__ll2float_rn(g), ig);
        d[1] = __fmul_rn(__ll2float_rn(h), ih);
        d[2] = static_cast<float>(c);
      }
      o.gh[2 * e] = 0ull;
      o.gh[2 * e + 1] = 0ull;
      o.cnt[e] = 0;
    }
  }
}

// After a block's flushes into cells [base, base + n) of the scratch: its
// ticket on `ticket`; the block that takes the last of `owners` tickets
// converts those cells and clears the ticket.  Every thread of the block
// calls it, after a __threadfence() and a barrier behind its flushes.
__device__ __forceinline__ void convert_if_last(const FixedOut& o,
                                                int* ticket, int owners,
                                                long long base, int n) {
  __shared__ int s_last;
  if (threadIdx.x == 0) s_last = atomicAdd(ticket, 1) == owners - 1;
  __syncthreads();
  const bool last = s_last;
  __syncthreads();  // s_last is free for the next call
  if (!last) return;  // uniform per block
  __threadfence();
  convert_fixed(o, 1, 0, base, n);
  if (threadIdx.x == 0) *ticket = 0;
}

// The work split of K segments' chunks (`chunks` in all) over `grid`
// blocks, F features in groups of at most cap (grid >= ceil(F / cap)).
struct HistSplit {
  int groups;      // feature groups
  int group_cols;  // features per group; the last may have fewer
  int chunks;      // chunks of all segments
};

__host__ __device__ inline HistSplit hist_split(int chunks, int grid, int F,
                                                int cap) {
  HistSplit s;
  s.chunks = chunks;
  // as many groups as fill the grid, one feature each at most, and no
  // fewer than the shared memory allows
  int g = chunks > 0 ? grid / chunks : grid;
  if (g > F) g = F;
  const int least = (F + cap - 1) / cap;
  if (g < least) g = least;
  s.group_cols = (F + g - 1) / g;
  s.groups = (F + s.group_cols - 1) / s.group_cols;
  return s;
}

// Block `block`'s share of a split: its feature group, its run of chunks
// [first, last), and the blocks of its group that have a run (`workers`;
// with no chunks at all the group's first block takes the empty run, so
// that the fixed-point output is still written).
struct HistRun {
  int group, first, last, workers;
  bool works;
  int q, per;  // the run's index in its group, and chunks a full run
};

__host__ __device__ inline HistRun hist_run(const HistSplit& s, int block,
                                            int grid) {
  HistRun r;
  r.group = block % s.groups;
  const int q = block / s.groups;
  const int nbg = (grid - r.group + s.groups - 1) / s.groups;
  const int per = s.chunks > 0 ? (s.chunks + nbg - 1) / nbg : 0;
  r.workers = s.chunks > 0 ? (s.chunks + per - 1) / per : 1;
  r.works = q < r.workers;
  r.first = q * per;
  r.last = r.first + per < s.chunks ? r.first + per : s.chunks;
  r.q = q;
  r.per = per;
  return r;
}

// The runs of a group that convert segment k, whose chunks are [off, off
// + nck): those that hold one of its chunks; an empty segment goes to the
// run at its place (the last run past the end).  [*qa, *qb].
__host__ __device__ inline void hist_owners(const HistRun& r, int off, int nck,
                                            int* qa, int* qb) {
  if (nck > 0) {
    *qa = off / r.per;
    *qb = (off + nck - 1) / r.per;
  } else {
    *qa = r.per > 0 ? (off / r.per < r.workers - 1 ? off / r.per
                                                   : r.workers - 1)
                    : 0;
    *qb = *qa;
  }
}

// The cells of a block: fixed point or int32.
template <bool Fixed>
struct CellsOf;

template <>
struct CellsOf<false> {
  __device__ static IntCells make(unsigned char* smem, int ncell,
                                  const FixedOut&) {
    return IntCells(smem, ncell);
  }
};

template <>
struct CellsOf<true> {
  __device__ static FixedCells make(unsigned char* smem, int ncell,
                                    const FixedOut& fo) {
    return FixedCells(smem, ncell, pow2f(fo.scale[0]), pow2f(fo.scale[1]));
  }
};

// The segments of B1 and B5: seg = [K, 2] int32 (start, count) on the
// device, every segment's rows in one payload.
struct SegTable {
  const float* payload;
  const int* seg;
  int P;
  __device__ void get(int k, const float*& rows, int& count) const {
    rows = payload + static_cast<long long>(seg[2 * k]) * P;
    count = seg[2 * k + 1];
  }
};

// B6's two children: each in its own buffer (where the move left it).
struct SegPair {
  const float* rows0;
  int count0;
  const float* rows1;
  int count1;
  __device__ void get(int k, const float*& rows, int& count) const {
    rows = k ? rows1 : rows0;
    count = k ? count1 : count0;
  }
};

// The segment that holds chunk j: walks forward from where it is.
template <typename Segs>
struct SegCursor {
  int k;        // the segment
  int base;     // its first chunk
  int nchunks;  // its chunks
  const float* rows;
  int count;
  __device__ void seek(const Segs& segs, int j) {
    while (j >= base + nchunks) {
      base += nchunks;
      segs.get(++k, rows, count);
      nchunks = (count + kHistChunkRows - 1) / kHistChunkRows;
    }
  }
};

// Block `block` of `grid`: its share of the histograms of the K segments
// of `segs`, slice k of the output for segment k.  Fixed-point cells when
// Fixed, with the sums' destinations in `fo`; else int32 cells added into
// iout [K, F, B, 3].  Every thread of the block calls it; smem holds
// hist_smem_bytes(cap, B, Fixed).
template <bool Fixed, typename Segs>
__device__ __forceinline__ void hist_block(
    const Segs& segs, int K, int P, int* iout, const FixedOut& fo, int F,
    int B, int cap, int grad_col, int hess_col, int cnt_col, int block,
    int grid, unsigned char* smem) {
  int chunks = 0;
  for (int k = 0; k < K; ++k) {
    const float* rows;
    int count;
    segs.get(k, rows, count);
    chunks += (count + kHistChunkRows - 1) / kHistChunkRows;
  }
  const HistSplit sp = hist_split(chunks, grid, F, cap);
  const HistRun run = hist_run(sp, block, grid);
  if (!run.works) return;  // uniform per block
  const int f0 = run.group * sp.group_cols;
  const int fn = min(sp.group_cols, F - f0);
  const int stride = hist_stride(B);
  const int ncell = fn * stride;
  auto cells = CellsOf<Fixed>::make(smem, ncell, fo);
  cells.clear(ncell);
  __syncthreads();
  auto flush = [&](int k) {
    const long long base = (static_cast<long long>(k) * F + f0) * B;
    if constexpr (Fixed) {
      flush_fixed(cells, fo, base, fn, B, stride);
    } else {
      flush_int(cells, iout + 3 * base, fn, B);
    }
  };

  if (run.first < run.last) {
    // a row's lanes: 3 values and fn bins in the smallest power of two
    const int width = fn <= 1 ? 4 : (fn <= 5 ? 8 : (fn <= 13 ? 16 : 32));
    const int rpp = 32 / width;  // rows per warp-wide load
    const int nload = kHistRowsPerWarp / rpp;
    const int lane = threadIdx.x & 31;
    const int slot = lane & (width - 1);
    const bool live = slot < fn + 3;
    const bool bin_lane = slot >= 3 && live;
    const int col = slot == 0 ? grad_col
                              : (slot == 1 ? hess_col
                                           : (slot == 2 ? cnt_col
                                                        : f0 + slot - 3));
    const int row0 = (threadIdx.x >> 5) * kHistRowsPerWarp + lane / width;

    // chunk j of the cursor's segment: its rows, the first in `first`
    auto chunk_rows = [&](const SegCursor<Segs>& at, int j,
                          const float*& first) -> int {
      const int r0 = (j - at.base) * kHistChunkRows;
      first = at.rows + static_cast<long long>(r0) * P;
      return min(kHistChunkRows, at.count - r0);
    };
    auto load = [&](const SegCursor<Segs>& at, int j,
                    float (&v)[kHistRowsPerWarp]) {
      const float* first;
      const int n = chunk_rows(at, j, first);
#pragma unroll
      for (int i = 0; i < kHistRowsPerWarp; ++i) {
        const int r = row0 + i * rpp;
        v[i] = (i < nload && live && r < n)
                   ? first[static_cast<long long>(r) * P + col]
                   : 0.f;
      }
    };

    SegCursor<Segs> cur_seg;
    cur_seg.k = 0;
    cur_seg.base = 0;
    segs.get(0, cur_seg.rows, cur_seg.count);
    cur_seg.nchunks = (cur_seg.count + kHistChunkRows - 1) / kHistChunkRows;
    cur_seg.seek(segs, run.first);
    float cur[kHistRowsPerWarp], nxt[kHistRowsPerWarp];
    int j = run.first;
    load(cur_seg, j, cur);
    for (;;) {
      const int jn = j + 1;
      const bool more = jn < run.last;  // uniform per block
      SegCursor<Segs> next_seg = cur_seg;
      if (more) {
        next_seg.seek(segs, jn);
        load(next_seg, jn, nxt);
      }
      const float* first;
      const int n = chunk_rows(cur_seg, j, first);
#pragma unroll
      for (int i = 0; i < kHistRowsPerWarp; ++i) {
        if (i < nload) {  // uniform per block
          const float v = cur[i];
          const float g = __shfl_sync(0xffffffffu, v, 0, width);
          const float h = __shfl_sync(0xffffffffu, v, 1, width);
          const float c = __shfl_sync(0xffffffffu, v, 2, width);
          if (bin_lane && row0 + i * rpp < n) {
            const int b = static_cast<int>(v);
            if (b >= 0 && b < B) cells.add((slot - 3) * stride + b, g, h, c);
          }
        }
      }
      if (!more) break;
      if (next_seg.k != cur_seg.k) {  // uniform per block
        __syncthreads();
        flush(cur_seg.k);
        __syncthreads();
        cells.clear(ncell);
        __syncthreads();
      }
      cur_seg = next_seg;
#pragma unroll
      for (int i = 0; i < kHistRowsPerWarp; ++i) cur[i] = nxt[i];
      j = jn;
    }
    __syncthreads();
    flush(cur_seg.k);
  }
  if constexpr (Fixed) {
    // each segment's slice of the group's cells is converted by the last
    // of the runs that flushed into it (tickets [K, groups])
    __threadfence();
    __syncthreads();
    int off = 0;
    for (int k = 0; k < K; ++k) {
      const float* rows;
      int count;
      segs.get(k, rows, count);
      const int nck = (count + kHistChunkRows - 1) / kHistChunkRows;
      int qa, qb;
      hist_owners(run, off, nck, &qa, &qb);
      off += nck;
      if (run.q >= qa && run.q <= qb) {  // uniform per block
        convert_if_last(fo, fo.tickets + k * sp.groups + run.group,
                        qb - qa + 1, (static_cast<long long>(k) * F + f0) * B,
                        fn * B);
      }
    }
  }
}

}  // namespace
