// The histogram body that B1, B4 and B5 (segment_hist.cu) and the merged
// partition + histogram B6 (segment_partition_hist.cu) share, and the
// (grad, hess) cell update that B7 (segment_hist_colblock.cu) shares too.
//
// Contract of the body: sums of (grad, hess, count mask) per (feature,
// bin) over the payload rows of up to two segments, each into its own
// [F, B, 3] output (zeroed by the caller), B1's sums for one segment and
// B6's for the two children of a split.  Bin columns hold integer-valued
// floats in [0, B); a bin outside that range is skipped.  The count mask
// holds small integers (0 or 1 in the grower, which has no bagging
// weights): each is rounded to int32 and summed exactly, so a fractional
// mask would be rounded, unlike the plain version's float sum.
//
// The work is split on the device, from the segments' counts, so the host
// sizes a fixed grid from the card alone (hist_split; the port's Python
// twin is ops/cuda_segment.hist_work_split, which the CPU tests hold to
// cover every (row, feature) once):
//   - the rows are cut into chunks of kHistChunkRows, segment 0's chunks
//     first;
//   - the features into groups of at most `cap` (<= kHistGroupCols, and as
//     many as a block's shared memory holds at B bins): as few groups as
//     that allows when the segments have at least as many chunks as the
//     grid has blocks (the root: every block takes every feature, as in a
//     plain per-block histogram), and otherwise as many as fill the grid,
//     up to one feature per group (a leaf of 2,000 rows then runs on
//     ~200 blocks instead of one);
//   - block b takes group b % groups and the chunks b / groups,
//     b / groups + (blocks of its group), ... in order.
// A block keeps its group's histogram in shared memory, as (grad, hess)
// pairs and integer counts [fn, B + 1] (the stride of B + 1 cells keeps
// the lanes that add one row's consecutive features in different banks).
// Each warp takes kHistRowsPerWarp consecutive rows of a chunk; one
// warp-wide load reads a row's three value columns and its group's bin
// columns (lanes 0-2 the values, lanes 3.. the bins; 2, 4 or 8 rows per
// load for groups of <= 13, <= 5 or 1 feature), and the next chunk's loads
// are issued before the current chunk is added, so they are in flight
// meanwhile.  A lane takes its row's values from lanes 0-2 by shuffle and
// adds them to its (feature, bin) cell: f32 (grad, hess) with one 64-bit
// compare-and-swap (sm_90 has no native f32 add on shared memory; a
// float atomicAdd there is a compare-and-swap loop per channel) and the
// count with the native int32 add (exact; converted when flushed); int32
// (the quantized mode) three native adds.  When a block's chunks pass
// from segment 0 to segment 1 it flushes and clears; after its chunks it
// adds its non-zero cells to the output with global atomics, 16 bytes at
// a time for f32.
//
// f32 atomics make the order of the sums vary from run to run, so grad and
// hess agree with a serial sum to f32 summation-order tolerance; the
// count channel is exact (integers below 2^24), and int32 sums are
// order-free, so B4 and B5's int32 instance are bit-identical at any grid.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

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

// *cell += (g, h) with one 64-bit compare-and-swap loop
__device__ __forceinline__ void add_pair(float2* cell, float g, float h) {
  unsigned long long* p = reinterpret_cast<unsigned long long*>(cell);
  unsigned long long old = *p;
  unsigned long long assumed;
  do {
    assumed = old;
    float2 v;
    memcpy(&v, &assumed, sizeof(v));
    v.x += g;
    v.y += h;
    unsigned long long next;
    memcpy(&next, &v, sizeof(next));
    old = atomicCAS(p, assumed, next);
  } while (old != assumed);
}

// Shared memory of a block whose groups have at most cap features at B
// bins: (grad, hess) pairs and counts, 12 bytes a cell.
__host__ __device__ inline int hist_smem_bytes(int cap, int B) {
  return cap * (B + 1) * 12;
}

// The work split of two segments of count0 and count1 rows over `grid`
// blocks, F features in groups of at most cap (grid >= ceil(F / cap)).
struct HistSplit {
  int groups;      // feature groups
  int group_cols;  // features per group; the last may have fewer
  int chunks0;     // chunks of segment 0
  int chunks;      // chunks of both segments
};

__host__ __device__ inline HistSplit hist_split(int count0, int count1,
                                                int grid, int F, int cap) {
  HistSplit s;
  s.chunks0 = (count0 + kHistChunkRows - 1) / kHistChunkRows;
  s.chunks = s.chunks0 + (count1 + kHistChunkRows - 1) / kHistChunkRows;
  // as many groups as fill the grid, one feature each at most, and no
  // fewer than the shared memory allows
  int g = s.chunks > 0 ? grid / s.chunks : grid;
  if (g > F) g = F;
  const int least = (F + cap - 1) / cap;
  if (g < least) g = least;
  s.group_cols = (F + g - 1) / g;
  s.groups = (F + s.group_cols - 1) / s.group_cols;
  return s;
}

template <typename T>
struct HistCells;

template <>
struct HistCells<float> {
  float2* gh;
  int* cnt;
  __device__ HistCells(unsigned char* smem, int ncell)
      : gh(reinterpret_cast<float2*>(smem)),
        cnt(reinterpret_cast<int*>(gh + ncell)) {}
  __device__ void clear(int ncell) {
    for (int i = threadIdx.x; i < ncell; i += blockDim.x) {
      gh[i] = make_float2(0.f, 0.f);
      cnt[i] = 0;
    }
  }
  __device__ void add(int k, float g, float h, float c) {
    add_pair(gh + k, g, h);
    atomicAdd(cnt + k, __float2int_rn(c));
  }
  __device__ float get(int k, int ch) const {
    return ch == 0 ? gh[k].x
                   : (ch == 1 ? gh[k].y : static_cast<float>(cnt[k]));
  }
};

template <>
struct HistCells<int> {
  int2* gh;
  int* cnt;
  __device__ HistCells(unsigned char* smem, int ncell)
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
    atomicAdd(&gh[k].x, __float2int_rn(g));
    atomicAdd(&gh[k].y, __float2int_rn(h));
    atomicAdd(cnt + k, __float2int_rn(c));
  }
  __device__ int get(int k, int ch) const {
    return ch == 0 ? gh[k].x : (ch == 1 ? gh[k].y : cnt[k]);
  }
};

// Element k of a group's output span [fn, B, 3], from its cells.
template <typename T>
__device__ __forceinline__ T cell_value(const HistCells<T>& cells, int k,
                                        int B) {
  const int j = k / (3 * B);
  const int rem = k - j * 3 * B;
  const int b = rem / 3;
  return cells.get(j * (B + 1) + b, rem - 3 * b);
}

// Adds a group's non-zero cells into its output span dst[0, fn * B * 3).
__device__ __forceinline__ void flush_cells(const HistCells<float>& cells,
                                            float* dst, int fn, int B) {
  const int n = fn * B * 3;
  const int head = min(
      static_cast<int>((4 - reinterpret_cast<uintptr_t>(dst) / 4 % 4) & 3),
      n);
  const int nvec = (n - head) >> 2;
  for (int i = threadIdx.x; i < nvec; i += blockDim.x) {
    const int k = head + 4 * i;
    const float4 v = make_float4(
        cell_value(cells, k, B), cell_value(cells, k + 1, B),
        cell_value(cells, k + 2, B), cell_value(cells, k + 3, B));
    if (v.x != 0.f || v.y != 0.f || v.z != 0.f || v.w != 0.f) {
      atomicAdd(reinterpret_cast<float4*>(dst + k), v);
    }
  }
  // the at most three elements before the aligned middle and after it
  const int edge = threadIdx.x < 3 ? static_cast<int>(threadIdx.x)
                                   : head + 4 * nvec + threadIdx.x - 3;
  if ((threadIdx.x < 3 && edge < head) ||
      (threadIdx.x >= 3 && threadIdx.x < 6 && edge < n)) {
    const float v = cell_value(cells, edge, B);
    if (v != 0.f) atomicAdd(dst + edge, v);
  }
}

__device__ __forceinline__ void flush_cells(const HistCells<int>& cells,
                                            int* dst, int fn, int B) {
  const int n = fn * B * 3;
  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    const int v = cell_value(cells, k, B);
    if (v != 0) atomicAdd(dst + k, v);
  }
}

// Block `block` of `grid`: its share of the histograms of segment 0 (rows
// [start0, start0 + count0) of src0, into out0) and segment 1 (rows
// [start1, start1 + count1) of src1, into out1).  Every thread of the
// block calls it; smem holds hist_smem_bytes(cap, B).
template <typename T>
__device__ __forceinline__ void hist_block(
    const float* src0, const float* src1, int P, long long start0,
    int count0, long long start1, int count1, T* out0, T* out1, int F,
    int B, int cap, int grad_col, int hess_col, int cnt_col, int block,
    int grid, unsigned char* smem) {
  const HistSplit sp = hist_split(count0, count1, grid, F, cap);
  const int group = block % sp.groups;
  const int q = block / sp.groups;
  if (q >= sp.chunks) return;  // uniform per block
  const int nbg = (grid - group + sp.groups - 1) / sp.groups;
  const int f0 = group * sp.group_cols;
  const int fn = min(sp.group_cols, F - f0);
  const int stride = B + 1;
  HistCells<T> cells(smem, fn * stride);
  cells.clear(fn * stride);
  __syncthreads();

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

  // chunk j's rows, its first row in `first`
  auto chunk_rows = [&](int j, const float*& first) -> int {
    if (j < sp.chunks0) {
      const int r0 = j * kHistChunkRows;
      first = src0 + (start0 + r0) * P;
      return min(kHistChunkRows, count0 - r0);
    }
    const int r0 = (j - sp.chunks0) * kHistChunkRows;
    first = src1 + (start1 + r0) * P;
    return min(kHistChunkRows, count1 - r0);
  };
  auto load = [&](int j, float (&v)[kHistRowsPerWarp]) {
    const float* first;
    const int n = chunk_rows(j, first);
#pragma unroll
    for (int i = 0; i < kHistRowsPerWarp; ++i) {
      const int r = row0 + i * rpp;
      v[i] = (i < nload && live && r < n)
                 ? first[static_cast<long long>(r) * P + col]
                 : 0.f;
    }
  };

  float cur[kHistRowsPerWarp], nxt[kHistRowsPerWarp];
  int j = q;
  int side = j < sp.chunks0 ? 0 : 1;
  load(j, cur);
  for (;;) {
    const int jn = j + nbg;
    const bool more = jn < sp.chunks;  // uniform per block
    if (more) load(jn, nxt);
    const float* first;
    const int n = chunk_rows(j, first);
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
    const int next_side = jn < sp.chunks0 ? 0 : 1;
    if (next_side != side) {  // uniform per block
      __syncthreads();
      flush_cells(cells, (side ? out1 : out0) + static_cast<long long>(f0) *
                                                    B * 3,
                  fn, B);
      __syncthreads();
      cells.clear(fn * stride);
      __syncthreads();
      side = next_side;
    }
#pragma unroll
    for (int i = 0; i < kHistRowsPerWarp; ++i) cur[i] = nxt[i];
    j = jn;
  }
  __syncthreads();
  flush_cells(cells, (side ? out1 : out0) + static_cast<long long>(f0) * B * 3,
              fn, B);
}

}  // namespace
