// The pieces of the stable segment partition that every partition kernel
// shares (segment_partition_inplace.cuh: B2 whole and as its stage and
// commit, B3, B6, B8): the predicate, the block scan and the scan of the
// tiles' left counts.
// The predicate follows _go_left_rows (lightgbm_tpu/ops/pallas_segment.py
// :282-316) and ops/bundle.decode_bin exactly: numerical threshold, NaN-
// and zero-missing with default_left, categorical bitset, EFB offset /
// identity decode.  start, count and every predicate scalar are read from
// device memory, and num_left stays there, so the grower never syncs to
// launch these; every kernel checks the segment against the payload's rows
// (the last scalar) on the device first (segment_check.cuh).
#pragma once

#include <cuda_runtime.h>

#include "segment_check.cuh"

namespace {

constexpr int kTile = 1024;  // rows per tile, one per thread
constexpr int kCopyThreads = 256;

// predicate scalars, in the order of pallas_segment._partition_segment_acc,
// then the payload's rows (the segment's bound)
enum {
  kStart = 0, kCount, kCol, kThreshold, kDefaultLeft, kIsCat, kMissingType,
  kNumBin, kDefaultBin, kOffset, kIdentity, kRows, kNumScalars
};
// Returns from the kernel when the scalars' segment is outside the payload.
#define CHECK_SCALARS(entry, sc) \
  CHECK_SEGMENT(entry, (sc)[kStart], (sc)[kCount], (sc)[kRows])

constexpr int kMissingZero = 1;
constexpr int kMissingNan = 2;

__device__ __forceinline__ int go_left(float stored, const int* sc,
                                       const unsigned char* bitset, int B) {
  const int raw = static_cast<int>(stored);  // f32 -> i32, like astype
  int fbin = raw;
  if (!sc[kIdentity]) {
    const int e = raw - sc[kOffset];
    const bool in_range = e >= 0 && e < sc[kNumBin] - 1;
    fbin = in_range ? e + (e >= sc[kDefaultBin] ? 1 : 0) : sc[kDefaultBin];
  }
  if (sc[kIsCat]) return (fbin >= 0 && fbin < B) ? (bitset[fbin] != 0) : 0;
  const bool miss =
      (sc[kMissingType] == kMissingNan && fbin == sc[kNumBin] - 1) ||
      (sc[kMissingType] == kMissingZero && fbin == sc[kDefaultBin]);
  return miss ? (sc[kDefaultLeft] != 0) : (fbin <= sc[kThreshold]);
}

__device__ __forceinline__ int warp_inclusive_scan(int v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, v, d);
    if (lane >= d) v += u;
  }
  return v;
}

// inclusive scan over the block (blockDim.x a multiple of 32, <= 1024);
// every thread of the block must call it
__device__ int block_inclusive_scan(int v, int* warp_tot) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarp = blockDim.x >> 5;
  v = warp_inclusive_scan(v);
  if (lane == 31) warp_tot[warp] = v;
  __syncthreads();
  if (warp == 0) {
    const int t = lane < nwarp ? warp_tot[lane] : 0;
    warp_tot[lane] = warp_inclusive_scan(t) - t;  // exclusive
  }
  __syncthreads();
  const int out = v + warp_tot[warp];
  __syncthreads();
  return out;
}

// Exclusive offsets of ntiles tile counts, and num_left, over a grid of
// scan_blocks(ntiles) blocks of kTile threads.  Up to kTile counts, block 0
// scans one count per thread (a small segment's scan, most calls).  Past
// that, block c takes the kScanChunk counts of chunk c, sums every earlier
// count itself (so no block waits on another), and scans its chunk, each
// thread kScanItems consecutive counts; the block holding the last tile
// writes num_left.
constexpr int kScanItems = 8;
constexpr int kScanChunk = kTile * kScanItems;

inline int scan_blocks(int ntiles) {
  return ntiles > kScanChunk ? (ntiles + kScanChunk - 1) / kScanChunk : 1;
}

__device__ void scan_tile_counts(int ntiles, const int* __restrict__ tile_left,
                                 int* __restrict__ tile_off,
                                 int* __restrict__ num_left) {
  __shared__ int warp_tot[32];
  __shared__ int s_pre;
  const int base = blockIdx.x * kScanChunk;
  if (base >= max(ntiles, 1)) return;  // uniform per block
  if (ntiles <= static_cast<int>(blockDim.x)) {  // one count per thread
    const int i = threadIdx.x;
    const int v = i < ntiles ? tile_left[i] : 0;
    const int incl = block_inclusive_scan(v, warp_tot);
    if (i < ntiles) tile_off[i] = incl - v;
    if (i == blockDim.x - 1) *num_left = incl;
    return;
  }
  int pre = 0;
  for (int i = threadIdx.x; i < base; i += blockDim.x) pre += tile_left[i];
  pre = block_inclusive_scan(pre, warp_tot);
  if (threadIdx.x == blockDim.x - 1) s_pre = pre;
  // this thread's kScanItems consecutive counts (a warp's are contiguous)
  const int i0 = base + threadIdx.x * kScanItems;
  int v[kScanItems];
  int sum = 0;
#pragma unroll
  for (int k = 0; k < kScanItems; ++k) {
    v[k] = i0 + k < ntiles ? tile_left[i0 + k] : 0;
    sum += v[k];
  }
  const int incl = block_inclusive_scan(sum, warp_tot);
  int off = s_pre + incl - sum;
#pragma unroll
  for (int k = 0; k < kScanItems; ++k) {
    if (i0 + k < ntiles) tile_off[i0 + k] = off;
    off += v[k];
  }
  if (threadIdx.x == blockDim.x - 1 && base + kScanChunk >= ntiles) {
    *num_left = s_pre + incl;
  }
}

}  // namespace
