// The pieces of the stable segment partition that B2
// (segment_partition.cu) and the merged partition + histogram B6
// (segment_partition_hist.cu) share: the predicate, the per-tile left
// counts, their scan, each row's stable destination, and the copy-back.
// The predicate follows _go_left_rows (lightgbm_tpu/ops/pallas_segment.py
// :282-316) and ops/bundle.decode_bin exactly: numerical threshold, NaN-
// and zero-missing with default_left, categorical bitset, EFB offset /
// identity decode.  start, count and every predicate scalar are read from
// device memory, and num_left stays there, so the grower never syncs to
// launch these.
#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 1024;  // rows per tile, one per thread
constexpr int kCopyThreads = 256;

// predicate scalars, in the order of pallas_segment._partition_segment_acc
enum {
  kStart = 0, kCount, kCol, kThreshold, kDefaultLeft, kIsCat, kMissingType,
  kNumBin, kDefaultBin, kOffset, kIdentity, kNumScalars
};
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

// One block per kTile-row tile counts the tile's left rows.  Before that,
// the blocks together zero `zero[0, n_zero)` (B6's two histograms; B2
// passes none), so no separate launch clears them.
__global__ void __launch_bounds__(kTile)
part_count(const float* __restrict__ payload, int P,
           const int* __restrict__ sc,
           const unsigned char* __restrict__ bitset, int B,
           int* __restrict__ tile_left, float* __restrict__ zero,
           int n_zero) {
  for (int i = blockIdx.x * kTile + threadIdx.x; i < n_zero;
       i += gridDim.x * kTile) {
    zero[i] = 0.f;
  }
  const int count = sc[kCount];
  const int row0 = blockIdx.x * kTile;
  if (row0 >= count) return;  // uniform per block
  const int r = row0 + threadIdx.x;
  int gl = 0;
  if (r < count) {
    gl = go_left(
        payload[(static_cast<long long>(sc[kStart]) + r) * P + sc[kCol]], sc,
        bitset, B);
  }
  const int n = __syncthreads_count(gl);
  if (threadIdx.x == 0) tile_left[blockIdx.x] = n;
}

// One block turns the counts of ntiles tiles into exclusive offsets and
// num_left.
__device__ void scan_tile_counts(int ntiles, const int* __restrict__ tile_left,
                                 int* __restrict__ tile_off,
                                 int* __restrict__ num_left) {
  __shared__ int warp_tot[32];
  __shared__ int carry;
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  for (int base = 0; base < ntiles; base += blockDim.x) {
    const int i = base + threadIdx.x;
    const int v = i < ntiles ? tile_left[i] : 0;
    const int incl = block_inclusive_scan(v, warp_tot);
    const int c = carry;
    if (i < ntiles) tile_off[i] = c + incl - v;
    __syncthreads();
    if (threadIdx.x == blockDim.x - 1) carry = c + incl;
    __syncthreads();
  }
  if (threadIdx.x == 0) *num_left = carry;
}

// One block scans the counts of the segment's kTile-row tiles.
__global__ void __launch_bounds__(kTile)
part_scan(const int* __restrict__ sc, const int* __restrict__ tile_left,
          int* __restrict__ tile_off, int* __restrict__ num_left) {
  scan_tile_counts((sc[kCount] + kTile - 1) / kTile, tile_left, tile_off,
                   num_left);
}

// The destination row of row `tile * kTile + threadIdx.x` of the segment
// (blockDim.x == kTile), or -1 past the segment's end: left rows go to
// start + (left rows before it), right rows to start + num_left + (right
// rows before it), which keeps both sides in row order.  Each warp ranks
// its rows with a ballot + popc, the warps' counts are scanned in
// warp_left[32].  Every thread of the block must call it.
__device__ int tile_dest(const float* __restrict__ payload, int P,
                         const int* __restrict__ sc,
                         const unsigned char* __restrict__ bitset, int B,
                         int tile, int tile_off, int num_left,
                         int* warp_left) {
  const int start = sc[kStart];
  const int row0 = tile * kTile;
  const int nrows = min(kTile, sc[kCount] - row0);
  const int r = threadIdx.x;
  const int lane = r & 31;
  const int warp = r >> 5;
  int gl = 0;
  if (r < nrows) {
    gl = go_left(
        payload[(static_cast<long long>(start) + row0 + r) * P + sc[kCol]],
        sc, bitset, B);
  }
  const unsigned ballot = __ballot_sync(0xffffffffu, gl);
  if (lane == 0) warp_left[warp] = __popc(ballot);
  __syncthreads();
  if (warp == 0) {
    const int t = warp_left[lane];
    warp_left[lane] = warp_inclusive_scan(t) - t;
  }
  __syncthreads();
  const int left_before =
      warp_left[warp] + __popc(ballot & ((1u << lane) - 1u));
  __syncthreads();  // warp_left is free for the next call
  if (r >= nrows) return -1;
  return gl ? start + tile_off + left_before
            : start + num_left + (row0 - tile_off) + (r - left_before);
}

// aux -> payload over the segment, with the leaf value written into
// value_col: fvals[0] for the first num_left rows, fvals[1] after them.
__global__ void __launch_bounds__(kCopyThreads)
part_copyback(float* __restrict__ payload, const float* __restrict__ aux,
              int P, const int* __restrict__ sc,
              const int* __restrict__ num_left,
              const float* __restrict__ fvals, int value_col) {
  const long long total = static_cast<long long>(sc[kCount]) * P;
  const long long per_block = static_cast<long long>(kCopyThreads) * 8;
  const long long want = (total + per_block - 1) / per_block;
  if (static_cast<long long>(blockIdx.x) >= want) return;
  const long long nblk = want < gridDim.x ? want : gridDim.x;
  const long long base = static_cast<long long>(sc[kStart]) * P;
  const int nl = *num_left;
  const float lv = fvals[0];
  const float rv = fvals[1];
  for (long long e = static_cast<long long>(blockIdx.x) * kCopyThreads +
                     threadIdx.x;
       e < total; e += nblk * kCopyThreads) {
    const long long rr = e / P;
    float v = aux[base + e];
    if (e - rr * P == value_col) v = rr < nl ? lv : rv;
    payload[base + e] = v;
  }
}

}  // namespace
