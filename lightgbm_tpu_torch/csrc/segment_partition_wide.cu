// Stable segment partition of wide payloads for Hopper (sm_90a).
//
// Replaces two TPU kernels of lightgbm_tpu/ops/pallas_segment.py, both
// with the contract of B2 (csrc/segment_partition.cu), byte for byte:
// stably partition payload rows [start, start + count) by the split
// predicate (left rows first), leave the partitioned rows in aux over the
// same range, copy them back into payload writing left_value / right_value
// into value_col, and report num_left.
//   - partition_segment -> _partition_kernel (B3, the "RMW" partition):
//     payloads past B2's plan, rows of 2-6.5 KB (513 <= P < 1665);
//   - partition_segment_acc_blocks -> _snap_window_kernel +
//     _acc_blocks_kernel (B8): the widest payloads (P >= 1665), over column
//     windows with the routing read once.
// The predicate follows _go_left_rows (pallas_segment.py:282-316) and
// ops/bundle.decode_bin exactly, as B2's does.
//
// What bounds it on this card: every row of the segment is read and
// written twice (payload -> aux, aux -> payload), 2 * count * P * 4 bytes
// each way, against HBM at 3.35 TB/s; there is no arithmetic to speak of.
// At these widths a row is 2-8 KB, so the routing column (one 32-byte
// sector per row) is a few percent of the traffic.
//
// Design: six launches, all sized for the largest segment (the whole
// payload), reading start, count and every predicate scalar from device
// memory, so the grower never syncs to launch them.
//   1. route_count: one block per 1024-row tile reads the routing column
//      once, keeps each row's side as a byte and counts the tile's lefts
//      (the TPU kernel's "snap" of the split column);
//   2. route_scan: one block turns the tile counts into exclusive offsets
//      and num_left;
//   3. route_rank: each tile ranks its rows from the stored bytes (warp
//      ballot + popc, a scan over the warps) and writes every row's
//      destination row;
//   4. the scatter, payload -> aux at the destinations:
//      B3 (rmw_scatter): one warp per row, with 16-byte moves over the
//      part of the row whose source and destination share their offset
//      within 16 bytes (8-byte moves where they share it within 8);
//      B8 (block_scatter): a 2-D grid of row tiles by column blocks of
//      kColBlock floats, so a segment of a few thousand rows still fills
//      the card and every block moves contiguous 2 KB row slices;
//   5. flat_copyback: the segment is one contiguous range of count * P
//      floats in aux and in payload, so the copy-back is a flat 16-byte
//      copy over the grid, whatever the width (B3 and B8 alike);
//   6. write_values: the leaf values into value_col, one thread per row.
// Count, scan and rank stay three launches rather than one with a
// decoupled look-back: they read one sector per row, which is a few
// percent of the row moves at these widths.  Rows move as raw 4-, 8- or
// 16-byte copies, so the result is byte-identical to the plain PyTorch
// version.  None of the TPU kernels' machinery (8-row aligned RMW windows,
// permutation matmuls, the 128-lane split-column snapshot) carries over.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 1024;       // rows per routing tile, one per thread
constexpr int kCopyThreads = 256;
constexpr int kRowTile = 32;      // rows per tile of B8's 2-D grid
constexpr int kColBlock = 2 * kCopyThreads;  // floats per column block

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

__global__ void __launch_bounds__(kTile)
route_count(const float* __restrict__ payload, int P,
            const int* __restrict__ sc,
            const unsigned char* __restrict__ bitset, int B,
            unsigned char* __restrict__ side, int* __restrict__ tile_left) {
  const int count = sc[kCount];
  const int row0 = blockIdx.x * kTile;
  if (row0 >= count) return;  // uniform per block
  const int r = row0 + threadIdx.x;
  int gl = 0;
  if (r < count) {
    gl = go_left(
        payload[(static_cast<long long>(sc[kStart]) + r) * P + sc[kCol]], sc,
        bitset, B);
    side[r] = static_cast<unsigned char>(gl);
  }
  const int n = __syncthreads_count(gl);
  if (threadIdx.x == 0) tile_left[blockIdx.x] = n;
}

__global__ void __launch_bounds__(kTile)
route_scan(const int* __restrict__ sc, const int* __restrict__ tile_left,
           int* __restrict__ tile_off, int* __restrict__ num_left) {
  __shared__ int warp_tot[32];
  __shared__ int carry;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int ntiles = (sc[kCount] + kTile - 1) / kTile;
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  for (int base = 0; base < ntiles; base += kTile) {
    const int i = base + threadIdx.x;
    const int v = i < ntiles ? tile_left[i] : 0;
    const int incl = warp_inclusive_scan(v);
    if (lane == 31) warp_tot[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      const int t = warp_tot[lane];
      warp_tot[lane] = warp_inclusive_scan(t) - t;  // exclusive
    }
    __syncthreads();
    const int c = carry;
    const int block_incl = incl + warp_tot[warp];
    if (i < ntiles) tile_off[i] = c + block_incl - v;
    __syncthreads();
    if (threadIdx.x == kTile - 1) carry = c + block_incl;
    __syncthreads();
  }
  if (threadIdx.x == 0) *num_left = carry;
}

__global__ void __launch_bounds__(kTile)
route_rank(const int* __restrict__ sc, const unsigned char* __restrict__ side,
           const int* __restrict__ tile_off, const int* __restrict__ num_left,
           int* __restrict__ dest) {
  __shared__ int warp_left[32];
  const int start = sc[kStart];
  const int count = sc[kCount];
  const int row0 = blockIdx.x * kTile;
  if (row0 >= count) return;  // uniform per block
  const int r = row0 + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int gl = r < count ? side[r] : 0;
  // stable rank of this row among the tile's left rows
  const unsigned ballot = __ballot_sync(0xffffffffu, gl);
  if (lane == 0) warp_left[warp] = __popc(ballot);
  __syncthreads();
  if (warp == 0) {
    const int t = warp_left[lane];
    warp_left[lane] = warp_inclusive_scan(t) - t;
  }
  __syncthreads();
  if (r < count) {
    const int left_before =
        warp_left[warp] + __popc(ballot & ((1u << lane) - 1u));
    const int off = tile_off[blockIdx.x];  // left rows of earlier tiles
    dest[r] = gl ? start + off + left_before
                 : start + *num_left + (row0 - off) +
                       (static_cast<int>(threadIdx.x) - left_before);
  }
}

// Moves of n floats, src -> dst, by the threads t = t0, t0 + step, ...:
// 16-byte moves where src and dst share their offset within 16 bytes,
// 8-byte moves where they share it within 8 (every row of an even-width
// payload), else 4-byte moves.  The loops are unrolled so that several
// loads of a thread are in flight at once.
__device__ __forceinline__ void copy_span(const float* __restrict__ src,
                                          float* __restrict__ dst,
                                          long long n, long long t0,
                                          long long step) {
  // offsets in floats within 16 bytes
  const int mis_s = static_cast<int>(reinterpret_cast<uintptr_t>(src) / 4 % 4);
  const int mis_d = static_cast<int>(reinterpret_cast<uintptr_t>(dst) / 4 % 4);
  if (mis_s == mis_d) {
    const long long head = min(static_cast<long long>((4 - mis_s) & 3), n);
    if (t0 < head) dst[t0] = src[t0];
    const long long nvec = (n - head) >> 2;
    const float4* s4 = reinterpret_cast<const float4*>(src + head);
    float4* d4 = reinterpret_cast<float4*>(dst + head);
#pragma unroll 4
    for (long long i = t0; i < nvec; i += step) d4[i] = s4[i];
    for (long long c = head + 4 * nvec + t0; c < n; c += step) dst[c] = src[c];
  } else if (((mis_s ^ mis_d) & 1) == 0) {
    const long long head = min(static_cast<long long>(mis_s & 1), n);
    if (t0 < head) dst[t0] = src[t0];
    const long long nvec = (n - head) >> 1;
    const float2* s2 = reinterpret_cast<const float2*>(src + head);
    float2* d2 = reinterpret_cast<float2*>(dst + head);
#pragma unroll 4
    for (long long i = t0; i < nvec; i += step) d2[i] = s2[i];
    for (long long c = head + 2 * nvec + t0; c < n; c += step) dst[c] = src[c];
  } else {
#pragma unroll 4
    for (long long c = t0; c < n; c += step) dst[c] = src[c];
  }
}

__global__ void __launch_bounds__(kCopyThreads)
rmw_scatter(const float* __restrict__ payload, float* __restrict__ aux, int P,
            const int* __restrict__ sc, const int* __restrict__ dest) {
  const int start = sc[kStart];
  const int count = sc[kCount];
  const int warps = kCopyThreads / 32;
  const int lane = threadIdx.x & 31;
  for (int r = blockIdx.x * warps + (threadIdx.x >> 5); r < count;
       r += gridDim.x * warps) {
    copy_span(payload + (static_cast<long long>(start) + r) * P,
              aux + static_cast<long long>(dest[r]) * P, P, lane, 32);
  }
}

__global__ void __launch_bounds__(kCopyThreads)
block_scatter(const float* __restrict__ payload, float* __restrict__ aux,
              int P, const int* __restrict__ sc,
              const int* __restrict__ dest) {
  const long long start = sc[kStart];
  const int count = sc[kCount];
  const int ntiles = (count + kRowTile - 1) / kRowTile;
  const int c0 = blockIdx.y * kColBlock;
  const int cw = min(kColBlock, P - c0);
  // an even width starts every row slice 8-byte aligned: one 8-byte move
  // per thread and row, else two 4-byte moves; the rows are unrolled so
  // that their loads are in flight together
  const bool even = (P & 1) == 0;
  const int ca = even ? 2 * threadIdx.x : threadIdx.x;
  const int cb = threadIdx.x + kCopyThreads;
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const int r0 = t * kRowTile;
    const int nr = min(kRowTile, count - r0);
#pragma unroll 8
    for (int rr = 0; rr < kRowTile; ++rr) {
      if (rr >= nr) continue;
      const float* src = payload + (start + r0 + rr) * P + c0;
      float* dst = aux + static_cast<long long>(dest[r0 + rr]) * P + c0;
      if (even) {
        if (ca < cw) {
          *reinterpret_cast<float2*>(dst + ca) =
              *reinterpret_cast<const float2*>(src + ca);
        }
      } else {
        if (ca < cw) dst[ca] = src[ca];
        if (cb < cw) dst[cb] = src[cb];
      }
    }
  }
}

// The segment's rows are one contiguous range in aux and in payload, so
// the copy-back is a flat copy of count * P floats over the grid ...
__global__ void __launch_bounds__(kCopyThreads)
flat_copyback(float* __restrict__ payload, const float* __restrict__ aux,
              int P, const int* __restrict__ sc) {
  const long long base = static_cast<long long>(sc[kStart]) * P;
  copy_span(aux + base, payload + base, static_cast<long long>(sc[kCount]) * P,
            static_cast<long long>(blockIdx.x) * kCopyThreads + threadIdx.x,
            static_cast<long long>(gridDim.x) * kCopyThreads);
}

// ... and then the leaf values go into value_col, one thread per row
__global__ void __launch_bounds__(kCopyThreads)
write_values(float* __restrict__ payload, int P, const int* __restrict__ sc,
             const int* __restrict__ num_left,
             const float* __restrict__ fvals, int value_col) {
  const long long start = sc[kStart];
  const int count = sc[kCount];
  const int nl = *num_left;
  for (int r = blockIdx.x * kCopyThreads + threadIdx.x; r < count;
       r += gridDim.x * kCopyThreads) {
    payload[(start + r) * P + value_col] = r < nl ? fvals[0] : fvals[1];
  }
}

}  // namespace

extern "C" {

int segment_partition_wide_tile_rows() { return kTile; }

// The whole partition (kernels 1-6).  scalars: int32[11] on the device
// (start, count, col, threshold, default_left, is_cat, missing_type,
// num_bin, default_bin, offset, identity); bitset: uint8[B], the bytes of a
// bool tensor; fvals: f32[2] (left, right value) on the device.  Scratch,
// sized for the largest count (n_rows rows): side uint8[n_rows], dest
// int32[n_rows], tile_left / tile_off int32[n_tiles] with n_tiles * 1024 >=
// n_rows.  num_left: one int32 on the device.  blocks = 0 scatters one warp
// per row (B3), else over the 2-D grid (B8); grid_x bounds the grid-stride
// launches (blocks of the warp scatter and of the copy-back, row-tile
// blocks of the 2-D grid).
// Returns cudaGetLastError().
int segment_partition_wide_launch(float* payload, float* aux, int P,
                                  const int* scalars,
                                  const unsigned char* bitset, int B,
                                  const float* fvals, int value_col,
                                  int n_tiles, unsigned char* side,
                                  int* dest, int* tile_left, int* tile_off,
                                  int* num_left, int blocks, int grid_x,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  route_count<<<n_tiles, kTile, 0, s>>>(payload, P, scalars, bitset, B, side,
                                        tile_left);
  route_scan<<<1, kTile, 0, s>>>(scalars, tile_left, tile_off, num_left);
  route_rank<<<n_tiles, kTile, 0, s>>>(scalars, side, tile_off, num_left,
                                       dest);
  if (blocks) {
    const dim3 grid2(grid_x, (P + kColBlock - 1) / kColBlock);
    block_scatter<<<grid2, kCopyThreads, 0, s>>>(payload, aux, P, scalars,
                                                 dest);
  } else {
    rmw_scatter<<<grid_x, kCopyThreads, 0, s>>>(payload, aux, P, scalars,
                                                dest);
  }
  flat_copyback<<<grid_x, kCopyThreads, 0, s>>>(payload, aux, P, scalars);
  write_values<<<grid_x, kCopyThreads, 0, s>>>(payload, P, scalars, num_left,
                                               fvals, value_col);
  return static_cast<int>(cudaGetLastError());
}

const char* segment_partition_wide_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
