// Stable segment partition for Hopper (sm_90a).
//
// Replaces the TPU kernel lightgbm_tpu/ops/pallas_segment.py
// partition_segment_acc -> _acc_kernel, with the same contract: stably
// partition payload rows [start, start + count) by the split predicate
// (left rows first), leave the partitioned rows in aux over the same
// range, copy them back into payload writing left_value / right_value
// into value_col, and report num_left.  The predicate follows
// _go_left_rows (pallas_segment.py:282-316) and ops/bundle.decode_bin
// exactly: numerical threshold, NaN- and zero-missing with default_left,
// categorical bitset, EFB offset / identity decode.
//
// What bounds it on this card: every row of the segment is read and
// written twice (payload -> aux, aux -> payload), 2 * count * P * 4 bytes
// each way, against HBM at 3.35 TB/s.  There is no arithmetic to speak of.
//
// Design: a stable partition on a parallel machine needs a scan, so this
// is four launches of simple code rather than one clever kernel, exported
// as two entry points: the stage (1-3), which only reads the payload, and
// the commit (4).  The frontier-batched grower stages several candidate
// splits and commits only those its replay accepts; partition_segment is
// the stage and the commit, one after the other (the JAX package's
// ops/segment.py partition_segment_stage / _commit, which are plain JAX
// there, are these two here):
//   1. part_count: one block per 1024-row tile counts its left rows;
//   2. part_scan: one block turns those counts into exclusive offsets and
//      num_left;
//   3. part_scatter: each tile ranks its rows with a warp ballot + popc and
//      a scan over the warps, then copies whole rows into aux: lefts to
//      start + offset, rights to start + num_left + offset, the copy done
//      cooperatively so reads are coalesced;
//   4. part_copyback: aux -> payload over the segment, with the leaf value
//      written into value_col.
// start, count and every predicate scalar are read from device memory, and
// num_left stays there, so the grower never syncs to launch this.  Grids
// are sized for the largest possible segment (the whole payload); tiles
// past the segment's end exit at once.  Rows move as raw 32-bit copies, so
// the result is byte-identical to the plain PyTorch version.
// None of the TPU kernel's machinery (8-row aligned windows, one-hot
// permutation matmuls, the accumulator rings) carries over.

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

__global__ void __launch_bounds__(kTile)
part_count(const float* __restrict__ payload, int P,
           const int* __restrict__ sc,
           const unsigned char* __restrict__ bitset, int B,
           int* __restrict__ tile_left) {
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

__global__ void __launch_bounds__(kTile)
part_scan(const int* __restrict__ sc, const int* __restrict__ tile_left,
          int* __restrict__ tile_off, int* __restrict__ num_left) {
  __shared__ int warp_tot[32];
  __shared__ int carry;
  const int ntiles = (sc[kCount] + kTile - 1) / kTile;
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

__global__ void __launch_bounds__(kTile)
part_scatter(const float* __restrict__ payload, float* __restrict__ aux,
             int P, const int* __restrict__ sc,
             const unsigned char* __restrict__ bitset, int B,
             const int* __restrict__ tile_off,
             const int* __restrict__ num_left) {
  __shared__ int warp_left[32];
  __shared__ int dest[kTile];
  const int start = sc[kStart];
  const int count = sc[kCount];
  const int row0 = blockIdx.x * kTile;
  if (row0 >= count) return;  // uniform per block
  const int nrows = min(kTile, count - row0);
  const int r = threadIdx.x;
  const int lane = r & 31;
  const int warp = r >> 5;

  int gl = 0;
  if (r < nrows) {
    gl = go_left(
        payload[(static_cast<long long>(start) + row0 + r) * P + sc[kCol]],
        sc, bitset, B);
  }
  // stable rank of this row among the tile's left rows
  const unsigned ballot = __ballot_sync(0xffffffffu, gl);
  if (lane == 0) warp_left[warp] = __popc(ballot);
  __syncthreads();
  if (warp == 0) {
    const int t = warp_left[lane];
    warp_left[lane] = warp_inclusive_scan(t) - t;
  }
  __syncthreads();
  const int left_before = warp_left[warp] + __popc(ballot & ((1u << lane) - 1u));
  if (r < nrows) {
    const int off = tile_off[blockIdx.x];  // left rows of earlier tiles
    dest[r] = gl ? start + off + left_before
                 : start + *num_left + (row0 - off) + (r - left_before);
  }
  __syncthreads();

  // whole-row copy: consecutive threads read consecutive payload floats
  const float* src = payload + (static_cast<long long>(start) + row0) * P;
  const int total = nrows * P;
  for (int e = threadIdx.x; e < total; e += blockDim.x) {
    const int rr = e / P;
    aux[static_cast<long long>(dest[rr]) * P + (e - rr * P)] = src[e];
  }
}

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

extern "C" {

int segment_partition_tile_rows() { return kTile; }

// The stage (kernels 1-3): the rows of [start, start + count), left rows
// first, into aux over the same range; payload is only read.  scalars:
// int32[11] on the device (start, count, col, threshold, default_left,
// is_cat, missing_type, num_bin, default_bin, offset, identity); bitset:
// uint8[B], the bytes of a bool tensor.  tile_left / tile_off: int32
// [n_tiles] scratch with n_tiles * 1024 >= the largest count; num_left: one
// int32 on the device (any slot of a caller's vector) that receives the
// left count.  Returns cudaGetLastError().
int segment_partition_stage_launch(const float* payload, float* aux, int P,
                                   const int* scalars,
                                   const unsigned char* bitset, int B,
                                   int n_tiles, int* tile_left,
                                   int* tile_off, int* num_left,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  part_count<<<n_tiles, kTile, 0, s>>>(payload, P, scalars, bitset, B,
                                       tile_left);
  part_scan<<<1, kTile, 0, s>>>(scalars, tile_left, tile_off, num_left);
  part_scatter<<<n_tiles, kTile, 0, s>>>(payload, aux, P, scalars, bitset, B,
                                         tile_off, num_left);
  return static_cast<int>(cudaGetLastError());
}

// The commit (kernel 4): aux -> payload over [start, start + count) with
// fvals[0] (left) / fvals[1] (right) written into value_col.  seg: int32[2]
// (start, count) on the device, or the stage's int32[11] scalars; num_left:
// one int32 on the device.  count 0 is a no-op.  Returns
// cudaGetLastError().
int segment_partition_commit_launch(float* payload, const float* aux, int P,
                                    const int* seg, const int* num_left,
                                    const float* fvals, int value_col,
                                    int copy_blocks, void* stream) {
  part_copyback<<<copy_blocks, kCopyThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      payload, aux, P, seg, num_left, fvals, value_col);
  return static_cast<int>(cudaGetLastError());
}

const char* segment_partition_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
