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
// Kernels 1, 2 and 4 and the ranking of 3 live in segment_partition.cuh,
// which the merged partition + histogram (segment_partition_hist.cu)
// shares.  start, count and every predicate scalar are read from device
// memory, and num_left stays there, so the grower never syncs to launch
// this.  Grids
// are sized for the largest possible segment (the whole payload); tiles
// past the segment's end exit at once.  Rows move as raw 32-bit copies, so
// the result is byte-identical to the plain PyTorch version.
// None of the TPU kernel's machinery (8-row aligned windows, one-hot
// permutation matmuls, the accumulator rings) carries over.

#include "segment_partition.cuh"

namespace {

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
  const int d = tile_dest(payload, P, sc, bitset, B, blockIdx.x,
                          tile_off[blockIdx.x], *num_left, warp_left);
  if (static_cast<int>(threadIdx.x) < nrows) dest[threadIdx.x] = d;
  __syncthreads();

  // whole-row copy: consecutive threads read consecutive payload floats
  const float* src = payload + (static_cast<long long>(start) + row0) * P;
  const int total = nrows * P;
  for (int e = threadIdx.x; e < total; e += blockDim.x) {
    const int rr = e / P;
    aux[static_cast<long long>(dest[rr]) * P + (e - rr * P)] = src[e];
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
                                       tile_left, nullptr, 0);
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
