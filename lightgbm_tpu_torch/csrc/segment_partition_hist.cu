// Merged segment partition + both children's histograms for Hopper
// (sm_90a).
//
// Replaces the TPU kernel lightgbm_tpu/ops/pallas_segment.py
// partition_segment_hist -> _acc_kernel(hist_cfg=...) (B6), with its
// contract: B2's stable partition of payload rows [start, start + count)
// by the split predicate (left rows first, left_value / right_value
// written into value_col, num_left reported on the device; aux over the
// segment is scratch and nothing outside the segment is written), plus the
// two children's [F, B, 3] f32 histograms of (grad, hess, count mask),
// the mask holding small integers (0 or 1 in the grower), summed exactly,
// grad and hess as B1's fixed-point sums (segment_hist.cuh), so each
// histogram is ops/segment.segment_histogram_fixed's bit for bit.
// The grower's merged mode calls it once per split in place of B2 + B1 on
// the smaller child + the subtraction, so no parent histogram or pool is
// kept.
//
// What bounds it on this card: every row of the segment is read once and
// written once (2 * count * P * 4 bytes) and the two histograms are
// written once (2 * F * B * 12 bytes), against HBM at 3.35 TB/s.  The F
// shared-memory updates per row come next (five native 32-bit adds a
// cell at most).
//
// Design: B2's in-place partition (segment_partition_inplace.cuh), then
// both histograms, in four launches:
//   1. phist_count: the left rows of each T-row tile (T as B2's, 192 rows
//      at P = 38); it also clears the move's ticket and flags;
//   2. phist_scan: the tile offsets and num_left;
//   3. phist_move: B2's move: the larger side compacted in place, the
//      smaller side into aux at the rows it will hold, leaf values
//      written on the way;
//   4. phist_side_hist: the first blocks copy the smaller side's one
//      contiguous range aux -> payload; the others build both children's
//      histograms with B1's body (segment_hist.cuh) over two segments, the
//      left child's rows then the right's, each read where the move left
//      it (the larger side in the payload, the smaller side in aux, which
//      the copy only reads); a block holds one child's cells at a time and
//      flushes where its run of chunks passes to the right child, and the
//      last block of each feature group writes both children's f32 cells.
// Why the histograms are not taken from the move's staged tiles: both
// children's fixed-point histograms at the main path's shape take 2 * 28
// * 257 * 20 B = 288 KB of shared memory, more than a block has, let
// alone beside the move's two staging buffers; splitting features across blocks, as B8 splits columns, makes
// every group rank its tiles and move its columns in strided spans under
// its own flags (B8 reads 1.9x its bound that way).  Reading the
// histograms' F + 3 columns once more after the move costs count * (F + 3)
// * 4 bytes, and in exchange the histogram spreads a small split over the
// whole card as B1 does.
// Rows move as raw 32-bit copies, so payload and num_left are
// byte-identical to the plain version, and the histograms are order-free.
// None of the TPU kernel's machinery (one-hot matmuls, the bf16 part
// split, the VMEM accumulator rings) carries over.

#include "segment_hist.cuh"
#include "segment_partition_inplace.cuh"

namespace {

constexpr int kCountThreads = 256;
constexpr int kMoveThreads = 512;
constexpr int kStageBytes = 32 * 1024;  // B2's: one tile, one of two buffers

int tile_rows(int P) { return move_tile_rows(P, kStageBytes); }

// B2's count
__global__ void __launch_bounds__(kCountThreads)
phist_count(const float* __restrict__ payload, int P,
            const int* __restrict__ sc,
            const unsigned char* __restrict__ bitset, int B, int T,
            int* __restrict__ tile_left, int* __restrict__ sync) {
  CHECK_SCALARS("partition_segment_hist count", sc);
  count_tiles(payload, P, sc, bitset, B, T, tile_left, sync);
}

__global__ void __launch_bounds__(kTile)
phist_scan(const int* __restrict__ sc, int T,
           const int* __restrict__ tile_left, int* __restrict__ tile_off,
           int* __restrict__ num_left) {
  CHECK_SCALARS("partition_segment_hist scan", sc);
  scan_tile_counts((sc[kCount] + T - 1) / T, tile_left, tile_off, num_left);
}

__global__ void __launch_bounds__(kMoveThreads)
phist_move(float* payload, float* aux, int P, const int* __restrict__ sc,
           const unsigned char* __restrict__ bitset, int B, int T,
           const int* __restrict__ tile_left,
           const int* __restrict__ tile_off,
           const int* __restrict__ num_left, const float* __restrict__ fvals,
           int value_col, int* sync) {
  CHECK_SCALARS("partition_segment_hist move", sc);
  move_tiles(payload, aux, P, sc, bitset, B, T, tile_left, tile_off,
             num_left, fvals, value_col, sync);
}

// Blocks [0, copy_blocks) copy the smaller side aux -> payload; the rest
// build the histograms into fo (fo.out = [2, F, Bh, 3]: left, then
// right).  The payload is written here (the smaller side's rows) while the
// larger side's rows are read, so neither pointer is restricted.
__global__ void __launch_bounds__(kHistThreads, 2)
phist_side_hist(float* payload, const float* aux, int P,
                const int* __restrict__ sc, const int* __restrict__ num_left,
                FixedOut fo, int F, int Bh, int cap, int grad_col,
                int hess_col, int cnt_col, int copy_blocks) {
  extern __shared__ __align__(16) unsigned char smem[];
  CHECK_SCALARS("partition_segment_hist histograms", sc);
  const int count = sc[kCount];
  const int nl = *num_left;
  const bool fwd = left_in_place(nl, count);
  const long long start = sc[kStart];
  if (static_cast<int>(blockIdx.x) < copy_blocks) {  // uniform per block
    const long long base = (start + (fwd ? nl : 0)) * P;
    const long long rows = fwd ? count - nl : nl;
    copy_span(aux + base, payload + base, rows * P,
              static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x,
              static_cast<long long>(copy_blocks) * blockDim.x);
    return;
  }
  const SegPair kids{(fwd ? payload : aux) + start * P, nl,
                     (fwd ? aux : payload) + (start + nl) * P, count - nl};
  hist_block<true>(kids, 2, P, nullptr, fo, F, Bh, cap, grad_col, hess_col,
                   cnt_col, blockIdx.x - copy_blocks, gridDim.x - copy_blocks,
                   smem);
}

}  // namespace

extern "C" {

// Rows per tile of the partition at width P (B2's); 0 when the kernel
// cannot take the width.
int segment_partition_hist_tile_rows(int P) {
  return P > 0 ? tile_rows(P) : 0;
}

// The merged partition (kernels 1-4).  scalars: int32[12] on the device
// (start, count, col, threshold, default_left, is_cat, missing_type,
// num_bin, default_bin, offset, identity, and the payload's rows, the
// segment's bound); bitset: uint8[B], the bytes of a
// bool tensor; fvals: f32[2] (left, right value) on the device.  Scratch,
// for n_tiles tiles of segment_partition_hist_tile_rows(P) rows covering
// the largest count: tile_left / tile_off int32[n_tiles], sync
// int32[1 + n_tiles] (cleared by the count kernel).  num_left: one int32
// on the device.  hist: f32 [2, F, Bh, 3] (left, then right), every cell
// written here; scale, scratch_gh ([2, F, Bh, 2]), scratch_cnt ([2, F,
// Bh]) and tickets ([F]): as for segment_hist_launch's f32 instance.
// cap: features per histogram group at most (<= kHistGroupCols of
// segment_hist.cuh, hist_smem_bytes(cap, Bh, true) of shared memory);
// hist_grid: the histogram blocks, at least ceil(F / cap); sms: the card's
// multiprocessors.  Returns cudaGetLastError(), or cudaErrorInvalidValue
// for a cap or hist_grid outside those bounds.
int segment_partition_hist_launch(float* payload, float* aux, int P,
                                  const int* scalars,
                                  const unsigned char* bitset, int B,
                                  const float* fvals, int value_col,
                                  int n_tiles, int* tile_left, int* tile_off,
                                  int* num_left, int* sync, float* hist,
                                  int F, int Bh, int cap, int grad_col,
                                  int hess_col, int cnt_col, int hist_grid,
                                  const int* scale,
                                  unsigned long long* scratch_gh,
                                  int* scratch_cnt, int* tickets, int sms,
                                  void* stream) {
  if (cap < 1 || cap > kHistGroupCols || hist_grid < (F + cap - 1) / cap) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int T = tile_rows(P);
  const size_t move_smem = move_smem_bytes(T, P);
  const int hist_smem = hist_smem_bytes(cap, Bh, true);
  // the move's grid stays resident (B2's rule); both opt-ins are set once
  // per width and shared-memory size
  static int occ_P = -1, occ_blocks = 1, smem_set = -1;
  if (occ_P != P) {
    cudaFuncSetAttribute(phist_move,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(move_smem));
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ_blocks, phist_move,
                                                  kMoveThreads, move_smem);
    occ_blocks = occ_blocks > 0 ? occ_blocks : 1;
    occ_P = P;
  }
  if (hist_smem != smem_set) {
    cudaError_t err = cudaFuncSetAttribute(
        phist_side_hist, cudaFuncAttributeMaxDynamicSharedMemorySize,
        hist_smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set = hist_smem;
  }
  phist_count<<<4 * sms, kCountThreads, 0, s>>>(
      payload, P, scalars, bitset, B, T, tile_left, sync);
  phist_scan<<<scan_blocks(n_tiles), kTile, 0, s>>>(scalars, T, tile_left,
                                                    tile_off, num_left);
  phist_move<<<occ_blocks * sms, kMoveThreads, move_smem, s>>>(
      payload, aux, P, scalars, bitset, B, T, tile_left, tile_off, num_left,
      fvals, value_col, sync);
  phist_side_hist<<<sms + hist_grid, kHistThreads, hist_smem, s>>>(
      payload, aux, P, scalars, num_left,
      FixedOut{scratch_gh, scratch_cnt, hist, tickets, scale}, F, Bh, cap,
      grad_col, hess_col, cnt_col, sms);
  return static_cast<int>(cudaGetLastError());
}

const char* segment_partition_hist_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
