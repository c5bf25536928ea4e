// Stable segment partition for Hopper (sm_90a).
//
// Replaces the TPU kernel lightgbm_tpu/ops/pallas_segment.py
// partition_segment_acc -> _acc_kernel: stably partition payload rows
// [start, start + count) by the split predicate (left rows first), write
// left_value / right_value into value_col, and report num_left.  The
// predicate follows _go_left_rows (pallas_segment.py:282-316) and
// ops/bundle.decode_bin exactly: numerical threshold, NaN- and
// zero-missing with default_left, categorical bitset, EFB offset /
// identity decode.  start, count and every predicate scalar are read from
// device memory, and num_left stays there, so the grower never syncs to
// launch this.  Rows move as raw 32-bit copies, so the payload and
// num_left are byte-identical to the plain PyTorch version.
//
// What bounds it on this card: HBM at 3.35 TB/s.  The least traffic is
// each row read once and written once, 2 * count * P * 4 bytes; there is
// no arithmetic to speak of.
//
// Two contracts, three entry points:
//
// The whole partition (segment_partition_launch), with the Pallas
// kernel's contract: payload and num_left as above, aux over the segment
// is scratch, and nothing outside the segment is written.  Each row is
// written once to its final place, except the smaller side, which goes
// through aux and back (segment_partition_inplace.cuh has the protocol):
//   1. part_count_tiles: a persistent grid counts the left rows of each
//      tile of T rows (T from the width: a tile fills 32 KB of shared
//      memory, 192 rows at P = 38), and clears the ticket and the tiles'
//      "read" flags;
//   2. part_scan_tiles: the counts become offsets and num_left (a block
//      per 8,192 tiles, segment_partition.cuh's scan_tile_counts);
//   3. part_move: a persistent grid takes tiles by ticket in walk order.
//      A block streams the next tile's rows, one contiguous span, into one
//      of two staging buffers by cp.async while it works on the current
//      one: ranks its rows (ballot + popc, a scan over the warps), writes
//      the leaf value into the staged value column, waits for the (at
//      most two) tiles its in-place rows land on, and writes its left rows
//      and its right rows as two contiguous spans with 16-byte stores:
//      the larger side's into the payload, the smaller side's into aux at
//      the rows they will hold;
//   4. part_copy_side: the smaller side's one contiguous range, aux ->
//      payload, with 16-byte moves.
// Traffic: 2 * count * P * 4 + 2 * min(L, R) * P * 4 bytes, and the count's
// read of the routing column.  At P = 38 that read pulls most of the
// payload's 128-byte lines, about a sixth of the kernel's time.  A
// single pass with a decoupled look-back that always sends the right rows
// through aux has no count, but was slower on the card: a tile's left
// count is known only once the tile is read, so look-backs wait on other
// blocks' prefetched tiles, and counting at claim time from the routing
// column pulls the lines again.  No per-element integer division: the
// spans are walked with a running (row, column) pair.
//
// The stage and the commit (segment_partition_stage_launch, _commit_launch),
// which the frontier-batched grower runs apart, keep the full contract:
// the stage leaves the payload untouched and the whole partition in aux,
// and the grower reads it there; the commit copies aux back.  Their
// kernels (the JAX package's ops/segment.py partition_segment_stage /
// _commit, plain JAX there):
//   1. part_count: one block per 1024-row tile counts its left rows;
//   2. part_scan: those counts become exclusive offsets and num_left;
//   3. part_scatter: each tile ranks its rows and copies whole rows into
//      aux: lefts to start + offset, rights to start + num_left + offset;
//   4. part_copyback: aux -> payload over the segment, with the leaf value
//      written into value_col.
// Kernels 1, 2 and 4 and the ranking of 3 live in segment_partition.cuh;
// their grids are sized for the largest possible segment.
// None of the TPU kernel's machinery (8-row aligned windows, one-hot
// permutation matmuls, the accumulator rings) carries over.

#include "segment_partition_inplace.cuh"

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

// ---- the whole partition ------------------------------------------------

constexpr int kCountThreads = 256;
constexpr int kMoveThreads = 512;
constexpr int kStageBytes = 32 * 1024;  // one tile's rows, one of two buffers

// Rows per tile of the whole partition at width P (0: the width is past
// the kernel).
int tile_rows(int P) { return move_tile_rows(P, kStageBytes); }

__global__ void __launch_bounds__(kCountThreads)
part_count_tiles(const float* __restrict__ payload, int P,
                 const int* __restrict__ sc,
                 const unsigned char* __restrict__ bitset, int B, int T,
                 int* __restrict__ tile_left, int* __restrict__ sync) {
  count_tiles(payload, P, sc, bitset, B, T, tile_left, sync);
}

__global__ void __launch_bounds__(kTile)
part_scan_tiles(const int* __restrict__ sc, int T,
                const int* __restrict__ tile_left, int* __restrict__ tile_off,
                int* __restrict__ num_left) {
  scan_tile_counts((sc[kCount] + T - 1) / T, tile_left, tile_off, num_left);
}

__global__ void __launch_bounds__(kMoveThreads)
part_move(float* payload, float* aux, int P, const int* __restrict__ sc,
          const unsigned char* __restrict__ bitset, int B, int T,
          const int* __restrict__ tile_left, const int* __restrict__ tile_off,
          const int* __restrict__ num_left, const float* __restrict__ fvals,
          int value_col, int* sync) {
  move_tiles(payload, aux, P, sc, bitset, B, T, tile_left, tile_off,
             num_left, fvals, value_col, sync);
}

__global__ void __launch_bounds__(kCopyThreads)
part_copy_side(float* __restrict__ payload, const float* __restrict__ aux,
               int P, const int* __restrict__ sc,
               const int* __restrict__ num_left) {
  copy_smaller_side(payload, aux, P, sc, num_left);
}

}  // namespace

extern "C" {

int segment_partition_tile_rows() { return kTile; }

// Rows per tile of the whole partition at width P; 0 when the kernel
// cannot take the width.
int segment_partition_move_tile_rows(int P) {
  return P > 0 ? tile_rows(P) : 0;
}

// The whole partition (kernels part_count_tiles, part_scan_tiles,
// part_move, part_copy_side).  scalars, bitset: as for the stage; fvals:
// f32[2] (left, right value) on the device.  Scratch, for n_tiles tiles of
// segment_partition_move_tile_rows(P) rows covering the largest count:
// tile_left / tile_off int32[n_tiles], sync int32[1 + n_tiles] (cleared
// by the count kernel).  num_left: one int32 on the device.  sms: the
// card's multiprocessors.  Returns cudaGetLastError().
int segment_partition_launch(float* payload, float* aux, int P,
                             const int* scalars, const unsigned char* bitset,
                             int B, const float* fvals, int value_col,
                             int n_tiles, int* tile_left, int* tile_off,
                             int* num_left, int* sync, int sms,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int T = tile_rows(P);
  const size_t smem = move_smem_bytes(T, P);
  // the grid that stays resident: blocks of a persistent grid never wait
  // for a slot while others spin
  static int occ_P = -1, occ_blocks = 1;
  if (occ_P != P) {
    cudaFuncSetAttribute(part_move,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ_blocks, part_move,
                                                  kMoveThreads, smem);
    occ_blocks = occ_blocks > 0 ? occ_blocks : 1;
    occ_P = P;
  }
  part_count_tiles<<<4 * sms, kCountThreads, 0, s>>>(
      payload, P, scalars, bitset, B, T, tile_left, sync);
  part_scan_tiles<<<scan_blocks(n_tiles), kTile, 0, s>>>(
      scalars, T, tile_left, tile_off, num_left);
  part_move<<<occ_blocks * sms, kMoveThreads, smem, s>>>(
      payload, aux, P, scalars, bitset, B, T, tile_left, tile_off, num_left,
      fvals, value_col, sync);
  part_copy_side<<<4 * sms, kCopyThreads, 0, s>>>(payload, aux, P, scalars,
                                                  num_left);
  return static_cast<int>(cudaGetLastError());
}

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
  part_scan<<<scan_blocks(n_tiles), kTile, 0, s>>>(scalars, tile_left,
                                                   tile_off, num_left);
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
