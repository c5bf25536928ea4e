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
// and the grower reads it there; the commit copies aux back with the leaf
// values.  (The JAX package's ops/segment.py partition_segment_stage /
// _commit, plain JAX there.)  Traffic: each row read and written once by
// each, 4 * count * P * 4 bytes in all.
//   1-2. part_count_tiles and part_scan_tiles, as for the whole partition;
//   3. part_stage_move: the whole partition's move (persistent grid, tiles
//      by ticket, cp.async staging, ranking by ballot, each side of a tile
//      written as one contiguous span with 16-byte stores), out of place:
//      every row goes to aux at its final row, so no tile waits for
//      another;
//   4. part_commit (the commit): aux -> payload over the segment with
//      16-byte moves on a grid sized from the card, the leaf value written
//      into value_col on the way; each thread walks its elements with a
//      running (row, column) pair, so no element costs a division.
// Every launch reads the count on the device, so an inactive candidate of
// a frontier round (count 0) costs its launches and nothing else.
// None of the TPU kernel's machinery (8-row aligned windows, one-hot
// permutation matmuls, the accumulator rings) carries over.

#include "segment_partition_inplace.cuh"

namespace {

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
  CHECK_SCALARS("partition_segment count", sc);
  count_tiles(payload, P, sc, bitset, B, T, tile_left, sync);
}

__global__ void __launch_bounds__(kTile)
part_scan_tiles(const int* __restrict__ sc, int T,
                const int* __restrict__ tile_left, int* __restrict__ tile_off,
                int* __restrict__ num_left) {
  CHECK_SCALARS("partition_segment scan", sc);
  scan_tile_counts((sc[kCount] + T - 1) / T, tile_left, tile_off, num_left);
}

__global__ void __launch_bounds__(kMoveThreads)
part_move(float* payload, float* aux, int P, const int* __restrict__ sc,
          const unsigned char* __restrict__ bitset, int B, int T,
          const int* __restrict__ tile_left, const int* __restrict__ tile_off,
          const int* __restrict__ num_left, const float* __restrict__ fvals,
          int value_col, int* sync) {
  CHECK_SCALARS("partition_segment move", sc);
  move_tiles(payload, aux, P, sc, bitset, B, T, tile_left, tile_off,
             num_left, fvals, value_col, sync);
}

__global__ void __launch_bounds__(kCopyThreads)
part_copy_side(float* __restrict__ payload, const float* __restrict__ aux,
               int P, const int* __restrict__ sc,
               const int* __restrict__ num_left) {
  CHECK_SCALARS("partition_segment copy", sc);
  copy_smaller_side(payload, aux, P, sc, num_left);
}

// ---- the stage + commit -------------------------------------------------

// The stage's move: out of place, so the payload is only read (the shared
// body takes a writable pointer; in its Stage form it never writes it).
__global__ void __launch_bounds__(kMoveThreads)
part_stage_move(const float* payload, float* __restrict__ aux, int P,
                const int* __restrict__ sc,
                const unsigned char* __restrict__ bitset, int B, int T,
                const int* __restrict__ tile_left,
                const int* __restrict__ tile_off,
                const int* __restrict__ num_left, int* sync) {
  CHECK_SCALARS("partition_segment_stage move", sc);
  move_tiles<true>(const_cast<float*>(payload), aux, P, sc, bitset, B, T,
                   tile_left, tile_off, num_left, nullptr, 0, sync);
}

// aux -> payload over the segment, with the leaf value written into
// value_col: fvals[0] for the first num_left rows, fvals[1] after them.
// 16-byte moves where aux and payload share their offset within 16 bytes
// (always, for two buffers of one shape from the allocator), else 4-byte
// ones; element e of the segment is row e / P, column e % P, tracked by a
// running pair.  Element counts and indices are 64-bit: a segment of
// count * P elements passes 2^31 past 2^24 rows at P >= 128.
__global__ void __launch_bounds__(kCopyThreads)
part_commit(float* __restrict__ payload, const float* __restrict__ aux, int P,
            const int* __restrict__ sc, int rows,
            const int* __restrict__ num_left,
            const float* __restrict__ fvals, int value_col) {
  CHECK_SEGMENT("partition_segment_commit", sc[kStart], sc[kCount], rows);
  const long long base = static_cast<long long>(sc[kStart]) * P;
  const long long n = static_cast<long long>(sc[kCount]) * P;
  const int nl = *num_left;
  const float lv = fvals[0];
  const float rv = fvals[1];
  const float* src = aux + base;
  float* dst = payload + base;
  const long long t0 =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  auto value = [&](long long e, float v) {
    const long long r = e / P;
    return e - r * P == value_col ? (r < nl ? lv : rv) : v;
  };
  if (phase16(src) != phase16(dst)) {
    for (long long e = t0; e < n; e += step) dst[e] = value(e, src[e]);
    return;
  }
  const long long head = min(static_cast<long long>((4 - phase16(dst)) & 3),
                             n);
  const long long nvec = (n - head) >> 2;
  // the at most three elements before the aligned middle and after it
  const long long edge = t0 < 3 ? t0 : head + 4 * nvec + t0 - 3;
  if ((t0 < 3 && edge < head) || (t0 >= 3 && t0 < 6 && edge < n)) {
    dst[edge] = value(edge, src[edge]);
  }
  const float4* s4 = reinterpret_cast<const float4*>(src + head);
  float4* d4 = reinterpret_cast<float4*>(dst + head);
  const long long e0 = head + 4 * t0;
  long long row = e0 / P;  // once per thread
  int col = static_cast<int>(e0 - row * P);
  const long long drow = (4 * step) / P;
  const int dcol = static_cast<int>(4 * step - drow * P);
#pragma unroll 4
  for (long long i = t0; i < nvec; i += step) {
    float4 v = s4[i];
    float* f = reinterpret_cast<float*>(&v);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      int c = col + q;
      long long r = row;
      if (c >= P) {
        c -= P;
        ++r;
      }
      if (c == value_col) f[q] = r < nl ? lv : rv;
    }
    d4[i] = v;
    row += drow;
    col += dcol;
    if (col >= P) {
      col -= P;
      ++row;
    }
  }
}

}  // namespace

extern "C" {

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

// The stage (part_count_tiles, part_scan_tiles, part_stage_move): the rows
// of [start, start + count), left rows first, into aux over the same range;
// payload is only read.  scalars: int32[12] on the device (start, count,
// col, threshold, default_left, is_cat, missing_type, num_bin,
// default_bin, offset, identity, and the payload's rows); bitset:
// uint8[B], the bytes of a bool tensor.  Scratch, for n_tiles tiles of
// segment_partition_move_tile_rows(P) rows covering the largest count:
// tile_left / tile_off int32[n_tiles], sync int32[1 + n_tiles] (cleared by
// the count kernel).  num_left: one int32 on the device (any slot of a
// caller's vector) that receives the left count.  sms: the card's
// multiprocessors.  Returns cudaGetLastError().
int segment_partition_stage_launch(const float* payload, float* aux, int P,
                                   const int* scalars,
                                   const unsigned char* bitset, int B,
                                   int n_tiles, int* tile_left,
                                   int* tile_off, int* num_left, int* sync,
                                   int sms, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int T = tile_rows(P);
  const size_t smem = move_smem_bytes(T, P);
  static int occ_P = -1, occ_blocks = 1;
  if (occ_P != P) {
    cudaFuncSetAttribute(part_stage_move,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &occ_blocks, part_stage_move, kMoveThreads, smem);
    occ_blocks = occ_blocks > 0 ? occ_blocks : 1;
    occ_P = P;
  }
  part_count_tiles<<<4 * sms, kCountThreads, 0, s>>>(
      payload, P, scalars, bitset, B, T, tile_left, sync);
  part_scan_tiles<<<scan_blocks(n_tiles), kTile, 0, s>>>(
      scalars, T, tile_left, tile_off, num_left);
  part_stage_move<<<occ_blocks * sms, kMoveThreads, smem, s>>>(
      payload, aux, P, scalars, bitset, B, T, tile_left, tile_off, num_left,
      sync);
  return static_cast<int>(cudaGetLastError());
}

// The commit (part_commit): aux -> payload over [start, start + count) with
// fvals[0] (left) / fvals[1] (right) written into value_col.  seg: int32[2]
// (start, count) on the device, or the stage's int32[12] scalars; rows:
// the payload's rows, the segment's bound; num_left: one int32 on the
// device.  count 0 is a no-op.  copy_blocks: the grid.  Returns
// cudaGetLastError().
int segment_partition_commit_launch(float* payload, const float* aux, int P,
                                    const int* seg, int rows,
                                    const int* num_left, const float* fvals,
                                    int value_col, int copy_blocks,
                                    void* stream) {
  part_commit<<<copy_blocks, kCopyThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(
      payload, aux, P, seg, rows, num_left, fvals, value_col);
  return static_cast<int>(cudaGetLastError());
}

const char* segment_partition_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
