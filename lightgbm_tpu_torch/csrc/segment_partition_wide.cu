// Stable segment partition of wide payloads for Hopper (sm_90a).
//
// Replaces two TPU kernels of lightgbm_tpu/ops/pallas_segment.py, both
// with the contract of B2 (csrc/segment_partition.cu): stably partition
// payload rows [start, start + count) by the split predicate (left rows
// first), write left_value / right_value into value_col, and report
// num_left; payload and num_left are byte-identical to the plain PyTorch
// version.  As in the Pallas kernels, aux over the segment is scratch
// (only the smaller side passes through it) and nothing outside the
// segment is written.
//   - partition_segment -> _partition_kernel (B3, the "RMW" partition):
//     payloads past B2's plan, rows of 2-6.5 KB (513 <= P < 1665);
//   - partition_segment_acc_blocks -> _snap_window_kernel +
//     _acc_blocks_kernel (B8): the widest payloads (P >= 1665), over column
//     windows with the routing read once.
// The predicate is B2's (segment_partition.cuh).
//
// What bounds it on this card: HBM at 3.35 TB/s.  The least traffic is
// each row read once and written once, 2 * count * P * 4 bytes; there is
// no arithmetic to speak of.  At these widths a row is 2-8 KB, so the
// routing column (one 32-byte sector per row) is a few percent of it.
// Both write each row once to its final place, except the smaller side,
// which goes through aux and back: 2 * count * P * 4 + 2 * min(L, R) * P *
// 4 bytes (the protocol is in segment_partition_inplace.cuh).
//
// B3 runs B2's whole-row tiles (count_tiles / move_tiles in the header)
// under its own names and tile geometry, four launches:
//   1. rmw_count: a grid of warps reads the routing column once, one
//      sector per row, counts each tile's left rows (a warp per tile of
//      at most 32 rows), and clears the move's ticket and the tiles'
//      "read" flags;
//   2. rmw_scan: the counts become offsets and num_left;
//   3. rmw_move: a persistent grid takes tiles of whole rows by ticket in
//      walk order, streams the next tile into the second of two staging
//      buffers by cp.async while it ranks the current one, writes the
//      leaf value into the staged value column, waits for the (at most
//      two) tiles its in-place rows land on, and writes each side of the
//      tile as one contiguous span with 16-byte stores: the larger side's
//      into the payload, the smaller side's into aux;
//   4. rmw_copy_side: the smaller side's one contiguous range, aux ->
//      payload, with 16-byte moves.
// Tiles fill kRmwStageBytes per staging buffer (8 rows at P = 978), and
// kRmwMoveThreads threads move them; both were chosen from readings on
// the card at P = 513, 978 and 1664 (PERF.md).
//
// B8 routes first, three launches sized for the largest segment (the
// whole payload) that read start, count and every predicate scalar from
// device memory, so the grower never syncs to launch them:
//   1. route_count: one block per 1024-row tile reads the routing column
//      once, keeps each row's side as a byte and counts the tile's lefts
//      (the TPU kernel's "snap" of the split column), and clears the
//      move's ticket and "read" flags;
//   2. route_scan: the tile counts become exclusive offsets and num_left;
//   3. route_rank: each tile ranks its rows from the stored bytes (warp
//      ballot + popc, a scan over the warps) and writes every row's
//      destination row.
// Then:
//   4. block_move: a persistent grid takes (row tile of 8 rows, column
//      block of 512 floats) tickets in walk order, each column block with
//      its own flags, so column blocks never wait on each other.  A block
//      streams the next tile's 8 row slices (16 KB) into one of two
//      staging buffers by cp.async while it works on the current one:
//      writes the leaf value into the staged value column, waits for the
//      (at most two) row tiles its in-place rows land on, and stores each
//      slice at its destination row with 16-byte stores, the larger
//      side's into the payload, the smaller side's into aux.  Tiles of 8
//      rows keep six blocks on an SM (32 rows, double buffered, leave one,
//      and ran slower on the card);
//   5. wide_copy_side: the smaller side's one contiguous range, aux ->
//      payload, with 16-byte moves.
// Rows move as raw 4-, 8- or 16-byte copies.  None of the TPU kernels'
// machinery (8-row aligned RMW windows, permutation matmuls, the 128-lane
// split-column snapshot) carries over.

#include "segment_partition_inplace.cuh"

namespace {

constexpr int kRowTile = 8;       // rows per tile of B8's move
constexpr int kColBlock = 512;   // floats per column block
constexpr int kSlab = kColBlock + 4;  // floats per staged row slice

// One block per 1024-row tile; sync gets its ticket and the flags of the
// tile's row tiles (ncb column blocks each) cleared.
__global__ void __launch_bounds__(kTile)
route_count(const float* __restrict__ payload, int P,
            const int* __restrict__ sc,
            const unsigned char* __restrict__ bitset, int B,
            unsigned char* __restrict__ side, int* __restrict__ tile_left,
            int* __restrict__ sync, int ncb) {
  CHECK_SCALARS("partition_segment_blocks route_count", sc);
  const int count = sc[kCount];
  const int row0 = blockIdx.x * kTile;
  if (blockIdx.x == 0 && threadIdx.x == 0) sync[0] = 0;
  const int ntiles = (count + kRowTile - 1) / kRowTile;
  const int t0 = row0 / kRowTile;
  const int nflags = (min(ntiles, t0 + kTile / kRowTile) - t0) * ncb;
  for (int i = threadIdx.x; i < nflags; i += kTile) {
    sync[1 + t0 * ncb + i] = 0;
  }
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
  CHECK_SCALARS("partition_segment_blocks route_scan", sc);
  scan_tile_counts((sc[kCount] + kTile - 1) / kTile, tile_left, tile_off,
                   num_left);
}

__global__ void __launch_bounds__(kTile)
route_rank(const int* __restrict__ sc, const unsigned char* __restrict__ side,
           const int* __restrict__ tile_off, const int* __restrict__ num_left,
           int* __restrict__ dest) {
  __shared__ int warp_left[32];
  CHECK_SCALARS("partition_segment_blocks route_rank", sc);
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

// ---- B3 ------------------------------------------------------------------

constexpr int kRmwCountThreads = 256;
constexpr int kRmwMoveThreads = 512;
constexpr int kRmwStageBytes = 32 * 1024;  // one tile, one of two buffers

// Rows per tile of B3 at width P (0: the width is past the kernel).
int rmw_tile_rows(int P) { return move_tile_rows(P, kRmwStageBytes); }

__global__ void __launch_bounds__(kRmwCountThreads)
rmw_count(const float* __restrict__ payload, int P, const int* __restrict__ sc,
          const unsigned char* __restrict__ bitset, int B, int T,
          int* __restrict__ tile_left, int* __restrict__ sync) {
  CHECK_SCALARS("partition_segment_rmw count", sc);
  count_tiles(payload, P, sc, bitset, B, T, tile_left, sync);
}

__global__ void __launch_bounds__(kTile)
rmw_scan(const int* __restrict__ sc, int T, const int* __restrict__ tile_left,
         int* __restrict__ tile_off, int* __restrict__ num_left) {
  CHECK_SCALARS("partition_segment_rmw scan", sc);
  scan_tile_counts((sc[kCount] + T - 1) / T, tile_left, tile_off, num_left);
}

__global__ void __launch_bounds__(kRmwMoveThreads)
rmw_move(float* payload, float* aux, int P, const int* __restrict__ sc,
         const unsigned char* __restrict__ bitset, int B, int T,
         const int* __restrict__ tile_left, const int* __restrict__ tile_off,
         const int* __restrict__ num_left, const float* __restrict__ fvals,
         int value_col, int* sync) {
  CHECK_SCALARS("partition_segment_rmw move", sc);
  move_tiles(payload, aux, P, sc, bitset, B, T, tile_left, tile_off,
             num_left, fvals, value_col, sync);
}

__global__ void __launch_bounds__(kCopyThreads)
rmw_copy_side(float* __restrict__ payload, const float* __restrict__ aux,
              int P, const int* __restrict__ sc,
              const int* __restrict__ num_left) {
  CHECK_SCALARS("partition_segment_rmw copy", sc);
  copy_smaller_side(payload, aux, P, sc, num_left);
}

// ---- B8 ------------------------------------------------------------------

// The head (< 4 floats before the first 16-byte boundary) and the count
// of float4 of a row slice of cw floats at `p`.
__device__ __forceinline__ void slice_shape(const float* p, int cw, int* head,
                                            int* nvec) {
  *head = min((4 - phase16(p)) & 3, cw);
  *nvec = (cw - *head) >> 2;
}

// One staging buffer of block_move: a tile's row slices, each at its
// source's offset within 16 bytes, and its rows' destinations and sides.
struct Slab {
  float f[kRowTile * kSlab];
  int dest[kRowTile];
  int side[kRowTile];
};

// Starts staging nr row slices of cw floats at src (row stride P) into
// `sl`: the aligned middles by cp.async (one committed group; the caller
// waits for it), the at most three floats on either side of each, and
// the rows' destinations and sides, by plain loads.
__device__ __forceinline__ void stage_slices(Slab* sl, const float* src,
                                             int P, int nr, int cw,
                                             const int* __restrict__ dest,
                                             const unsigned char* __restrict__
                                                 side) {
  constexpr int kVec = kColBlock / 4;  // float4 per slice, at most
  for (int idx = threadIdx.x; idx < nr * kVec; idx += kCopyThreads) {
    const int rr = idx / kVec;
    const int q = idx % kVec;
    const float* p = src + static_cast<long long>(rr) * P;
    int head, nvec;
    slice_shape(p, cw, &head, &nvec);
    if (q < nvec) {
      cp_async16(sl->f + rr * kSlab + phase16(p) + head + 4 * q,
                 p + head + 4 * q);
    }
  }
  cp_async_commit();
  if (static_cast<int>(threadIdx.x) < nr) {
    sl->dest[threadIdx.x] = dest[threadIdx.x];
    sl->side[threadIdx.x] = side[threadIdx.x];
  }
  for (int idx = threadIdx.x; idx < nr * 8; idx += kCopyThreads) {
    const int rr = idx >> 3;
    const int j = idx & 7;
    const float* p = src + static_cast<long long>(rr) * P;
    int head, nvec;
    slice_shape(p, cw, &head, &nvec);
    const int c = j < 4 ? j : head + 4 * nvec + (j - 4);
    if ((j < 4 && c < head) || (j >= 4 && c < cw)) {
      sl->f[rr * kSlab + phase16(p) + c] = p[c];
    }
  }
}

// B8's move; see the note at the top of the file.  Two staging buffers:
// the next tile's slices stream in by cp.async while the block writes the
// current one's, and the ticket after that is claimed meanwhile.  The
// next tile's flag is published only once its copies have landed, after
// the current tile's writes, which wait only for tiles before the current
// one in walk order; so the lowest ticket without a flag always makes
// progress (segment_partition_inplace.cuh's move_tiles says why).
__global__ void __launch_bounds__(kCopyThreads)
block_move(float* payload, float* aux, int P, const int* __restrict__ sc,
           const unsigned char* __restrict__ side,
           const int* __restrict__ dest, const int* __restrict__ num_left,
           const float* __restrict__ fvals, int value_col, int* sync) {
  extern __shared__ float4 smem4[];
  Slab* slabs = reinterpret_cast<Slab*>(smem4);
  __shared__ int s_ticket;
  __shared__ int s_claim[2];
  __shared__ int s_wait[2];
  CHECK_SCALARS("partition_segment_blocks move", sc);
  const long long start = sc[kStart];
  const int count = sc[kCount];
  const int nl = *num_left;
  const bool fwd = left_in_place(nl, count);
  const int ntiles = (count + kRowTile - 1) / kRowTile;
  const int ncb = (P + kColBlock - 1) / kColBlock;
  const int nticket = ntiles * ncb;
  int* flags = sync + 1;  // flags[tile * ncb + column block]
  const int lane = threadIdx.x & 31;
  // a ticket's row tile (walk order within its column block) and column
  // block; the tile's first row and rows, the block's first column and
  // width
  struct Job {
    int t, cb, r0, nr, c0, cw;
  };
  auto job_of = [&](int tk) {
    Job j;
    const int i = tk / ncb;
    j.cb = tk - i * ncb;
    j.t = fwd ? i : ntiles - 1 - i;
    j.r0 = j.t * kRowTile;
    j.nr = min(kRowTile, count - j.r0);
    j.c0 = j.cb * kColBlock;
    j.cw = min(kColBlock, P - j.c0);
    return j;
  };
  auto src_of = [&](const Job& j) {
    return payload + (start + j.r0) * P + j.c0;
  };

  auto stage = [&](int tk, Slab* into) {
    const Job j = job_of(tk);
    stage_slices(into, src_of(j), P, j.nr, j.cw, dest + j.r0, side + j.r0);
  };
  auto publish = [&](int tk) {
    const Job j = job_of(tk);
    publish_read(flags + j.t * ncb + j.cb);
  };

  int tk = next_ticket(sync, &s_ticket);
  if (tk >= nticket) return;  // uniform per block
  Slab* sl = slabs;
  stage(tk, sl);
  cp_async_wait_all();
  publish(tk);
  int nk = next_ticket(sync, &s_ticket);
  Slab* next = slabs + 1;
  if (nk < nticket) stage(nk, next);
  for (int it = 0;; ++it) {
    // the ticket after next, claimed while this tile is worked on (two
    // slots: a thread may still read the last one)
    if (threadIdx.x == 0) s_claim[it & 1] = atomicAdd(sync, 1);

    const Job j = job_of(tk);
    const float* src = src_of(j);
    // the leaf values into the staged value column
    if (value_col >= j.c0 && value_col < j.c0 + j.cw &&
        static_cast<int>(threadIdx.x) < j.nr) {
      const float* p = src + static_cast<long long>(threadIdx.x) * P;
      sl->f[threadIdx.x * kSlab + phase16(p) + (value_col - j.c0)] =
          sl->side[threadIdx.x] ? fvals[0] : fvals[1];
    }
    // the in-place rows of a tile land on consecutive rows: wait for the
    // row tiles that hold them (at most two, none after this one in walk
    // order) in this column block
    if (threadIdx.x < 32) {
      const bool in_place = lane < j.nr && (sl->side[lane] != 0) == fwd;
      const unsigned b = __ballot_sync(0xffffffffu, in_place);
      if (lane == 0) {
        s_wait[0] = 0;
        s_wait[1] = -1;
        if (b != 0) {
          s_wait[0] = static_cast<int>(sl->dest[__ffs(b) - 1] - start) /
                      kRowTile;
          s_wait[1] = static_cast<int>(sl->dest[31 - __clz(b)] - start) /
                      kRowTile;
        }
      }
    }
    __syncthreads();
    wait_read(flags + j.cb, s_wait[0], s_wait[1], ncb);

    // each slice to its destination row: 16-byte stores over the
    // destination's aligned middle, then the at most three floats on
    // either side
    constexpr int kVec = kColBlock / 4;
    for (int idx = threadIdx.x; idx < j.nr * kVec; idx += kCopyThreads) {
      const int rr = idx / kVec;
      const int q = idx % kVec;
      float* d = ((sl->side[rr] != 0) == fwd ? payload : aux) +
                 static_cast<long long>(sl->dest[rr]) * P + j.c0;
      int head, nvec;
      slice_shape(d, j.cw, &head, &nvec);
      if (q < nvec) {
        // the staged floats sit at the source's offset within 16 bytes:
        // one 16-byte load where it is the destination's, two 8-byte
        // loads where the two share it within 8 bytes
        const int ps = phase16(src + static_cast<long long>(rr) * P);
        const float* s = sl->f + rr * kSlab + ps + head + 4 * q;
        float4 v;
        if (ps == phase16(d)) {
          v = *reinterpret_cast<const float4*>(s);
        } else if (((ps ^ phase16(d)) & 1) == 0) {
          const float2 a = reinterpret_cast<const float2*>(s)[0];
          const float2 b = reinterpret_cast<const float2*>(s)[1];
          v = make_float4(a.x, a.y, b.x, b.y);
        } else {
          v = make_float4(s[0], s[1], s[2], s[3]);
        }
        reinterpret_cast<float4*>(d + head)[q] = v;
      }
    }
    for (int idx = threadIdx.x; idx < j.nr * 8; idx += kCopyThreads) {
      const int rr = idx >> 3;
      const int e = idx & 7;
      float* d = ((sl->side[rr] != 0) == fwd ? payload : aux) +
                 static_cast<long long>(sl->dest[rr]) * P + j.c0;
      int head, nvec;
      slice_shape(d, j.cw, &head, &nvec);
      const int c = e < 4 ? e : head + 4 * nvec + (e - 4);
      if ((e < 4 && c < head) || (e >= 4 && c < j.cw)) {
        d[c] = sl->f[rr * kSlab +
                     phase16(src + static_cast<long long>(rr) * P) + c];
      }
    }

    if (nk >= nticket) break;  // uniform per block
    cp_async_wait_all();
    publish(nk);
    tk = nk;
    nk = s_claim[it & 1];
    Slab* done = sl;
    sl = next;
    next = done;
    if (nk < nticket) stage(nk, next);
  }
}

__global__ void __launch_bounds__(kCopyThreads)
wide_copy_side(float* __restrict__ payload, const float* __restrict__ aux,
               int P, const int* __restrict__ sc,
               const int* __restrict__ num_left) {
  CHECK_SCALARS("partition_segment_blocks copy", sc);
  copy_smaller_side(payload, aux, P, sc, num_left);
}

}  // namespace

extern "C" {

int segment_partition_wide_tile_rows() { return kTile; }

// Rows per tile of B8's move, whose sync scratch holds one flag per row
// tile and column block.
int segment_partition_blocks_row_tile() { return kRowTile; }
int segment_partition_blocks_col_block() { return kColBlock; }

// Rows per tile of B3 at width P; 0 when the kernel cannot take the width.
int segment_partition_rmw_tile_rows(int P) {
  return P > 0 ? rmw_tile_rows(P) : 0;
}

// B3 (kernels rmw_count, rmw_scan, rmw_move, rmw_copy_side).  scalars:
// int32[12] on the device (start, count, col, threshold, default_left,
// is_cat, missing_type, num_bin, default_bin, offset, identity, and the
// payload's rows, the segment's bound); bitset:
// uint8[B], the bytes of a bool tensor; fvals: f32[2] (left, right value)
// on the device.  Scratch, for n_tiles tiles of
// segment_partition_rmw_tile_rows(P) rows covering the largest count:
// tile_left / tile_off int32[n_tiles], sync int32[1 + n_tiles] (cleared by
// the count kernel).  num_left: one int32 on the device.  sms: the card's
// multiprocessors.  Returns cudaGetLastError().
int segment_partition_rmw_launch(float* payload, float* aux, int P,
                                 const int* scalars,
                                 const unsigned char* bitset, int B,
                                 const float* fvals, int value_col,
                                 int n_tiles, int* tile_left, int* tile_off,
                                 int* num_left, int* sync, int sms,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int T = rmw_tile_rows(P);
  const size_t smem = move_smem_bytes(T, P);
  // the grid that stays resident: blocks of a persistent grid never wait
  // for a slot while others spin
  static int occ_P = -1, occ_blocks = 1;
  if (occ_P != P) {
    cudaFuncSetAttribute(rmw_move,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ_blocks, rmw_move,
                                                  kRmwMoveThreads, smem);
    occ_blocks = occ_blocks > 0 ? occ_blocks : 1;
    occ_P = P;
  }
  // a warp per tile at a time: enough warps that each takes a few of the
  // root's tiles of a few rows
  rmw_count<<<16 * sms, kRmwCountThreads, 0, s>>>(payload, P, scalars,
                                                  bitset, B, T, tile_left,
                                                  sync);
  rmw_scan<<<scan_blocks(n_tiles), kTile, 0, s>>>(scalars, T, tile_left,
                                                  tile_off, num_left);
  rmw_move<<<occ_blocks * sms, kRmwMoveThreads, smem, s>>>(
      payload, aux, P, scalars, bitset, B, T, tile_left, tile_off, num_left,
      fvals, value_col, sync);
  rmw_copy_side<<<4 * sms, kCopyThreads, 0, s>>>(payload, aux, P, scalars,
                                                 num_left);
  return static_cast<int>(cudaGetLastError());
}

// B8 (kernels 1-3, then block_move, wide_copy_side).  scalars, bitset,
// fvals, num_left: as B3's.  Scratch, sized for the largest count (n_rows
// rows): side uint8[n_rows], dest int32[n_rows], tile_left / tile_off
// int32[n_tiles] with n_tiles * 1024 >= n_rows, sync int32[1 +
// ceil(n_rows / 8) * ceil(P / 512)] (cleared by route_count).  sms: the
// card's multiprocessors.  Returns cudaGetLastError().
int segment_partition_blocks_launch(float* payload, float* aux, int P,
                                    const int* scalars,
                                    const unsigned char* bitset, int B,
                                    const float* fvals, int value_col,
                                    int n_tiles, unsigned char* side,
                                    int* dest, int* tile_left, int* tile_off,
                                    int* num_left, int* sync, int sms,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = 2 * sizeof(Slab);
  static int occ_blocks = 0;
  if (occ_blocks == 0) {
    cudaFuncSetAttribute(block_move,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ_blocks, block_move,
                                                  kCopyThreads, smem);
    occ_blocks = occ_blocks > 0 ? occ_blocks : 1;
  }
  const int ncb = (P + kColBlock - 1) / kColBlock;
  route_count<<<n_tiles, kTile, 0, s>>>(payload, P, scalars, bitset, B, side,
                                        tile_left, sync, ncb);
  route_scan<<<scan_blocks(n_tiles), kTile, 0, s>>>(scalars, tile_left,
                                                    tile_off, num_left);
  route_rank<<<n_tiles, kTile, 0, s>>>(scalars, side, tile_off, num_left,
                                       dest);
  block_move<<<occ_blocks * sms, kCopyThreads, smem, s>>>(
      payload, aux, P, scalars, side, dest, num_left, fvals, value_col, sync);
  wide_copy_side<<<4 * sms, kCopyThreads, 0, s>>>(payload, aux, P, scalars,
                                                  num_left);
  return static_cast<int>(cudaGetLastError());
}

const char* segment_partition_wide_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
