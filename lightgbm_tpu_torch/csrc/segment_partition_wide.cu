// Stable segment partition of wide payloads for Hopper (sm_90a).
//
// Replaces two TPU kernels of lightgbm_tpu/ops/pallas_segment.py, both
// with the contract of B2 (csrc/segment_partition.cu): stably partition
// payload rows [start, start + count) by the split predicate (left rows
// first), write left_value / right_value into value_col, and report
// num_left; payload and num_left are byte-identical to the plain PyTorch
// version.
//   - partition_segment -> _partition_kernel (B3, the "RMW" partition):
//     payloads past B2's plan, rows of 2-6.5 KB (513 <= P < 1665); it also
//     leaves the whole partition in aux over the segment;
//   - partition_segment_acc_blocks -> _snap_window_kernel +
//     _acc_blocks_kernel (B8): the widest payloads (P >= 1665), over column
//     windows with the routing read once.  As in the Pallas kernel, aux
//     over the segment is scratch; nothing outside the segment is written.
// The predicate is B2's (segment_partition.cuh).
//
// What bounds it on this card: HBM at 3.35 TB/s.  The least traffic is
// each row read once and written once, 2 * count * P * 4 bytes; there is
// no arithmetic to speak of.  At these widths a row is 2-8 KB, so the
// routing column (one 32-byte sector per row) is a few percent of it.
//
// Both start with one routing, three launches sized for the largest
// segment (the whole payload) that read start, count and every predicate
// scalar from device memory, so the grower never syncs to launch them:
//   1. route_count: one block per 1024-row tile reads the routing column
//      once, keeps each row's side as a byte and counts the tile's lefts
//      (the TPU kernel's "snap" of the split column); for B8 it also
//      clears the move's ticket and "read" flags;
//   2. route_scan: one block turns the tile counts into exclusive offsets
//      and num_left;
//   3. route_rank: each tile ranks its rows from the stored bytes (warp
//      ballot + popc, a scan over the warps) and writes every row's
//      destination row.
// B3 then moves every row twice, 4 * count * P * 4 bytes:
//   4. rmw_scatter: payload -> aux, one warp per row, with 16-byte moves
//      over the part of the row whose source and destination share their
//      offset within 16 bytes (8-byte moves where they share it within 8);
//   5. flat_copyback: the segment is one contiguous range of count * P
//      floats in aux and in payload, so the copy-back is a flat 16-byte
//      copy over the grid;
//   6. write_values: the leaf values into value_col, one thread per row.
// B8 writes each row once to its final place, except the smaller side,
// which goes through aux and back, 2 * count * P * 4 + 2 * min(L, R) * P * 4
// bytes (the protocol is in segment_partition_inplace.cuh):
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

// One block per 1024-row tile; sync (B8, else null) gets its ticket and
// the flags of the tile's row tiles (ncb column blocks each) cleared.
__global__ void __launch_bounds__(kTile)
route_count(const float* __restrict__ payload, int P,
            const int* __restrict__ sc,
            const unsigned char* __restrict__ bitset, int B,
            unsigned char* __restrict__ side, int* __restrict__ tile_left,
            int* __restrict__ sync, int ncb) {
  const int count = sc[kCount];
  const int row0 = blockIdx.x * kTile;
  if (sync != nullptr) {
    if (blockIdx.x == 0 && threadIdx.x == 0) sync[0] = 0;
    const int ntiles = (count + kRowTile - 1) / kRowTile;
    const int t0 = row0 / kRowTile;
    const int nflags = (min(ntiles, t0 + kTile / kRowTile) - t0) * ncb;
    for (int i = threadIdx.x; i < nflags; i += kTile) {
      sync[1 + t0 * ncb + i] = 0;
    }
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
  scan_tile_counts((sc[kCount] + kTile - 1) / kTile, tile_left, tile_off,
                   num_left);
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
// progress (segment_partition.cu's part_move says why).
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
  copy_smaller_side(payload, aux, P, sc, num_left);
}

// The routing (kernels 1-3); sync / ncb as route_count takes them.
void route(const float* payload, int P, const int* scalars,
           const unsigned char* bitset, int B, int n_tiles,
           unsigned char* side, int* dest, int* tile_left, int* tile_off,
           int* num_left, int* sync, int ncb, cudaStream_t s) {
  route_count<<<n_tiles, kTile, 0, s>>>(payload, P, scalars, bitset, B, side,
                                        tile_left, sync, ncb);
  route_scan<<<1, kTile, 0, s>>>(scalars, tile_left, tile_off, num_left);
  route_rank<<<n_tiles, kTile, 0, s>>>(scalars, side, tile_off, num_left,
                                       dest);
}

}  // namespace

extern "C" {

int segment_partition_wide_tile_rows() { return kTile; }

// Rows per tile of B8's move, whose sync scratch holds one flag per row
// tile and column block.
int segment_partition_blocks_row_tile() { return kRowTile; }
int segment_partition_blocks_col_block() { return kColBlock; }

// B3 (kernels 1-3, then rmw_scatter, flat_copyback, write_values).
// scalars: int32[11] on the device (start, count, col, threshold,
// default_left, is_cat, missing_type, num_bin, default_bin, offset,
// identity); bitset: uint8[B], the bytes of a bool tensor; fvals: f32[2]
// (left, right value) on the device.  Scratch, sized for the largest
// count (n_rows rows): side uint8[n_rows], dest int32[n_rows], tile_left /
// tile_off int32[n_tiles] with n_tiles * 1024 >= n_rows.  num_left: one
// int32 on the device.  grid_x: blocks of the grid-stride launches.
// Returns cudaGetLastError().
int segment_partition_rmw_launch(float* payload, float* aux, int P,
                                 const int* scalars,
                                 const unsigned char* bitset, int B,
                                 const float* fvals, int value_col,
                                 int n_tiles, unsigned char* side, int* dest,
                                 int* tile_left, int* tile_off, int* num_left,
                                 int grid_x, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  route(payload, P, scalars, bitset, B, n_tiles, side, dest, tile_left,
        tile_off, num_left, nullptr, 0, s);
  rmw_scatter<<<grid_x, kCopyThreads, 0, s>>>(payload, aux, P, scalars, dest);
  flat_copyback<<<grid_x, kCopyThreads, 0, s>>>(payload, aux, P, scalars);
  write_values<<<grid_x, kCopyThreads, 0, s>>>(payload, P, scalars, num_left,
                                               fvals, value_col);
  return static_cast<int>(cudaGetLastError());
}

// B8 (kernels 1-3, then block_move, wide_copy_side).  Arguments as B3's,
// plus sync: int32[1 + ceil(n_rows / 32) * ceil(P / 512)] (cleared by
// route_count); sms: the card's multiprocessors.  Returns
// cudaGetLastError().
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
  route(payload, P, scalars, bitset, B, n_tiles, side, dest, tile_left,
        tile_off, num_left, sync, ncb, s);
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
