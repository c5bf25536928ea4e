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
//   2. part_scan_tiles: one block turns the counts into offsets and
//      num_left;
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
//   2. part_scan: one block turns those counts into exclusive offsets and
//      num_left;
//   3. part_scatter: each tile ranks its rows and copies whole rows into
//      aux: lefts to start + offset, rights to start + num_left + offset;
//   4. part_copyback: aux -> payload over the segment, with the leaf value
//      written into value_col.
// Kernels 1, 2 and 4 and the ranking of 3 live in segment_partition.cuh,
// which the merged partition + histogram (segment_partition_hist.cu)
// shares; their grids are sized for the largest possible segment.
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
constexpr int kMaxSmemBytes = 227 * 1024;  // a block's, on sm_90

// Rows per tile of the whole partition at width P: as many as fill
// kStageBytes, a multiple of 32 where that leaves any; one row where a
// row is wider, while two of them fit a block's shared memory; else 0.
int move_tile_rows(int P) {
  const int t = kStageBytes / (4 * P);
  if (t == 0) return 8 * (P + 8) <= kMaxSmemBytes ? 1 : 0;
  return t >= 32 ? t - t % 32 : t;
}

// Floats per staging buffer: a tile's span with up to three floats before
// it (to keep its offset within 16 bytes), rounded to 16 bytes.
__host__ __device__ inline int move_buffer_floats(int T, int P) {
  return (T * P + 4 + 3) & ~3;
}

// part_move's dynamic shared memory: two staging buffers and the tile's
// rows in destination order.
size_t move_smem_bytes(int P) {
  const int T = move_tile_rows(P);
  return static_cast<size_t>(2 * move_buffer_floats(T, P)) * 4 + (T + 1) * 4;
}

// A persistent grid counts the left rows of every T-row tile of the
// segment and clears its "read" flag (sync[1 + tile]); block 0 clears the
// ticket counter (sync[0]).  A thread's loads of a tile are unrolled so
// that they are in flight together.
__global__ void __launch_bounds__(kCountThreads)
part_count_tiles(const float* __restrict__ payload, int P,
                 const int* __restrict__ sc,
                 const unsigned char* __restrict__ bitset, int B, int T,
                 int* __restrict__ tile_left, int* __restrict__ sync) {
  __shared__ int s_left;
  if (blockIdx.x == 0 && threadIdx.x == 0) sync[0] = 0;
  if (threadIdx.x == 0) s_left = 0;
  __syncthreads();
  const long long start = sc[kStart];
  const int count = sc[kCount];
  const int col = sc[kCol];
  const int ntiles = (count + T - 1) / T;
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const int row0 = t * T;
    const int nr = min(T, count - row0);
    const float* c0 = payload + (start + row0) * P + col;
    int n = 0;
#pragma unroll 4
    for (int r = threadIdx.x; r < nr; r += kCountThreads) {
      n += go_left(c0[static_cast<long long>(r) * P], sc, bitset, B);
    }
    n = __reduce_add_sync(0xffffffffu, n);
    if ((threadIdx.x & 31) == 0 && n) atomicAdd(&s_left, n);
    __syncthreads();
    if (threadIdx.x == 0) {
      tile_left[t] = s_left;
      s_left = 0;
      sync[1 + t] = 0;
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kTile)
part_scan_tiles(const int* __restrict__ sc, int T,
                const int* __restrict__ tile_left, int* __restrict__ tile_off,
                int* __restrict__ num_left) {
  scan_tile_counts((sc[kCount] + T - 1) / T, tile_left, tile_off, num_left);
}

// Starts copying n floats from global `src` into shared `dst`, where dst
// sits at src's offset within 16 bytes: the aligned middle by cp.async
// (committed as one group; the caller waits for it), the at most three
// floats on either side by plain loads.
__device__ __forceinline__ void load_span_async(float* dst, const float* src,
                                                int n) {
  const int head = min((4 - phase16(src)) & 3, n);
  const int nvec = (n - head) >> 2;
  const int tail0 = head + 4 * nvec;
  for (int i = threadIdx.x; i < nvec; i += blockDim.x) {
    cp_async16(dst + head + 4 * i, src + head + 4 * i);
  }
  cp_async_commit();
  const int edge = threadIdx.x < 3 ? static_cast<int>(threadIdx.x)
                                   : tail0 + threadIdx.x - 3;
  if ((threadIdx.x < 3 && edge < head) ||
      (threadIdx.x >= 3 && threadIdx.x < 6 && edge < n)) {
    dst[edge] = src[edge];
  }
}

// Writes m staged rows, rows[0..m) (indices into the staged span at
// buf[ph + row * P]), as one contiguous span of m * P floats at dst, with
// 16-byte stores over its aligned middle.  Each thread walks its elements
// with a running (row, column) pair.
__device__ __forceinline__ void write_span(float* dst, const float* buf,
                                           int ph, const int* rows, int m,
                                           int P) {
  const int n = m * P;
  const int head = min((4 - phase16(dst)) & 3, n);
  const int nvec = (n - head) >> 2;
  const int tail0 = head + 4 * nvec;
  // the at most three floats before the aligned middle and after it
  const int edge = threadIdx.x < 3 ? static_cast<int>(threadIdx.x)
                                   : tail0 + threadIdx.x - 3;
  if ((threadIdx.x < 3 && edge < head) ||
      (threadIdx.x >= 3 && threadIdx.x < 6 && edge < n)) {
    const int k = edge / P;
    dst[edge] = buf[ph + rows[k] * P + (edge - k * P)];
  }
  const int e0 = head + 4 * threadIdx.x;
  int k = e0 / P;  // once per thread
  int c = e0 - k * P;
  const int step = 4 * blockDim.x;
  const int dk = step / P;
  const int dc = step - dk * P;
  float4* d4 = reinterpret_cast<float4*>(dst + head);
  for (int i = threadIdx.x; i < nvec; i += blockDim.x) {
    float v[4];
    int kk = k, cc = c;
    int s = ph + rows[kk] * P;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      v[q] = buf[s + cc];
      if (++cc == P && q < 3) {
        cc = 0;
        s = ph + rows[++kk] * P;
      }
    }
    d4[i] = make_float4(v[0], v[1], v[2], v[3]);
    k += dk;
    c += dc;
    if (c >= P) {
      c -= P;
      ++k;
    }
  }
}

// The move: tiles by ticket in walk order (forward when the left side is
// compacted in place, backward when the right side is); see the note at
// the top of the file and segment_partition_inplace.cuh.  Two staging
// buffers: the next tile's rows stream in by cp.async while the block
// ranks and writes the current one, and the ticket after that is claimed
// meanwhile.  The next tile's flag is published only once its copies
// have landed, after the current tile's writes, which wait only for
// tiles before the current one in walk order; a claimed ticket without a
// flag is a block's next tile only once all before it have flags, so the
// lowest ticket without a flag always makes progress.
__global__ void __launch_bounds__(kMoveThreads)
part_move(float* payload, float* aux, int P, const int* __restrict__ sc,
          const unsigned char* __restrict__ bitset, int B, int T,
          const int* __restrict__ tile_left, const int* __restrict__ tile_off,
          const int* __restrict__ num_left, const float* __restrict__ fvals,
          int value_col, int* sync) {
  extern __shared__ float4 smem4[];
  const int nbuf = move_buffer_floats(T, P);
  float* bufs = reinterpret_cast<float*>(smem4);
  int* order = reinterpret_cast<int*>(bufs + 2 * nbuf);
  __shared__ int warp_left[32];
  __shared__ int s_ticket;
  __shared__ int s_claim[2];
  const long long start = sc[kStart];
  const int count = sc[kCount];
  const int col = sc[kCol];
  const int nl = *num_left;
  const bool fwd = left_in_place(nl, count);
  const int ntiles = (count + T - 1) / T;
  const float lv = fvals[0];
  const float rv = fvals[1];
  int* flags = sync + 1;
  auto tile_of = [&](int tk) { return fwd ? tk : ntiles - 1 - tk; };
  auto span_of = [&](int t) { return payload + (start + t * T) * P; };
  auto rows_of = [&](int t) { return min(T, count - t * T); };
  auto load = [&](int t, float* into) {
    load_span_async(into + phase16(span_of(t)), span_of(t), rows_of(t) * P);
  };

  int tk = next_ticket(sync, &s_ticket);
  if (tk >= ntiles) return;  // uniform per block
  float* buf = bufs;
  load(tile_of(tk), buf);
  cp_async_wait_all();
  publish_read(flags + tile_of(tk));
  int nk = next_ticket(sync, &s_ticket);
  float* next = bufs + nbuf;
  if (nk < ntiles) load(tile_of(nk), next);
  for (int it = 0;; ++it) {
    // the ticket after next, claimed while this tile is worked on (two
    // slots: a thread may still read the last one)
    if (threadIdx.x == 0) s_claim[it & 1] = atomicAdd(sync, 1);

    const int t = tile_of(tk);
    const int row0 = t * T;
    const int nr = rows_of(t);
    const int ph = phase16(span_of(t));
    // rank: order[] lists the tile's rows left rows first, each side in
    // row order; the leaf value goes into the staged value column
    const int lt = tile_left[t];
    int carry = 0;
    for (int r0 = 0; r0 < nr; r0 += blockDim.x) {  // uniform per block
      const int r = r0 + threadIdx.x;
      const int gl =
          r < nr ? go_left(buf[ph + r * P + col], sc, bitset, B) : 0;
      const int incl = block_inclusive_scan(gl, warp_left);
      const int tot = __syncthreads_count(gl);
      if (r < nr) {
        const int lb = carry + incl - gl;  // left rows before r
        order[gl ? lb : lt + (r - lb)] = r;
        buf[ph + r * P + value_col] = gl ? lv : rv;
      }
      carry += tot;
    }

    // the in-place side's rows land on consecutive rows: wait for the
    // tiles that hold them (at most two, none after this one in walk
    // order)
    const int off = tile_off[t];
    const int left0 = off;                 // segment row of the first left
    const int right0 = nl + row0 - off;    // ... and of the first right
    const int in0 = fwd ? left0 : right0;
    const int n_in = fwd ? lt : nr - lt;
    wait_read(flags, in0 / T, n_in > 0 ? (in0 + n_in - 1) / T : -1, 1);
    write_span((fwd ? payload : aux) + (start + left0) * P, buf, ph, order,
               lt, P);
    write_span((fwd ? aux : payload) + (start + right0) * P, buf, ph,
               order + lt, nr - lt, P);

    if (nk >= ntiles) break;  // uniform per block
    cp_async_wait_all();
    publish_read(flags + tile_of(nk));
    tk = nk;
    nk = s_claim[it & 1];
    float* done = buf;
    buf = next;
    next = done;
    if (nk < ntiles) load(tile_of(nk), next);
  }
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
  return P > 0 ? move_tile_rows(P) : 0;
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
                             int* tile_left, int* tile_off, int* num_left,
                             int* sync, int sms, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int T = move_tile_rows(P);
  const size_t smem = move_smem_bytes(P);
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
  part_scan_tiles<<<1, kTile, 0, s>>>(scalars, T, tile_left, tile_off,
                                      num_left);
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
