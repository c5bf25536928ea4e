// The in-place protocol of the whole partitions B2 (segment_partition.cu),
// B3 and B8 (segment_partition_wide.cu), the 16-byte copies they share,
// and the whole-row tile kernels' bodies that B2 and B3 launch under
// their own names and tile geometry (count_tiles, move_tiles).
//
// A whole partition leaves payload[start, start + count) partitioned and
// num_left set; aux over [start, start + count) is scratch, as in the JAX
// package's Pallas kernels, and nothing outside the segment is written.
// Once the count and scan have given num_left and each tile's left
// offset, the larger side is compacted in place in the payload (left rows
// move to lower rows, so their tiles are walked forward; right rows move
// to higher rows, walked backward) and the smaller side goes to aux at
// the rows it will hold in the payload; a second, short launch copies that
// one contiguous range of aux back.  Each row is read once and written
// once, plus the smaller side's copy.
//
// The hazard: an in-place write may only land on rows that their own
// tile has already read.  Tiles take tickets from a device counter in
// walk order, and a tile publishes a "read" flag once its rows are in
// shared memory.  A tile then waits for the tiles whose rows its in-place
// rows land on: those lie at or before it in walk order, so they hold
// lower tickets.  A block streams its next tile in while it writes the
// current one and publishes the next tile's flag after those writes; the
// lowest ticket without a flag is then either a block's first tile
// (published before any wait) or the next tile of a block whose current
// tile waits only on lower, flagged tickets, so the waits cannot
// deadlock.  The flag is released after a __threadfence() and read with
// an acquire load, so a write never overtakes the read it waited for.
// The count launch clears the ticket and the flags, so no memset is
// launched.  The payload is read by cp.async into shared memory, never
// through the read-only path: it is written while the kernel runs.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "segment_partition.cuh"

namespace {

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;"
               :: "l"(p), "r"(v) : "memory");
}

// The next ticket for the whole block (sync[0] is the counter).  Every
// thread must call it; the barrier before the fetch also frees the
// shared memory of the previous tile.
__device__ __forceinline__ int next_ticket(int* counter, int* s_ticket) {
  __syncthreads();
  if (threadIdx.x == 0) *s_ticket = atomicAdd(counter, 1);
  __syncthreads();
  return *s_ticket;
}

// Publish that the block's tile has been read: every thread must call it
// once its loads have landed in shared memory.
__device__ __forceinline__ void publish_read(int* flag) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    st_release(flag, 1);
  }
}

// Wait until flags[j * stride] is set for every j in [j0, j1] (none when
// j1 < j0).  Every thread must call it.
__device__ __forceinline__ void wait_read(const int* flags, int j0, int j1,
                                          int stride) {
  if (threadIdx.x == 0) {
    for (int j = j0; j <= j1; ++j) {
      const int* f = flags + static_cast<long long>(j) * stride;
      while (ld_acquire(f) == 0) __nanosleep(64);
    }
  }
  __syncthreads();
}

// A pointer's offset in floats within 16 bytes.
__device__ __forceinline__ int phase16(const float* p) {
  return static_cast<int>(reinterpret_cast<uintptr_t>(p) / 4 % 4);
}

// 16 bytes global -> shared without passing through registers (both
// 16-byte aligned); cached in L2 only.  A block issues a tile's copies,
// commits them as a group, and waits for them before it publishes the
// tile as read.
__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
               :: "r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
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
  const int mis_s = phase16(src);
  const int mis_d = phase16(dst);
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

// True when the left side is compacted in place (it is not the smaller
// side); the right side then goes through aux.  B2, B3, B8 and the
// schedule test (tests/test_torch_partition_schedule.py) share this rule.
__device__ __forceinline__ bool left_in_place(int num_left, int count) {
  return num_left >= count - num_left;
}

// The smaller side's rows aux -> payload over the grid: rows
// [start + num_left, start + count) when the left side was compacted in
// place, else [start, start + num_left).  Their leaf values were written
// on the way into aux.
__device__ __forceinline__ void copy_smaller_side(
    float* __restrict__ payload, const float* __restrict__ aux, int P,
    const int* __restrict__ sc, const int* __restrict__ num_left) {
  const int count = sc[kCount];
  const int nl = *num_left;
  const bool fwd = left_in_place(nl, count);
  const long long base =
      (static_cast<long long>(sc[kStart]) + (fwd ? nl : 0)) * P;
  const long long rows = fwd ? count - nl : nl;
  copy_span(aux + base, payload + base, rows * P,
            static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x,
            static_cast<long long>(gridDim.x) * blockDim.x);
}


// ---- whole-row tiles: the count and the move of B2 and B3 ---------------
//
// A tile is T consecutive rows of the segment, staged as one contiguous
// span of T * P floats; each side of a tile is written as one contiguous
// span too, so rows of any width move with 16-byte stores.

constexpr int kMaxSmemBytes = 227 * 1024;  // a block's, on sm_90

// Rows per tile at width P with stage_bytes per staging buffer: as many as
// fill it, a multiple of 32 where that leaves any; one row where a row is
// wider, while two of them fit a block's shared memory; else 0.
inline int move_tile_rows(int P, int stage_bytes) {
  const int t = stage_bytes / (4 * P);
  if (t == 0) return 8 * (P + 8) <= kMaxSmemBytes ? 1 : 0;
  return t >= 32 ? t - t % 32 : t;
}

// Floats per staging buffer: a tile's span with up to three floats before
// it (to keep its offset within 16 bytes), rounded to 16 bytes.
__host__ __device__ inline int move_buffer_floats(int T, int P) {
  return (T * P + 4 + 3) & ~3;
}

// move_tiles' dynamic shared memory: two staging buffers and the tile's
// rows in destination order.
inline size_t move_smem_bytes(int T, int P) {
  return static_cast<size_t>(2 * move_buffer_floats(T, P)) * 4 + (T + 1) * 4;
}

// A persistent grid counts the left rows of every T-row tile of the
// segment and clears its "read" flag (sync[1 + tile]); block 0 clears the
// ticket counter (sync[0]).  The routing column is read once, one sector
// per row where a row is wider than a sector.  A tile of at most 32 rows
// is counted by one warp (its lanes' loads are all that is in flight, so
// the warps take tiles apart, with no barrier); a taller tile by the whole
// block, a thread per row.
__device__ __forceinline__ void count_tiles(
    const float* __restrict__ payload, int P, const int* __restrict__ sc,
    const unsigned char* __restrict__ bitset, int B, int T,
    int* __restrict__ tile_left, int* __restrict__ sync) {
  __shared__ int s_left;
  if (blockIdx.x == 0 && threadIdx.x == 0) sync[0] = 0;
  const long long start = sc[kStart];
  const int count = sc[kCount];
  const int col = sc[kCol];
  const int ntiles = (count + T - 1) / T;
  const int lane = threadIdx.x & 31;
  auto count_rows = [&](int t, int r0, int step) {
    const int nr = min(T, count - t * T);
    const float* c0 = payload + (start + t * T) * P + col;
    int n = 0;
#pragma unroll 4
    for (int r = r0; r < nr; r += step) {
      n += go_left(c0[static_cast<long long>(r) * P], sc, bitset, B);
    }
    return __reduce_add_sync(0xffffffffu, n);
  };
  if (T <= 32) {  // uniform per launch
    const int warps = blockDim.x >> 5;
    for (int t = blockIdx.x * warps + (threadIdx.x >> 5); t < ntiles;
         t += gridDim.x * warps) {
      const int n = count_rows(t, lane, 32);
      if (lane == 0) {
        tile_left[t] = n;
        sync[1 + t] = 0;
      }
    }
    return;
  }
  if (threadIdx.x == 0) s_left = 0;
  __syncthreads();
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const int n = count_rows(t, threadIdx.x, blockDim.x);
    if (lane == 0 && n) atomicAdd(&s_left, n);
    __syncthreads();
    if (threadIdx.x == 0) {
      tile_left[t] = s_left;
      s_left = 0;
      sync[1 + t] = 0;
    }
    __syncthreads();
  }
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
// the top of the file.  Two staging buffers (move_smem_bytes): the next
// tile's rows stream in by cp.async while the block ranks and writes the
// current one, and the ticket after that is claimed meanwhile.  The next
// tile's flag is published only once its copies have landed, after the
// current tile's writes, which wait only for tiles before the current one
// in walk order; a claimed ticket without a flag is a block's next tile
// only once all before it have flags, so the lowest ticket without a flag
// always makes progress.
__device__ __forceinline__ void move_tiles(
    float* payload, float* aux, int P, const int* __restrict__ sc,
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

}  // namespace
