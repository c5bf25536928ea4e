// The in-place protocol of the whole partitions B2 (segment_partition.cu)
// and B8 (segment_partition_wide.cu), and the 16-byte copies they share
// with B3.
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
// side); the right side then goes through aux.  B2, B8 and the schedule
// test (tests/test_torch_partition_schedule.py) share this rule.
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

}  // namespace
