// Column-block segment histogram for Hopper (sm_90a).
//
// Replaces the TPU kernel lightgbm_tpu/ops/pallas_segment.py
// segment_histogram_colblock -> _hist_colblock_kernel (B7), with B1's
// contract: hist[F, B, 3] f32 = sums of (grad, hess, count mask) per
// (feature, bin) over payload rows [start, start + count) of a row-major
// [N + GUARD, P] f32 payload whose bin columns hold integer-valued floats
// in [0, B).  It serves the wide payloads (F >= 889: Bosch- and
// Epsilon-shaped data), where B1's one-row-per-thread walk makes every
// warp-wide load touch 32 rows kilobytes apart.
//
// What bounds it on this card: each row of the segment is read once (F bin
// columns plus the three value columns, count * (F + 3) * 4 bytes) against
// HBM at 3.35 TB/s; the F shared-memory updates per row come next, and in
// practice set the pace: sm_90 has no native f32 add on shared memory
// (atomicAdd(float) there compiles to a compare-and-swap loop,
// ATOMS.CAST.SPIN), so B1 spends three such loops per row and feature.
//
// Design: a 2-D grid of row chunks (x) by feature-column blocks of Fb
// columns (y).  Each block keeps the histogram of its column block in
// shared memory as (grad, hess) float pairs [Fb, B + 1] and int32 counts
// [Fb, B + 1]: one 64-bit compare-and-swap adds both values of a row, and
// the count is a native integer atomic add (exact; converted to f32 when
// the block flushes).  The feature stride of B + 1 cells keeps the lanes of
// a warp, which add one row's consecutive features, in different banks
// even when the bins agree.  Rows are staged kRowTile at a
// time: each warp reads contiguous columns of one row (coalesced), with
// the loads of its kRowsPerWarp rows all issued before the first store, so
// enough bytes are in flight to cover HBM latency; the bins become uint16
// in shared memory, and the three value columns of the tile are read once,
// not once per feature.  Two blocks of 512 threads share an SM.  After its
// rows, a block adds its non-zero cells into the zeroed output with global
// atomics.  Segment bounds are read from device memory, so the grower
// launches this without a host sync; blocks whose share of a small segment
// is empty exit at once.
// f32 atomics make the order of the sums vary from run to run; the count
// channel is exact (integer values below 2^24).
// None of the TPU kernel's machinery (128-lane windows, the aux-column
// window DMA, one-hot matmuls, the bf16 hi/mid/lo split) carries over.

#include <cuda_runtime.h>
#include <string.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kRowTile = 128;                    // rows staged per tile
constexpr int kRowsPerWarp = kRowTile / kWarps;  // 8
// rows a block should have before one more block joins a segment: tiles
// of one block run one after another, so a small segment is spread over
// more blocks than in B1 (4096)
constexpr int kMinRowsPerBlock = 1024;
constexpr unsigned short kNoBin = 0xFFFF;

// *cell += (g, h) with one 64-bit compare-and-swap loop
__device__ __forceinline__ void add_pair(float2* cell, float g, float h) {
  unsigned long long* p = reinterpret_cast<unsigned long long*>(cell);
  unsigned long long old = *p;
  unsigned long long assumed;
  do {
    assumed = old;
    float2 v;
    memcpy(&v, &assumed, sizeof(v));
    v.x += g;
    v.y += h;
    unsigned long long next;
    memcpy(&next, &v, sizeof(next));
    old = atomicCAS(p, assumed, next);
  } while (old != assumed);
}

__global__ void __launch_bounds__(kThreads, 2)
hist_colblock_kernel(const float* __restrict__ payload, int P,
                     const int* __restrict__ seg, float* __restrict__ out,
                     int F, int B, int Fb, int grad_col, int hess_col,
                     int cnt_col) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int fstride = B + 1;
  float2* gh = reinterpret_cast<float2*>(smem);              // [Fb, fstride]
  int* cnt = reinterpret_cast<int*>(gh + Fb * fstride);      // [Fb, fstride]
  // the staged tile: three values and Fb bins for each of kRowTile rows
  float* vals = reinterpret_cast<float*>(cnt + Fb * fstride);
  unsigned short* bins =
      reinterpret_cast<unsigned short*>(vals + kRowTile * 3);

  const int start = seg[0];
  const int count = seg[1];
  const int want = (count + kMinRowsPerBlock - 1) / kMinRowsPerBlock;
  if (static_cast<int>(blockIdx.x) >= want) return;  // uniform per block
  const int nblk = min(want, static_cast<int>(gridDim.x));
  const int f0 = blockIdx.y * Fb;
  const int fn = min(Fb, F - f0);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int vcol = lane == 0 ? grad_col : (lane == 1 ? hess_col : cnt_col);

  for (int i = threadIdx.x; i < fn * fstride; i += kThreads) {
    gh[i] = make_float2(0.f, 0.f);
    cnt[i] = 0;
  }

  const int ntiles = (count + kRowTile - 1) / kRowTile;
  for (int t = blockIdx.x; t < ntiles; t += nblk) {
    const int r0 = t * kRowTile;
    const int nr = min(kRowTile, count - r0);
    const float* tile = payload + (static_cast<long long>(start) + r0) * P;
    __syncthreads();  // the previous tile (or the zeroing) is done
    // stage: warp w takes rows w, w + kWarps, ...; each of its loads is
    // issued before any is stored, so kRowsPerWarp rows are in flight
    for (int j0 = 0; j0 < fn; j0 += 32) {
      const int j = j0 + lane;
      float v[kRowsPerWarp];
      float x[kRowsPerWarp];
#pragma unroll
      for (int k = 0; k < kRowsPerWarp; ++k) {
        const int rr = warp + k * kWarps;
        const float* row = tile + static_cast<long long>(rr) * P;
        v[k] = (rr < nr && j < fn) ? row[f0 + j] : -1.f;
        x[k] = (j0 == 0 && rr < nr && lane < 3) ? row[vcol] : 0.f;
      }
#pragma unroll
      for (int k = 0; k < kRowsPerWarp; ++k) {
        const int rr = warp + k * kWarps;
        const int b = static_cast<int>(v[k]);
        if (rr < nr && j < fn) {
          bins[rr * Fb + j] =
              (b >= 0 && b < B) ? static_cast<unsigned short>(b) : kNoBin;
        }
        if (j0 == 0 && rr < nr && lane < 3) vals[rr * 3 + lane] = x[k];
      }
    }
    __syncthreads();
    // accumulate: the lanes of a warp add one row's consecutive features
    for (int rr = warp; rr < nr; rr += kWarps) {
      const float g = vals[rr * 3];
      const float h = vals[rr * 3 + 1];
      const int c = static_cast<int>(vals[rr * 3 + 2]);  // the 0/1 mask
      for (int j = lane; j < fn; j += 32) {
        const unsigned short b = bins[rr * Fb + j];
        if (b == kNoBin) continue;  // outside the contract; never written
        add_pair(gh + j * fstride + b, g, h);
        atomicAdd(cnt + j * fstride + b, c);
      }
    }
  }
  __syncthreads();

  float* dst = out + static_cast<long long>(f0) * B * 3;
  for (int i = threadIdx.x; i < fn * B; i += kThreads) {
    const int j = i / B;
    const int k = j * fstride + (i - j * B);
    const float2 p = gh[k];
    const float c = static_cast<float>(cnt[k]);
    if (p.x != 0.f) atomicAdd(dst + 3 * i, p.x);
    if (p.y != 0.f) atomicAdd(dst + 3 * i + 1, p.y);
    if (c != 0.f) atomicAdd(dst + 3 * i + 2, c);
  }
}

}  // namespace

extern "C" {

// Shared memory one block of Fb columns needs at B bins.
int segment_hist_colblock_smem_bytes(int Fb, int B) {
  return Fb * (B + 1) * 12 + kRowTile * 3 * 4 + kRowTile * Fb * 2;
}

// hist[F, B, 3] f32 over one segment: seg = int32[2] (start, count) on the
// device, out zeroed by the caller.  grid = (grid_x, ceil(F / Fb)); Fb
// columns per block, each block's shared memory as
// segment_hist_colblock_smem_bytes says.  Returns cudaGetLastError().
int segment_hist_colblock_launch(const float* payload, int P, const int* seg,
                                 float* out, int F, int B, int Fb,
                                 int grad_col, int hess_col, int cnt_col,
                                 int grid_x, void* stream) {
  const int smem = segment_hist_colblock_smem_bytes(Fb, B);
  cudaError_t err = cudaFuncSetAttribute(
      hist_colblock_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(grid_x, (F + Fb - 1) / Fb);
  hist_colblock_kernel<<<grid, kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      payload, P, seg, out, F, B, Fb, grad_col, hess_col, cnt_col);
  return static_cast<int>(cudaGetLastError());
}

const char* segment_hist_colblock_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
