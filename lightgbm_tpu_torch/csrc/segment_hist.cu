// Segment histogram for Hopper (sm_90a).
//
// Replaces the TPU kernel lightgbm_tpu/ops/pallas_segment.py
// segment_histogram -> _hist_kernel: hist[F, B, 3] = sums of (grad, hess,
// count mask) per (feature, bin) over payload rows [start, start + count).
// The payload is row-major [N + GUARD, P] f32; bin values are
// integer-valued floats in [0, B).
//
// What bounds it on this card: each row is read once (F bin columns plus
// three value columns, n * (F + 3) * 4 bytes), so the floor is HBM at
// 3.35 TB/s.  The work in between is F * 3 shared-memory atomic adds per
// row, and with F = 28 those, not the bytes, are what this simple first
// version spends its time on.
//
// Design: each block keeps a private [Ft, B, 3] f32 histogram in shared
// memory (86 KB at Ft = 28, B = 256, so it needs the dynamic-shared-memory
// opt-in above 48 KB), walks its share of the segment's rows with a
// grid-stride loop adding with shared-memory atomicAdd, then adds its
// non-zero cells into the zeroed global output with global atomics.
// Features are tiled over blockIdx.y so any F fits at B <= 256.  start and
// count are read from device memory, so the grower launches this without
// a host sync; a block whose share of a small segment would be empty exits
// before it clears its shared memory, which keeps small segments cheap.
// None of the TPU kernel's machinery (8-row alignment, the bf16 hi/mid/lo
// split, one-hot matmuls, DMA rings) carries over.
//
// Float atomics make the order of the sums vary from run to run; results
// agree with the serial CPU sum to f32 summation-order tolerance and the
// count channel is exact (integer values below 2^24).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
// rows a block should have before one more block joins a segment
constexpr int kMinRowsPerBlock = 4096;

__global__ void __launch_bounds__(kThreads)
segment_hist_kernel(const float* __restrict__ payload, int P,
                    const int* __restrict__ seg, float* __restrict__ out,
                    int F, int B, int Ft, int grad_col, int hess_col,
                    int cnt_col) {
  extern __shared__ float cells[];  // [fn, B, 3]
  const int start = seg[0];
  const int count = seg[1];
  const int want = (count + kMinRowsPerBlock - 1) / kMinRowsPerBlock;
  if (static_cast<int>(blockIdx.x) >= want) return;  // uniform per block
  const int nblk = min(want, static_cast<int>(gridDim.x));
  const int f0 = blockIdx.y * Ft;
  const int fn = min(Ft, F - f0);
  const int ncell = fn * B * 3;

  for (int i = threadIdx.x; i < ncell; i += blockDim.x) cells[i] = 0.f;
  __syncthreads();

  const long long stride = static_cast<long long>(nblk) * blockDim.x;
  for (long long r = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       r < count; r += stride) {
    const float* row = payload + (static_cast<long long>(start) + r) * P;
    const float g = row[grad_col];
    const float h = row[hess_col];
    const float c = row[cnt_col];
    for (int j = 0; j < fn; ++j) {
      const int b = static_cast<int>(row[f0 + j]);
      if (b < 0 || b >= B) continue;  // outside the contract; never written
      float* cell = cells + (j * B + b) * 3;
      atomicAdd(cell, g);
      atomicAdd(cell + 1, h);
      atomicAdd(cell + 2, c);
    }
  }
  __syncthreads();

  float* dst = out + static_cast<long long>(f0) * B * 3;
  for (int i = threadIdx.x; i < ncell; i += blockDim.x) {
    const float v = cells[i];
    if (v != 0.f) atomicAdd(dst + i, v);
  }
}

}  // namespace

extern "C" {

// hist over payload rows [seg[0], seg[0] + seg[1]) into `out` ([F, B, 3],
// zeroed by the caller).  grid = (grid_x, ceil(F / Ft)); Ft * B * 3 floats
// of dynamic shared memory per block.  Returns cudaGetLastError().
int segment_hist_launch(const float* payload, int P, const int* seg,
                        float* out, int F, int B, int Ft, int grad_col,
                        int hess_col, int cnt_col, int grid_x,
                        void* stream) {
  const size_t smem = static_cast<size_t>(Ft) * B * 3 * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      segment_hist_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(grid_x, (F + Ft - 1) / Ft);
  segment_hist_kernel<<<grid, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      payload, P, seg, out, F, B, Ft, grad_col, hess_col, cnt_col);
  return static_cast<int>(cudaGetLastError());
}

const char* segment_hist_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
