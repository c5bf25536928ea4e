// Segment histograms for Hopper (sm_90a): f32, int32 and batched.
//
// Replaces three TPU kernels of lightgbm_tpu/ops/pallas_segment.py with
// one kernel body, templated over the accumulator type and indexed over
// segments by blockIdx.z:
//   - segment_histogram -> _hist_kernel (B1): hist[F, B, 3] f32 = sums of
//     (grad, hess, count mask) per (feature, bin) over payload rows
//     [start, start + count);
//   - segment_histogram_quant -> _hist_quant_kernel (B4): the same sums in
//     int32 over the integer-valued grad/hess columns of the quantized
//     mode (gradient_quantization);
//   - segment_histogram_batched -> _hist_batched_kernel (B5):
//     hist[K, F, B, 3] over K disjoint segments, slice k equal to the
//     single-segment histogram of segment k; instantiated for f32 and, for
//     the quantized frontier grower, for int32.
// The payload is row-major [N + GUARD, P] f32; bin values are
// integer-valued floats in [0, B).
//
// What bounds it on this card: each row of a segment is read once (F bin
// columns plus three value columns, count * (F + 3) * 4 bytes), so the
// floor is HBM at 3.35 TB/s.  The work in between is F * 3 shared-memory
// atomic adds per row, and with F = 28 those, not the bytes, are what this
// simple version spends its time on.
//
// Design: each block keeps a private [Ft, B, 3] histogram in shared memory
// (86 KB at Ft = 28, B = 256, so it needs the dynamic-shared-memory opt-in
// above 48 KB), walks its share of its segment's rows with a grid-stride
// loop adding with shared-memory atomicAdd, then adds its non-zero cells
// into the zeroed global output with global atomics.  Features are tiled
// over blockIdx.y so any F fits at B <= 256.  Segment bounds are read from
// device memory, so the grower launches this without a host sync; a block
// whose share of a small segment would be empty exits before it clears
// its shared memory, which keeps small segments cheap.
//
// int32 (B4, B5 int32): each grad/hess value is converted exactly
// (__float2int_rn; the values are integers by construction) and the count
// channel is the 0/1 mask.  Integer addition is order-free, so the result
// is bit-identical to the plain version at any grid; derive_qmax keeps
// rows * qmax below 2^31, so no cell overflows.  The TPU kernel stops at
// qmax <= 127 because its MXU operands are int8; int32 atomics have no
// such limit, so this one serves the int16 grid too.  Packing grad and
// hess into one wider atomic is later work.
//
// Batched (B5): blockIdx.z is the segment and every segment gets the same
// grid.x, so small segments leave most of their blocks idle (they exit at
// once, but are still scheduled).  Sizing grid.x per segment is later
// work.
//
// f32 atomics make the order of the sums vary from run to run; f32 results
// agree with the serial CPU sum to f32 summation-order tolerance and the
// count channel is exact (integer values below 2^24).
// None of the TPU kernels' machinery (8-row alignment, the bf16 hi/mid/lo
// split, one-hot matmuls, int8 MXU operands, DMA rings) carries over.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
// rows a block should have before one more block joins a segment
constexpr int kMinRowsPerBlock = 4096;

template <typename T>
__device__ __forceinline__ T to_acc(float v);
template <>
__device__ __forceinline__ float to_acc<float>(float v) { return v; }
template <>
__device__ __forceinline__ int to_acc<int>(float v) {
  return __float2int_rn(v);
}

// seg: [K, 2] int32 (start, count) per segment; out: [K, F, B, 3], zeroed
template <typename T>
__global__ void __launch_bounds__(kThreads)
segment_hist_kernel(const float* __restrict__ payload, int P,
                    const int* __restrict__ seg, T* __restrict__ out, int F,
                    int B, int Ft, int grad_col, int hess_col, int cnt_col) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* cells = reinterpret_cast<T*>(smem);  // [fn, B, 3]
  const int z = blockIdx.z;
  const int start = seg[2 * z];
  const int count = seg[2 * z + 1];
  const int want = (count + kMinRowsPerBlock - 1) / kMinRowsPerBlock;
  if (static_cast<int>(blockIdx.x) >= want) return;  // uniform per block
  const int nblk = min(want, static_cast<int>(gridDim.x));
  const int f0 = blockIdx.y * Ft;
  const int fn = min(Ft, F - f0);
  const int ncell = fn * B * 3;

  for (int i = threadIdx.x; i < ncell; i += blockDim.x) cells[i] = T(0);
  __syncthreads();

  const long long stride = static_cast<long long>(nblk) * blockDim.x;
  for (long long r = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       r < count; r += stride) {
    const float* row = payload + (static_cast<long long>(start) + r) * P;
    const T g = to_acc<T>(row[grad_col]);
    const T h = to_acc<T>(row[hess_col]);
    const T c = to_acc<T>(row[cnt_col]);
    for (int j = 0; j < fn; ++j) {
      const int b = static_cast<int>(row[f0 + j]);
      if (b < 0 || b >= B) continue;  // outside the contract; never written
      T* cell = cells + (j * B + b) * 3;
      atomicAdd(cell, g);
      atomicAdd(cell + 1, h);
      atomicAdd(cell + 2, c);
    }
  }
  __syncthreads();

  T* dst = out + (static_cast<long long>(z) * F + f0) * B * 3;
  for (int i = threadIdx.x; i < ncell; i += blockDim.x) {
    const T v = cells[i];
    if (v != T(0)) atomicAdd(dst + i, v);
  }
}

template <typename T>
int launch(const float* payload, int P, const int* seg, T* out, int K, int F,
           int B, int Ft, int grad_col, int hess_col, int cnt_col,
           int grid_x, void* stream) {
  const size_t smem = static_cast<size_t>(Ft) * B * 3 * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      segment_hist_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(grid_x, (F + Ft - 1) / Ft, K);
  segment_hist_kernel<T><<<grid, kThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      payload, P, seg, out, F, B, Ft, grad_col, hess_col, cnt_col);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Histograms over K segments: seg = [K, 2] int32 (start, count) on the
// device, out = [K, F, B, 3] zeroed by the caller, int32 when quantized !=
// 0 (B4, and B5's int32 instance) else f32 (B1, B5).  grid = (grid_x,
// ceil(F / Ft), K); Ft * B * 3 * 4 bytes of dynamic shared memory per
// block.  Returns cudaGetLastError().
int segment_hist_launch(const float* payload, int P, const int* seg,
                        void* out, int K, int F, int B, int Ft, int grad_col,
                        int hess_col, int cnt_col, int grid_x, int quantized,
                        void* stream) {
  if (quantized) {
    return launch<int>(payload, P, seg, static_cast<int*>(out), K, F, B, Ft,
                       grad_col, hess_col, cnt_col, grid_x, stream);
  }
  return launch<float>(payload, P, seg, static_cast<float*>(out), K, F, B,
                       Ft, grad_col, hess_col, cnt_col, grid_x, stream);
}

const char* segment_hist_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
