// Segment histograms for Hopper (sm_90a): f32, int32 and batched.
//
// Replaces three TPU kernels of lightgbm_tpu/ops/pallas_segment.py with
// one kernel body (segment_hist.cuh), templated over the accumulator type
// and indexed over segments by blockIdx.z:
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
// integer-valued floats in [0, B); the count mask holds small integers
// (0 or 1 in the grower), summed exactly as int32.
//
// What bounds it on this card: each row of a segment is read once (F bin
// columns plus three value columns, count * (F + 3) * 4 bytes) and the
// output written once (F * B * 12 bytes), against HBM at 3.35 TB/s.  Next
// come the F shared-memory updates per row.  The grower calls B1 once at
// the root and then on each split's smaller child, mostly a few thousand
// rows or fewer, where what counts is spreading the work over the card.
//
// Design (segment_hist.cuh): a fixed grid of 2 blocks per SM (at least one
// per feature group the shared memory forces), sized on the host from the
// card alone; each block derives its work from the segment's count on the
// device: 128-row chunks, and feature groups when the segment has fewer
// chunks than the grid has blocks.  Rows are read by coalesced warp-wide
// loads, the next chunk's in flight while the current one is added; the
// cells are (grad, hess) pairs updated by one 64-bit compare-and-swap and
// int32 counts by the native shared add.  Segment bounds are read from
// device memory, so the grower launches this without a host sync.
//
// int32 (B4, B5 int32): each grad/hess value is converted exactly
// (__float2int_rn; the values are integers by construction).  Integer
// addition is order-free, so the result is bit-identical to the plain
// version at any grid; derive_qmax keeps rows * qmax below 2^31, so no
// cell overflows.  The TPU kernel stops at qmax <= 127 because its MXU
// operands are int8; int32 atomics have no such limit, so this one serves
// the int16 grid too.  Packing grad and hess into one wider atomic is later
// work.
//
// Batched (B5): blockIdx.z is the segment and every segment gets the same
// grid.x; sizing grid.x per segment is later work.
// None of the TPU kernels' machinery (8-row alignment, the bf16 hi/mid/lo
// split, one-hot matmuls, int8 MXU operands, DMA rings) carries over.

#include "segment_hist.cuh"

namespace {

// seg: [K, 2] int32 (start, count) per segment; out: [K, F, B, 3], zeroed
template <typename T>
__global__ void __launch_bounds__(kHistThreads, 2)
segment_hist_kernel(const float* __restrict__ payload, int P,
                    const int* __restrict__ seg, T* __restrict__ out, int F,
                    int B, int cap, int grad_col, int hess_col,
                    int cnt_col) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int z = blockIdx.z;
  T* dst = out + static_cast<long long>(z) * F * B * 3;
  hist_block<T>(payload, payload, P, seg[2 * z], seg[2 * z + 1], 0, 0, dst,
                dst, F, B, cap, grad_col, hess_col, cnt_col, blockIdx.x,
                gridDim.x, smem);
}

template <typename T>
int launch(const float* payload, int P, const int* seg, T* out, int K, int F,
           int B, int cap, int grad_col, int hess_col, int cnt_col, int grid,
           void* stream) {
  const int smem = hist_smem_bytes(cap, B);
  static int smem_set = -1;  // the opt-in last set for this instance
  if (smem != smem_set) {
    cudaError_t err = cudaFuncSetAttribute(
        segment_hist_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set = smem;
  }
  segment_hist_kernel<T><<<dim3(grid, 1, K), kHistThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      payload, P, seg, out, F, B, cap, grad_col, hess_col, cnt_col);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Histograms over K segments: seg = [K, 2] int32 (start, count) on the
// device, out = [K, F, B, 3] zeroed by the caller, int32 when quantized !=
// 0 (B4, and B5's int32 instance) else f32 (B1, B5).  cap: features per
// group at most (<= kHistGroupCols of segment_hist.cuh, and cap * (B + 1)
// * 12 bytes of shared memory); grid: blocks per segment, at least
// ceil(F / cap).  Returns cudaGetLastError(), or cudaErrorInvalidValue for
// a cap or grid outside those bounds.
int segment_hist_launch(const float* payload, int P, const int* seg,
                        void* out, int K, int F, int B, int cap, int grad_col,
                        int hess_col, int cnt_col, int grid, int quantized,
                        void* stream) {
  if (cap < 1 || cap > kHistGroupCols || grid < (F + cap - 1) / cap) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (quantized) {
    return launch<int>(payload, P, seg, static_cast<int*>(out), K, F, B, cap,
                       grad_col, hess_col, cnt_col, grid, stream);
  }
  return launch<float>(payload, P, seg, static_cast<float*>(out), K, F, B,
                       cap, grad_col, hess_col, cnt_col, grid, stream);
}

// The work split the kernel derives on the device (hist_split of
// segment_hist.cuh), computed on the host: out = {groups, group_cols,
// chunks0, chunks}, so a caller can hold its own copy of the split to it.
int segment_hist_split(int count0, int count1, int grid, int F, int cap,
                       int* out) {
  const HistSplit s = hist_split(count0, count1, grid, F, cap);
  out[0] = s.groups;
  out[1] = s.group_cols;
  out[2] = s.chunks0;
  out[3] = s.chunks;
  return 0;
}

const char* segment_hist_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
