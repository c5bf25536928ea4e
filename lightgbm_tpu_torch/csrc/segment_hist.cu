// Segment histograms for Hopper (sm_90a): f32, int32 and batched.
//
// Replaces three TPU kernels of lightgbm_tpu/ops/pallas_segment.py with
// one kernel body (segment_hist.cuh), over K segments in one grid:
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
// f32 (B1, B5 f32): the sums are fixed point (segment_hist.cuh): each
// grad / hess value rounded to a multiple of 2^-s, summed exactly as int64,
// and the sum rounded once to f32, so the histogram is
// ops/segment.segment_histogram_fixed bit for bit at any grid and in any
// order.  int32 (B4, B5 int32): each grad/hess value is converted exactly
// (__float2int_rn; the values are integers by construction), and integer
// addition is order-free too; derive_qmax keeps rows * qmax below 2^31, so
// no cell overflows.  The TPU kernel stops at qmax <= 127 because its MXU
// operands are int8; int32 atomics have no such limit, so this one serves
// the int16 grid too.
//
// What bounds it on this card: each row of a segment is read once (F bin
// columns plus three value columns, count * (F + 3) * 4 bytes) and the
// output written once (F * B * 12 bytes), against HBM at 3.35 TB/s.  Next
// come the F shared-memory updates per row: five native 32-bit adds a
// fixed-point cell at most (two a channel, the high word's only when it
// changes, and the count), three an int32 cell.  The grower calls B1 once
// at the root and then on each split's smaller child, mostly a few
// thousand rows or fewer, and B5 on a frontier round's K smaller children,
// where what counts is spreading the work over the card.
//
// Design (segment_hist.cuh): a fixed grid of 2 blocks per SM (at least one
// per feature group the shared memory forces), sized on the host from the
// card alone; each block derives its work from the segments' counts on
// the device: the K segments' 128-row chunks numbered one after another
// and cut into one run of consecutive chunks per block, and feature groups
// when there are fewer chunks than the grid has blocks.  So B5's K
// segments share one grid, and a block flushes only where its run passes
// from one segment to the next.  Rows are read by coalesced warp-wide
// loads, the next chunk's in flight while the current one is added.
// Segment bounds are read from device memory, so the grower launches this
// without a host sync.
// None of the TPU kernels' machinery (8-row alignment, the bf16 hi/mid/lo
// split, one-hot matmuls, int8 MXU operands, DMA rings) carries over.

#include "segment_hist.cuh"

namespace {

// seg: [K, 2] int32 (start, count) per segment; the f32 instance writes fo
// (segment_hist.cuh's FixedOut), the int32 one adds into iout [K, F, B, 3],
// zeroed by the caller.  B1 and B4 launch segment_hist_kernel, B5
// segment_hist_batched_kernel: one body under two names, so a profile
// tells them apart.
#define SEGMENT_HIST_KERNEL(name)                                           \
  template <bool Fixed>                                                     \
  __global__ void __launch_bounds__(kHistThreads, 2)                        \
  name(const float* __restrict__ payload, int P, int rows,                  \
       const int* __restrict__ seg, int K, int* iout, FixedOut fo, int F,   \
       int B, int cap, int grad_col, int hess_col, int cnt_col) {           \
    extern __shared__ __align__(16) unsigned char smem[];                   \
    for (int k = 0; k < K; ++k) {                                           \
      CHECK_SEGMENT(#name, seg[2 * k], seg[2 * k + 1], rows);               \
    }                                                                       \
    hist_block<Fixed>(SegTable{payload, seg, P}, K, P, iout, fo, F, B, cap, \
                      grad_col, hess_col, cnt_col, blockIdx.x, gridDim.x,   \
                      smem);                                                \
  }
SEGMENT_HIST_KERNEL(segment_hist_kernel)
SEGMENT_HIST_KERNEL(segment_hist_batched_kernel)
#undef SEGMENT_HIST_KERNEL

template <typename Kernel>
int launch(Kernel kernel, int* smem_set, const float* payload, int P,
           int rows, const int* seg, int K, int* iout, const FixedOut& fo,
           int F, int B, int cap, int grad_col, int hess_col, int cnt_col,
           int grid, bool fixed, void* stream) {
  const int smem = hist_smem_bytes(cap, B, fixed);
  if (smem != *smem_set) {  // the opt-in last set for this kernel
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    *smem_set = smem;
  }
  kernel<<<grid, kHistThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      payload, P, rows, seg, K, iout, fo, F, B, cap, grad_col, hess_col,
      cnt_col);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Histograms over K segments: seg = [K, 2] int32 (start, count) on the
// device, each inside the payload's `rows` rows (checked on the device:
// segment_check.cuh).  quantized != 0 (B4, and B5's int32 instance): out =
// int32 [K, F, B, 3] zeroed by the caller.  Else (B1, B5): out = f32 [K, F,
// B, 3], every cell written here; scale = int32 [2], the fixed-point
// exponents of grad and hess (ops/segment.fixed_scale); scratch_gh = int64
// [K, F, B, 2] and scratch_cnt = int32 [K, F, B], zero on entry; tickets =
// int32 [K, F] (one per segment and feature group at most), zero on entry;
// all three are left zero.  cap: features per group at most (<=
// kHistGroupCols of segment_hist.cuh, and hist_smem_bytes(cap, B, f32) of
// shared memory); grid: the blocks, at least ceil(F / cap).  batched != 0
// launches the kernel under B5's name.  raw != 0 (f32 mode only): out =
// int64 [K, F, B, 3], each cell's exact integer sums (grad and hess at
// the exponents, count), not converted.  Returns cudaGetLastError(), or
// cudaErrorInvalidValue for a cap or grid outside those bounds.
int segment_hist_launch(const float* payload, int P, int rows,
                        const int* seg,
                        void* out, int K, int F, int B, int cap, int grad_col,
                        int hess_col, int cnt_col, int grid, int quantized,
                        int batched, const int* scale,
                        unsigned long long* scratch_gh, int* scratch_cnt,
                        int* tickets, int raw, void* stream) {
  if (cap < 1 || cap > kHistGroupCols || grid < (F + cap - 1) / cap) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  static int smem_set[2][2] = {{-1, -1}, {-1, -1}};
  int* set = &smem_set[batched ? 1 : 0][quantized ? 0 : 1];
  if (quantized) {
    return launch(batched ? segment_hist_batched_kernel<false>
                          : segment_hist_kernel<false>,
                  set, payload, P, rows, seg, K, static_cast<int*>(out),
                  FixedOut{},
                  F, B, cap, grad_col, hess_col, cnt_col, grid, false,
                  stream);
  }
  const FixedOut fo{scratch_gh, scratch_cnt, static_cast<float*>(out),
                    tickets, scale, raw};
  return launch(batched ? segment_hist_batched_kernel<true>
                        : segment_hist_kernel<true>,
                set, payload, P, rows, seg, K, nullptr, fo, F, B, cap, grad_col,
                hess_col, cnt_col, grid, true, stream);
}

// The work split the kernel derives on the device (hist_split and hist_run
// of segment_hist.cuh), computed on the host for K segments of counts[K]
// rows: out = {groups, group_cols, chunks, then for each block of the
// grid its group, first chunk, end chunk, workers of its group and 1 if it
// works}, 3 + 5 * grid ints, so a caller can hold its own copy of the
// split to it.
int segment_hist_split(const int* counts, int K, int grid, int F, int cap,
                       int* out) {
  int chunks = 0;
  for (int k = 0; k < K; ++k) {
    chunks += (counts[k] + kHistChunkRows - 1) / kHistChunkRows;
  }
  const HistSplit s = hist_split(chunks, grid, F, cap);
  out[0] = s.groups;
  out[1] = s.group_cols;
  out[2] = s.chunks;
  for (int b = 0; b < grid; ++b) {
    const HistRun r = hist_run(s, b, grid);
    int* o = out + 3 + 5 * b;
    o[0] = r.group;
    o[1] = r.first;
    o[2] = r.last;
    o[3] = r.workers;
    o[4] = r.works ? 1 : 0;
  }
  return 0;
}

const char* segment_hist_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
