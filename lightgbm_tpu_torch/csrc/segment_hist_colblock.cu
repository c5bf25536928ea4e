// Column-block segment histogram for Hopper (sm_90a).
//
// Replaces the TPU kernel lightgbm_tpu/ops/pallas_segment.py
// segment_histogram_colblock -> _hist_colblock_kernel (B7), with B1's
// contract: hist[F, B, 3] f32 = sums of (grad, hess, count mask) per
// (feature, bin) over payload rows [start, start + count) of a row-major
// [N + GUARD, P] f32 payload whose bin columns hold integer-valued floats
// in [0, B), and whose count mask is 0 or 1.  It serves the wide payloads
// (F >= 889: Bosch- and Epsilon-shaped data), where B1's one-row-per-thread
// walk makes every warp-wide load touch 32 rows kilobytes apart.
//
// What bounds it on this card: each row of the segment is read once (F bin
// columns plus the three value columns, count * (F + 3) * 4 bytes) against
// HBM at 3.35 TB/s.  Next come the F shared-memory updates per row, five
// native 32-bit adds a cell at most, whose random bins share banks a few
// ways deep.
//
// Order-free sums: grad and hess are B1's fixed point (segment_hist.cuh):
// each value rounded to a multiple of 2^-s and summed exactly as a 64-bit
// integer (two 32-bit words in shared memory, native adds with a carry;
// native 64-bit atomics into an int64 scratch), the last block of each
// column block writing its f32 cells once every block has flushed.  So the
// histogram is ops/segment.segment_histogram_fixed bit for bit.
//
// Design: a 2-D grid of row chunks (x) by column blocks of Fb <= 32 bin
// columns (y), one 1024-thread block per SM, as many row chunks as keep
// the whole grid resident.  Each block keeps the histogram of its column
// block in shared memory, [Fb, stride] fixed-point cells (stride = (B + 1)
// | 1, so the lanes of a warp, which add one row's consecutive features,
// sit in different banks when their bins agree).  A cell takes 20 bytes,
// so 32 columns at 255 bins take 161 KB: one block an SM holds them (two
// 512-thread blocks held 19 columns each, and each row's staging was
// repeated over 1.7 times the column blocks: 9.6 ms at the Bosch root
// against 6.4, PERF.md).
//   - Staging: a tile of kRowTile rows at a time.  Warp w reads rows w,
//     w + 16, ... (each row's Fb bin columns in one coalesced load; lanes
//     0-2 load its grad, hess and count mask), and stores the bins as
//     uint16 and the values once per tile, already in fixed point, not once
//     per feature.  The next tile's loads are issued into registers before
//     the current tile is accumulated, so they are in flight meanwhile.
//   - Accumulation: the lanes of a warp add one row's consecutive
//     features with native adds, which never retry: a hot bin (a missing
//     bin that holds a fifth of the rows) costs no more than any other (a
//     per-lane register sum of a hot bin, which the f32 compare-and-swap
//     needed, read slower here: 9.6 against 7.5 ms).
//   - Flush: after its rows, a block adds its non-zero cells into the int64
//     scratch with native 64-bit global atomics; the last block of the
//     column block converts.
// Segment bounds are read from device memory, so the grower launches this
// without a host sync; blocks whose share of a small segment is empty exit
// at once.
// Designs without shared-memory atomics were built and measured slower on
// the card (PERF.md): warps owning features with lanes over rows, equal
// bins pre-summed after __match_any_sync or per-bit ballots, and lanes
// owning features outright (two warps per SM); finding the equal bins
// cost more than the atomics they remove.
// None of the TPU kernel's machinery (128-lane windows, the aux-column
// window DMA, one-hot matmuls, the bf16 hi/mid/lo split) carries over.

#include <cuda_runtime.h>

#include "segment_hist.cuh"  // the fixed-point cells, flush and conversion

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kCols = 32;                        // bin columns per block, at most
constexpr int kRowTile = 128;                    // rows staged per tile
constexpr int kRowsPerWarp = kRowTile / kWarps;  // 4
constexpr int kBlocksPerSm = 1;
constexpr int kMaxSmemBytes = 220 * 1024;        // a block's, one per SM
// rows a block should have before one more block joins a segment: tiles
// of one block run one after another, so a small segment is spread over
// several blocks
constexpr int kMinRowsPerBlock = 1024;
constexpr unsigned short kNoBin = 0xFFFF;

// Shared memory of a block of Fb columns at B bins: the staged tile's
// fixed-point (grad, hess) and counts [kRowTile] and bins [kRowTile,
// kCols], then the histogram's fixed-point cells [Fb, stride].
__host__ __device__ inline int smem_bytes(int Fb, int B) {
  return kRowTile * (16 + 4) + kRowTile * kCols * 2 +
         Fb * hist_stride(B) * kHistCellBytesFixed;
}

// seg: int32 [2] (start, count); fo: segment_hist.cuh's FixedOut for one
// segment, one ticket per column block
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
hist_colblock_kernel(const float* __restrict__ payload, int P, int rows,
                     const int* __restrict__ seg, FixedOut fo, int F, int B,
                     int Fb, int grad_col, int hess_col, int cnt_col) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int stride = hist_stride(B);
  // the staged tile: fixed-point (grad, hess), counts and Fb bins for each
  // of kRowTile rows
  longlong2* qv = reinterpret_cast<longlong2*>(smem);          // [kRowTile]
  int* cv = reinterpret_cast<int*>(qv + kRowTile);             // [kRowTile]
  unsigned short* bins =
      reinterpret_cast<unsigned short*>(cv + kRowTile);        // [kRowTile, kCols]

  CHECK_SEGMENT("segment_histogram_colblock", seg[0], seg[1], rows);
  const int start = seg[0];
  const int count = seg[1];
  // at least one block, which writes the output of an empty segment
  const int want = max(1, (count + kMinRowsPerBlock - 1) / kMinRowsPerBlock);
  if (static_cast<int>(blockIdx.x) >= want) return;  // uniform per block
  const int nblk = min(want, static_cast<int>(gridDim.x));
  const int f0 = blockIdx.y * Fb;
  const int fn = min(Fb, F - f0);
  FixedCells cells(reinterpret_cast<unsigned char*>(bins + kRowTile * kCols),
                   fn * stride, pow2f(fo.scale[0]), pow2f(fo.scale[1]));
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int vcol = lane == 0 ? grad_col : (lane == 1 ? hess_col : cnt_col);

  cells.clear(fn * stride);

  // this warp's rows of a tile, in flight in registers: lane j's bin
  // column j (-1 past the segment) and, on lanes 0-2, a value column
  float v[kRowsPerWarp];
  float x[kRowsPerWarp];
  const int ntiles = (count + kRowTile - 1) / kRowTile;
  auto load = [&](int t) {
    const int r0 = t * kRowTile;
    const int nr = min(kRowTile, count - r0);
    const float* tile = payload + (static_cast<long long>(start) + r0) * P;
#pragma unroll
    for (int k = 0; k < kRowsPerWarp; ++k) {
      const int rr = warp + k * kWarps;
      const float* row = tile + static_cast<long long>(rr) * P;
      v[k] = (rr < nr && lane < fn) ? row[f0 + lane] : -1.f;
      x[k] = (rr < nr && lane < 3) ? row[vcol] : 0.f;
    }
  };

  int t = blockIdx.x;
  if (t < ntiles) load(t);
  for (; t < ntiles; t += nblk) {
    const int nr = min(kRowTile, count - t * kRowTile);
    __syncthreads();  // the previous tile (or the zeroing) is done
#pragma unroll
    for (int k = 0; k < kRowsPerWarp; ++k) {
      const int rr = warp + k * kWarps;
      const int b = static_cast<int>(v[k]);
      if (lane < fn) {
        bins[rr * kCols + lane] =
            (b >= 0 && b < B) ? static_cast<unsigned short>(b) : kNoBin;
      }
      if (lane == 0) qv[rr].x = to_fixed(x[k], cells.mg);
      if (lane == 1) qv[rr].y = to_fixed(x[k], cells.mh);
      if (lane == 2) cv[rr] = __float2int_rn(x[k]);
    }
    __syncthreads();
    if (t + nblk < ntiles) load(t + nblk);
    // the lanes of a warp add one row's consecutive features
    if (lane < fn) {
      for (int rr = warp; rr < nr; rr += kWarps) {
        const unsigned short b = bins[rr * kCols + lane];
        if (b == kNoBin) continue;  // outside the contract; never written
        const longlong2 q = qv[rr];
        cells.add_q(lane * stride + b, q.x, q.y, cv[rr]);
      }
    }
  }
  __syncthreads();
  flush_fixed(cells, fo, static_cast<long long>(f0) * B, fn, B, stride);
  __threadfence();
  __syncthreads();
  convert_if_last(fo, fo.tickets + blockIdx.y, nblk,
                  static_cast<long long>(f0) * B, fn * B);
}

}  // namespace

extern "C" {

// Bin columns per block at B bins: as many as one warp's lanes and the
// shared memory hold, at most F; 0 when not one column fits.
int segment_hist_colblock_cols(int F, int B) {
  int fb = kCols;
  while (fb > 0 && smem_bytes(fb, B) > kMaxSmemBytes) --fb;
  return fb < F ? fb : F;
}

// hist[F, B, 3] f32 over one segment: seg = int32[2] (start, count) on the
// device, inside the payload's `rows` rows (checked on the device); out:
// every cell written here; scale = int32 [2], the fixed-point exponents of
// grad and hess (ops/segment.fixed_scale); scratch_gh = int64 [F, B, 2],
// scratch_cnt = int32 [F, B] and tickets = int32 [F], zero on entry and
// left zero.  Fb = segment_hist_colblock_cols(F, B) columns per
// block; a grid of ceil(F / Fb) column blocks by as many row chunks as
// keep the whole grid resident on `sms` multiprocessors.  raw != 0: out
// is int64 [F, B, 3], each cell's exact integer sums, not converted
// (segment_hist.cuh's FixedOut).  Returns
// cudaGetLastError().
int segment_hist_colblock_launch(const float* payload, int P, int rows,
                                 const int* seg,
                                 float* out, int F, int B, int sms,
                                 int grad_col, int hess_col, int cnt_col,
                                 const int* scale,
                                 unsigned long long* scratch_gh,
                                 int* scratch_cnt, int* tickets, int raw,
                                 void* stream) {
  const int Fb = segment_hist_colblock_cols(F, B);
  if (Fb < 1 || B < 1 || B >= kNoBin) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int smem = smem_bytes(Fb, B);
  cudaError_t err = cudaFuncSetAttribute(
      hist_colblock_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int ncb = (F + Fb - 1) / Fb;
  const dim3 grid(max(1, kBlocksPerSm * sms / ncb), ncb);
  hist_colblock_kernel<<<grid, kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      payload, P, rows, seg,
      FixedOut{scratch_gh, scratch_cnt, out, tickets, scale, raw}, F, B, Fb,
      grad_col, hess_col, cnt_col);
  return static_cast<int>(cudaGetLastError());
}

const char* segment_hist_colblock_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
