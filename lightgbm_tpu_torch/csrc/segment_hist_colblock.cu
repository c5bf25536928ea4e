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
// HBM at 3.35 TB/s.  Next come the F shared-memory updates per row, three
// cells each, whose random bins share banks a few ways deep.  sm_90 has no
// native f32 add on shared memory (atomicAdd(float) there is a
// compare-and-swap loop, ATOMS.CAST.SPIN); int32 adds are native.
//
// Design: a 2-D grid of row chunks (x) by column blocks of Fb <= 32 bin
// columns (y), two 512-thread blocks per SM, as many row chunks as keep
// the whole grid resident.  Each block keeps the histogram of its column
// block in shared memory as (grad, hess) float pairs [Fb, B + 1] and int32
// counts [Fb, B + 1] (exact; converted to f32 when the block flushes); the
// feature stride of B + 1 cells keeps the lanes of a warp, which add one
// row's consecutive features, in different banks when their bins agree.
//   - Staging: a tile of kRowTile rows at a time.  Warp w reads rows w,
//     w + 16, ... (each row's Fb bin columns in one coalesced load; lanes
//     0-2 load its grad, hess and count mask), and stores the bins as
//     uint16 and the values once per tile, not once per feature.  The next
//     tile's loads are issued into registers before the current tile is
//     accumulated, so they are in flight meanwhile.
//   - Accumulation: the lanes of a warp add one row's consecutive
//     features, (grad, hess) with one 64-bit compare-and-swap and the
//     count with a native int32 add.  The 16 warps of a block share the
//     cells, so a hot bin (a missing bin that holds a fifth of the rows,
//     say) makes their compare-and-swaps collide and retry: each lane sums
//     the rows of the first bin whose compare-and-swap met another warp's
//     in registers, and adds that sum once, after its rows.
//   - Flush: after its rows, a block adds its non-zero cells into the
//     zeroed output with global f32 atomics.
// Segment bounds are read from device memory, so the grower launches this
// without a host sync; blocks whose share of a small segment is empty exit
// at once.  Atomics make the order of the sums vary from run to run; the
// count channel is exact (integer values below 2^24).
// Designs without shared-memory atomics were built and measured slower on
// the card (PERF.md): warps owning features with lanes over rows, equal
// bins pre-summed after __match_any_sync or per-bit ballots, and lanes
// owning features outright (two warps per SM); finding the equal bins
// cost more than the compare-and-swap retries it removes.
// None of the TPU kernel's machinery (128-lane windows, the aux-column
// window DMA, one-hot matmuls, the bf16 hi/mid/lo split) carries over.

#include <cuda_runtime.h>
#include <string.h>

#include "segment_hist.cuh"  // add_pair

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kCols = 32;                        // bin columns per block, at most
constexpr int kRowTile = 128;                    // rows staged per tile
constexpr int kRowsPerWarp = kRowTile / kWarps;  // 8
constexpr int kBlocksPerSm = 2;
constexpr int kMaxSmemBytes = 110 * 1024;        // a block's, two per SM
// rows a block should have before one more block joins a segment: tiles
// of one block run one after another, so a small segment is spread over
// several blocks
constexpr int kMinRowsPerBlock = 1024;
constexpr unsigned short kNoBin = 0xFFFF;

// Shared memory of a block of Fb columns at B bins: the histogram (grad,
// hess) pairs and int32 counts [Fb, B + 1], the staged tile's values and
// bins [kRowTile, kCols].
__host__ __device__ inline int smem_bytes(int Fb, int B) {
  return Fb * (B + 1) * 12 + kRowTile * 3 * 4 + kRowTile * kCols * 2;
}

// *cell += (g, h) with one 64-bit compare-and-swap, if no other thread
// changed the cell meanwhile; false when one did
__device__ __forceinline__ bool try_add_pair(float2* cell, float g, float h) {
  unsigned long long* p = reinterpret_cast<unsigned long long*>(cell);
  const unsigned long long old = *p;
  float2 v;
  memcpy(&v, &old, sizeof(v));
  v.x += g;
  v.y += h;
  unsigned long long next;
  memcpy(&next, &v, sizeof(next));
  return atomicCAS(p, old, next) == old;
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
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

  // this lane's hot bin: the first bin whose compare-and-swap met another
  // warp's, and the sums of its rows since
  unsigned short hot = kNoBin;
  float hot_g = 0.f, hot_h = 0.f;
  int hot_c = 0;

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
      if (lane < 3) vals[rr * 3 + lane] = x[k];
    }
    __syncthreads();
    if (t + nblk < ntiles) load(t + nblk);
    // the lanes of a warp add one row's consecutive features; rows in the
    // lane's hot bin are summed in registers
    if (lane < fn) {
      for (int rr = warp; rr < nr; rr += kWarps) {
        const unsigned short b = bins[rr * kCols + lane];
        if (b == kNoBin) continue;  // outside the contract; never written
        const float g = vals[rr * 3];
        const float h = vals[rr * 3 + 1];
        const int c = static_cast<int>(vals[rr * 3 + 2]);
        if (b == hot) {
          hot_g += g;
          hot_h += h;
          hot_c += c;
          continue;
        }
        float2* cell = gh + lane * fstride + b;
        if (!try_add_pair(cell, g, h)) {
          if (hot == kNoBin) {  // the first contended bin becomes hot
            hot = b;
            hot_g = g;
            hot_h = h;
            hot_c = c;
            continue;
          }
          add_pair(cell, g, h);
        }
        atomicAdd(cnt + lane * fstride + b, c);
      }
    }
  }
  if (hot != kNoBin) {
    add_pair(gh + lane * fstride + hot, hot_g, hot_h);
    atomicAdd(cnt + lane * fstride + hot, hot_c);
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

// Bin columns per block at B bins: as many as one warp's lanes and the
// shared memory hold, at most F; 0 when not one column fits.
int segment_hist_colblock_cols(int F, int B) {
  int fb = kCols;
  while (fb > 0 && smem_bytes(fb, B) > kMaxSmemBytes) --fb;
  return fb < F ? fb : F;
}

// hist[F, B, 3] f32 over one segment: seg = int32[2] (start, count) on the
// device, out zeroed by the caller.  Fb = segment_hist_colblock_cols(F, B)
// columns per block; a grid of ceil(F / Fb) column blocks by as many row
// chunks as keep the whole grid resident on `sms` multiprocessors.
// Returns cudaGetLastError().
int segment_hist_colblock_launch(const float* payload, int P, const int* seg,
                                 float* out, int F, int B, int sms,
                                 int grad_col, int hess_col, int cnt_col,
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
      payload, P, seg, out, F, B, Fb, grad_col, hess_col, cnt_col);
  return static_cast<int>(cudaGetLastError());
}

const char* segment_hist_colblock_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
