// Merged segment partition + both children's histograms for Hopper
// (sm_90a).
//
// Replaces the TPU kernel lightgbm_tpu/ops/pallas_segment.py
// partition_segment_hist -> _acc_kernel(hist_cfg=...) (B6), with its
// contract: B2's stable partition of payload rows [start, start + count)
// by the split predicate (left rows first, the partitioned rows left in
// aux over the same range, copied back into payload with left_value /
// right_value in value_col, num_left reported on the device), plus the
// two children's [F, B, 3] f32 histograms of (grad, hess, count mask),
// taken from the same read of the parent's rows.  The grower's merged
// mode calls it once per split in place of B2 + B1 on the smaller child
// + the subtraction, so no parent histogram or pool is kept.
//
// What bounds it on this card: every row of the segment is read once and
// written once (2 * count * P * 4 bytes) and the two histograms are
// written once (2 * F * B * 12 bytes), against HBM at 3.35 TB/s.  The F
// shared-memory updates per row come next: sm_90 has no native f32 add on
// shared memory, so, as in B7, (grad, hess) is one 64-bit compare-and-swap
// and the count an int32 with the native atomic add (exact; converted
// to f32 when the block flushes).
//
// Design: B2's stage and commit (segment_partition.cuh) with the scatter
// widened into the histogram pass.
//   1. part_count: the tile counts, after the blocks have zeroed the two
//      output histograms (no separate launch clears them);
//   2. part_scan: the tile offsets and num_left;
//   3. part_hist_scatter: a 2-D grid of row blocks (x) by feature tiles
//      of Ft columns (y).  Both children's histograms at the main path's
//      shape are 2 * 28 * 255 * 12 B = 171 KB, past the shared memory of a
//      block that leaves room for two per SM, so the features are tiled:
//      each block keeps the left and right histograms of its Ft features
//      in shared memory.  It walks its 1024-row tiles (grid-stride over
//      x), ranks each tile's rows as B2 does, and moves its own columns of
//      those rows into aux (the last feature tile also moves the value
//      columns, so every column moves once); each bin value it moves is
//      added into the left or the right histogram by the side of its row
//      (its destination against start + num_left).  After its tiles it
//      adds its non-zero cells into the zeroed output with global atomics;
//   4. part_copyback: B2's commit, aux -> payload with the leaf values.
// Rows move as raw 32-bit copies, so payload, aux and num_left are
// byte-identical to B2's (and the plain version's); the count channel is
// exact, grad / hess agree with the plain sums to f32 summation order
// (atomics make that order vary from run to run).  Like B1, a block of x
// whose share of a small segment would be empty exits at once.
// None of the TPU kernel's machinery (one-hot matmuls, the bf16 part
// split, the VMEM accumulator rings) carries over.

#include <string.h>

#include "segment_partition.cuh"

namespace {

// rows a block of x should have before one more joins a segment (B1's)
constexpr int kMinRowsPerBlock = 4096;

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

// hist: [2, F, Bh, 3] f32 (left, then right), zeroed by part_count
__global__ void __launch_bounds__(kTile)
part_hist_scatter(const float* __restrict__ payload, float* __restrict__ aux,
                  int P, const int* __restrict__ sc,
                  const unsigned char* __restrict__ bitset, int B,
                  const int* __restrict__ tile_off,
                  const int* __restrict__ num_left, float* __restrict__ hist,
                  int F, int Bh, int Ft, int grad_col, int hess_col,
                  int cnt_col) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int warp_left[32];
  // the feature stride of Bh + 1 cells keeps the lanes of a warp, which
  // add one row's consecutive features, in different banks
  const int fstride = Bh + 1;
  const int ncell = 2 * Ft * fstride;
  float2* gh = reinterpret_cast<float2*>(smem);           // [2, Ft, fstride]
  int* cnt = reinterpret_cast<int*>(gh + ncell);          // [2, Ft, fstride]
  float* vals = reinterpret_cast<float*>(cnt + ncell);    // [kTile, 3]
  int* dest = reinterpret_cast<int*>(vals + 3 * kTile);   // [kTile]

  const int start = sc[kStart];
  const int count = sc[kCount];
  const int want = (count + kMinRowsPerBlock - 1) / kMinRowsPerBlock;
  if (static_cast<int>(blockIdx.x) >= want) return;  // uniform per block
  const int nblk = min(want, static_cast<int>(gridDim.x));
  const int ntiles = (count + kTile - 1) / kTile;
  const int f0 = blockIdx.y * Ft;
  const int fn = min(Ft, F - f0);
  // the columns this block moves: its features, and on the last feature
  // tile every column after them
  const int cw = (blockIdx.y == gridDim.y - 1 ? P : f0 + fn) - f0;
  const int split = start + *num_left;  // first row of the right child
  const int t = threadIdx.x;

  for (int i = t; i < ncell; i += kTile) {
    gh[i] = make_float2(0.f, 0.f);
    cnt[i] = 0;
  }

  for (int tile = blockIdx.x; tile < ntiles; tile += nblk) {
    const int row0 = tile * kTile;
    const int nrows = min(kTile, count - row0);
    __syncthreads();  // the previous tile's dest / vals are done with
    const int d = tile_dest(payload, P, sc, bitset, B, tile, tile_off[tile],
                            split - start, warp_left);
    const float* rows = payload + (static_cast<long long>(start) + row0) * P;
    if (t < nrows) {
      dest[t] = d;
      const float* row = rows + static_cast<long long>(t) * P;
      vals[3 * t] = row[grad_col];
      vals[3 * t + 1] = row[hess_col];
      vals[3 * t + 2] = row[cnt_col];
    }
    __syncthreads();
    // consecutive threads take consecutive columns of a row
    const int total = nrows * cw;
    for (int e = t; e < total; e += kTile) {
      const int rr = e / cw;
      const int c = e - rr * cw;
      const float v = rows[static_cast<long long>(rr) * P + f0 + c];
      const int dr = dest[rr];
      aux[static_cast<long long>(dr) * P + f0 + c] = v;
      if (c >= fn) continue;  // a value column: moved, not counted
      const int b = static_cast<int>(v);
      if (b < 0 || b >= Bh) continue;  // outside the contract; never written
      const int k = ((dr >= split ? Ft : 0) + c) * fstride + b;
      add_pair(gh + k, vals[3 * rr], vals[3 * rr + 1]);
      atomicAdd(cnt + k, static_cast<int>(vals[3 * rr + 2]));
    }
  }
  __syncthreads();

  for (int i = t; i < 2 * fn * Bh; i += kTile) {
    const int side = i / (fn * Bh);
    const int j = (i - side * fn * Bh) / Bh;
    const int b = i - side * fn * Bh - j * Bh;
    const int k = (side * Ft + j) * fstride + b;
    float* dst =
        hist + ((static_cast<long long>(side) * F + f0 + j) * Bh + b) * 3;
    const float2 p = gh[k];
    const float c = static_cast<float>(cnt[k]);
    if (p.x != 0.f) atomicAdd(dst, p.x);
    if (p.y != 0.f) atomicAdd(dst + 1, p.y);
    if (c != 0.f) atomicAdd(dst + 2, c);
  }
}

}  // namespace

extern "C" {

int segment_partition_hist_tile_rows() { return kTile; }

// Dynamic shared memory one block of Ft features needs at Bh bins.
int segment_partition_hist_smem_bytes(int Ft, int Bh) {
  return 2 * Ft * (Bh + 1) * 12 + kTile * 4 * 4;
}

// The merged partition (kernels 1-4).  scalars: int32[11] on the device
// (start, count, col, threshold, default_left, is_cat, missing_type,
// num_bin, default_bin, offset, identity); bitset: uint8[B], the bytes of a
// bool tensor; fvals: f32[2] (left, right value) on the device.
// tile_left / tile_off: int32[n_tiles] scratch with n_tiles * 1024 >= the
// largest count; num_left: one int32 on the device.  hist: f32
// [2, F, Bh, 3] (left, then right), zeroed here.  grid of the scatter =
// (grid_x, ceil(F / Ft)), each block's shared memory as
// segment_partition_hist_smem_bytes says; copy_blocks bounds the
// copy-back's grid.  Returns cudaGetLastError().
int segment_partition_hist_launch(float* payload, float* aux, int P,
                                  const int* scalars,
                                  const unsigned char* bitset, int B,
                                  int n_tiles, int* tile_left, int* tile_off,
                                  int* num_left, const float* fvals,
                                  int value_col, float* hist, int F, int Bh,
                                  int Ft, int grad_col, int hess_col,
                                  int cnt_col, int grid_x, int copy_blocks,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int smem = segment_partition_hist_smem_bytes(Ft, Bh);
  cudaError_t err = cudaFuncSetAttribute(
      part_hist_scatter, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  part_count<<<n_tiles, kTile, 0, s>>>(payload, P, scalars, bitset, B,
                                       tile_left, hist, 2 * F * Bh * 3);
  part_scan<<<scan_blocks(n_tiles), kTile, 0, s>>>(scalars, tile_left,
                                                   tile_off, num_left);
  const dim3 grid(grid_x, (F + Ft - 1) / Ft);
  part_hist_scatter<<<grid, kTile, smem, s>>>(
      payload, aux, P, scalars, bitset, B, tile_off, num_left, hist, F, Bh,
      Ft, grad_col, hess_col, cnt_col);
  part_copyback<<<copy_blocks, kCopyThreads, 0, s>>>(
      payload, aux, P, scalars, num_left, fvals, value_col);
  return static_cast<int>(cudaGetLastError());
}

const char* segment_partition_hist_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
