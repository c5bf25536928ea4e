// The device-side bound check of every partition and histogram kernel: a
// segment [start, start + count) must lie inside the payload's rows.  The
// kernels read start and count from device memory (the grower never syncs
// to launch them), so the host cannot check them; each kernel checks the
// scalars it loads anyway before it touches a row.  A segment outside the
// payload makes block 0's first thread print the entry and the segment and
// fail a device assertion (the launch's CUDA error is then "device-side
// assert triggered"), while every other thread returns: nothing is read
// or written out of range, and no launch waits for the host.  On the card
// the check costs B1 and B2 2-4 % a call and B7 6-9 %; taking a bad
// segment as empty instead of returning (no early exit) cost B2 and B5
// more and B7 less (PERF.md).
#pragma once

#include <assert.h>
#include <stdio.h>

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ bool segment_outside(long long start,
                                                long long count, int rows) {
  return start < 0 || count < 0 || start + count > rows;
}

// The failure, out of line: the kernels' own code holds only the compare
// and a call that never runs on a good segment.
__device__ __noinline__ void segment_fault(const char* entry, long long start,
                                           long long count, int rows) {
  printf("%s: segment [%lld, %lld) outside the payload's %d rows\n", entry,
         start, start + count, rows);
  assert(!"segment outside the payload's rows");
}

}  // namespace

// Returns from the calling kernel when [start, start + count) is not
// inside [0, rows); `entry` names the kernel in the message.
#define CHECK_SEGMENT(entry, start, count, rows)                            \
  do {                                                                      \
    const long long cs_start_ = (start);                                    \
    const long long cs_count_ = (count);                                    \
    if (segment_outside(cs_start_, cs_count_, (rows))) {                    \
      if (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0) {         \
        segment_fault((entry), cs_start_, cs_count_, (rows));               \
      }                                                                     \
      return;                                                               \
    }                                                                       \
  } while (0)
