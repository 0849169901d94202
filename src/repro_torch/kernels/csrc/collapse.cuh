// Warp collapse of equal adjacent ids under a combine operation: the sums
// (and counts) of scatter_sum.cuh and the min of order-preserving keys of
// segment_minmax.cu.
#pragma once

#include "common.cuh"

namespace repro {

// A run's partial sum and its row count.
template <typename T>
struct SumCount {
  T v;
  int c;
};

template <typename V>
__device__ inline V shfl_up(V x, int off) {
  return __shfl_up_sync(FULL_MASK, x, off);
}
template <typename T>
__device__ inline SumCount<T> shfl_up(SumCount<T> x, int off) {
  return {__shfl_up_sync(FULL_MASK, x.v, off),
          __shfl_up_sync(FULL_MASK, x.c, off)};
}

// Four consecutive rows of this lane (ids l, -1 where dropped; values v):
// runs of equal ids inside the lane and across adjacent lanes of the warp
// combine into one value with op(a, b) (associative and commutative), then
// each run is handed once to emit(id, value).  A warp with no pair of
// equal ids across lanes skips the scan.  The whole warp calls it together.
template <typename V, typename Op, typename Emit>
__device__ inline void collapse_runs(int (&l)[4], V (&v)[4], Op op,
                                     Emit&& emit) {
  const int lane = threadIdx.x & 31;
  bool tail[4];
#pragma unroll
  for (int j = 1; j < 4; ++j) {
    tail[j - 1] = l[j] != l[j - 1];
    if (!tail[j - 1]) v[j] = op(v[j], v[j - 1]);
  }
  tail[3] = true;
  const int prev_last = __shfl_up_sync(FULL_MASK, l[3], 1);
  const int next_first = __shfl_down_sync(FULL_MASK, l[0], 1);
  const bool joins_prev = lane > 0 && l[0] >= 0 && prev_last == l[0];
  const bool joins_next = lane < 31 && l[3] >= 0 && next_first == l[3];
  if (__any_sync(FULL_MASK, joins_prev)) {
    const bool whole = !tail[0] && !tail[1] && !tail[2];
    // segmented inclusive scan of each lane's last run across the warp
    V s = v[3];
    int open = !(whole && joins_prev);      // 1: a run starts in this lane
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const V o = shfl_up(s, off);
      const int oo = __shfl_up_sync(FULL_MASK, open, off);
      if (lane >= off) {
        if (!open) s = op(s, o);
        open |= oo;
      }
    }
    const V carry = shfl_up(s, 1);
    if (whole) {
      v[3] = s;
    } else if (joins_prev) {
      const int h = tail[0] ? 0 : (tail[1] ? 1 : 2);   // end of the head run
#pragma unroll
      for (int j = 0; j < 3; ++j)
        if (j == h) v[j] = op(v[j], carry);
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (tail[j] && l[j] >= 0 && !(j == 3 && joins_next)) emit(l[j], v[j]);
}

}  // namespace repro
