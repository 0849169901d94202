// Shared helpers of the port's hand-written kernels.
//
// Each source file builds into its own shared library with a plain C
// interface (loaded from Python with ctypes).  Every exported launcher
// takes raw device pointers and the caller's CUDA stream, allocates
// nothing, never synchronises, and returns cudaGetLastError() so that a
// refused launch surfaces in the Python wrapper as an exception.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define REPRO_EXPORT extern "C" __attribute__((visibility("default")))

namespace repro {

constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr int SM_COUNT = 132;      // H100 SXM

// Grid for a grid-stride loop over `work` items: enough blocks to fill
// every SM several times over, never more than the work needs.
inline int grid_for(long long work, int threads) {
  long long blocks = (work + threads - 1) / threads;
  long long cap = (long long)SM_COUNT * 16;
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  return (int)blocks;
}

// Slot of `key` in `keys[0..cap)` (sorted ascending, unique among real
// entries, padded with INT32_MAX), or -1 when absent.  Left-bound binary
// search plus an equality test: the same slot as the composed path's
// searchsorted + membership test.
__device__ inline int find_slot(const int32_t* keys, int cap, int32_t key) {
  int lo = 0, hi = cap;
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    if (keys[mid] < key) lo = mid + 1; else hi = mid;
  }
  return (lo < cap && keys[lo] == key) ? lo : -1;
}

}  // namespace repro

REPRO_EXPORT const char* repro_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
