// Segment sum with optional per-segment row counts: the Reduce stage.
//
// Replaces repro/kernels/segment_reduce.py: segment_sum_counts_mxu and
// segment_sum_mxu (one kernel, counts on or off).  The TPU turns a segment
// sum into a one-hot matmul on its matrix unit, O(N * K) work that a
// block-skip trims for sorted ids.  On the H100 the natural form is a
// scatter-add: one thread per (row, column) adds its value into out[seg, col]
// with an atomic, and the column-0 thread of a row also adds 1 to
// counts[seg].  Ids outside [0, K) are dropped, exactly as the one-hot
// never matches them.  Ids need not be sorted: the initial run reduces
// before it sorts.
//
// Numbers: int32 sums use integer atomics and are exact.  float32 atomics
// add in an order that changes from run to run, so float sums agree with a
// sequential sum only to reordering of additions; sums of integer-valued
// floats below 2^24 are exact in any order.
//
// What bounds it: device-memory bytes (read seg and vals once, write the
// [K, D] output); the atomics land in the 50 MB L2 for the K of the main
// path (2^18 + 1 segments, 1 MB).
#include "common.cuh"

namespace {

constexpr int THREADS = 256;

template <typename T>
__global__ void segment_sum_kernel(const int32_t* __restrict__ seg,
                                   const T* __restrict__ vals,
                                   T* __restrict__ out,
                                   int32_t* __restrict__ counts, long long n,
                                   int d, int k) {
  const long long total = n * d;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    const long long row = i / d;
    const int col = (int)(i - row * d);
    const int s = seg[row];
    if (s < 0 || s >= k) continue;
    atomicAdd(&out[(long long)s * d + col], vals[i]);
    if (counts != nullptr && col == 0) atomicAdd(&counts[s], 1);
  }
}

}  // namespace

// seg: [n] int32; vals: [n, d] float32 (is_float) or int32, contiguous;
// out: [k, d] same type; counts: [k] int32 or null.  Zeroes the outputs
// on the stream, then adds.
REPRO_EXPORT int segment_sum_launch(const void* seg, const void* vals,
                                    void* out, void* counts, long long n,
                                    int d, int k, int is_float,
                                    void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (k <= 0) return (int)cudaGetLastError();
  cudaMemsetAsync(out, 0, (size_t)k * d * 4, stream);
  if (counts != nullptr) cudaMemsetAsync(counts, 0, (size_t)k * 4, stream);
  if (n > 0 && d > 0) {
    const int grid = repro::grid_for(n * d, THREADS);
    if (is_float) {
      segment_sum_kernel<float><<<grid, THREADS, 0, stream>>>(
          (const int32_t*)seg, (const float*)vals, (float*)out,
          (int32_t*)counts, n, d, k);
    } else {
      segment_sum_kernel<int><<<grid, THREADS, 0, stream>>>(
          (const int32_t*)seg, (const int*)vals, (int*)out, (int32_t*)counts,
          n, d, k);
    }
  }
  return (int)cudaGetLastError();
}
