// Segment min / max: the Reduce stage of min and max reducers (SSSP).
//
// Replaces repro/kernels/segment_reduce.py: segment_minmax_mxu.  The TPU
// folds 8-row chunks into a stationary [kblk, D] accumulator in VMEM, one
// grid cell per (row tile, segment block), which is O(N K / kblk) work.
// On the H100 the natural form is a scatter: the output is first filled
// with the identity on the stream, then one thread per (row, column)
// folds its value into out[seg, col] with an atomic.  Ids outside [0, K)
// are dropped, as the reference's padding never lands in a real block.
//
// Identity: +inf / -inf for float32 (what XLA's segment_min / max leave in
// an empty segment), INT32_MAX / INT32_MIN for int32, not the finfo
// extreme: SSSP reads +inf as "no in-edge left".  Invalid rows never reach
// the output (the dispatcher gives them the out-of-range id K).
//
// float32 has no atomicMin / atomicMax, so the kernel works on the bits.
// For min: a value with the sign bit clear takes atomicMin on the bits as
// a signed int (non-negative floats order like their bits, and any
// negative float in memory is a negative int, which stays); a value with
// the sign bit set takes atomicMax on the bits as unsigned (negative
// floats order in reverse of their magnitude bits, and any non-negative
// float in memory is a smaller unsigned, which loses).  Max mirrors it.
// The result is exact and does not depend on the order of the atomics, so
// the kernel equals its plain version bit for bit on data without NaN.
// Signed zeros: the bit order puts -0.0 below +0.0, so a segment holding
// both yields -0.0 for min and +0.0 for max, where scatter_reduce treats
// them as equal and may return either.  The engine never meets that case
// (SSSP distances are d + w with w >= 0, and the root emits +0.0), and
// the equality checks keep -0.0 out of their data.
//
// What bounds it: device-memory bytes (read seg and vals once, write the
// [K, D] output twice: the fill and the folds).  At SSSP's main path
// (N = (2^22 + 1) * 16 rows, half of them padding, D = 1, K = 2^22) the
// 16 MB output sits in the 50 MB L2, so the atomics rarely reach device
// memory.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;

template <typename T>
__global__ void fill_kernel(T* __restrict__ out, long long total, T value) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    out[i] = value;
  }
}

template <bool IS_MIN>
__device__ inline void fold(float* addr, float v) {
  const int bits = __float_as_int(v);
  if (IS_MIN) {
    if (bits >= 0) atomicMin((int*)addr, bits);
    else atomicMax((unsigned int*)addr, (unsigned int)bits);
  } else {
    if (bits >= 0) atomicMax((int*)addr, bits);
    else atomicMin((unsigned int*)addr, (unsigned int)bits);
  }
}

template <bool IS_MIN>
__device__ inline void fold(int* addr, int v) {
  if (IS_MIN) atomicMin(addr, v);
  else atomicMax(addr, v);
}

template <typename T, bool IS_MIN>
__global__ void segment_minmax_kernel(const int32_t* __restrict__ seg,
                                      const T* __restrict__ vals,
                                      T* __restrict__ out, long long n, int d,
                                      int k) {
  const long long total = n * d;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    const long long row = i / d;
    const int col = (int)(i - row * d);
    const int s = seg[row];
    if (s < 0 || s >= k) continue;
    fold<IS_MIN>(&out[(long long)s * d + col], vals[i]);
  }
}

template <typename T, bool IS_MIN>
void launch(const int32_t* seg, const T* vals, T* out, long long n, int d,
            int k, T ident, cudaStream_t stream) {
  const long long total_out = (long long)k * d;
  fill_kernel<T><<<repro::grid_for(total_out, THREADS), THREADS, 0, stream>>>(
      out, total_out, ident);
  if (n > 0) {
    segment_minmax_kernel<T, IS_MIN>
        <<<repro::grid_for(n * d, THREADS), THREADS, 0, stream>>>(
            seg, vals, out, n, d, k);
  }
}

}  // namespace

// seg: [n] int32; vals: [n, d] float32 (is_float) or int32, contiguous;
// out: [k, d] same type.  Fills out with the identity on the stream, then
// folds every row whose id lies in [0, k).
REPRO_EXPORT int segment_minmax_launch(const void* seg, const void* vals,
                                       void* out, long long n, int d, int k,
                                       int is_float, int is_min,
                                       void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (k <= 0 || d <= 0) return (int)cudaGetLastError();
  const int32_t* s = (const int32_t*)seg;
  if (is_float) {
    const float inf = INFINITY;
    if (is_min) {
      launch<float, true>(s, (const float*)vals, (float*)out, n, d, k, inf,
                          stream);
    } else {
      launch<float, false>(s, (const float*)vals, (float*)out, n, d, k, -inf,
                           stream);
    }
  } else {
    if (is_min) {
      launch<int, true>(s, (const int*)vals, (int*)out, n, d, k, INT32_MAX,
                        stream);
    } else {
      launch<int, false>(s, (const int*)vals, (int*)out, n, d, k, INT32_MIN,
                         stream);
    }
  }
  return (int)cudaGetLastError();
}
