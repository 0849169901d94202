// Segment min / max: the Reduce stage of min and max reducers (SSSP).
//
// Replaces repro/kernels/segment_reduce.py: segment_minmax_mxu.  The TPU
// folds 8-row chunks into a stationary [kblk, D] accumulator in VMEM, one
// grid cell per (row tile, segment block), which is O(N K / kblk) work.
// On the H100 it is a scatter, as the segment sum is.  Ids outside [0, K)
// are dropped, as the reference's padding never lands in a real block.
//
// Identity: +inf / -inf for float32 (what XLA's segment_min / max leave in
// an empty segment), INT32_MAX / INT32_MIN for int32, not the finfo
// extreme: SSSP reads +inf as "no in-edge left".  Invalid rows never reach
// the output (the dispatcher gives them the out-of-range id K).
//
// What bounds it (tools/scatter_probes.py; NVIDIA H100 80GB HBM3, 700 W):
// one global atomic a row runs at the L2's reduction rate, ~73 G/s beside
// a stream that reads the rows (probe f), about two and a half times the
// time of reading them.  Min and max are idempotent and the stored value
// only moves toward the result, so a row could read out[id] first and
// skip its atomic where it cannot win.  Probe (g) measured that skip test
// losing: at SSSP's run shape a load a row costs more than the
// fire-and-forget red.global.min it saves (0.576 ms against 0.465 with
// rows in random order; 0.430 in increasing order, its best case; 0.679
// in decreasing order, its worst).  So no row loads `out`; the one skip
// kept is free: a row holding the identity (SSSP's unreached vertices
// emit +inf) cannot win and drops before any memory access.
//
// Order-preserving keys: a float maps to bits ^ (sign ? 0xFFFFFFFF :
// 0x80000000), an int32 to bits ^ 0x80000000, and max complements the key,
// so one unsigned min decides every case: min and max, float32 and int32.
//
// One pass after the identity fill, at every K.  At D = 1 a thread takes 4
// rows with one 16-byte load of ids and one of values, drops rows out of
// range (or at the identity) before touching `out`, collapses equal ids
// adjacent in the warp to their least key (collapse.cuh: sorted ids, hot
// ids) and folds each run with one red.global.  D > 1 is a thread a (row,
// column).  Small inputs take smaller blocks, so that the grid still
// spreads over the SMs.  No block folds into a private slab of keys in
// shared memory: at SSSP's refresh (N 2^17, K 16,384, ids ascending as the
// composed merge gives them) a slab a block measured 0.0051 ms of device
// time against 0.0046 for this pass with 1,024-thread blocks and 0.0035
// with the blocks sized to the SMs.
// The output in device memory holds the values' own bits, since the pass
// folds straight into it: float32 takes the two-branch fold (a
// non-negative value takes a signed atomic on its bits, a negative one an
// unsigned atomic of the other sense; probe g timed it equal to one
// atomicMin on keys).  Storing keys would add a decoding pass.
//
// The result is exact and does not depend on the order of the atomics, so
// the kernel equals its plain version bit for bit on data without NaN.
// Signed zeros: the key order puts -0.0 below +0.0, so a segment holding
// both yields -0.0 for min and +0.0 for max, where scatter_reduce treats
// them as equal and may return either.  The engine never meets that case
// (SSSP distances are d + w with w >= 0, and the root emits +0.0), and
// the equality checks keep -0.0 out of their data.
#include <math.h>

#include <algorithm>

#include "collapse.cuh"
#include "common.cuh"

namespace {

constexpr int THREADS = 1024;                // most threads a block
constexpr int MIN_THREADS = 128;
constexpr int FILL_THREADS = 256;

// order-preserving u32 key (ascending as the values)
__device__ inline uint32_t bits_key(float v) {
  const uint32_t b = __float_as_uint(v);
  return b ^ ((uint32_t)((int32_t)b >> 31) | 0x80000000u);
}
__device__ inline uint32_t bits_key(int v) { return (uint32_t)v ^ 0x80000000u; }

template <typename T>
__device__ inline T from_bits(int b) { return b; }
template <>
__device__ inline float from_bits<float>(int b) { return __int_as_float(b); }

// the key one unsigned min decides on: max complements it
template <typename T, bool IS_MIN>
__device__ inline uint32_t okey(T v) {
  return IS_MIN ? bits_key(v) : ~bits_key(v);
}
template <typename T>
__device__ inline T key_value(uint32_t k);
template <>
__device__ inline float key_value<float>(uint32_t k) {
  return __uint_as_float((k & 0x80000000u) ? k ^ 0x80000000u : ~k);
}
template <>
__device__ inline int key_value<int>(uint32_t k) {
  return (int)(k ^ 0x80000000u);
}
template <typename T, bool IS_MIN>
__device__ inline T from_okey(uint32_t k) {
  return key_value<T>(IS_MIN ? k : ~k);
}

// atomic min (max) of v into *addr, on the value's own bits
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

// Rows [row, row + 4) before `end` and their keys, ids -1 past it, out of
// [0, k) or at the identity (whose key `ident` no row can go below): 16-byte
// loads where the quad is whole and aligned.
template <typename T, bool IS_MIN>
__device__ inline void load_quad(const int32_t* __restrict__ seg,
                                 const T* __restrict__ vals, long long row,
                                 long long end, int k, bool aligned,
                                 uint32_t ident, int (&l)[4],
                                 uint32_t (&key)[4]) {
  int id[4];
  T v[4];
  if (aligned && row + 3 < end) {
    const int4 s4 = __ldcs(reinterpret_cast<const int4*>(seg + row));
    const int4 v4 = __ldcs(reinterpret_cast<const int4*>(vals + row));
    id[0] = s4.x; id[1] = s4.y; id[2] = s4.z; id[3] = s4.w;
    v[0] = from_bits<T>(v4.x); v[1] = from_bits<T>(v4.y);
    v[2] = from_bits<T>(v4.z); v[3] = from_bits<T>(v4.w);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      id[j] = -1;
      v[j] = 0;
      if (row + j < end) {
        id[j] = seg[row + j];
        v[j] = vals[row + j];
      }
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    key[j] = okey<T, IS_MIN>(v[j]);
    l[j] = id[j] >= 0 && id[j] < k && key[j] < ident ? id[j] : -1;
  }
}

template <typename T>
__global__ void fill_kernel(T* __restrict__ out, long long total, T value) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x)
    out[i] = value;
}

// direct, D = 1: two quads a thread an iteration, both loaded before either
// folds; whole warps iterate together (collapse_runs shuffles)
template <typename T, bool IS_MIN>
__global__ void __launch_bounds__(THREADS)
    direct_kernel(const int32_t* __restrict__ seg, const T* __restrict__ vals,
                  T* __restrict__ out, long long n, int k, int aligned,
                  T ident) {
  const uint32_t ident_key = okey<T, IS_MIN>(ident);
  const long long quads = (n + 3) / 4;
  const long long stride = 2ll * gridDim.x * blockDim.x;
  for (long long base = 2ll * blockIdx.x * blockDim.x; base < quads;
       base += stride) {
    int l[2][4];
    uint32_t key[2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h)
      load_quad<T, IS_MIN>(seg, vals,
                           4 * (base + h * blockDim.x + threadIdx.x), n, k,
                           aligned, ident_key, l[h], key[h]);
#pragma unroll
    for (int h = 0; h < 2; ++h)
      repro::collapse_runs(
          l[h], key[h], [](uint32_t a, uint32_t b) { return min(a, b); },
          [&](int id, uint32_t kk) {
            fold<IS_MIN>(out + id, from_okey<T, IS_MIN>(kk));
          });
  }
}

// direct, D > 1: a thread a (row, column)
template <typename T, bool IS_MIN>
__global__ void direct_wide_kernel(const int32_t* __restrict__ seg,
                                   const T* __restrict__ vals,
                                   T* __restrict__ out, long long n, int d,
                                   int k, T ident) {
  const long long total = n * d;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    const long long row = i / d;
    const int s = seg[row];
    if (s < 0 || s >= k || vals[i] == ident) continue;
    fold<IS_MIN>(out + (long long)s * d + (i - row * d), vals[i]);
  }
}

template <typename T, bool IS_MIN>
int launch(const int32_t* seg, const T* vals, T* out, long long n, int d,
           int k, T ident, cudaStream_t stream) {
  const long long words = (long long)k * d;
  fill_kernel<T><<<repro::grid_for(words, FILL_THREADS), FILL_THREADS, 0,
                   stream>>>(out, words, ident);
  if (n == 0) return (int)cudaGetLastError();
  if (d == 1) {
    static int per_sm = 0;
    if (per_sm == 0) {
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, direct_kernel<T, IS_MIN>, THREADS, 0);
      per_sm = std::max(per_sm, 1);
    }
    // the largest block whose grid still covers every SM (SSSP's refresh,
    // N 2^17: 128 blocks of 128 where 1,024 threads would make 16)
    const long long quads = (n + 3) / 4;
    int threads = THREADS;
    while (threads > MIN_THREADS &&
           (quads + 2 * threads - 1) / (2 * threads) < repro::SM_COUNT)
      threads /= 2;
    const long long blocks = std::min<long long>(
        (quads + 2 * threads - 1) / (2 * threads),
        (long long)per_sm * (THREADS / threads) * repro::SM_COUNT);
    const int aligned = ((reinterpret_cast<uintptr_t>(seg) |
                          reinterpret_cast<uintptr_t>(vals)) & 15) == 0;
    direct_kernel<T, IS_MIN><<<(int)blocks, threads, 0, stream>>>(
        seg, vals, out, n, k, aligned, ident);
  } else {
    direct_wide_kernel<T, IS_MIN>
        <<<repro::grid_for(n * d, FILL_THREADS), FILL_THREADS, 0, stream>>>(
            seg, vals, out, n, d, k, ident);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// seg: [n] int32; vals: [n, d] float32 (is_float) or int32, contiguous;
// out: [k, d] same type.  Writes every output element: the min (max) of the
// rows whose id lies in [0, k), the identity where there are none.
REPRO_EXPORT int segment_minmax_launch(const void* seg, const void* vals,
                                       void* out, long long n, int d, int k,
                                       int is_float, int is_min,
                                       void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (k <= 0 || d <= 0) return (int)cudaGetLastError();
  if (n < 0 || (long long)k * d > INT32_MAX) return (int)cudaErrorInvalidValue;
  const int32_t* s = (const int32_t*)seg;
  if (is_float) {
    if (is_min)
      return launch<float, true>(s, (const float*)vals, (float*)out, n, d, k,
                                 INFINITY, stream);
    return launch<float, false>(s, (const float*)vals, (float*)out, n, d, k,
                                -INFINITY, stream);
  }
  if (is_min)
    return launch<int, true>(s, (const int*)vals, (int*)out, n, d, k,
                             INT32_MAX, stream);
  return launch<int, false>(s, (const int*)vals, (int*)out, n, d, k,
                            INT32_MIN, stream);
}
