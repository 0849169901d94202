// Fused shuffle + last-writer-wins merge + Reduce into affected-key slots.
//
// Replaces repro/kernels/fused.py: fused_shuffle_reduce (its single-tile
// _sort_lww_reduce_kernel and multi-tile _lww_reduce_kernel).  Contract:
// sort rows stably by (k2, mk); the last row of each (k2, mk) run is live
// when it is valid and its sign is positive; live rows are summed into the
// slot of the sorted `keys` (affected keys, padded with INT32_MAX) whose
// key equals their k2, and counted per slot.
//
// Two launchers:
//   * fused_small_launch (n <= 4096): ONE block sorts the three int lanes
//     (k2, mk, row) with a bitonic network in dynamic shared memory
//     (12 bytes a row, 48 KB at 4096 rows), then gathers the payload, marks
//     the last writers and routes live rows, all in the same launch.
//   * fused_lww_launch (n > 4096): runs after the sort kernel (sort.cu) has
//     written k2_s, mk_s and perm.  One thread per sorted row gathers its
//     payload, compares its (k2, mk) with the next sorted row in device
//     memory (no tile boundary, so no sentinel hand-off), and routes.
//
// Routing is a binary search over the sorted keys; sums and counts go to
// `acc` [key_cap, d] and `counts` [key_cap] in device memory with atomics
// (acc can reach 8 MB: it does not fit shared memory).  int32 sums are
// exact; float32 atomics add in run-dependent order (exact on
// integer-valued data).
//
// What bounds it: device-memory bytes for the large path (each row's lanes,
// payload, validity and sign read once, the sorted outputs written once);
// the small path is one block and bounded by its own latency.
#include "common.cuh"

namespace {

constexpr int SMALL_MAX = 4096;
constexpr int SMALL_THREADS = 1024;
constexpr int THREADS = 256;
constexpr int32_t KEY_MAX = 0x7fffffff;

__device__ inline bool lex_lt(int32_t ah, int32_t al, int32_t ai, int32_t bh,
                              int32_t bl, int32_t bi) {
  if (ah != bh) return ah < bh;
  if (al != bl) return al < bl;
  return ai < bi;
}

// Payload gather, live test and routing of sorted row p (source row r).
template <typename T>
__device__ inline void emit_row(int p, int r, int32_t h, bool last,
                                const T* __restrict__ vals,
                                const uint8_t* __restrict__ valid,
                                const int8_t* __restrict__ sign,
                                const int32_t* __restrict__ keys, int key_cap,
                                int d, T* __restrict__ vals_out,
                                uint8_t* __restrict__ live_out,
                                T* __restrict__ acc,
                                int32_t* __restrict__ counts) {
  const T* src = vals + (long long)r * d;
  T* dst = vals_out + (long long)p * d;
  for (int c = 0; c < d; ++c) dst[c] = src[c];
  const bool live = last && valid[r] != 0 && sign[r] > 0;
  live_out[p] = live ? 1 : 0;
  if (!live) return;
  const int slot = repro::find_slot(keys, key_cap, h);
  if (slot < 0) return;
  T* a = acc + (long long)slot * d;
  for (int c = 0; c < d; ++c) atomicAdd(&a[c], src[c]);
  atomicAdd(&counts[slot], 1);
}

template <typename T>
__global__ void __launch_bounds__(SMALL_THREADS)
sort_lww_reduce_kernel(const int32_t* __restrict__ k2,
                       const int32_t* __restrict__ mk,
                       const T* __restrict__ vals,
                       const uint8_t* __restrict__ valid,
                       const int8_t* __restrict__ sign,
                       const int32_t* __restrict__ keys, int key_cap, int n,
                       int m, int d, int32_t* __restrict__ k2_out,
                       int32_t* __restrict__ mk_out, T* __restrict__ vals_out,
                       uint8_t* __restrict__ live_out,
                       int32_t* __restrict__ perm, T* __restrict__ acc,
                       int32_t* __restrict__ counts) {
  extern __shared__ int32_t lanes[];
  int32_t* sh = lanes;
  int32_t* sl = lanes + m;
  int32_t* si = lanes + 2 * m;
  const int tid = threadIdx.x;
  for (int i = tid; i < m; i += blockDim.x) {
    // padding rows sort after every real row: max keys, indices >= n
    sh[i] = i < n ? k2[i] : KEY_MAX;
    sl[i] = i < n ? mk[i] : KEY_MAX;
    si[i] = i;
  }
  __syncthreads();
  for (int k = 2; k <= m; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = tid; i < m; i += blockDim.x) {
        const int p = i ^ j;
        if (p <= i) continue;
        const bool up = (i & k) == 0;
        const bool partner_lt = lex_lt(sh[p], sl[p], si[p], sh[i], sl[i], si[i]);
        if (partner_lt == up) {
          int32_t t;
          t = sh[i]; sh[i] = sh[p]; sh[p] = t;
          t = sl[i]; sl[i] = sl[p]; sl[p] = t;
          t = si[i]; si[i] = si[p]; si[p] = t;
        }
      }
      __syncthreads();
    }
  }
  for (int p = tid; p < n; p += blockDim.x) {
    const int32_t h = sh[p], l = sl[p];
    const bool last = p == n - 1 || sh[p + 1] != h || sl[p + 1] != l;
    k2_out[p] = h;
    mk_out[p] = l;
    perm[p] = si[p];
    emit_row<T>(p, si[p], h, last, vals, valid, sign, keys, key_cap, d,
                vals_out, live_out, acc, counts);
  }
}

template <typename T>
__global__ void lww_reduce_kernel(const int32_t* __restrict__ k2_s,
                                  const int32_t* __restrict__ mk_s,
                                  const int32_t* __restrict__ perm,
                                  const T* __restrict__ vals,
                                  const uint8_t* __restrict__ valid,
                                  const int8_t* __restrict__ sign,
                                  const int32_t* __restrict__ keys,
                                  int key_cap, int n, int d,
                                  T* __restrict__ vals_out,
                                  uint8_t* __restrict__ live_out,
                                  T* __restrict__ acc,
                                  int32_t* __restrict__ counts) {
  for (int p = blockIdx.x * blockDim.x + threadIdx.x; p < n;
       p += gridDim.x * blockDim.x) {
    const int32_t h = k2_s[p], l = mk_s[p];
    const bool last = p == n - 1 || k2_s[p + 1] != h || mk_s[p + 1] != l;
    emit_row<T>(p, perm[p], h, last, vals, valid, sign, keys, key_cap, d,
                vals_out, live_out, acc, counts);
  }
}

void zero_outputs(void* acc, void* counts, int key_cap, int d,
                  cudaStream_t stream) {
  cudaMemsetAsync(acc, 0, (size_t)key_cap * d * 4, stream);
  cudaMemsetAsync(counts, 0, (size_t)key_cap * 4, stream);
}

}  // namespace

// n <= 4096 rows.  k2 (invalid rows already at INT32_MAX), mk: [n] int32;
// vals: [n, d] float32 (is_float) or int32; valid: [n] uint8; sign: [n]
// int8; keys: [key_cap] int32.  Outputs: k2_out, mk_out, perm [n] int32,
// vals_out [n, d], live [n] uint8, acc [key_cap, d], counts [key_cap] int32.
REPRO_EXPORT int fused_small_launch(
    const void* k2, const void* mk, const void* vals, const void* valid,
    const void* sign, const void* keys, int key_cap, int n, int d,
    int is_float, void* k2_out, void* mk_out, void* vals_out, void* live,
    void* perm, void* acc, void* counts, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (n <= 0 || n > SMALL_MAX || key_cap <= 0) return (int)cudaErrorInvalidValue;
  zero_outputs(acc, counts, key_cap, d, stream);
  int m = 1;
  while (m < n) m <<= 1;
  const size_t smem = (size_t)3 * m * sizeof(int32_t);
  if (is_float) {
    cudaFuncSetAttribute(sort_lww_reduce_kernel<float>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    sort_lww_reduce_kernel<float><<<1, SMALL_THREADS, smem, stream>>>(
        (const int32_t*)k2, (const int32_t*)mk, (const float*)vals,
        (const uint8_t*)valid, (const int8_t*)sign, (const int32_t*)keys,
        key_cap, n, m, d, (int32_t*)k2_out, (int32_t*)mk_out,
        (float*)vals_out, (uint8_t*)live, (int32_t*)perm, (float*)acc,
        (int32_t*)counts);
  } else {
    cudaFuncSetAttribute(sort_lww_reduce_kernel<int>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    sort_lww_reduce_kernel<int><<<1, SMALL_THREADS, smem, stream>>>(
        (const int32_t*)k2, (const int32_t*)mk, (const int*)vals,
        (const uint8_t*)valid, (const int8_t*)sign, (const int32_t*)keys,
        key_cap, n, m, d, (int32_t*)k2_out, (int32_t*)mk_out, (int*)vals_out,
        (uint8_t*)live, (int32_t*)perm, (int*)acc, (int32_t*)counts);
  }
  return (int)cudaGetLastError();
}

// The multi-block epilogue: k2_s, mk_s, perm [n] from the sort kernel; the
// other arguments as for fused_small_launch.
REPRO_EXPORT int fused_lww_launch(
    const void* k2_s, const void* mk_s, const void* perm, const void* vals,
    const void* valid, const void* sign, const void* keys, int key_cap, int n,
    int d, int is_float, void* vals_out, void* live, void* acc, void* counts,
    void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (n <= 0 || key_cap <= 0) return (int)cudaErrorInvalidValue;
  zero_outputs(acc, counts, key_cap, d, stream);
  const int grid = repro::grid_for(n, THREADS);
  if (is_float) {
    lww_reduce_kernel<float><<<grid, THREADS, 0, stream>>>(
        (const int32_t*)k2_s, (const int32_t*)mk_s, (const int32_t*)perm,
        (const float*)vals, (const uint8_t*)valid, (const int8_t*)sign,
        (const int32_t*)keys, key_cap, n, d, (float*)vals_out,
        (uint8_t*)live, (float*)acc, (int32_t*)counts);
  } else {
    lww_reduce_kernel<int><<<grid, THREADS, 0, stream>>>(
        (const int32_t*)k2_s, (const int32_t*)mk_s, (const int32_t*)perm,
        (const int*)vals, (const uint8_t*)valid, (const int8_t*)sign,
        (const int32_t*)keys, key_cap, n, d, (int*)vals_out, (uint8_t*)live,
        (int*)acc, (int32_t*)counts);
  }
  return (int)cudaGetLastError();
}
