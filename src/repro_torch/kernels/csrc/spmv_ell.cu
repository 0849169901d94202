// ELL-format SpMV: PageRank's propagation step, y[j] = sum of contrib over
// the slots (i, f) with nbrs[i, f] == j.
//
// Replaces repro/kernels/spmv_ell.py: spmv_ell.  The TPU tiles the output
// vertex range into VMEM blocks and turns the scatter into a one-hot
// matmul per (row tile, output block), O(S F V / kblk) work.  On the H100
// the natural form is the scatter itself: y is zeroed on the stream, then
// one thread per slot adds its contribution into y[nbrs] with an atomic.
// Padding slots (-1) and ids >= V are skipped, as the one-hot never
// matches them.
//
// Numbers: float32 atomics add in an order that changes from run to run,
// so y agrees with a sequential sum only up to the reordering of its
// additions (exact on integer-valued data below 2^24).
//
// What bounds it: device-memory bytes (read nbrs and contrib once, write
// y once).  At PageRank's main-path shape (S = 2^22, F = 16, V = 2^22) y is
// 16 MB and stays in the 50 MB L2 while the atomics land.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;

__global__ void spmv_ell_kernel(const int32_t* __restrict__ nbrs,
                                const float* __restrict__ contrib,
                                float* __restrict__ y, long long slots,
                                int v) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < slots; i += (long long)gridDim.x * blockDim.x) {
    const int j = nbrs[i];
    if (j < 0 || j >= v) continue;
    atomicAdd(&y[j], contrib[i]);
  }
}

}  // namespace

// nbrs: [slots] int32 (an [S, F] array, contiguous); contrib: [slots]
// float32; y: [v] float32.  Zeroes y on the stream, then adds.
REPRO_EXPORT int spmv_ell_launch(const void* nbrs, const void* contrib,
                                 void* y, long long slots, int v,
                                 void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (v <= 0) return (int)cudaGetLastError();
  cudaMemsetAsync(y, 0, (size_t)v * 4, stream);
  if (slots > 0) {
    spmv_ell_kernel<<<repro::grid_for(slots, THREADS), THREADS, 0, stream>>>(
        (const int32_t*)nbrs, (const float*)contrib, (float*)y, slots, v);
  }
  return (int)cudaGetLastError();
}
