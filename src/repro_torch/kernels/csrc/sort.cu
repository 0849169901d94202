// Stable lexicographic sort of two int32 key lanes: the shuffle sort.
//
// Replaces the TPU's bitonic network, repro/kernels/sort_u32.py:
// sort_lex_pallas (its tile, cross-tile and finish kernels).  The TPU
// sorts (hi, lo, row index) with a compare-exchange network because its
// vector unit wants data-independent selects.  On the H100 the natural
// stable sort is an LSD radix sort of the 64-bit key
//
//     ((hi ^ 0x80000000) << 32) | (lo ^ 0x80000000)
//
// (the xor maps signed to unsigned order).  Every pass is stable, so rows
// with equal (hi, lo) keep their input order: the index lane needs no
// compare, and the permutation is the exact total order (hi, lo, row).
//
// What bounds it: device-memory bytes.  Each of the 8 passes of 8 bits
// reads the keys twice (histogram, scatter) and writes keys and indices
// once; the per-block digit histogram lives in shared memory and the
// stable in-block rank comes from warp match masks, so no pass touches
// device memory beyond that.  Output is exactly n rows: no padding to a
// power of two.
#include "common.cuh"

namespace {

using repro::FULL_MASK;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int CHUNKS = 16;                  // chunks of THREADS rows a block
constexpr int TILE = THREADS * CHUNKS;      // rows per block: 4096
constexpr int RADIX = 256;
constexpr int PASSES = 8;
constexpr int SCAN_ITEMS = 4;
constexpr int SCAN_TILE = THREADS * SCAN_ITEMS;

__global__ void pack_kernel(const int32_t* __restrict__ hi,
                            const int32_t* __restrict__ lo,
                            uint64_t* __restrict__ key,
                            int32_t* __restrict__ idx, int n) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    uint64_t h = (uint32_t)hi[i] ^ 0x80000000u;
    uint64_t l = (uint32_t)lo[i] ^ 0x80000000u;
    key[i] = (h << 32) | l;
    idx[i] = i;
  }
}

__global__ void unpack_kernel(const uint64_t* __restrict__ key,
                              const int32_t* __restrict__ idx,
                              int32_t* __restrict__ hi,
                              int32_t* __restrict__ lo,
                              int32_t* __restrict__ perm, int n) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    uint64_t k = key[i];
    hi[i] = (int32_t)((uint32_t)(k >> 32) ^ 0x80000000u);
    lo[i] = (int32_t)((uint32_t)k ^ 0x80000000u);
    perm[i] = idx[i];
  }
}

// hist[d * nblocks + b] = rows of block b whose digit is d (digit-major, so
// one exclusive scan gives every (digit, block) its output offset).
__global__ void histogram_kernel(const uint64_t* __restrict__ key,
                                 uint32_t* __restrict__ hist, int n,
                                 int shift, int nblocks) {
  __shared__ uint32_t h[RADIX];
  for (int d = threadIdx.x; d < RADIX; d += THREADS) h[d] = 0;
  __syncthreads();
  long long base = (long long)blockIdx.x * TILE;
  for (int c = 0; c < CHUNKS; ++c) {
    long long i = base + (long long)c * THREADS + threadIdx.x;
    if (i < n) atomicAdd(&h[(unsigned)(key[i] >> shift) & 0xFFu], 1u);
  }
  __syncthreads();
  for (int d = threadIdx.x; d < RADIX; d += THREADS)
    hist[(size_t)d * nblocks + blockIdx.x] = h[d];
}

// Stable scatter of one block's rows to their digit's output run.  Rows
// are taken in chunks of THREADS consecutive rows; within a chunk a row's
// rank among equal digits is (rows of lower warps) + (lower lanes of its
// own warp, from __match_any_sync).  `base` carries the running offset of
// each digit across chunks.
__global__ void scatter_kernel(const uint64_t* __restrict__ key_in,
                               const int32_t* __restrict__ idx_in,
                               uint64_t* __restrict__ key_out,
                               int32_t* __restrict__ idx_out,
                               const uint32_t* __restrict__ offsets, int n,
                               int shift, int nblocks) {
  __shared__ uint32_t base[RADIX];
  __shared__ uint32_t warp_cnt[WARPS][RADIX];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const unsigned lower_lanes = (1u << lane) - 1u;
  for (int d = tid; d < RADIX; d += THREADS)
    base[d] = offsets[(size_t)d * nblocks + blockIdx.x];
  const long long tile0 = (long long)blockIdx.x * TILE;
  for (int c = 0; c < CHUNKS; ++c) {
    const long long chunk0 = tile0 + (long long)c * THREADS;
    if (chunk0 >= n) break;                       // uniform over the block
    for (int k = tid; k < WARPS * RADIX; k += THREADS)
      (&warp_cnt[0][0])[k] = 0;
    __syncthreads();
    const long long i = chunk0 + tid;
    const bool ok = i < n;
    const uint64_t k = ok ? key_in[i] : 0ull;
    const int32_t x = ok ? idx_in[i] : 0;
    const unsigned d = ok ? ((unsigned)(k >> shift) & 0xFFu) : RADIX;
    const unsigned peers = __match_any_sync(FULL_MASK, d);
    const unsigned rank = __popc(peers & lower_lanes);
    if (ok && rank == 0) warp_cnt[warp][d] = __popc(peers);
    __syncthreads();
    if (ok) {
      unsigned pos = base[d] + rank;
      for (int w = 0; w < warp; ++w) pos += warp_cnt[w][d];
      key_out[pos] = k;
      idx_out[pos] = x;
    }
    __syncthreads();
    for (int dd = tid; dd < RADIX; dd += THREADS) {
      unsigned s = 0;
      for (int w = 0; w < WARPS; ++w) s += warp_cnt[w][dd];
      base[dd] += s;
    }
    __syncthreads();
  }
}

// Exclusive scan of SCAN_TILE values per block in place; the block's total
// goes to sums[blockIdx.x] when sums is given.
__global__ void scan_tiles_kernel(uint32_t* __restrict__ data,
                                  uint32_t* __restrict__ sums, long long len) {
  __shared__ uint32_t warp_sums[WARPS];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long t0 = (long long)blockIdx.x * SCAN_TILE +
                       (long long)tid * SCAN_ITEMS;
  uint32_t v[SCAN_ITEMS];
  uint32_t own = 0;
#pragma unroll
  for (int j = 0; j < SCAN_ITEMS; ++j) {
    v[j] = (t0 + j < len) ? data[t0 + j] : 0u;
    own += v[j];
  }
  uint32_t incl = own;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    uint32_t y = __shfl_up_sync(FULL_MASK, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    uint32_t w = lane < WARPS ? warp_sums[lane] : 0u;
    uint32_t wincl = w;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      uint32_t y = __shfl_up_sync(FULL_MASK, wincl, o);
      if (lane >= o) wincl += y;
    }
    if (lane < WARPS) warp_sums[lane] = wincl - w;
    if (sums != nullptr && lane == WARPS - 1) sums[blockIdx.x] = wincl;
  }
  __syncthreads();
  uint32_t run = warp_sums[warp] + incl - own;
#pragma unroll
  for (int j = 0; j < SCAN_ITEMS; ++j) {
    if (t0 + j < len) data[t0 + j] = run;
    run += v[j];
  }
}

__global__ void add_tile_offsets_kernel(uint32_t* __restrict__ data,
                                        const uint32_t* __restrict__ sums,
                                        long long len) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < len; i += (long long)gridDim.x * blockDim.x)
    data[i] += sums[i / SCAN_TILE];
}

long long ceil_div(long long a, long long b) { return (a + b - 1) / b; }
size_t align_up(size_t x) { return (x + 255) & ~(size_t)255; }

// words of scratch the recursive scan of `len` values needs
size_t scan_scratch_words(long long len) {
  size_t words = 0;
  while (len > SCAN_TILE) {
    long long nb = ceil_div(len, SCAN_TILE);
    words += align_up((size_t)nb * 4) / 4;
    len = nb;
  }
  return words + 64;
}

void exclusive_scan(uint32_t* data, long long len, uint32_t* scratch,
                    cudaStream_t stream) {
  long long nb = ceil_div(len, SCAN_TILE);
  if (nb <= 1) {
    scan_tiles_kernel<<<1, THREADS, 0, stream>>>(data, nullptr, len);
    return;
  }
  scan_tiles_kernel<<<(unsigned)nb, THREADS, 0, stream>>>(data, scratch, len);
  exclusive_scan(scratch, nb, scratch + align_up((size_t)nb * 4) / 4, stream);
  add_tile_offsets_kernel<<<repro::grid_for(len, THREADS), THREADS, 0,
                            stream>>>(data, scratch, len);
}

struct Workspace {
  uint64_t* key_a; uint64_t* key_b;
  int32_t* idx_a; int32_t* idx_b;
  uint32_t* hist; uint32_t* scan;
  size_t bytes;
};

Workspace carve(long long n, char* base) {
  const long long nblocks = ceil_div(n, TILE);
  Workspace w;
  size_t off = 0;
  auto take = [&](size_t bytes) { char* p = base + off; off += align_up(bytes); return p; };
  w.key_a = (uint64_t*)take((size_t)n * 8);
  w.key_b = (uint64_t*)take((size_t)n * 8);
  w.idx_a = (int32_t*)take((size_t)n * 4);
  w.idx_b = (int32_t*)take((size_t)n * 4);
  w.hist = (uint32_t*)take((size_t)RADIX * nblocks * 4);
  w.scan = (uint32_t*)take(scan_scratch_words((long long)RADIX * nblocks) * 4);
  w.bytes = off;
  return w;
}

}  // namespace

// Bytes of device scratch sort_lex_launch needs for n rows.
REPRO_EXPORT size_t sort_lex_workspace_bytes(long long n) {
  if (n <= 0) return 0;
  return carve(n, nullptr).bytes;
}

// hi, lo: [n] int32 in; hi_out, lo_out, perm: [n] int32 out, sorted by
// (hi, lo, row).  n < 2^31.
REPRO_EXPORT int sort_lex_launch(const void* hi, const void* lo, void* hi_out,
                                 void* lo_out, void* perm, long long n,
                                 void* workspace, void* stream_ptr) {
  if (n <= 0) return (int)cudaGetLastError();
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  Workspace w = carve(n, (char*)workspace);
  const int nn = (int)n;
  const int nblocks = (int)ceil_div(n, TILE);
  const long long hist_len = (long long)RADIX * nblocks;
  const int grid = repro::grid_for(n, THREADS);
  pack_kernel<<<grid, THREADS, 0, stream>>>(
      (const int32_t*)hi, (const int32_t*)lo, w.key_a, w.idx_a, nn);
  for (int pass = 0; pass < PASSES; ++pass) {
    const int shift = pass * 8;
    histogram_kernel<<<nblocks, THREADS, 0, stream>>>(w.key_a, w.hist, nn,
                                                      shift, nblocks);
    exclusive_scan(w.hist, hist_len, w.scan, stream);
    scatter_kernel<<<nblocks, THREADS, 0, stream>>>(
        w.key_a, w.idx_a, w.key_b, w.idx_b, w.hist, nn, shift, nblocks);
    uint64_t* tk = w.key_a; w.key_a = w.key_b; w.key_b = tk;
    int32_t* ti = w.idx_a; w.idx_a = w.idx_b; w.idx_b = ti;
  }
  unpack_kernel<<<grid, THREADS, 0, stream>>>(
      w.key_a, w.idx_a, (int32_t*)hi_out, (int32_t*)lo_out, (int32_t*)perm,
      nn);
  return (int)cudaGetLastError();
}
