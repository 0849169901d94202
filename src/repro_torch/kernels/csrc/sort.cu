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
// (the xor maps signed to unsigned order), 8 passes of 8 bits.  Every
// pass is stable, so rows with equal (hi, lo) keep their input order: the
// index lane needs no compare, and the permutation is the exact total
// order (hi, lo, row).  Output is exactly n rows: no padding.
//
// What bounds it: device-memory bytes.  The least a pass can move is its
// rows once in and once out (8-byte key and 4-byte index each way: 24
// bytes a row).  A plain LSD sort moves 4-8x that: a histogram kernel
// reads every key a second time each pass, a scan of 256 counts a block
// follows, a row scattered on its own to a random address fills a
// 32-byte sector with 8 or 4 bytes, and packing the lanes into keys and
// back adds 40 bytes a row.
//
// The one-sweep design (after Adinets and Merrill, "Onesweep", 2022):
//   * one histogram kernel reads the keys once and counts all 8 digits
//     (a warp whose 32 rows share a digit adds once, else one shared
//     atomic a lane); one small kernel scans the 8 x 256 counts into each
//     digit's global start and plans the passes: a digit that is the same
//     for every row is skipped on the device (the pass's blocks return at
//     once, and the ping-pong buffers follow the passes that run), so the
//     host never waits; if every digit is constant, the last pass runs
//     alone;
//   * the first pass that runs reads hi and lo and makes idx = row, the
//     last writes hi_out, lo_out and perm: no pack or unpack pass;
//   * one kernel a pass.  A block of 256 threads takes its tile's number
//     from an atomic counter (never blockIdx), so it only waits on tiles
//     whose blocks have already started.  It loads 4096 rows,
//     warp-striped (row 32 j + lane of each warp's 512: every load
//     instruction reads 128 or 256 contiguous bytes; a 16-byte load
//     would put two neighbouring rows in one thread and break the stable
//     rank below), ranks them stably in shared memory (item by item in
//     row order: nine ballots give the lower lanes with the same digit,
//     a per-warp digit count the earlier items; __match_any_sync, which
//     computes the same mask, was slower here), publishes its 256 digit
//     counts and takes its offsets by decoupled look-back over the tiles
//     before it, reorders the tile in shared memory by digit, and writes
//     the digit runs out with neighbouring threads on neighbouring
//     addresses.
// A pass then moves its 24 bytes a row plus 2 KB of status a tile.
//
// The look-back status of (tile, digit) is one 64-bit word: the flag
// (1: this tile's count, 2: the count of this and all earlier tiles) in
// the high half, the count (< 2^31) in the low half, written and read
// whole.  The status words are cleared on the stream (cudaMemsetAsync)
// before every pass; each pass has its own tile counter, all cleared with
// the digit counts before the first.
//
// Workspace: two key buffers (8 n bytes each), two index buffers (4 n
// each), the status words (2 KB a 4096-row tile, n / 2 bytes) and 16 KB
// of counts, offsets and plan: 24.5 n bytes + 16 KB (the first design
// took 24.25 n + its scan scratch).  Shared memory a block: 58 KB.
#include "common.cuh"

namespace {

using repro::FULL_MASK;

constexpr int RADIX = 256;
constexpr int PASSES = 8;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ITEMS = 16;                    // rows a thread
constexpr int WARP_ROWS = 32 * ITEMS;        // consecutive rows a warp
constexpr int TILE = THREADS * ITEMS;        // rows a block: 4096
constexpr int HIST_THREADS = 256;
constexpr int HIST_BLOCKS = 4 * repro::SM_COUNT;
constexpr uint64_t FLAG_COUNT = 1ull << 32;  // this tile's count
constexpr uint64_t FLAG_PREFIX = 2ull << 32; // count of tiles 0..this

// Which passes run and where each reads and writes: -1 is the caller's
// lanes (hi/lo in, hi_out/lo_out/perm out), 0 and 1 the ping-pong
// buffers.
struct Plan {
  int run[PASSES];
  int src[PASSES];
  int dst[PASSES];
};

__device__ inline uint64_t pack_key(int32_t hi, int32_t lo) {
  return ((uint64_t)((uint32_t)hi ^ 0x80000000u) << 32) |
         ((uint32_t)lo ^ 0x80000000u);
}

__device__ inline unsigned digit_of(uint64_t key, int pass) {
  return (unsigned)(key >> (8 * pass)) & 0xFFu;
}

// Lanes whose 9-bit label equals this lane's, one ballot a bit (the
// label RADIX marks a row past n).
__device__ inline unsigned match_label(unsigned label) {
  unsigned peers = FULL_MASK;
#pragma unroll
  for (int b = 0; b < 9; ++b) {
    const unsigned set = __ballot_sync(FULL_MASK, (label >> b) & 1u);
    peers &= ((label >> b) & 1u) ? set : ~set;
  }
  return peers;
}

// hist[pass * 256 + d] += rows whose digit `pass` is d (hist zeroed
// beforehand).  A warp whose 32 rows share a digit adds once (a constant
// digit would otherwise put 32 lanes on one shared counter); otherwise
// each lane adds its own.
__global__ void __launch_bounds__(HIST_THREADS)
    histogram_kernel(const int32_t* __restrict__ hi,
                     const int32_t* __restrict__ lo,
                     uint32_t* __restrict__ hist, int n) {
  __shared__ uint32_t h[PASSES * RADIX];
  for (int i = threadIdx.x; i < PASSES * RADIX; i += HIST_THREADS) h[i] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const long long stride = (long long)gridDim.x * HIST_THREADS;
  for (long long base = (long long)blockIdx.x * HIST_THREADS +
                        (threadIdx.x & ~31);
       base < n; base += stride) {         // warp-uniform trip count
    const long long i = base + lane;
    const bool full = base + 32 <= n;
    const bool ok = i < n;
    const uint64_t key = ok ? pack_key(hi[i], lo[i]) : 0ull;
#pragma unroll
    for (int pass = 0; pass < PASSES; ++pass) {
      const unsigned d = digit_of(key, pass);
      const unsigned d0 = __shfl_sync(FULL_MASK, d, 0);
      if (full && __all_sync(FULL_MASK, d == d0)) {
        if (lane == 0) atomicAdd(&h[pass * RADIX + d0], 32u);
      } else if (ok) {
        atomicAdd(&h[pass * RADIX + d], 1u);
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < PASSES * RADIX; i += HIST_THREADS)
    if (h[i]) atomicAdd(&hist[i], h[i]);
}

// offsets[pass * 256 + d] = rows of pass `pass` whose digit is below d,
// and the plan: a pass runs unless one digit holds all n rows.
__global__ void __launch_bounds__(RADIX)
    plan_kernel(const uint32_t* __restrict__ hist,
                uint32_t* __restrict__ offsets, Plan* __restrict__ plan,
                int n) {
  __shared__ uint32_t warp_sums[RADIX / 32];
  __shared__ int constant[PASSES];
  const int d = threadIdx.x, warp = d >> 5, lane = d & 31;
  for (int pass = 0; pass < PASSES; ++pass) {
    const uint32_t c = hist[pass * RADIX + d];
    if (d == 0) constant[pass] = 0;
    __syncthreads();
    if (c == (uint32_t)n) constant[pass] = 1;
    uint32_t incl = c;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const uint32_t y = __shfl_up_sync(FULL_MASK, incl, o);
      if (lane >= o) incl += y;
    }
    if (lane == 31) warp_sums[warp] = incl;
    __syncthreads();
    uint32_t before = 0;
    for (int w = 0; w < warp; ++w) before += warp_sums[w];
    offsets[pass * RADIX + d] = before + incl - c;
    __syncthreads();
  }
  if (d == 0) {
    int any = 0;
    for (int pass = 0; pass < PASSES; ++pass) any |= !constant[pass];
    int last = -1, buf = 0;
    for (int pass = 0; pass < PASSES; ++pass) {
      plan->run[pass] = any ? !constant[pass] : pass == PASSES - 1;
      if (plan->run[pass]) last = pass;
    }
    int src = -1;
    for (int pass = 0; pass < PASSES; ++pass) {
      plan->src[pass] = src;
      plan->dst[pass] = pass == last ? -1 : buf;
      if (plan->run[pass] && pass != last) {
        src = buf;
        buf ^= 1;
      }
    }
  }
}

struct PassSmem {
  uint64_t key[TILE];
  int32_t idx[TILE];
  uint32_t warp_count[WARPS][RADIX];   // per warp, then its exclusive sum
  uint32_t start[RADIX];               // digit's first slot in the tile
  uint32_t shift[RADIX];               // output row - tile slot, mod 2^32
  uint32_t scan[RADIX / 32];
  int tile;
};

__device__ inline uint64_t load_status(const uint64_t* p) {
  uint64_t v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p)
               : "memory");
  return v;
}

__device__ inline void store_status(uint64_t* p, uint64_t v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

// One stable counting pass over digit `pass`, one 4096-row tile a block.
__global__ void __launch_bounds__(THREADS, 2)
    onesweep_kernel(const int32_t* __restrict__ hi,
                    const int32_t* __restrict__ lo, uint64_t* key0,
                    uint64_t* key1, int32_t* idx0, int32_t* idx1,
                    int32_t* __restrict__ hi_out,
                    int32_t* __restrict__ lo_out,
                    int32_t* __restrict__ perm, const Plan* __restrict__ plan,
                    const uint32_t* __restrict__ offsets, uint64_t* status,
                    uint32_t* tile_counter, int n, int pass) {
  if (!plan->run[pass]) return;               // a constant digit
  const int src = plan->src[pass], dst = plan->dst[pass];
  extern __shared__ __align__(16) unsigned char smem_raw[];
  PassSmem& sm = *reinterpret_cast<PassSmem*>(smem_raw);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const unsigned lower_lanes = (1u << lane) - 1u;

  if (tid == 0) sm.tile = (int)atomicAdd(tile_counter, 1u);
  for (int i = tid; i < WARPS * RADIX; i += THREADS)
    (&sm.warp_count[0][0])[i] = 0;
  __syncthreads();
  const int tile = sm.tile;
  const long long t0 = (long long)tile * TILE;
  const int count = (int)min((long long)TILE, (long long)n - t0);

  // load, warp-striped: item j of a lane is row warp * 256 + 32 j + lane
  uint64_t key[ITEMS];
  int32_t idx[ITEMS];
  const int row0 = warp * WARP_ROWS + lane;
  const uint64_t* ksrc = src == 0 ? key0 : key1;
  const int32_t* isrc = src == 0 ? idx0 : idx1;
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const int r = row0 + 32 * j;
    const long long i = t0 + r;
    if (r >= count) {
      key[j] = 0ull;
      idx[j] = 0;
    } else if (src < 0) {
      key[j] = pack_key(hi[i], lo[i]);
      idx[j] = (int32_t)i;
    } else {
      key[j] = ksrc[i];
      idx[j] = isrc[i];
    }
  }

  // rank among the warp's rows of the same digit, in row order
  uint32_t rank[ITEMS];
  uint32_t* wc = sm.warp_count[warp];
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const bool ok = row0 + 32 * j < count;
    const unsigned d = ok ? digit_of(key[j], pass) : RADIX;
    const unsigned peers = match_label(d);
    const uint32_t before = ok ? wc[d] : 0u;
    rank[j] = before + __popc(peers & lower_lanes);
    __syncwarp();
    if (ok && lane == __ffs(peers) - 1) wc[d] = before + __popc(peers);
    __syncwarp();
  }
  __syncthreads();

  // per digit: exclusive sums over the warps, the tile's count published
  uint32_t total = 0;
  if (tid < RADIX) {
    for (int w = 0; w < WARPS; ++w) {
      const uint32_t c = sm.warp_count[w][tid];
      sm.warp_count[w][tid] = total;
      total += c;
    }
    store_status(status + (size_t)tile * RADIX + tid,
                 (tile == 0 ? FLAG_PREFIX : FLAG_COUNT) | total);
    uint32_t incl = total;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const uint32_t y = __shfl_up_sync(FULL_MASK, incl, o);
      if (lane >= o) incl += y;
    }
    if (lane == 31) sm.scan[warp] = incl;
    sm.start[tid] = incl - total;             // within its warp so far
  }
  __syncthreads();
  if (tid < RADIX) {
    uint32_t before = 0;
    for (int w = 0; w < warp; ++w) before += sm.scan[w];
    sm.start[tid] += before;
  }
  __syncthreads();

  // reorder the tile by digit in shared memory
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    if (row0 + 32 * j < count) {
      const unsigned d = digit_of(key[j], pass);
      const uint32_t slot = sm.start[d] + sm.warp_count[warp][d] + rank[j];
      sm.key[slot] = key[j];
      sm.idx[slot] = idx[j];
    }
  }

  // decoupled look-back: rows of each digit in the tiles before this one
  if (tid < RADIX) {
    uint32_t before = 0;
    if (tile > 0) {
      for (int t = tile - 1;;) {
        const uint64_t s = load_status(status + (size_t)t * RADIX + tid);
        const uint64_t flag = s & ~0xFFFFFFFFull;
        if (flag == 0) continue;              // that tile has not counted
        before += (uint32_t)s;
        if (flag == FLAG_PREFIX) break;
        --t;
      }
      store_status(status + (size_t)tile * RADIX + tid,
                   FLAG_PREFIX | (before + total));
    }
    sm.shift[tid] = offsets[pass * RADIX + tid] + before - sm.start[tid];
  }
  __syncthreads();

  // write the digit runs: slot i goes to row shift[d] + i
  uint64_t* kdst = dst == 0 ? key0 : key1;
  int32_t* idst = dst == 0 ? idx0 : idx1;
  for (int i = tid; i < count; i += THREADS) {
    const uint64_t k = sm.key[i];
    const uint32_t row = sm.shift[digit_of(k, pass)] + (uint32_t)i;
    if (dst < 0) {
      hi_out[row] = (int32_t)((uint32_t)(k >> 32) ^ 0x80000000u);
      lo_out[row] = (int32_t)((uint32_t)k ^ 0x80000000u);
      perm[row] = sm.idx[i];
    } else {
      kdst[row] = k;
      idst[row] = sm.idx[i];
    }
  }
}

long long ceil_div(long long a, long long b) { return (a + b - 1) / b; }
size_t align_up(size_t x) { return (x + 255) & ~(size_t)255; }

struct Workspace {
  uint64_t* key[2];
  int32_t* idx[2];
  uint64_t* status;
  uint32_t* hist;
  uint32_t* offsets;
  Plan* plan;
  uint32_t* counters;
  size_t status_bytes, small_bytes, bytes;
};

Workspace carve(long long n, char* base) {
  Workspace w;
  size_t off = 0;
  auto take = [&](size_t bytes) {
    char* p = base + off;
    off += align_up(bytes);
    return p;
  };
  w.key[0] = (uint64_t*)take((size_t)n * 8);
  w.key[1] = (uint64_t*)take((size_t)n * 8);
  w.idx[0] = (int32_t*)take((size_t)n * 4);
  w.idx[1] = (int32_t*)take((size_t)n * 4);
  w.status_bytes = (size_t)ceil_div(n, TILE) * RADIX * 8;
  w.status = (uint64_t*)take(w.status_bytes);
  char* small = base + off;
  w.hist = (uint32_t*)take(PASSES * RADIX * 4);
  w.counters = (uint32_t*)take(PASSES * 4);
  w.small_bytes = (size_t)(base + off - small);   // zeroed once a sort
  w.offsets = (uint32_t*)take(PASSES * RADIX * 4);
  w.plan = (Plan*)take(sizeof(Plan));
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
  const int tiles = (int)ceil_div(n, TILE);
  cudaMemsetAsync(w.hist, 0, w.small_bytes, stream);
  const long long want = ceil_div(n, HIST_THREADS);
  const int hist_blocks = (int)(want < HIST_BLOCKS ? want : HIST_BLOCKS);
  histogram_kernel<<<hist_blocks, HIST_THREADS, 0, stream>>>(
      (const int32_t*)hi, (const int32_t*)lo, w.hist, nn);
  plan_kernel<<<1, RADIX, 0, stream>>>(w.hist, w.offsets, w.plan, nn);
  const int smem = (int)sizeof(PassSmem);
  cudaFuncSetAttribute(onesweep_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  for (int pass = 0; pass < PASSES; ++pass) {
    cudaMemsetAsync(w.status, 0, w.status_bytes, stream);
    onesweep_kernel<<<tiles, THREADS, smem, stream>>>(
        (const int32_t*)hi, (const int32_t*)lo, w.key[0], w.key[1], w.idx[0],
        w.idx[1], (int32_t*)hi_out, (int32_t*)lo_out, (int32_t*)perm, w.plan,
        w.offsets, w.status, w.counters + pass, nn, pass);
  }
  return (int)cudaGetLastError();
}
