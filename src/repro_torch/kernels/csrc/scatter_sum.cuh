// Scatter-sum core of segment_sum.cu and spmv_ell.cu: out[id] += row for
// every row whose id lies in [0, K), with optional row counts.
//
// What bounds it on the H100 (tools/scatter_probes.py; NVIDIA H100 80GB
// HBM3, 700 W): one global atomic a row runs at the L2's reduction rate,
// ~89 G/s to random addresses in a 1 MB or a 16 MB array alike (0.75 ms
// for 2^26), and ~73 G/s beside a stream that reads the rows (2^25 adds
// and 2^26 rows read: 0.457 ms), against 0.19 ms to read 2^26 ids and
// values once.  Shared-memory atomics reach 446 G/s (f32) and 1,400 G/s
// (u32); distributed shared memory across a 16-block cluster only 35 G/s
// (f32), slower than L2, so no variant uses a cluster.
//
// Variants, chosen by the launcher from the output's words K (D + counts)
// (as flash_attention.cu's launcher chooses by head dim):
//   * private (K (D + counts) 4 bytes <= SLAB_BYTES, 128 KB: the
//     accumulator's and the composed merge's key_cap buckets): the reduce
//     kernel reads the rows in place; each block sums a chunk of rows into
//     a private copy of the whole output in shared memory.  With one chunk
//     it writes the output, else each chunk writes its slab to scratch and
//     a combine kernel adds the chunks' slabs in a fixed order.
//   * direct (larger, D + counts = 1: SSSP's counts, spmv_ell): one pass,
//     one red.global.add a run of equal ids into the zeroed output.  One
//     add a row is all the L2 is asked for here, and the partition below
//     measured slower (0.72 against 0.48 ms for spmv_ell at S = V = 2^22,
//     F = 16): it moves 6 bytes a live row twice beside the rows it reads.
//   * partitioned (larger, D + counts >= 2: wordcount's and PageRank's
//     sums with counts), where the partition saves an L2 add a column:
//       1. count: every 16th run of 128 rows (every run below 2^20 rows)
//          adds its rows in range to their bins' counts; a bin is kpb
//          keys, kpb the power of two that fills the slab (16,384 keys at
//          D = 1 with counts), at most MAX_BINS bins;
//       2. plan the bins (one block): each bin's room, 9/8 of its
//          estimate + SLACK rows, padded to 8 rows;
//       3. partition: a block an SM takes 12,288-row tiles (the next one
//          arriving by bulk copy meanwhile), ranks each tile's live rows
//          by bin in shared memory, reserves each bin's run with one
//          global atomic a (tile, bin), and writes the runs contiguously:
//          a 16-bit bin-local id and the 32-bit value (at D = 1) or row
//          index (D > 1), 6 bytes a live row.  Dropped rows go nowhere; a
//          row past its bin's room (an estimate the data fooled) adds
//          straight into the zeroed output.  Bigger tiles make longer runs
//          a bin: 1,024 threads and 12,288 rows took PageRank's partition
//          from 0.41 to 0.32 ms against 512 and 6,144;
//       4. plan the tasks (one block): pieces of at most `piece` rows a
//          bin, about TARGET_TASKS in all, so a hot bin splits across
//          blocks and never falls to one; with bins enough to fill the
//          card a bin near the mean stays whole;
//       5. reduce: a block a piece sums it into its slab in shared memory
//          and adds the slab once into the bin's slice of the output when
//          the bin is one piece, else writes it as a partial slab;
//       6. combine: bins of several pieces add their partial slabs, in a
//          fixed order, into the output.
// At D = 1 (every main-path call) a thread loads 4 ids and 4 values with
// one 8- or 16-byte load each, drops ids outside [0, K) before any add,
// and equal ids adjacent in the warp (sorted ids, runs, all rows on one
// id) collapse to one add through a segmented warp scan, which a warp
// with no such pair skips.  D > 1 is a warp a row, lanes over the
// columns.  Output wider than the slab is cut into column groups and key
// windows of the slab's size, each a work item of its own.
//
// Numbers: int32 sums are exact (two's complement wraps as index_add_
// does).  float32 adds in run-dependent order (shared and global atomics)
// and then in a fixed one, so sums of integer-valued floats below 2^24
// are exact; otherwise they agree with a sequential sum up to reordering.
// Nothing rounds through another type.
//
// Workspace (segment_sum_workspace_bytes, spmv_ell_workspace_bytes, from
// make_layout): partitioned, 6 bytes a row of room (9/8 of the rows + 1032
// a bin from 2^20 rows) + bin tables and tasks (< 100 KB) + partial slabs
// (at most 2 TARGET_TASKS x kpb (D + counts) 4 bytes: 66 MB at D = 1):
// 520 MB at 2^26 rows; private, the chunks' slabs (at most TARGET_TASKS x
// 128 KB); direct, none.  Shared memory a block: reduce the slab (up to
// 128 KB), partition 192 KB + 16 bytes a bin, count 4 bytes a bin.
#pragma once

#include <algorithm>
#include <type_traits>

#include "collapse.cuh"
#include "common.cuh"

// Internal linkage (the unnamed namespace): segment_sum.cu and spmv_ell.cu
// each build into a library of their own, and a kernel's host stub or a
// function-local static shared between the two would bind across them.
namespace repro {
namespace scatter {
namespace {

constexpr int SLAB_BYTES = 128 * 1024;
constexpr int SLAB_WORDS = SLAB_BYTES / 4;
constexpr int MAX_BINS = 2048;
constexpr int MAX_BIN_KEYS = 1 << 16;        // bin-local ids are 16 bits
constexpr long long MAX_KEYS = (long long)MAX_BINS * MAX_BIN_KEYS;  // 2^27
constexpr int REDUCE_THREADS = 1024;
constexpr int TARGET_TASKS = 2 * SM_COUNT;    // 2 waves of full-slab blocks
constexpr int PIECE_MIN = 4096;
constexpr int PART_THREADS = 1024;
constexpr int PART_BLOCKS = SM_COUNT;         // the partition's grid
constexpr int PART_QUADS = 3;                 // quads of rows a thread a tile
constexpr int TILE = PART_THREADS * PART_QUADS * 4;   // 12288 rows
constexpr int COUNT_THREADS = 512;
constexpr int PLAN_THREADS = 1024;
constexpr int PAD = 8;                        // bin starts: 16-byte aligned
// Bin sizes are estimated from every SAMPLE-th run of 128 rows (exactly
// below SAMPLE_FROM rows); a bin gets 9/8 of its estimate + SLACK rows,
// and a row past its bin's room adds straight into the output.
constexpr int SAMPLE = 16;
constexpr long long SAMPLE_FROM = 1 << 20;
constexpr int SLACK = 1024;
constexpr uint32_t DROPPED = 0xFFFFFFFFu;

struct Task {          // rows [begin, end) of the partition, one bin
  uint32_t begin, end;
  int bin;
  int slot;            // partial slab in scratch, or -1: write the output
};

struct Layout {
  int ok;
  int priv;            // 1: the rows read in place, one bin of all K keys
  int direct;          // 1: D = 1, counts off, above the slab: one pass
  int kpb;             // keys a bin (power of two when partitioned)
  int bin_bits;
  int bins;
  int wkeys;           // keys a slab window
  int nwin;            // windows a bin
  int dg;              // columns a slab
  int ncg;             // column groups
  int counts;
  long long chunks;    // private: row chunks
  long long chunk_rows;
  long long slots;     // partial slabs in scratch
  long long slot_words;
  int sample;          // 1 in `sample` runs of 128 rows counted
  long long rows;      // room of the partition
  size_t off_count, off_start, off_limit, off_cursor, off_meta, off_tasks,
      off_ntasks, off_lid, off_pay, off_scratch, total;
};

inline size_t align_up(size_t x, size_t a) { return (x + a - 1) / a * a; }

inline Layout make_layout(long long n, int d, int k, int counts) {
  Layout L = {};
  const int c = counts ? 1 : 0;
  const long long per_key = (long long)d + c;     // words a key
  L.counts = c;
  if (k <= 0 || n < 0 || n >= (1ll << 31) || d < 0 || per_key == 0 ||
      k > MAX_KEYS)
    return L;
  L.ok = 1;
  size_t off = 0;
  if (per_key * k <= SLAB_WORDS) {
    L.priv = 1;
    L.kpb = L.wkeys = k;
    L.bins = L.nwin = L.ncg = 1;
    L.dg = d;
    // a chunk's slab costs as much as 4 x its words of rows, at least
    // PIECE_MIN rows, at most TARGET_TASKS chunks
    long long want = n / std::max<long long>(4 * per_key * k, PIECE_MIN);
    want = std::min<long long>(std::max<long long>(want, 1), TARGET_TASKS);
    L.chunk_rows = align_up((size_t)((n + want - 1) / want), 4);
    if (L.chunk_rows == 0) L.chunk_rows = 4;
    L.chunks = n ? (n + L.chunk_rows - 1) / L.chunk_rows : 1;
    L.slots = L.chunks > 1 ? L.chunks : 0;
    L.slot_words = per_key * k;
  } else if (d == 1 && !c) {
    L.direct = 1;
  } else {
    L.dg = (int)std::min<long long>(d, SLAB_WORDS - c);
    L.ncg = d ? (d + L.dg - 1) / L.dg : 1;
    int w = 1;
    while ((long long)2 * w * (L.dg + c) <= SLAB_WORDS &&
           2 * w <= MAX_BIN_KEYS)
      w *= 2;
    L.wkeys = w;
    int kpb = w;
    while ((long long)kpb * MAX_BINS < k) kpb *= 2;
    L.kpb = kpb;
    L.bin_bits = 0;
    while ((1 << L.bin_bits) < kpb) ++L.bin_bits;
    L.nwin = kpb / w;
    L.bins = (int)((k + (long long)kpb - 1) / kpb);
    L.slots = std::min<long long>(2 * TARGET_TASKS, 2 * (n / PIECE_MIN));
    L.slot_words = per_key * kpb;
    L.sample = n >= SAMPLE_FROM ? SAMPLE : 1;
    const long long rows = (long long)align_up(
        n + (L.sample > 1 ? n / 8 : 0) + (long long)(SLACK + PAD) * L.bins,
        PAD);
    L.rows = rows;
    L.off_count = off;
    off = align_up(off + 4 * (size_t)L.bins, 256);
    L.off_start = off;
    off = align_up(off + 4 * (size_t)L.bins, 256);
    L.off_limit = off;
    off = align_up(off + 4 * (size_t)L.bins, 256);
    L.off_cursor = off;
    off = align_up(off + 4 * (size_t)L.bins, 256);
    L.off_meta = off;
    off = align_up(off + 8 * (size_t)L.bins, 256);
    L.off_ntasks = off;
    off = align_up(off + 8, 256);
    L.off_tasks = off;
    off = align_up(off + sizeof(Task) * (size_t)(L.bins + n / PIECE_MIN + 1 +
                                                 2 * TARGET_TASKS), 256);
    L.off_lid = off;
    off = align_up(off + 2 * (size_t)rows, 256);
    L.off_pay = off;
    off = align_up(off + 4 * (size_t)rows, 256);
  }
  L.off_scratch = off;
  off = align_up(off + 4 * (size_t)L.slots * L.slot_words, 256);
  L.total = std::max<size_t>(off, 256);
  return L;
}

// ---------------------------------------------------------------------------
// device helpers
// ---------------------------------------------------------------------------

// Exclusive prefix of x over the block (blockDim a multiple of 32, at most
// 1024); *total gets the sum.  `ws` is 33 words of shared memory.
__device__ inline uint32_t block_exclusive_scan(uint32_t x, uint32_t* ws,
                                                uint32_t* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  uint32_t incl = x;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const uint32_t o = __shfl_up_sync(FULL_MASK, incl, off);
    if (lane >= off) incl += o;
  }
  if (lane == 31) ws[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const uint32_t v = lane < nwarps ? ws[lane] : 0;
    uint32_t s = v;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const uint32_t o = __shfl_up_sync(FULL_MASK, s, off);
      if (lane >= off) s += o;
    }
    ws[lane] = s - v;
    if (lane == 31) ws[32] = s;
  }
  __syncthreads();
  const uint32_t out = ws[warp] + incl - x;
  *total = ws[32];
  __syncthreads();
  return out;
}

// One for this lane's row on its bin's shared counter: a warp whose lanes
// are all live and share one bin adds 32 once (a hot bin would otherwise
// take 32 atomics on one word), otherwise each live lane adds its own.
__device__ inline void count_in_bin(uint32_t* hist, bool live, uint32_t bin) {
  const uint32_t b0 = __shfl_sync(FULL_MASK, bin, 0);
  if (__all_sync(FULL_MASK, live && bin == b0)) {
    if ((threadIdx.x & 31) == 0) atomicAdd(&hist[b0], 32u);
  } else if (live) {
    atomicAdd(&hist[bin], 1u);
  }
}

template <typename T>
__device__ inline T from_bits(uint32_t b) { return (T)b; }
template <>
__device__ inline float from_bits<float>(uint32_t b) {
  return __uint_as_float(b);
}

// red.global.add that asks L2 to keep the line (the output stays resident
// while the rows stream past it)
__device__ inline void red_keep(float* p, float v, uint64_t policy) {
  asm volatile("red.global.add.L2::cache_hint.f32 [%0], %1, %2;" ::"l"(p),
               "f"(v), "l"(policy) : "memory");
}
__device__ inline void red_keep(int* p, int v, uint64_t policy) {
  asm volatile("red.global.add.L2::cache_hint.s32 [%0], %1, %2;" ::"l"(p),
               "r"(v), "l"(policy) : "memory");
}

// ---------------------------------------------------------------------------
// kernels
// ---------------------------------------------------------------------------

// 1. rows in range a bin, into bin_count (zeroed beforehand), over every
// sample-th run of 128 rows (a warp's 32 quads)
__global__ void __launch_bounds__(COUNT_THREADS)
    count_kernel(const int32_t* __restrict__ seg, long long n, int k,
                 int bin_bits, int bins, int aligned, int sample,
                 uint32_t* __restrict__ bin_count) {
  extern __shared__ uint32_t hist[];
  for (int b = threadIdx.x; b < bins; b += COUNT_THREADS) hist[b] = 0;
  __syncthreads();
  const long long runs = (n + 127) / 128;
  const long long warps = (long long)gridDim.x * (COUNT_THREADS / 32);
  const long long warp = blockIdx.x * (COUNT_THREADS / 32) + threadIdx.x / 32;
  // whole warps iterate together (count_in_bin votes)
  for (long long run = warp * sample; run < runs; run += warps * sample) {
    const long long row = 128 * run + 4 * (threadIdx.x & 31);
    int id[4] = {-1, -1, -1, -1};
    if (aligned && row + 3 < n) {
      const int4 s = __ldcs(reinterpret_cast<const int4*>(seg + row));
      id[0] = s.x; id[1] = s.y; id[2] = s.z; id[3] = s.w;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (row + j < n) id[j] = seg[row + j];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool live = id[j] >= 0 && id[j] < k;
      count_in_bin(hist, live, live ? (uint32_t)id[j] >> bin_bits : 0u);
    }
  }
  __syncthreads();
  for (int b = threadIdx.x; b < bins; b += COUNT_THREADS)
    if (hist[b]) atomicAdd(&bin_count[b], hist[b]);
}

// 2. (one block) each bin's room from its estimate: 9/8 of it plus SLACK
// rows, padded to PAD, never past the partition's `rows`; its start, end
// (limit) and cursor
__global__ void __launch_bounds__(PLAN_THREADS)
    plan_bins_kernel(const uint32_t* __restrict__ bin_count, int bins,
                     int sample, long long rows, uint32_t* __restrict__ start,
                     uint32_t* __restrict__ limit,
                     uint32_t* __restrict__ cursor) {
  __shared__ uint32_t ws[33];
  const int per = (bins + PLAN_THREADS - 1) / PLAN_THREADS;   // <= 4
  const int b0 = threadIdx.x * per;
  uint32_t room[4], mine = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t c = i < per && b0 + i < bins ? bin_count[b0 + i] : 0u;
    const uint32_t r = sample > 1 ? c * sample + c * sample / 8 + SLACK : c;
    room[i] = i < per && b0 + i < bins ? (r + PAD - 1) / PAD * PAD : 0u;
    mine += room[i];
  }
  uint32_t total;
  uint32_t at = block_exclusive_scan(mine, ws, &total);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int b = b0 + i;
    if (i >= per || b >= bins) break;
    const uint32_t lo = (uint32_t)min((long long)at, rows);
    start[b] = lo;
    cursor[b] = lo;
    limit[b] = (uint32_t)min((long long)at + room[i], rows);
    at += room[i];
  }
}

// 3b. (one block, after the partition) each bin's rows, pieces of at most
// `piece` rows (about TARGET_TASKS in all: a hot bin splits across
// blocks), and partial-slab slots for bins of several pieces
__global__ void __launch_bounds__(PLAN_THREADS)
    plan_tasks_kernel(const uint32_t* __restrict__ start,
                      const uint32_t* __restrict__ limit,
                      const uint32_t* __restrict__ cursor, int bins,
                      int2* __restrict__ meta, Task* __restrict__ tasks,
                      uint32_t* __restrict__ ntasks) {
  __shared__ uint32_t ws[33];
  const int per = (bins + PLAN_THREADS - 1) / PLAN_THREADS;   // <= 4
  const int b0 = threadIdx.x * per;
  uint32_t cnt[4], mine = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int b = b0 + i;
    cnt[i] = i < per && b < bins ? min(cursor[b], limit[b]) - start[b] : 0u;
    mine += cnt[i];
  }
  uint32_t total;
  block_exclusive_scan(mine, ws, &total);
  // about TARGET_TASKS pieces in all, counting the one a bin may add by
  // rounding up; with bins enough to fill the card, a bin near the mean
  // stays whole (one piece writes its slice: no partial slabs to add)
  const uint32_t target = max(TARGET_TASKS - bins, TARGET_TASKS / 2);
  uint32_t piece = (total + target - 1) / target;
  if (2 * bins >= TARGET_TASKS)
    piece = max(piece, (uint32_t)(((unsigned long long)total * 5 / 4 +
                                   bins - 1) / bins));
  piece = (piece + PAD - 1) / PAD * PAD;
  if (piece < PIECE_MIN) piece = PIECE_MIN;
  uint32_t pieces = 0, slots = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (i < per && b0 + i < bins) {
      const uint32_t p = cnt[i] ? (cnt[i] + piece - 1) / piece : 1;
      pieces += p;
      slots += p > 1 ? p : 0;
    }
  uint32_t t_all, s_all;
  uint32_t tfirst = block_exclusive_scan(pieces, ws, &t_all);
  uint32_t sfirst = block_exclusive_scan(slots, ws, &s_all);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int b = b0 + i;
    if (i >= per || b >= bins) break;
    const uint32_t p = cnt[i] ? (cnt[i] + piece - 1) / piece : 1;
    meta[b] = make_int2((int)sfirst, p > 1 ? (int)p : 0);
    for (uint32_t j = 0; j < p; ++j) {
      Task t;
      t.begin = start[b] + j * piece;
      t.end = min(start[b] + cnt[i], t.begin + piece);
      t.bin = b;
      t.slot = p > 1 ? (int)(sfirst + j) : -1;
      tasks[tfirst + j] = t;
    }
    tfirst += p;
    sfirst += p > 1 ? p : 0;
  }
  if (threadIdx.x == 0) {
    ntasks[0] = t_all;
    ntasks[1] = s_all;          // partial slabs: none, and combine returns
  }
}

// shared-memory address, mbarrier and bulk-copy helpers (as flash_attention.cu)
__device__ inline uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ inline void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  }
}

// `bytes` (a multiple of 16, both addresses 16-byte aligned) from device
// memory into shared memory, completing on `bar`
__device__ inline void bulk_load(void* dst, const void* src, uint32_t bytes,
                                 uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)), "l"(src), "r"(bytes),
      "r"(smem_addr(bar)) : "memory");
}

// 3. live rows into their bins' runs: 16-bit bin-local id + 32-bit payload.
// Blocks take tiles grid-strided; a tile reserves its run in each bin with
// one global atomic on the bin's cursor, so consecutive runs of a bin come
// from tiles in flight together and fill their sectors while they are in
// L2.  A full tile's ids (and values at D = 1) arrive by bulk copy into an
// input buffer, the next tile's copy in flight while this one is ranked,
// staged and written; a ragged last tile, or input off 16-byte alignment,
// is loaded by the threads.
__global__ void __launch_bounds__(PART_THREADS, 1)
    partition_kernel(const int32_t* __restrict__ seg,
                     const uint32_t* __restrict__ vals, long long n, int d,
                     int k, int bin_bits, int bins, int aligned,
                     uint32_t* __restrict__ gcursor,
                     const uint32_t* __restrict__ limit,
                     uint16_t* __restrict__ lid_out,
                     uint32_t* __restrict__ pay_out, void* out,
                     int32_t* counts, int is_float) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);       // 16 bytes kept
  int32_t* in_seg = reinterpret_cast<int32_t*>(smem + 16);
  uint32_t* in_val = reinterpret_cast<uint32_t*>(in_seg + TILE);
  uint32_t* s_pay = in_val + (d == 1 ? TILE : 0);
  uint16_t* s_lid = reinterpret_cast<uint16_t*>(s_pay + TILE);
  uint16_t* s_bin = s_lid + TILE;
  uint32_t* hist = reinterpret_cast<uint32_t*>(s_bin + TILE);
  uint32_t* loff = hist + bins;      // a bin's first row in the staging
  uint32_t* shift = loff + bins;     // this tile: staging row -> position
  uint32_t* lim = shift + bins;      // end of a bin's room
  uint32_t* ws = lim + bins;         // 33 words
  const uint32_t lmask = (1u << bin_bits) - 1;
  // tiles wholly inside [0, n) come by bulk copy when the input is aligned
  const long long t_end = (n + TILE - 1) / TILE;
  const long long t_full = aligned ? n / TILE : 0;
  const uint32_t tile_bytes = (d == 1 ? 8 : 4) * TILE;
  const int per = (bins + PART_THREADS - 1) / PART_THREADS;   // <= 4
  for (int b = threadIdx.x; b < bins; b += PART_THREADS) lim[b] = limit[b];
  long long tile = blockIdx.x;
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(
                     smem_addr(bar)) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    if (tile < t_full) {
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                   ::"r"(smem_addr(bar)), "r"(tile_bytes) : "memory");
      bulk_load(in_seg, seg + tile * TILE, 4 * TILE, bar);
      if (d == 1) bulk_load(in_val, vals + tile * TILE, 4 * TILE, bar);
    }
  }
  __syncthreads();
  uint32_t parity = 0;
  for (; tile < t_end; tile += gridDim.x) {
    for (int b = threadIdx.x; b < bins; b += PART_THREADS) hist[b] = 0;
    const bool from_smem = tile < t_full;
    if (from_smem) {
      mbar_wait(bar, parity);
      parity ^= 1;
    }
    int id[PART_QUADS * 4];
    uint32_t pay[PART_QUADS * 4];
#pragma unroll
    for (int q = 0; q < PART_QUADS; ++q) {
      const int r = 4 * (q * PART_THREADS + threadIdx.x);   // row in tile
      const long long row = tile * TILE + r;
      if (from_smem) {
        const int4 s4 = *reinterpret_cast<const int4*>(in_seg + r);
        id[4 * q] = s4.x; id[4 * q + 1] = s4.y;
        id[4 * q + 2] = s4.z; id[4 * q + 3] = s4.w;
        if (d == 1) {
          const uint4 v4 = *reinterpret_cast<const uint4*>(in_val + r);
          pay[4 * q] = v4.x; pay[4 * q + 1] = v4.y;
          pay[4 * q + 2] = v4.z; pay[4 * q + 3] = v4.w;
        }
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          id[4 * q + j] = row + j < n ? seg[row + j] : -1;
          if (d == 1) pay[4 * q + j] = row + j < n ? vals[row + j] : 0u;
        }
      }
      if (d != 1)
#pragma unroll
        for (int j = 0; j < 4; ++j) pay[4 * q + j] = (uint32_t)(row + j);
    }
    __syncthreads();              // input buffer read, hist zeroed
    const long long next = tile + gridDim.x;
    if (threadIdx.x == 0 && next < t_full) {
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                   ::"r"(smem_addr(bar)), "r"(tile_bytes) : "memory");
      bulk_load(in_seg, seg + next * TILE, 4 * TILE, bar);
      if (d == 1) bulk_load(in_val, vals + next * TILE, 4 * TILE, bar);
    }
    // rank each live row in its bin (independent atomics, many in flight);
    // the key keeps the bin and the bin-local id
    uint32_t key[PART_QUADS * 4], rank[PART_QUADS * 4];
#pragma unroll
    for (int i = 0; i < PART_QUADS * 4; ++i) {
      const bool live = id[i] >= 0 && id[i] < k;
      const uint32_t b = (uint32_t)id[i] >> bin_bits;
      key[i] = live ? (b << 16) | ((uint32_t)id[i] & lmask) : DROPPED;
      rank[i] = live ? atomicAdd(&hist[b], 1u) : 0u;
    }
    __syncthreads();
    // each thread scans `per` consecutive bins and reserves their runs
    const int b0 = threadIdx.x * per;
    uint32_t mine = 0;
    for (int i = 0; i < per; ++i)
      if (b0 + i < bins) mine += hist[b0 + i];
    uint32_t live_rows;
    uint32_t off = block_exclusive_scan(mine, ws, &live_rows);
    for (int i = 0; i < per; ++i) {
      const int b = b0 + i;
      if (b >= bins) break;
      const uint32_t h = hist[b];
      loff[b] = off;
      shift[b] = (h ? atomicAdd(&gcursor[b], h) : 0u) - off;
      off += h;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < PART_QUADS * 4; ++i) {
      if (key[i] == DROPPED) continue;
      const uint32_t b = key[i] >> 16;
      const uint32_t pos = loff[b] + rank[i];
      s_lid[pos] = (uint16_t)(key[i] & 0xFFFFu);
      s_bin[pos] = (uint16_t)b;
      s_pay[pos] = pay[i];
    }
    __syncthreads();
    for (uint32_t i = threadIdx.x; i < live_rows; i += PART_THREADS) {
      const uint32_t b = s_bin[i];
      const uint32_t dst = shift[b] + i;
      if (dst < lim[b]) {
        lid_out[dst] = s_lid[i];
        pay_out[dst] = s_pay[i];
      } else {
        // past the bin's room: straight into the (zeroed) output
        const long long key = ((long long)b << bin_bits) + s_lid[i];
        if (d == 1) {
          if (is_float)
            atomicAdd(static_cast<float*>(out) + key,
                      __uint_as_float(s_pay[i]));
          else
            atomicAdd(static_cast<int*>(out) + key, (int)s_pay[i]);
        } else {
          const long long row = s_pay[i];
          for (int c = 0; c < d; ++c) {
            if (is_float)
              atomicAdd(static_cast<float*>(out) + key * d + c,
                        __uint_as_float(vals[row * d + c]));
            else
              atomicAdd(static_cast<int*>(out) + key * d + c,
                        (int)vals[row * d + c]);
          }
        }
        if (counts) atomicAdd(&counts[key], 1);
      }
    }
    __syncthreads();
  }
}

// Shared memory of partition_kernel: input buffer, staging, bin tables,
// scan words and the mbarrier.
inline int partition_smem(int d, int bins) {
  return 16 + (d == 1 ? 8 : 4) * TILE + 8 * TILE + 4 * (4 * bins + 33);
}
static_assert(16 + 16 * TILE + 4 * (4 * MAX_BINS + 33) <= 232448,
              "the partition's shared memory at MAX_BINS fits a block");

struct ReduceArgs {
  const int32_t* seg;     // private: ids in place
  const void* vals;       // private: values in place; partitioned, D > 1
  const uint16_t* lid;    // partitioned: bin-local ids
  const uint32_t* pay;    // partitioned: values (D = 1) or row indices
  const Task* tasks;
  const uint32_t* ntasks;
  void* out;
  int32_t* counts;
  uint32_t* scratch;
  long long n, chunks, chunk_rows, slot_words;
  int d, k, kpb, wkeys, nwin, dg, ncg, with_counts, aligned;
};

// Rows [row, row + 4) of a reduce task (ids -1 past `end`): bin-local ids
// and payloads from the partition, or ids and values in place.
template <typename T, bool PART>
__device__ inline void load_quad(const ReduceArgs& a, const T* vals,
                                 long long row, long long end, int (&id)[4],
                                 T (&v)[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    id[j] = -1;
    v[j] = 0;
  }
  if (PART) {
    if (row + 3 < end) {
      const uint2 li = *reinterpret_cast<const uint2*>(a.lid + row);
      const uint4 pv = __ldcs(reinterpret_cast<const uint4*>(a.pay + row));
      id[0] = li.x & 0xFFFF; id[1] = li.x >> 16;
      id[2] = li.y & 0xFFFF; id[3] = li.y >> 16;
      v[0] = from_bits<T>(pv.x); v[1] = from_bits<T>(pv.y);
      v[2] = from_bits<T>(pv.z); v[3] = from_bits<T>(pv.w);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (row + j < end) {
          id[j] = a.lid[row + j];
          v[j] = from_bits<T>(a.pay[row + j]);
        }
    }
  } else if (a.aligned && row + 3 < end) {
    const int4 s = __ldcs(reinterpret_cast<const int4*>(a.seg + row));
    const uint4 pv = __ldcs(reinterpret_cast<const uint4*>(vals + row));
    id[0] = s.x; id[1] = s.y; id[2] = s.z; id[3] = s.w;
    v[0] = from_bits<T>(pv.x); v[1] = from_bits<T>(pv.y);
    v[2] = from_bits<T>(pv.z); v[3] = from_bits<T>(pv.w);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (row + j < end) {
        id[j] = a.seg[row + j];
        v[j] = vals[row + j];
      }
  }
}

// The quad's rows whose key lies in the slab's window add into it.
template <typename T, bool PART>
__device__ inline void add_quad(const int (&id)[4], const T (&v)[4],
                                long long row, long long end, int lkey0,
                                long long key0, int wlen, T* sums, int* cnt,
                                bool with_counts) {
  int l[4];
  SumCount<T> vc[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    // private: key0 = 0 and wlen = K, so this also drops ids outside
    // [0, K)
    const long long lk = PART ? (long long)(id[j] - lkey0)
                              : (long long)id[j] - key0;
    const bool live = row + j < end && lk >= 0 && lk < wlen;
    l[j] = live ? (int)lk : -1;
    vc[j] = {live ? v[j] : T(0), live};
  }
  collapse_runs(
      l, vc,
      [](SumCount<T> a, SumCount<T> b) {
        return SumCount<T>{a.v + b.v, a.c + b.c};
      },
      [&](int key, SumCount<T> r) {
        atomicAdd(&sums[key], r.v);
        if (with_counts) atomicAdd(&cnt[key], r.c);
      });
}

// 4. a block a (piece, key window, column group): sum into the slab, then
// write the slab once
template <typename T, bool PART>
__global__ void __launch_bounds__(REDUCE_THREADS)
    reduce_kernel(ReduceArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* sums = reinterpret_cast<T*>(smem);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  constexpr int WARPS = REDUCE_THREADS / 32;
  const long long ntasks = PART ? (long long)*a.ntasks : a.chunks;
  const int nsub = a.nwin * a.ncg;
  const T* vals = static_cast<const T*>(a.vals);
  for (long long w = blockIdx.x; w < ntasks * nsub; w += gridDim.x) {
    const long long task = w / nsub;
    const int sub = (int)(w - task * nsub);
    const int win = sub / a.ncg, cg = sub - win * a.ncg;
    int bin, slot;
    long long begin, end;
    if (PART) {
      const Task t = a.tasks[task];
      bin = t.bin;
      begin = t.begin;
      end = t.end;
      slot = t.slot;
    } else {
      bin = 0;
      begin = task * a.chunk_rows;
      end = min(a.n, begin + a.chunk_rows);
      slot = a.chunks > 1 ? (int)task : -1;
    }
    const int lkey0 = win * a.wkeys;                // first key, bin-local
    const long long key0 = (long long)bin * a.kpb + lkey0;
    const int wlen = (int)min((long long)a.wkeys, (long long)a.k - key0);
    const int c0 = cg * a.dg;
    const int cw = min(a.dg, a.d - c0);
    const bool with_counts = a.with_counts && cg == 0;
    int* cnt = reinterpret_cast<int*>(sums + wlen * cw);
    const int words = wlen * cw + (with_counts ? wlen : 0);
    for (int i = threadIdx.x; i < words; i += REDUCE_THREADS)
      reinterpret_cast<uint32_t*>(smem)[i] = 0;
    __syncthreads();
    if (a.d == 1) {
      // whole warps iterate together (collapse_runs shuffles)
      for (long long base = begin; base < end;
           base += 4ll * REDUCE_THREADS) {
        const long long row = base + 4ll * threadIdx.x;
        int id[4];
        T v[4];
        load_quad<T, PART>(a, vals, row, end, id, v);
        add_quad<T, PART>(id, v, row, end, lkey0, key0, wlen, sums, cnt,
                          with_counts);
      }
    } else {
      // a warp a row, lanes over the columns of this group
      for (long long i = begin + warp; i < end; i += WARPS) {
        const long long lk = PART ? (long long)a.lid[i] - lkey0
                                  : (long long)a.seg[i] - key0;
        if (lk < 0 || lk >= wlen) continue;
        const long long row = PART ? (long long)a.pay[i] : i;
        const T* src = vals + row * a.d + c0;
        for (int j = lane; j < cw; j += 32)
          atomicAdd(&sums[lk * cw + j], src[j]);
        if (with_counts && lane == 0) atomicAdd(&cnt[lk], 1);
      }
    }
    __syncthreads();
    if (slot < 0) {
      // the bin's slice of the output: written (private), or added to the
      // rows that found no room in the partition (partitioned: zeroed)
      T* out = static_cast<T*>(a.out);
      for (int i = threadIdx.x; i < wlen * cw; i += REDUCE_THREADS) {
        const int kl = cw == 1 ? i : i / cw;
        T* o = out + (key0 + kl) * a.d + c0 + (i - kl * cw);
        *o = PART ? *o + sums[i] : sums[i];
      }
      if (with_counts)
        for (int i = threadIdx.x; i < wlen; i += REDUCE_THREADS)
          a.counts[key0 + i] = PART ? a.counts[key0 + i] + cnt[i] : cnt[i];
    } else {
      uint32_t* part = a.scratch + slot * a.slot_words;
      const uint32_t* s = reinterpret_cast<const uint32_t*>(sums);
      for (int i = threadIdx.x; i < wlen * cw; i += REDUCE_THREADS) {
        const int kl = cw == 1 ? i : i / cw;
        part[(long long)(lkey0 + kl) * a.d + c0 + (i - kl * cw)] = s[i];
      }
      if (with_counts)
        for (int i = threadIdx.x; i < wlen; i += REDUCE_THREADS)
          part[(long long)a.kpb * a.d + lkey0 + i] = (uint32_t)cnt[i];
    }
    __syncthreads();
  }
}

// The direct variant: D = 1, counts off, output above the slab.  One pass;
// a thread loads 4 ids and 4 values with 16-byte loads, drops ids outside
// [0, K) before any add, and each run of equal ids in the warp adds once
// into the zeroed output with red.global.add.
template <typename T>
__global__ void __launch_bounds__(REDUCE_THREADS)
    direct_kernel(const int32_t* __restrict__ seg, const T* __restrict__ vals,
                  T* __restrict__ out, long long n, int k, int aligned) {
  const long long quads = (n + 3) / 4;
  const long long stride = 2ll * gridDim.x * REDUCE_THREADS;
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;"
               : "=l"(policy));
  // two quads a thread an iteration, both loaded before either adds; whole
  // warps iterate together (collapse_runs shuffles)
  for (long long base = 2ll * blockIdx.x * REDUCE_THREADS; base < quads;
       base += stride) {
    int id[2][4];
    T v[2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long row = 4 * (base + h * REDUCE_THREADS + threadIdx.x);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        id[h][j] = -1;
        v[h][j] = 0;
      }
      if (aligned && row + 3 < n) {
        const int4 s4 = __ldcs(reinterpret_cast<const int4*>(seg + row));
        const uint4 v4 = __ldcs(reinterpret_cast<const uint4*>(vals + row));
        id[h][0] = s4.x; id[h][1] = s4.y; id[h][2] = s4.z; id[h][3] = s4.w;
        v[h][0] = from_bits<T>(v4.x); v[h][1] = from_bits<T>(v4.y);
        v[h][2] = from_bits<T>(v4.z); v[h][3] = from_bits<T>(v4.w);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (row + j < n) {
            id[h][j] = seg[row + j];
            v[h][j] = vals[row + j];
          }
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      int l[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool live = id[h][j] >= 0 && id[h][j] < k;
        l[j] = live ? id[h][j] : -1;
        if (!live) v[h][j] = 0;
      }
      collapse_runs(
          l, v[h], [](T a, T b) { return a + b; },
          [&](int key, T val) { red_keep(out + key, val, policy); });
    }
  }
}

// 5. bins of several pieces: their partial slabs, added in slot order (to
// the overflow rows' sums when partitioned, over a zeroed output otherwise)
template <typename T>
__global__ void combine_kernel(const uint32_t* __restrict__ nslots,
                               const int2* __restrict__ meta, int priv_slots,
                               const uint32_t* __restrict__ scratch,
                               T* __restrict__ out,
                               int32_t* __restrict__ counts, int k, int d,
                               int kpb, long long slot_words) {
  if (nslots && *nslots == 0) return;
  const long long sums = (long long)k * d;
  const long long total = sums + (counts ? k : 0);
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       e < total; e += (long long)gridDim.x * blockDim.x) {
    const bool is_sum = e < sums;
    const long long key = is_sum ? (d == 1 ? e : e / d) : e - sums;
    const int bin = (int)(key / kpb);
    const int2 m = meta ? meta[bin] : make_int2(0, priv_slots);
    if (m.y == 0) continue;
    const long long lk = key - (long long)bin * kpb;
    const long long off = is_sum ? lk * d + (e - key * d)
                                 : (long long)kpb * d + lk;
    const uint32_t* p = scratch + m.x * slot_words + off;
    if (is_sum) {
      T acc = 0;
      for (int s = 0; s < m.y; ++s) acc += from_bits<T>(p[s * slot_words]);
      out[e] = meta ? out[e] + acc : acc;
    } else {
      int32_t acc = 0;
      for (int s = 0; s < m.y; ++s) acc += (int32_t)p[s * slot_words];
      counts[key] = meta ? counts[key] + acc : acc;
    }
  }
}

// Blocks of the reduce kernel: as many as fit the card at this slab size,
// at most `items`.
template <typename T, bool PART>
inline int reduce_grid(int smem, long long items) {
  static bool ready = false;
  if (!ready) {
    cudaFuncSetAttribute(reduce_kernel<T, PART>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         SLAB_BYTES);
    ready = true;
  }
  int per_sm = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, reduce_kernel<T, PART>, REDUCE_THREADS, smem);
  return (int)std::max<long long>(
      1, std::min<long long>(items, (long long)std::max(per_sm, 1) *
                                        SM_COUNT));
}

template <typename T>
int launch_typed(const Layout& L, const int32_t* seg, const void* vals,
                 void* out, int32_t* counts, long long n, int d, int k,
                 unsigned char* ws, cudaStream_t stream) {
  ReduceArgs a = {};
  a.seg = seg;
  a.vals = vals;
  a.out = out;
  a.counts = L.counts ? counts : nullptr;
  a.scratch = reinterpret_cast<uint32_t*>(ws + L.off_scratch);
  a.n = n;
  a.d = d;
  a.k = k;
  a.kpb = L.kpb;
  a.wkeys = L.wkeys;
  a.nwin = L.nwin;
  a.dg = L.dg;
  a.ncg = L.ncg;
  a.with_counts = L.counts;
  a.slot_words = L.slot_words;
  a.aligned = ((reinterpret_cast<uintptr_t>(seg) |
                reinterpret_cast<uintptr_t>(vals)) & 15) == 0;
  // the slab: a window's keys x (its columns + the count)
  const int smem = (int)align_up(
      (size_t)L.wkeys * ((size_t)L.dg + L.counts) * 4, 16);
  if (L.direct) {
    static int per_sm = 0;
    if (per_sm == 0) {
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, direct_kernel<T>, REDUCE_THREADS, 0);
      if (per_sm < 1) per_sm = 1;
    }
    cudaMemsetAsync(out, 0, (size_t)k * sizeof(T), stream);
    const long long blocks = ((n + 3) / 4 + 2 * REDUCE_THREADS - 1) /
                             (2 * REDUCE_THREADS);
    if (blocks > 0)
      direct_kernel<T><<<(int)std::min<long long>(blocks,
                                                  (long long)per_sm * SM_COUNT),
                         REDUCE_THREADS, 0, stream>>>(
          seg, static_cast<const T*>(vals), static_cast<T*>(out), n, k,
          a.aligned);
    return (int)cudaGetLastError();
  }
  if (L.priv) {
    a.chunks = L.chunks;
    a.chunk_rows = L.chunk_rows;
    const int grid = reduce_grid<T, false>(smem, L.chunks);
    reduce_kernel<T, false><<<grid, REDUCE_THREADS, smem, stream>>>(a);
    if (L.slots)
      combine_kernel<T><<<grid_for((long long)k * (d + L.counts), 256), 256,
                          0, stream>>>(nullptr, nullptr, (int)L.slots,
                                       a.scratch, (T*)out, a.counts, k, d,
                                       L.kpb, L.slot_words);
    return (int)cudaGetLastError();
  }
  uint32_t* bin_count = reinterpret_cast<uint32_t*>(ws + L.off_count);
  uint32_t* start = reinterpret_cast<uint32_t*>(ws + L.off_start);
  uint32_t* limit = reinterpret_cast<uint32_t*>(ws + L.off_limit);
  uint32_t* cursor = reinterpret_cast<uint32_t*>(ws + L.off_cursor);
  int2* meta = reinterpret_cast<int2*>(ws + L.off_meta);
  uint32_t* ntasks = reinterpret_cast<uint32_t*>(ws + L.off_ntasks);
  Task* tasks = reinterpret_cast<Task*>(ws + L.off_tasks);
  uint16_t* lid = reinterpret_cast<uint16_t*>(ws + L.off_lid);
  uint32_t* pay = reinterpret_cast<uint32_t*>(ws + L.off_pay);
  const int seg_aligned = (reinterpret_cast<uintptr_t>(seg) & 15) == 0;
  // the outputs start at zero: rows past their bin's room add into them
  // during the partition, the reduce and combine add the rest
  cudaMemsetAsync(out, 0, (size_t)k * d * sizeof(T), stream);
  if (a.counts) cudaMemsetAsync(a.counts, 0, (size_t)k * 4, stream);
  cudaMemsetAsync(bin_count, 0, 4 * (size_t)L.bins, stream);
  if (n > 0)
    count_kernel<<<4 * SM_COUNT, COUNT_THREADS, 4 * L.bins, stream>>>(
        seg, n, k, L.bin_bits, L.bins, seg_aligned, L.sample, bin_count);
  plan_bins_kernel<<<1, PLAN_THREADS, 0, stream>>>(
      bin_count, L.bins, L.sample, L.rows, start, limit, cursor);
  if (n > 0) {
    const int psmem = partition_smem(d, L.bins);
    cudaFuncSetAttribute(partition_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, psmem);
    const long long tiles = (n + TILE - 1) / TILE;
    partition_kernel<<<(int)std::min<long long>(tiles, PART_BLOCKS),
                       PART_THREADS, psmem, stream>>>(
        seg, static_cast<const uint32_t*>(vals), n, d, k, L.bin_bits, L.bins,
        d == 1 ? a.aligned : seg_aligned, cursor, limit, lid, pay, out,
        a.counts, std::is_same<T, float>::value);
  }
  plan_tasks_kernel<<<1, PLAN_THREADS, 0, stream>>>(start, limit, cursor,
                                                    L.bins, meta, tasks,
                                                    ntasks);
  a.lid = lid;
  a.pay = pay;
  a.tasks = tasks;
  a.ntasks = ntasks;
  const long long max_items =
      (long long)(L.bins + n / PIECE_MIN + 1 + 2 * TARGET_TASKS) * L.nwin *
      L.ncg;
  const int grid = reduce_grid<T, true>(smem, max_items);
  reduce_kernel<T, true><<<grid, REDUCE_THREADS, smem, stream>>>(a);
  if (L.slots)
    combine_kernel<T><<<grid_for((long long)k * (d + L.counts), 256), 256, 0,
                        stream>>>(ntasks + 1, meta, 0, a.scratch, (T*)out,
                                  a.counts, k, d, L.kpb, L.slot_words);
  return (int)cudaGetLastError();
}

// seg [n] int32; vals [n, d] (float32 when is_float, else int32),
// contiguous; out [k, d]; counts [k] int32 or null.  Writes every output
// element.  ws: make_layout(n, d, k, counts != null).total bytes.
inline int launch(const int32_t* seg, const void* vals, void* out,
                  int32_t* counts, long long n, int d, int k, int is_float,
                  void* ws, size_t ws_bytes, cudaStream_t stream) {
  const Layout L = make_layout(n, d, k, counts != nullptr);
  if (!L.ok || ws_bytes < L.total) return (int)cudaErrorInvalidValue;
  unsigned char* w = static_cast<unsigned char*>(ws);
  if (is_float)
    return launch_typed<float>(L, seg, vals, out, counts, n, d, k, w, stream);
  return launch_typed<int>(L, seg, vals, out, counts, n, d, k, w, stream);
}

}  // namespace
}  // namespace scatter
}  // namespace repro
