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
//   * fused_small_launch (n <= ONE_BLOCK_MAX): ONE block, one launch, no
//     memset.  The block is sized to n: a warp up to 128 rows, then 4 rows a
//     thread up to 1,024 threads (m = n rounded up to a power of two, at
//     least 32; R = m / threads rows a thread).  It loads each row's (k2, mk)
//     and its valid/sign bit into registers, and meanwhile copies the
//     affected keys and (D = 1) the values into shared memory with cp.async,
//     so every global load is issued before the sort.  A stable LSD radix
//     sort orders (k2, mk) with the row breaking ties: 8-bit digits over only
//     the bits that vary across the rows (INT32_MAX, the invalid and padding
//     rows, squeezed to just above the largest other key), each pass ranking
//     a warp's rows with __match_any_sync, one exclusive scan of the block's
//     histogram, and a scatter in shared memory (five barriers a pass, one
//     pass a byte of varying bits).  Then the block marks the last writers
//     against the next sorted row, writes the sorted rows, and sums each k2
//     run's live rows in a fixed order: in the thread, then a segmented scan
//     across the warp and the block (D = 1); or a thread a (slot, column)
//     over the slot's run (D > 1; the payload is copied a warp a row, lanes
//     over the columns).  The run's last row routes it (a binary search of
//     the keys in shared memory) and stores its slot's sums and count once; a
//     slot whose key has no row, or repeats the key before it (the INT32_MAX
//     padding), is written as zero.
//   * fused_runs_launch (n above the one-block route): runs after the sort
//     kernel (sort.cu) has written k2_s, mk_s and perm.  The rows arrive
//     sorted by k2, so an affected key's rows are one contiguous run and the
//     Reduce is a segmented sum over sorted runs, not a scatter.  A block
//     stages the keys in shared memory and takes tiles of sorted rows (1024
//     at D = 1: 4 a thread, loaded 16 bytes at a time; a warp's 32 rows at D
//     > 1, lanes over the columns).  It gathers each row's payload, marks the
//     last writers by comparing with the next sorted row, and sums each run's
//     live rows and counts in a fixed order: in the thread, then a segmented
//     scan across the warp and the block.  The run's last row in the tile
//     routes it once (a binary search in shared memory) and stores its slot's
//     sums and count, so no output is added to twice and nothing is zeroed
//     first.  A run that crosses tiles leaves a partial in each tile it
//     touches, and a combine kernel adds them in tile order into the slot.
//     Each slot whose key has no rows is written as zero by the one tile
//     where its key would sort in.
//
// Numbers: int32 sums are exact.  Both paths add float32 in a fixed order,
// so acc is the same from run to run (and equals any order's sum on
// integer-valued data).
//
// What bounds it: device-memory bytes for the large path (each row's lanes,
// payload, validity and sign read once, the sorted outputs written once);
// the sort before it makes one pass a digit that is not constant.  The
// one-block path is bounded by its latency: one round trip to device
// memory for its inputs, then the radix passes on one SM (each a few
// barriers and m / 32 warp-wide steps a digit), and the stores.
#include <algorithm>
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int32_t KEY_MAX = 0x7fffffff;
constexpr int MAX_D = 512;
constexpr int MAX_KEYS = 4096;                   // affected-key slots (ops' cap)
constexpr int MAX_COLS = MAX_D / 32;             // columns a lane, D > 1
constexpr int ONE_BLOCK_MAX = 16384;   // rows the one-block kernel takes
constexpr int ONE_ROWS = 4;            // rows a thread once a warp is full
constexpr int ONE_THREADS = 1024;
// dynamic shared memory a block may take: the H100's 227 KB less room for
// the kernel's static arrays (1.5 KB)
constexpr int ONE_SMEM = 227 * 1024 - 2048;

// 4 bytes from global into shared memory, asynchronously (sm_80+)
__device__ inline void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ inline void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// A key lane as an unsigned digit source: the sign bit flipped (so that
// unsigned order is int32 order), and its all-ones value (INT32_MAX, the
// invalid and padding rows) moved to just above the largest other value
// `top`, so that the bits that vary over the rows are the real keys'.
// The map keeps the order of the values present.
__device__ inline uint32_t squeeze(int32_t v, uint32_t top) {
  const uint32_t u = static_cast<uint32_t>(v) ^ 0x80000000u;
  return (u == 0xffffffffu && top < 0xfffffffeu) ? top + 1 : u;
}

// The radix histogram: a counter a (digit, warp), digit-major, each
// digit's row of `warps` counters padded by one so that a warp's lanes,
// counting different digits, fall in different shared-memory banks.
__device__ inline int hist_at(int digit, int warp, int warps) {
  return digit * (warps + 1) + warp;
}

// Exclusive prefix sums, in place, of the radix histogram read digit-major
// (digit, warp): where each warp's rows of each digit start in the pass's
// output.  8 consecutive counters a thread; each warp scans the warps'
// totals itself; two barriers.
__device__ inline void scan_hist(uint32_t* hist, uint32_t* wtot) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int warps = blockDim.x >> 5, lw = __ffs(warps) - 1;
  uint32_t v[8], sum = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int f = tid * 8 + k;         // (f >> lw, f & (warps - 1))
    v[k] = hist[f + (f >> lw)];
    sum += v[k];
  }
  uint32_t inc = sum;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const uint32_t o = __shfl_up_sync(repro::FULL_MASK, inc, off);
    if (lane >= off) inc += o;
  }
  if (lane == 31) wtot[warp] = inc;
  __syncthreads();
  uint32_t w = lane < warps ? wtot[lane] : 0u;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const uint32_t o = __shfl_up_sync(repro::FULL_MASK, w, off);
    if (lane >= off) w += o;
  }
  // the warps before this one, then the threads before this one
  const uint32_t before = __shfl_sync(repro::FULL_MASK, w, (warp + 31) & 31);
  uint32_t run = (warp > 0 ? before : 0u) + inc - sum;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int f = tid * 8 + k;
    hist[f + (f >> lw)] = run;
    run += v[k];
  }
  __syncthreads();
}

// What the run open at this thread's first row brings from the threads
// before it: an exclusive segmented scan, in thread order, of each
// thread's (sum and count since its last run start, start seen), across
// the warp with shuffles and across the warps through shared memory.
template <typename T>
__device__ inline void run_carry(T run, int runc, bool any, T& carry,
                                 int& carryc) {
  __shared__ T wsum[32], wcarry[32];
  __shared__ int wcnt[32], wflag[32], wccarry[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  T sx = run;
  int sc = runc, sf = any;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const T ox = __shfl_up_sync(repro::FULL_MASK, sx, off);
    const int oc = __shfl_up_sync(repro::FULL_MASK, sc, off);
    const int of = __shfl_up_sync(repro::FULL_MASK, sf, off);
    if (lane >= off) {
      if (!sf) {
        sx = ox + sx;
        sc = oc + sc;
      }
      sf |= of;
    }
  }
  T ex = __shfl_up_sync(repro::FULL_MASK, sx, 1);
  int exc = __shfl_up_sync(repro::FULL_MASK, sc, 1);
  int exf = __shfl_up_sync(repro::FULL_MASK, sf, 1);
  if (lane == 0) {
    ex = 0;
    exc = exf = 0;
  }
  if (lane == 31) {
    wsum[warp] = sx;
    wcnt[warp] = sc;
    wflag[warp] = sf;
  }
  __syncthreads();
  if (warp == 0) {
    T ax = lane < warps ? wsum[lane] : (T)0;
    int ac = lane < warps ? wcnt[lane] : 0;
    int af = lane < warps ? wflag[lane] : 1;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const T ox = __shfl_up_sync(repro::FULL_MASK, ax, off);
      const int oc = __shfl_up_sync(repro::FULL_MASK, ac, off);
      const int of = __shfl_up_sync(repro::FULL_MASK, af, off);
      if (lane >= off) {
        if (!af) {
          ax = ox + ax;
          ac = oc + ac;
        }
        af |= of;
      }
    }
    const T px = __shfl_up_sync(repro::FULL_MASK, ax, 1);
    const int pc = __shfl_up_sync(repro::FULL_MASK, ac, 1);
    if (lane < warps) {
      wcarry[lane] = lane ? px : (T)0;
      wccarry[lane] = lane ? pc : 0;
    }
  }
  __syncthreads();
  carry = exf ? ex : wcarry[warp] + ex;
  carryc = exf ? exc : wccarry[warp] + exc;
}

// The one-block path: m = R blockDim.x >= n rows, R rows a thread.
// Dynamic shared memory: the sorted lanes sh, sl [m] int32 and si [m]
// uint16 (2 row + a bit: below 2^15), the keys [key_cap], a scratch (the
// radix histogram during the sort; after it, at D > 1, each slot's run
// [lo, hi) of sorted rows, 16-bit), then at D = 1 the values [n] when
// `stage`.
template <typename T, int R>
__global__ void __launch_bounds__(ONE_THREADS)
one_block_kernel(const int32_t* __restrict__ k2,
                 const int32_t* __restrict__ mk, const T* __restrict__ vals,
                 const uint8_t* __restrict__ valid,
                 const int8_t* __restrict__ sign,
                 const int32_t* __restrict__ keys, int key_cap, int n, int d,
                 int scratch, int stage, int32_t* __restrict__ k2_out,
                 int32_t* __restrict__ mk_out, T* __restrict__ vals_out,
                 uint8_t* __restrict__ live_out, int32_t* __restrict__ perm,
                 T* __restrict__ acc, int32_t* __restrict__ counts) {
  extern __shared__ __align__(16) int32_t sm[];
  __shared__ uint32_t red[6][32], wtot[32];
  const int tid = threadIdx.x, threads = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, warps = threads >> 5;
  const int m = R * threads;
  int32_t* sh = sm;
  int32_t* sl = sm + m;
  uint16_t* si = reinterpret_cast<uint16_t*>(sm + 2 * m);
  int32_t* skeys = sm + 2 * m + m / 2;
  uint32_t* hist = reinterpret_cast<uint32_t*>(skeys + key_cap);
  uint16_t* slo = reinterpret_cast<uint16_t*>(hist);          // D > 1
  uint16_t* shi = slo + key_cap;
  T* svals = reinterpret_cast<T*>(skeys + key_cap + scratch);  // D = 1

  // every global load first: the keys and the values copied into shared
  // memory asynchronously, this thread's rows into registers.  The rows
  // are warp-striped: warp w holds rows w 32 R + 32 r + lane.
  for (int i = tid; i < key_cap; i += threads) cp_async4(skeys + i, keys + i);
  if (d == 1 && stage)
    for (int i = tid; i < n; i += threads) cp_async4(svals + i, vals + i);
  const int base = warp * 32 * R + lane;
  int32_t h[R], l[R], x[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    // padding rows sort after every real row: max keys, rows >= n; x is
    // 2 row + the row's valid-and-positive bit
    const int i = base + 32 * r;
    const bool in = i < n;
    h[r] = in ? k2[i] : KEY_MAX;
    l[r] = in ? mk[i] : KEY_MAX;
    x[r] = (i << 1) | (in && valid[i] != 0 && sign[i] > 0);
  }

  // the bits of k2 and mk that vary over the rows (squeezed), from the
  // largest values below INT32_MAX, then their OR and AND; each warp's
  // part in red, read back by every warp
  const auto in_warps = [&](int row, uint32_t none) {
    return lane < warps ? red[row][lane] : none;
  };
  uint32_t th = 0, tl = 0;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const uint32_t uh = static_cast<uint32_t>(h[r]) ^ 0x80000000u;
    const uint32_t ul = static_cast<uint32_t>(l[r]) ^ 0x80000000u;
    if (uh != 0xffffffffu) th = max(th, uh);
    if (ul != 0xffffffffu) tl = max(tl, ul);
  }
  th = __reduce_max_sync(repro::FULL_MASK, th);
  tl = __reduce_max_sync(repro::FULL_MASK, tl);
  if (lane == 0) {
    red[0][warp] = th;
    red[1][warp] = tl;
  }
  __syncthreads();
  th = __reduce_max_sync(repro::FULL_MASK, in_warps(0, 0u));
  tl = __reduce_max_sync(repro::FULL_MASK, in_warps(1, 0u));
  uint32_t oh = 0, ah = ~0u, ol = 0, al = ~0u;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const uint32_t uh = squeeze(h[r], th), ul = squeeze(l[r], tl);
    oh |= uh;
    ah &= uh;
    ol |= ul;
    al &= ul;
  }
  oh = __reduce_or_sync(repro::FULL_MASK, oh);
  ah = __reduce_and_sync(repro::FULL_MASK, ah);
  ol = __reduce_or_sync(repro::FULL_MASK, ol);
  al = __reduce_and_sync(repro::FULL_MASK, al);
  if (lane == 0) {
    red[2][warp] = oh;
    red[3][warp] = ah;
    red[4][warp] = ol;
    red[5][warp] = al;
  }
  __syncthreads();
  // the bits that vary, of mk then of k2
  const uint32_t vary[2] = {
      __reduce_or_sync(repro::FULL_MASK, in_warps(4, 0u)) ^
          __reduce_and_sync(repro::FULL_MASK, in_warps(5, ~0u)),
      __reduce_or_sync(repro::FULL_MASK, in_warps(2, 0u)) ^
          __reduce_and_sync(repro::FULL_MASK, in_warps(3, ~0u))};
  const uint32_t top[2] = {tl, th};
  int left = 0;                        // radix passes still to run
  for (int k = 0; k < 2; ++k)
    if (vary[k]) left += (31 - __clz(vary[k]) - (__ffs(vary[k]) - 1)) / 8 + 1;

  // stable LSD radix sort, 8-bit digits over the varying bits of mk, then
  // of k2: the row order breaks ties.  A pass ranks each warp's rows in
  // row order (__match_any_sync, a running count a digit in the warp's
  // column of the histogram), scans the histogram, and scatters the rows
  // to their place in shared memory.
  if (left == 0) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      sh[base + 32 * r] = h[r];
      sl[base + 32 * r] = l[r];
      si[base + 32 * r] = static_cast<uint16_t>(x[r]);
    }
  }
  for (int k = 0; k < 2; ++k) {
    if (!vary[k]) continue;
    const int hi_bit = 31 - __clz(vary[k]);
    for (int shift = __ffs(vary[k]) - 1; shift <= hi_bit; shift += 8) {
      --left;
      for (int dg = lane; dg < 256; dg += 32)
        hist[hist_at(dg, warp, warps)] = 0;
      __syncwarp();
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const uint32_t dg = (squeeze(k ? h[r] : l[r], top[k]) >> shift) & 0xff;
        const unsigned peers = __match_any_sync(repro::FULL_MASK, dg);
        const int first = __ffs(peers) - 1;
        uint32_t had = 0;
        if (lane == first)
          had = atomicAdd(hist + hist_at(dg, warp, warps), __popc(peers));
        had = __shfl_sync(repro::FULL_MASK, had, first);
        // the row's rank among its warp's rows of this digit, kept in the
        // high half of x until the scatter
        x[r] = (x[r] & 0xffff) |
               static_cast<int32_t>((had + __popc(peers & ((1u << lane) - 1)))
                                    << 16);
      }
      __syncthreads();
      scan_hist(hist, wtot);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const uint32_t dg = (squeeze(k ? h[r] : l[r], top[k]) >> shift) & 0xff;
        const int pos = hist[hist_at(dg, warp, warps)] + (x[r] >> 16);
        sh[pos] = h[r];
        sl[pos] = l[r];
        si[pos] = static_cast<uint16_t>(x[r]);
      }
      __syncthreads();
      if (left > 0) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          h[r] = sh[base + 32 * r];
          l[r] = sl[base + 32 * r];
          x[r] = si[base + 32 * r];
        }
      }
    }
  }
  cp_async_wait_all();
  if (d > 1)
    for (int s = tid; s < key_cap; s += threads) slo[s] = shi[s] = 0;
  __syncthreads();

  // the sorted rows out, a thread a row in turn (coalesced stores): the
  // last writers, and the live bit in place of si's valid-and-positive
  // bit; at D > 1 each run's first and last row mark its slot's run
  for (int p = tid; p < n; p += threads) {
    const int32_t hp = sh[p], lp = sl[p];
    const int xp = si[p], src = xp >> 1;
    const bool ends = p + 1 == n || sh[p + 1] != hp;
    const bool live = (xp & 1) && (ends || sl[p + 1] != lp);
    k2_out[p] = hp;
    mk_out[p] = lp;
    perm[p] = src;
    live_out[p] = live;
    si[p] = static_cast<uint16_t>((src << 1) | live);
    if (d == 1) {
      vals_out[p] = stage ? svals[src] : vals[src];
    } else {
      const bool starts = p == 0 || sh[p - 1] != hp;
      if (starts || ends) {
        const int slot = repro::find_slot(skeys, key_cap, hp);
        if (slot >= 0) {
          if (starts) slo[slot] = static_cast<uint16_t>(p);
          if (ends) shi[slot] = static_cast<uint16_t>(p + 1);
        }
      }
    }
  }
  __syncthreads();                     // si's live bits, the slots' runs

  if (d == 1) {
    // each run's share of this thread's R consecutive rows, the carry from
    // the threads before, then each run's sum in row order; its last row
    // stores it
    T run = 0;
    int runc = 0;
    bool any = false;
    for (int r = 0; r < R; ++r) {
      const int p = tid * R + r;
      if (p >= n) break;
      const int xp = si[p];
      if (p == 0 || sh[p - 1] != sh[p]) {
        run = 0;
        runc = 0;
        any = true;
      }
      if (xp & 1) {
        run += stage ? svals[xp >> 1] : vals[xp >> 1];
        ++runc;
      }
    }
    T sum;
    int cnt;
    run_carry<T>(run, runc, any, sum, cnt);        // two barriers
    for (int r = 0; r < R; ++r) {
      const int p = tid * R + r;
      if (p >= n) break;
      const int32_t hp = sh[p];
      const int xp = si[p];
      if (p > 0 && sh[p - 1] != hp) {
        sum = 0;
        cnt = 0;
      }
      if (xp & 1) {
        sum += stage ? svals[xp >> 1] : vals[xp >> 1];
        ++cnt;
      }
      if (p + 1 == n || sh[p + 1] != hp) {
        const int slot = repro::find_slot(skeys, key_cap, hp);
        if (slot >= 0) {
          acc[slot] = sum;
          counts[slot] = cnt;
        }
      }
    }
    // the slots no run stores: keys with no row, repeated keys
    for (int s = tid; s < key_cap; s += threads) {
      const int32_t key = skeys[s];
      if ((s > 0 && skeys[s - 1] == key) || repro::find_slot(sh, n, key) < 0) {
        acc[s] = 0;
        counts[s] = 0;
      }
    }
    return;
  }

  // the payload through perm: a warp a row, lanes over the columns
  for (int p = warp; p < n; p += warps) {
    const T* src = vals + (long long)(si[p] >> 1) * d;
    T* dst = vals_out + (long long)p * d;
    T buf[MAX_COLS];
#pragma unroll
    for (int c = 0; c < MAX_COLS; ++c)
      if (lane + 32 * c < d) buf[c] = src[lane + 32 * c];
#pragma unroll
    for (int c = 0; c < MAX_COLS; ++c)
      if (lane + 32 * c < d) dst[lane + 32 * c] = buf[c];
  }
  // every slot's sums, a thread a (slot, column), in row order over the
  // slot's run (empty for keys with no row and repeated keys)
  for (int e = tid; e < key_cap * d; e += threads) {
    const int s = e / d, c = e - s * d;
    const int hi = shi[s];
    T sum = 0;
    int cnt = 0;
    for (int p = slo[s]; p < hi; ++p) {
      const int xp = si[p];
      if (xp & 1) {
        sum += vals[(long long)(xp >> 1) * d + c];
        ++cnt;
      }
    }
    acc[e] = sum;
    if (c == 0) counts[s] = cnt;
  }
}

// ---------------------------------------------------------------------------
// the large path: a segmented sum over the sorted runs
// ---------------------------------------------------------------------------

// 1024-row tiles: ~1 us faster than 2048 below 2^17 rows, the same at 2^20
// (tools/scatter_probes.py --kernels)
constexpr int RUN_THREADS = 256;
constexpr int RUN_ROWS = 4;                      // rows a thread at D = 1
constexpr int TILE = RUN_THREADS * RUN_ROWS;     // rows a tile at D = 1
constexpr int WIDE_THREADS = 256;
constexpr int WIDE_ROWS = 32;                    // rows a warp's tile, D > 1
constexpr int OPEN_START = 1;   // the tile's first run began in an earlier tile
constexpr int OPEN_END = 2;     // its last run goes on past the tile
constexpr int ONE_RUN = 4;      // its first run is its last

// A tile's record for the combine: the flags, the count of the run open
// at its start (head) and of the run that starts in it and goes on past
// it (tail), and the tail's slot.  Their sums are in `head` and `tail`
// ([tiles, d] each).
struct TileInfo {
  int flags, slot, head_cnt, tail_cnt;
};

__device__ inline int as_bits(float v) { return __float_as_int(v); }
__device__ inline int as_bits(int v) { return v; }

// first index of keys[0..cap) above x
__device__ inline int upper_bound(const int32_t* keys, int cap, int32_t x) {
  int lo = 0, hi = cap;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (keys[mid] <= x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__device__ inline bool contains(const int32_t* a, int cnt, int32_t x) {
  int lo = 0, hi = cnt;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] < x) lo = mid + 1; else hi = mid;
  }
  return lo < cnt && a[lo] == x;
}

// Where the run of k2 == key ends in this tile (`sum`, `cnt` over its live
// rows here): the head partial if it began in an earlier tile, the tail
// partial if it starts here and goes on, else its slot's outputs.  Returns
// where its `d` sums go (null: nowhere) and writes the count.
template <typename T>
__device__ inline T* run_target(int32_t key, int cnt, int tile, int d,
                                bool first, bool last, int flags,
                                const int32_t* skeys, int key_cap,
                                TileInfo* info, T* head, T* tail, T* acc,
                                int32_t* counts) {
  if (first && (flags & OPEN_START)) {
    info[tile].head_cnt = cnt;
    return head + (long long)tile * d;
  }
  const int slot = repro::find_slot(skeys, key_cap, key);
  if (last && (flags & OPEN_END)) {
    info[tile].slot = slot;
    info[tile].tail_cnt = cnt;
    return tail + (long long)tile * d;
  }
  if (slot < 0) return nullptr;
  counts[slot] = cnt;
  return acc + (long long)slot * d;
}

// The slots this tile answers for: keys that sort into it, k2_s[base - 1]
// < key <= k2_s[end - 1] (the first tile from below, the last to above).
// A slot whose key has no row here (or repeats the key before it: the
// INT32_MAX padding) gets zero sums and count.
template <typename T>
__device__ inline void zero_absent(const int32_t* skeys, int key_cap,
                                   const int32_t* rows_k2, int cnt,
                                   bool first_tile, int32_t before,
                                   bool last_tile, int32_t last_k2, int d,
                                   T* acc, int32_t* counts, int lane0,
                                   int step) {
  const int lo = first_tile ? 0 : upper_bound(skeys, key_cap, before);
  const int hi = last_tile ? key_cap : upper_bound(skeys, key_cap, last_k2);
  for (int s = lo + lane0; s < hi; s += step) {
    const int32_t key = skeys[s];
    if ((s > 0 && skeys[s - 1] == key) || !contains(rows_k2, cnt, key)) {
      for (int c = 0; c < d; ++c) acc[(long long)s * d + c] = 0;
      counts[s] = 0;
    }
  }
}

// D = 1: a block a tile of TILE sorted rows at a time, 4 a thread
template <typename T>
__global__ void __launch_bounds__(RUN_THREADS)
runs_kernel(const int32_t* __restrict__ k2_s, const int32_t* __restrict__ mk_s,
            const int32_t* __restrict__ perm, const T* __restrict__ vals,
            const uint8_t* __restrict__ valid, const int8_t* __restrict__ sign,
            const int32_t* __restrict__ keys, int key_cap, int n, int tiles,
            int aligned, T* __restrict__ vals_out,
            uint8_t* __restrict__ live_out, T* __restrict__ acc,
            int32_t* __restrict__ counts, TileInfo* __restrict__ info,
            T* __restrict__ head, T* __restrict__ tail) {
  constexpr int WARPS = RUN_THREADS / 32;
  extern __shared__ __align__(16) int32_t sm[];
  int32_t* sk2 = sm;                   // the tile's k2 [TILE]
  int32_t* smk = sm + TILE;            // and mk [TILE]
  int32_t* skeys = sm + 2 * TILE;      // the affected keys [key_cap]
  __shared__ T wsum[WARPS], wcarry[WARPS];
  __shared__ int wcnt[WARPS], wflag[WARPS], wccarry[WARPS];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int i = tid; i < key_cap; i += RUN_THREADS) skeys[i] = keys[i];
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int base = tile * TILE;
    const int cnt = min(n - base, TILE);
    const int end = base + cnt;
    const int i0 = RUN_ROWS * tid;                 // first row, tile-local
    const int p0 = base + i0;
    int h[4], m[4], r[4];
    if (aligned && i0 + 3 < cnt) {
      const int4 a = *reinterpret_cast<const int4*>(k2_s + p0);
      const int4 b = *reinterpret_cast<const int4*>(mk_s + p0);
      const int4 c = *reinterpret_cast<const int4*>(perm + p0);
      h[0] = a.x; h[1] = a.y; h[2] = a.z; h[3] = a.w;
      m[0] = b.x; m[1] = b.y; m[2] = b.z; m[3] = b.w;
      r[0] = c.x; r[1] = c.y; r[2] = c.z; r[3] = c.w;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool in = i0 + j < cnt;
        h[j] = in ? k2_s[p0 + j] : 0;
        m[j] = in ? mk_s[p0 + j] : 0;
        r[j] = in ? perm[p0 + j] : 0;
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (i0 + j < cnt) {
        sk2[i0 + j] = h[j];
        smk[i0 + j] = m[j];
      }
    __syncthreads();
    // the rows on either side of the tile, and the tile's flags
    const int32_t before = base > 0 ? k2_s[base - 1] : 0;
    const int32_t after_k2 = end < n ? k2_s[end] : 0;
    const int32_t after_mk = end < n ? mk_s[end] : 0;
    const int32_t first_k2 = sk2[0], last_k2 = sk2[cnt - 1];
    const int flags = (base > 0 && before == first_k2 ? OPEN_START : 0) |
                      (end < n && after_k2 == last_k2 ? OPEN_END : 0) |
                      (first_k2 == last_k2 ? ONE_RUN : 0);
    if (tid == 0) info[tile].flags = flags;

    // gather, last writers, each row's share of its run
    T x[4], vo[4];
    int c[4];
    bool starts[4], ends[4];
    uint8_t lv[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int i = i0 + j;
      x[j] = vo[j] = 0;
      c[j] = lv[j] = 0;
      starts[j] = ends[j] = false;
      if (i >= cnt) continue;
      const int32_t nk = i + 1 < cnt ? sk2[i + 1] : after_k2;
      const int32_t nm = i + 1 < cnt ? smk[i + 1] : after_mk;
      const bool last = base + i + 1 >= n || nk != h[j] || nm != m[j];
      vo[j] = vals[r[j]];
      lv[j] = last && valid[r[j]] != 0 && sign[r[j]] > 0;
      x[j] = lv[j] ? vo[j] : (T)0;
      c[j] = lv[j];
      starts[j] = i == 0 || sk2[i - 1] != h[j];
      ends[j] = i + 1 == cnt || nk != h[j];
    }
    if (aligned && i0 + 3 < cnt) {
      *reinterpret_cast<uchar4*>(live_out + p0) =
          make_uchar4(lv[0], lv[1], lv[2], lv[3]);
      *reinterpret_cast<int4*>(vals_out + p0) = make_int4(
          as_bits(vo[0]), as_bits(vo[1]), as_bits(vo[2]), as_bits(vo[3]));
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (i0 + j < cnt) {
          live_out[p0 + j] = lv[j];
          vals_out[p0 + j] = vo[j];
        }
    }
    // the thread's running sums since its last run start, in row order
    T inc[4];
    int incc[4];
    bool had[4];
    T run = 0;
    int runc = 0;
    bool any = false;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (starts[j]) {
        run = 0;
        runc = 0;
        any = true;
      }
      run += x[j];
      runc += c[j];
      inc[j] = run;
      incc[j] = runc;
      had[j] = any;
    }
    // segmented scan of (start seen, sum, count) over the threads in order:
    // the warp, then the warps
    T sx = run;
    int sc = runc, sf = any;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const T ox = __shfl_up_sync(repro::FULL_MASK, sx, off);
      const int oc = __shfl_up_sync(repro::FULL_MASK, sc, off);
      const int of = __shfl_up_sync(repro::FULL_MASK, sf, off);
      if (lane >= off) {
        if (!sf) {
          sx = ox + sx;
          sc = oc + sc;
        }
        sf |= of;
      }
    }
    T ex = __shfl_up_sync(repro::FULL_MASK, sx, 1);
    int exc = __shfl_up_sync(repro::FULL_MASK, sc, 1);
    int exf = __shfl_up_sync(repro::FULL_MASK, sf, 1);
    if (lane == 0) {
      ex = 0;
      exc = exf = 0;
    }
    if (lane == 31) {
      wsum[warp] = sx;
      wcnt[warp] = sc;
      wflag[warp] = sf;
    }
    __syncthreads();
    if (warp == 0) {
      T ax = lane < WARPS ? wsum[lane] : (T)0;
      int ac = lane < WARPS ? wcnt[lane] : 0;
      int af = lane < WARPS ? wflag[lane] : 1;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const T ox = __shfl_up_sync(repro::FULL_MASK, ax, off);
        const int oc = __shfl_up_sync(repro::FULL_MASK, ac, off);
        const int of = __shfl_up_sync(repro::FULL_MASK, af, off);
        if (lane >= off) {
          if (!af) {
            ax = ox + ax;
            ac = oc + ac;
          }
          af |= of;
        }
      }
      const T px = __shfl_up_sync(repro::FULL_MASK, ax, 1);
      const int pc = __shfl_up_sync(repro::FULL_MASK, ac, 1);
      if (lane < WARPS) {
        wcarry[lane] = lane ? px : (T)0;
        wccarry[lane] = lane ? pc : 0;
      }
    }
    __syncthreads();
    // what the run open at this thread's first row brings from before it
    const T carry = exf ? ex : wcarry[warp] + ex;
    const int carryc = exf ? exc : wccarry[warp] + exc;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (!ends[j]) continue;
      const T sum = had[j] ? inc[j] : carry + inc[j];
      const int sumc = had[j] ? incc[j] : carryc + incc[j];
      T* dst = run_target<T>(h[j], sumc, tile, 1, h[j] == first_k2,
                             h[j] == last_k2, flags, skeys, key_cap, info,
                             head, tail, acc, counts);
      if (dst) *dst = sum;
    }
    zero_absent<T>(skeys, key_cap, sk2, cnt, base == 0, before, end == n,
                   last_k2, 1, acc, counts, tid, RUN_THREADS);
    __syncthreads();                    // sk2 and the warp sums are reused
  }
}

// D > 1: a warp a tile of WIDE_ROWS sorted rows, a lane a row for the
// lanes, lanes over the columns for the payload and the sums
template <typename T>
__global__ void __launch_bounds__(WIDE_THREADS)
wide_runs_kernel(const int32_t* __restrict__ k2_s,
                 const int32_t* __restrict__ mk_s,
                 const int32_t* __restrict__ perm, const T* __restrict__ vals,
                 const uint8_t* __restrict__ valid,
                 const int8_t* __restrict__ sign,
                 const int32_t* __restrict__ keys, int key_cap, int n, int d,
                 int tiles, T* __restrict__ vals_out,
                 uint8_t* __restrict__ live_out, T* __restrict__ acc,
                 int32_t* __restrict__ counts, TileInfo* __restrict__ info,
                 T* __restrict__ head, T* __restrict__ tail) {
  constexpr int WARPS = WIDE_THREADS / 32;
  extern __shared__ __align__(16) int32_t skeys[];
  const int lane = threadIdx.x & 31;
  for (int i = threadIdx.x; i < key_cap; i += WIDE_THREADS) skeys[i] = keys[i];
  __syncthreads();
  for (int tile = blockIdx.x * WARPS + (threadIdx.x >> 5); tile < tiles;
       tile += gridDim.x * WARPS) {
    const int base = tile * WIDE_ROWS;
    const int cnt = min(n - base, WIDE_ROWS);
    const int end = base + cnt;
    const int p = base + lane;
    const bool in = lane < cnt;
    const int32_t h = in ? k2_s[p] : 0, m = in ? mk_s[p] : 0;
    const int r = in ? perm[p] : 0;
    int32_t nk = __shfl_down_sync(repro::FULL_MASK, h, 1);
    int32_t nm = __shfl_down_sync(repro::FULL_MASK, m, 1);
    if (lane == cnt - 1 && end < n) {
      nk = k2_s[end];
      nm = mk_s[end];
    }
    const bool last = p + 1 >= n || nk != h || nm != m;
    const bool ok = in && last && valid[r] != 0 && sign[r] > 0;
    if (in) live_out[p] = ok;
    const bool ends = in && (lane == cnt - 1 || nk != h);
    const int32_t before = base > 0 ? k2_s[base - 1] : 0;
    const int32_t first_k2 = __shfl_sync(repro::FULL_MASK, h, 0);
    const int32_t last_k2 = __shfl_sync(repro::FULL_MASK, h, cnt - 1);
    const int32_t after_k2 = __shfl_sync(repro::FULL_MASK, nk, cnt - 1);
    const int flags = (base > 0 && before == first_k2 ? OPEN_START : 0) |
                      (end < n && after_k2 == last_k2 ? OPEN_END : 0) |
                      (first_k2 == last_k2 ? ONE_RUN : 0);
    if (lane == 0) info[tile].flags = flags;
    T sum[MAX_COLS];
#pragma unroll
    for (int j = 0; j < MAX_COLS; ++j) sum[j] = 0;
    int runc = 0;
    for (int i = 0; i < cnt; ++i) {
      const int ri = __shfl_sync(repro::FULL_MASK, r, i);
      const bool oki = __shfl_sync(repro::FULL_MASK, (int)ok, i);
      const T* src = vals + (long long)ri * d;
      T* dst = vals_out + (long long)(base + i) * d;
#pragma unroll
      for (int j = 0; j < MAX_COLS; ++j) {
        const int col = lane + 32 * j;
        if (col < d) {
          const T v = src[col];
          dst[col] = v;
          if (oki) sum[j] += v;
        }
      }
      runc += oki;
      if (__shfl_sync(repro::FULL_MASK, (int)ends, i)) {
        const int32_t ki = __shfl_sync(repro::FULL_MASK, h, i);
        // every lane finds the target; lane 0 writes the count
        T* out = nullptr;
        if (lane == 0)
          out = run_target<T>(ki, runc, tile, d, ki == first_k2,
                              ki == last_k2, flags, skeys, key_cap, info,
                              head, tail, acc, counts);
        out = reinterpret_cast<T*>(__shfl_sync(
            repro::FULL_MASK, reinterpret_cast<unsigned long long>(out), 0));
        if (out) {
#pragma unroll
          for (int j = 0; j < MAX_COLS; ++j) {
            const int col = lane + 32 * j;
            if (col < d) out[col] = sum[j];
          }
        }
#pragma unroll
        for (int j = 0; j < MAX_COLS; ++j) sum[j] = 0;
        runc = 0;
      }
    }
    // the slots this tile answers for (see zero_absent), a warp a slot
    const int lo = base == 0 ? 0 : upper_bound(skeys, key_cap, before);
    const int hi = end == n ? key_cap : upper_bound(skeys, key_cap, last_k2);
    for (int s = lo; s < hi; ++s) {
      const int32_t key = skeys[s];
      if ((s > 0 && skeys[s - 1] == key) ||
          !__any_sync(repro::FULL_MASK, in && h == key)) {
        for (int col = lane; col < d; col += 32)
          acc[(long long)s * d + col] = 0;
        if (lane == 0) counts[s] = 0;
      }
    }
  }
}

// The runs that cross tiles: a warp a tile whose last run starts in it and
// goes on, adding the head partials of the tiles the run covers, in tile
// order, to the tile's tail partial.  At D = 1 the lanes take 32 tiles at
// a time (a key that owns every row covers every tile); at D > 1 the lanes
// take the columns.
template <typename T>
__global__ void combine_runs_kernel(const TileInfo* __restrict__ info,
                                    const T* __restrict__ head,
                                    const T* __restrict__ tail, int tiles,
                                    int d, T* __restrict__ acc,
                                    int32_t* __restrict__ counts) {
  const int lane = threadIdx.x & 31;
  const int warps = gridDim.x * (blockDim.x >> 5);
  for (int b = (blockIdx.x * blockDim.x + threadIdx.x) >> 5; b < tiles;
       b += warps) {
    const int f = info[b].flags;
    if (!(f & OPEN_END) || ((f & ONE_RUN) && (f & OPEN_START))) continue;
    const int slot = info[b].slot;
    if (slot < 0) continue;
    int total_c = info[b].tail_cnt;
    if (d == 1) {
      T total = tail[b];
      for (int c0 = b + 1;; c0 += 32) {
        const int t = c0 + lane;
        const int ft = t < tiles ? info[t].flags : 0;
        // the run goes on past tile t unless t is where it ends
        const unsigned stop = __ballot_sync(
            repro::FULL_MASK, !((ft & ONE_RUN) && (ft & OPEN_END)));
        const bool take = stop == 0 || lane <= __ffs(stop) - 1;
        T x = take ? head[t] : (T)0;
        int xc = take ? info[t].head_cnt : 0;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          x += __shfl_xor_sync(repro::FULL_MASK, x, off);
          xc += __shfl_xor_sync(repro::FULL_MASK, xc, off);
        }
        total += x;
        total_c += xc;
        if (stop) break;
      }
      if (lane == 0) acc[slot] = total;
    } else {
      for (int col = lane; col < d; col += 32) {
        T total = tail[(long long)b * d + col];
        for (int t = b + 1;; ++t) {
          total += head[(long long)t * d + col];
          const int ft = info[t].flags;
          if (!((ft & ONE_RUN) && (ft & OPEN_END))) break;
        }
        acc[(long long)slot * d + col] = total;
      }
      for (int t = b + 1;; ++t) {
        total_c += info[t].head_cnt;
        const int ft = info[t].flags;
        if (!((ft & ONE_RUN) && (ft & OPEN_END))) break;
      }
    }
    if (lane == 0) counts[slot] = total_c;
  }
}

inline int run_tiles(int n, int d) {
  const int rows = d == 1 ? TILE : WIDE_ROWS;
  return (n + rows - 1) / rows;
}


// The one-block launch of one instantiation; the shared-memory limit is
// raised once for it, not at every launch.
template <typename T, int R>
int launch_one_block(const void* k2, const void* mk, const void* vals,
                     const void* valid, const void* sign, const void* keys,
                     int key_cap, int n, int d, int scratch, int stage,
                     int threads, size_t smem, void* k2_out, void* mk_out,
                     void* vals_out,
                     void* live, void* perm, void* acc, void* counts,
                     cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      one_block_kernel<T, R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      ONE_SMEM);
  if (attr != cudaSuccess) return (int)attr;
  one_block_kernel<T, R><<<1, threads, smem, stream>>>(
      (const int32_t*)k2, (const int32_t*)mk, (const T*)vals,
      (const uint8_t*)valid, (const int8_t*)sign, (const int32_t*)keys,
      key_cap, n, d, scratch, stage, (int32_t*)k2_out, (int32_t*)mk_out,
      (T*)vals_out, (uint8_t*)live, (int32_t*)perm, (T*)acc, (int32_t*)counts);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_one_block_rows(int rows, const void* k2, const void* mk,
                          const void* vals, const void* valid,
                          const void* sign, const void* keys, int key_cap,
                          int n, int d, int scratch, int stage, int threads,
                          size_t smem,
                          void* k2_out, void* mk_out, void* vals_out,
                          void* live, void* perm, void* acc, void* counts,
                          cudaStream_t stream) {
  switch (rows) {
#define REPRO_ONE_BLOCK(R)                                                    \
  case R:                                                                     \
    return launch_one_block<T, R>(k2, mk, vals, valid, sign, keys, key_cap,   \
                                  n, d, scratch, stage, threads, smem,        \
                                  k2_out, mk_out, vals_out, live, perm, acc,  \
                                  counts, stream);
    REPRO_ONE_BLOCK(1)
    REPRO_ONE_BLOCK(2)
    REPRO_ONE_BLOCK(4)
    REPRO_ONE_BLOCK(8)
    REPRO_ONE_BLOCK(16)
#undef REPRO_ONE_BLOCK
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// n <= ONE_BLOCK_MAX rows, one block, one launch.  k2 (invalid rows already
// at INT32_MAX), mk: [n] int32; vals: [n, d] float32 (is_float) or int32;
// valid: [n] uint8; sign: [n] int8; keys: [key_cap] int32.  Outputs:
// k2_out, mk_out, perm [n] int32, vals_out [n, d], live [n] uint8, acc
// [key_cap, d], counts [key_cap] int32, every element written once.
REPRO_EXPORT int fused_small_launch(
    const void* k2, const void* mk, const void* vals, const void* valid,
    const void* sign, const void* keys, int key_cap, int n, int d,
    int is_float, void* k2_out, void* mk_out, void* vals_out, void* live,
    void* perm, void* acc, void* counts, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (n <= 0 || n > ONE_BLOCK_MAX || key_cap <= 0 || key_cap > MAX_KEYS ||
      d <= 0 || d > MAX_D)
    return (int)cudaErrorInvalidValue;
  int m = 32;
  while (m < n) m <<= 1;
  const int threads = std::min(std::max(m / ONE_ROWS, 32), ONE_THREADS);
  // 32-bit words of scratch: the histogram's 256 (warps + 1) counters,
  // or at D > 1 the slots' runs (2 key_cap 16-bit words)
  const int scratch = std::max(256 * (threads / 32 + 1), d > 1 ? key_cap : 0);
  size_t words = (size_t)2 * m + m / 2 + key_cap + scratch;
  // the values go into shared memory while the rows sort, where they fit
  const int stage = d == 1 && (words + n) * 4 <= (size_t)ONE_SMEM;
  if (stage) words += n;
  if (words * 4 > (size_t)ONE_SMEM) return (int)cudaErrorInvalidValue;
  return is_float
      ? launch_one_block_rows<float>(m / threads, k2, mk, vals, valid, sign,
                                     keys, key_cap, n, d, scratch, stage,
                                     threads, words * 4, k2_out, mk_out,
                                     vals_out, live, perm, acc, counts,
                                     stream)
      : launch_one_block_rows<int>(m / threads, k2, mk, vals, valid, sign,
                                   keys, key_cap, n, d, scratch, stage,
                                   threads, words * 4, k2_out, mk_out,
                                   vals_out, live, perm, acc, counts, stream);
}

// Workspace of fused_runs_launch: the tiles' records and partial sums.
REPRO_EXPORT size_t fused_runs_workspace_bytes(int n, int d) {
  const size_t tiles = run_tiles(n, d);
  return tiles * sizeof(TileInfo) + 2 * tiles * (size_t)d * 4;
}

// The large path's epilogue: k2_s, mk_s, perm [n] from the sort kernel;
// ws: fused_runs_workspace_bytes(n, d) bytes, 4-byte aligned; the other
// arguments as for fused_small_launch.  Writes every element of vals_out,
// live, acc and counts.
REPRO_EXPORT int fused_runs_launch(
    const void* k2_s, const void* mk_s, const void* perm, const void* vals,
    const void* valid, const void* sign, const void* keys, int key_cap, int n,
    int d, int is_float, void* vals_out, void* live, void* acc, void* counts,
    void* ws, size_t ws_bytes, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (n <= 0 || key_cap <= 0 || key_cap > MAX_KEYS || d <= 0 || d > MAX_D ||
      ws_bytes < fused_runs_workspace_bytes(n, d))
    return (int)cudaErrorInvalidValue;
  const int tiles = run_tiles(n, d);
  TileInfo* info = static_cast<TileInfo*>(ws);
  uint32_t* head = reinterpret_cast<uint32_t*>(info + tiles);
  uint32_t* tail = head + (size_t)tiles * d;
  const int aligned = ((reinterpret_cast<uintptr_t>(k2_s) |
                        reinterpret_cast<uintptr_t>(mk_s) |
                        reinterpret_cast<uintptr_t>(perm) |
                        reinterpret_cast<uintptr_t>(vals_out)) & 15) == 0 &&
                      (reinterpret_cast<uintptr_t>(live) & 3) == 0;
  const int per_block = d == 1 ? 1 : WIDE_THREADS / 32;
  const int threads = d == 1 ? RUN_THREADS : WIDE_THREADS;
  // at most (2 TILE + MAX_KEYS) 4 = 24 KB, under the 48 KB default
  const int smem = d == 1 ? (2 * TILE + key_cap) * 4 : key_cap * 4;
  auto go = [&](auto kernel, auto* tag) -> int {
    using T = std::remove_pointer_t<decltype(tag)>;
    // blocks an SM at the most shared memory a launch takes, once a kernel
    static int per_sm = 0;
    if (per_sm == 0) {
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, kernel, threads,
          d == 1 ? (2 * TILE + MAX_KEYS) * 4 : MAX_KEYS * 4);
      per_sm = std::max(per_sm, 1);
    }
    const int grid = std::max(1, std::min((tiles + per_block - 1) / per_block,
                                          per_sm * repro::SM_COUNT));
    if (d == 1)
      runs_kernel<T><<<grid, threads, smem, stream>>>(
          (const int32_t*)k2_s, (const int32_t*)mk_s, (const int32_t*)perm,
          (const T*)vals, (const uint8_t*)valid, (const int8_t*)sign,
          (const int32_t*)keys, key_cap, n, tiles, aligned, (T*)vals_out,
          (uint8_t*)live, (T*)acc, (int32_t*)counts, info, (T*)head,
          (T*)tail);
    else
      wide_runs_kernel<T><<<grid, threads, smem, stream>>>(
          (const int32_t*)k2_s, (const int32_t*)mk_s, (const int32_t*)perm,
          (const T*)vals, (const uint8_t*)valid, (const int8_t*)sign,
          (const int32_t*)keys, key_cap, n, d, tiles, (T*)vals_out,
          (uint8_t*)live, (T*)acc, (int32_t*)counts, info, (T*)head,
          (T*)tail);
    if (tiles > 1)
      combine_runs_kernel<T><<<(tiles + 7) / 8, 256, 0, stream>>>(
          info, (const T*)head, (const T*)tail, tiles, d, (T*)acc,
          (int32_t*)counts);
    return (int)cudaGetLastError();
  };
  if (is_float)
    return d == 1 ? go(runs_kernel<float>, (float*)nullptr)
                  : go(wide_runs_kernel<float>, (float*)nullptr);
  return d == 1 ? go(runs_kernel<int>, (int*)nullptr)
                : go(wide_runs_kernel<int>, (int*)nullptr);
}
