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
//     the last writers and routes live rows with atomics into the zeroed
//     acc and counts, all in the same launch.
//   * fused_runs_launch (n > 4096): runs after the sort kernel (sort.cu)
//     has written k2_s, mk_s and perm.  The rows arrive sorted by k2, so
//     an affected key's rows are one contiguous run and the Reduce is a
//     segmented sum over sorted runs, not a scatter.  A block stages the
//     keys in shared memory and takes tiles of sorted rows (1024 at D = 1:
//     4 a thread, loaded 16 bytes at a time; a warp's 32 rows at D > 1,
//     lanes over the columns).  It gathers each row's payload, marks the
//     last writers by comparing with the next sorted row, and sums each
//     run's live rows and counts in a fixed order: in the thread, then a
//     segmented scan across the warp and the block.  The run's last row
//     in the tile routes it once (a binary search in shared memory) and
//     stores its slot's sums and count, so no output is added to twice and
//     nothing is zeroed first.  A run that crosses tiles leaves a partial
//     in each tile it touches, and a combine kernel adds them in tile
//     order into the slot.  Each slot whose key has no rows is written as
//     zero by the one tile where its key would sort in.
//
// Numbers: int32 sums are exact.  The large path adds float32 in a fixed
// order, so its acc is the same from run to run (and equals any order's
// sum on integer-valued data); the small path adds with atomics, in a
// run-dependent order (exact on integer-valued data).
//
// What bounds it: device-memory bytes for the large path (each row's lanes,
// payload, validity and sign read once, the sorted outputs written once);
// the sort before it makes one pass a digit that is not constant.  The
// small path is one block and bounded by its own latency.
#include <algorithm>
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int SMALL_MAX = 4096;
constexpr int SMALL_THREADS = 1024;
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
constexpr int MAX_D = 512;
constexpr int MAX_KEYS = 4096;                   // affected-key slots (ops' cap)
constexpr int MAX_COLS = MAX_D / 32;             // columns a lane, D > 1
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
