// Flash attention, forward: GQA, causal, sliding window, tanh softcap.
//
// Replaces src/repro/kernels/flash_attention.py:82 (flash_attention, whose
// pl.pallas_call walks the KV sequence of one (batch, head, q block) with
// a fori_loop, carrying the streaming-softmax state m, l, acc).  The
// contract is the Pallas kernel's: q [B, H, S, hd], k/v [B, KH, S, hd]
// (H % KH == 0), positions 0..S-1 for both; scores q.k / sqrt(hd) in
// float32, tanh softcap, then the causal and window masks at -2e38;
// m, l, acc in float32 with p rounded to V's type before P.V; the output
// acc / max(l, 1e-30) in q's type.  V may have a head dim of its own, vd
// (DeepSeek-V3's MLA: q.k over 192 = 128 + 64 rope columns, v 128; its
// 100m preset's 96 = 64 + 32 and v 64): v [B, KH, S, vd] and the output
// [B, H, S, vd], the scale still 1 / sqrt(hd), as the reference's dense
// attention (repro/models/blocks.py _attend) takes it; the Pallas kernel
// had one hd for all three.
//
// On the H100 the TPU's sequential grid becomes independent blocks: one
// block per (q tile, head, batch), the KV tiles walked by a loop inside
// it, the heaviest (latest) q tiles launched first.  Tiles wholly after
// the diagonal (causal) or wholly before the window are skipped: every
// row keeps its own diagonal key, so a skipped tile would have added
// exp(-2e38 - m) = 0.  K and V rows past S are zeros and masked, so any
// S runs.  Three kernels, chosen by dtype and head dim:
//
//   dtype    head dim (q.k / v)                    kernel
//   bf16     64, 80, 128, 160, 256; 192/128, 96/64 flash_wgmma_kernel
//                                                  (wgmma + TMA)
//   bf16     16, 32                                flash_mma_kernel (mma.sync)
//   float32  all seven; 192/128, 96/64             flash_f32_kernel (FMAs)
//
//   bf16, hd 64/80/128/160/256 (the serving path): wgmma with a TMA ring.  A
//     block of 384 threads owns 128 q rows of one head: warpgroup 0 is the
//     producer (its registers cut to 40 by setmaxnreg; one thread issues
//     every TMA copy), warpgroups 1 and 2 the consumers (232 registers), 64 q
//     rows each.  Q comes in once by TMA; K and V tiles of BK keys (80 at hd
//     256, 128 below) go through a ring of 2 stages (4 at hd 80) in shared
//     memory, each with its own full and empty mbarriers, so later tiles land
//     while this tile's P.V still reads V.  A tile is a row of TMA boxes,
//     each BOX columns wide and swizzled across its own rows (rows past S
//     arrive as zeros): 64 columns (128-byte rows, the 128-byte swizzle) at
//     the multiples of 64, so hd 256 is 4 boxes; 32 columns (the 64-byte
//     swizzle) at hd 160 and 16 (the 32-byte swizzle) at hd 80, 5 boxes
//     each.  Narrow boxes cost TMA time: read in 16-column boxes through 2
//     stages, hd 128 took 1.3x as long (in 32-column ones no longer); at hd
//     80, 4 stages make 16-column boxes as fast as a 64- and a 16-column box
//     (tools/flash_probes.py).  In every mode the 8 rows of a core matrix
//     fall on distinct banks, and the wgmma descriptors name the box's
//     swizzle, with 8 of its rows as the stride of 8-row groups.  S = Q.K^T
//     is wgmma with A and B from shared memory (both K-major), a k16 step
//     within one box; the streaming softmax runs on the float32 accumulators
//     in registers, in base 2, with the softcap's tanh as 1 - 2 / (2^(2 y
//     log2 e) + 1) (two special-function ops, about 1e-7 absolute, where
//     tanhf is a long software sequence) and the softcap and masks as
//     compile-time variants; P is rounded to bf16 in registers and O += P.V
//     is wgmma with A from registers and V as an MN-major (transposed) B from
//     shared memory: one wgmma of N = hd a k16 step, the boxes BK x 2 BOX
//     bytes apart.  Within a consumer, S of tile t and P.V of tile t-1 are
//     issued together and the softmax of tile t runs while P.V does.  Each
//     consumer skips the tiles that only the other one's rows need.  Not
//     done: a persistent grid, a TMA store of O, and sharing one K/V tile
//     between the two q heads of a KV head (each block loads its own; L2
//     serves the second).  Shared memory: Q 128 x hd + the stages x (K + V)
//     of BK x hd, bf16: 224 KB at hd 256, 200 KB at 160, 180 KB at 80, 160 KB
//     at 128, 80 KB at 64 (plus 1 KB alignment and the barriers).  Registers
//     a consumer thread: hd / 2 float32 for O, BK / 2 for S and BK / 4 for P
//     (128 + 40 + 20 at hd 256, 80 + 64 + 32 at 160).  With a v head dim of
//     its own (VD, MLA's 192 / 128) Q and K are HD columns (three 64-column
//     boxes) and V, P.V, O and the store VD (two): Q 48 KB + 2 stages of K
//     (96 KB) and V (64 KB) = 208 KB; O takes VD / 2 registers.  At 96 / 64
//     (the 100m preset's MLA) the box is the 32 columns that tile 96, in
//     the 64-byte swizzle as at hd 160: Q and K three boxes, V and O two; Q
//     24 KB + 2 stages of K (48 KB) and V (32 KB) = 104 KB.  The rest is
//     the kernel at HD, unchanged: no path of it reads VD apart from V.
//   bf16, hd 16, 32: mma.sync m16n8k16, 4 warps, 64 q rows x 64-key
//     tiles loaded synchronously into shared memory (rows padded by 8
//     elements so fragment loads hit 32 distinct banks: a row is an odd
//     number of 16-byte chunks at both dims); P goes from the S
//     accumulators into A fragments.  These are the smoke configs' heads
//     (hd 16); no full-width arch has them.
//   float32: plain FMAs (the tensor cores' TF32 would break the float32
//     contract), 256 threads, 32 q rows x 32-key tiles in shared
//     memory, 8 threads a row (VD / 8 output columns each).  It serves the
//     float32 checks and models, not the serving path.
//
// What bounds it: at the main shape (B 2, H 16, KH 8, S 8192, hd 256,
// bf16) tensor-core operations: about 1.1e12 FLOP for a global layer
// (4 B H hd x the keys in range) against 0.4 GB of q, k, v and o (0.12 ms
// at 3.35 TB/s); 1.1 ms at 989 TFLOP/s.  What the design still leaves:
// the softmax of a tile takes about as long as its two products (the
// special-function unit does 16 exponentials or reciprocals a cycle an
// SM, and the softcap needs three a score), the two consumers are not
// scheduled against each other (a ping-pong of named barriers measured no
// faster), and O is stored from registers.  At hd 80 (HuBERT's
// layer, 0.17 ms of operations) a tile's products are short beside its
// softmax: without the softmax the layer takes about two thirds of the
// time, without its exponentials seven eighths (tools/flash_probes.py).
#include "common.cuh"
#include "wgmma.cuh"

#include <cuda.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr float NEG = -2.0e38f;
constexpr float LOG2E = 1.4426950408889634f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int B, H, KH, S;
  int causal, window;
  float softcap;          // 0: off
  float scale;            // 1 / sqrt(hd)
};

// KV tiles [t_lo, t_hi) that can hold a key some row of [q0, q1) attends.
__device__ inline void kv_tiles(const Params& p, int q0, int q1, int bk,
                                int& t_lo, int& t_hi) {
  const int k_hi = p.causal ? q1 : p.S;
  const int k_lo = p.window > 0 ? max(0, q0 - p.window + 1) : 0;
  t_lo = k_lo / bk;
  t_hi = (k_hi + bk - 1) / bk;
}

__device__ inline bool key_visible(const Params& p, int qpos, int kpos) {
  return kpos < p.S && (!p.causal || kpos <= qpos) &&
         (p.window <= 0 || qpos - kpos < p.window);
}

__device__ inline float masked_score(const Params& p, float dot, int qpos,
                                     int kpos) {
  float s = dot * p.scale;
  if (p.softcap > 0.f) s = tanhf(s / p.softcap) * p.softcap;
  return key_visible(p, qpos, kpos) ? s : NEG;
}

__device__ inline uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ------------------------------------------- bf16, hd >= 64: wgmma + TMA

__device__ inline float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ inline uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ inline void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(count) : "memory");
}

__device__ inline void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ inline void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                   smem_addr(bar)) : "memory");
}

// Wait until the phase of `bar` with this parity has completed.
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

// One box of a 3-d tensor map (inner coordinate first) into shared memory,
// completing `bytes` on `bar`.
__device__ inline void tma_load_3d(void* dst, const CUtensorMap* map,
                                   uint64_t* bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(smem_addr(bar)) : "memory");
}

// wgmma shared-memory descriptor of a tile of BOX-column boxes in their
// swizzle: start address, leading and stride byte offsets (16-byte
// units), layout 1 (128-byte swizzle), 2 (64-byte) or 3 (32-byte).
template <int BOX>
__device__ inline uint64_t smem_desc(const void* p, uint32_t lbo,
                                     uint32_t sbo) {
  constexpr uint64_t layout = BOX == 64 ? 1 : BOX == 32 ? 2 : 3;
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) |
         ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32) |
         (layout << 62);
}

// Keep the compiler from moving accumulator registers across the async
// wgmma that reads and writes them.
template <int N>
__device__ inline void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ inline void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ inline void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ inline void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

__device__ inline float rcp(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// the widest swizzle row (64, 32 or 16 columns) that tiles a head dim
constexpr int box_of(int d) { return d % 64 == 0 ? 64 : d % 32 == 0 ? 32 : 16; }

template <int HD, int VD>
struct Wg {
  static constexpr int BQ = 128;                 // q rows a block
  // keys a tile: at hd 256 the widest that fits two stages beside Q
  static constexpr int BK = HD == 256 ? 80 : 128;
  // K/V stages in the ring: at hd 80 a tile is short work, and 4 stages
  // (180 KB) keep more loads in flight than 2 (h80s2 in
  // tools/flash_probes.py)
  static constexpr int STAGES = HD == 80 ? 4 : 2;
  static constexpr int THREADS = 384;            // producer + 2 consumers
  // columns a TMA box: the widest swizzle row that tiles hd and vd
  static constexpr int BOX = box_of(HD) < box_of(VD) ? box_of(HD) : box_of(VD);
  static constexpr uint32_t GROUP = 8 * BOX * 2; // 8 rows of a box, bytes
  static constexpr int Q_ELEMS = BQ * HD;
  static constexpr int K_ELEMS = BK * HD;        // one K tile
  static constexpr int V_ELEMS = BK * VD;        // one V tile
  static constexpr uint32_t Q_BYTES = Q_ELEMS * 2;
  static constexpr uint32_t K_BYTES = K_ELEMS * 2;
  static constexpr uint32_t V_BYTES = V_ELEMS * 2;
  // the tiles, 1 KB to align them to the 128-byte swizzle's period, and
  // the 1 + 4 STAGES barriers
  static constexpr int SMEM =
      (Q_ELEMS + STAGES * (K_ELEMS + V_ELEMS)) * 2 + 1024 + 256;
  static_assert((1 + 4 * STAGES) * 8 <= 256, "barriers overflow");
  static_assert(SMEM <= 232448, "over the 227 KB a block can use");
  static_assert(HD % BOX == 0 && VD % BOX == 0, "boxes tile hd and vd");
};

// S (BK/2 accumulators) for the 64 rows of consumer `c`: Q.K^T over hd.
template <int HD, int VD>
__device__ inline void qk_product(float* s, const __nv_bfloat16* Qs,
                                  const __nv_bfloat16* Kst, int c) {
  using W = Wg<HD, VD>;
  constexpr int SUBS = W::BOX / 16;              // k16 steps a box
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const int box = kk / SUBS, sub = kk % SUBS;
    const uint64_t a = smem_desc<W::BOX>(
        Qs + box * W::BQ * W::BOX + c * 64 * W::BOX + sub * 16, 16,
        W::GROUP);
    const uint64_t b = smem_desc<W::BOX>(
        Kst + box * W::BK * W::BOX + sub * 16, 16, W::GROUP);
    if constexpr (W::BK == 80)
      repro::wgmma_ss_m64n80k16(s, a, b, kk > 0);
    else
      repro::wgmma_ss_m64n128k16(s, a, b, kk > 0);
  }
}

// O (VD/2 accumulators) += P (bf16 A fragments) . V over BK keys.
template <int HD, int VD>
__device__ inline void pv_product(float* o, uint32_t (*pa)[4],
                                  const __nv_bfloat16* Vst) {
  using W = Wg<HD, VD>;
#pragma unroll
  for (int kk = 0; kk < W::BK / 16; ++kk) {
    // MN-major B: 16 key rows of 2 BOX bytes (8-row groups GROUP bytes
    // apart), the vd columns in boxes of BOX BK * 2 BOX bytes apart
    const uint64_t b = smem_desc<W::BOX>(Vst + kk * 16 * W::BOX,
                                         W::BK * W::BOX * 2, W::GROUP);
    if constexpr (VD == 256)
      repro::wgmma_rs_m64n256k16(o, pa[kk], b);
    else if constexpr (VD == 160)
      repro::wgmma_rs_m64n160k16(o, pa[kk], b);
    else if constexpr (VD == 128)
      repro::wgmma_rs_m64n128k16(o, pa[kk], b);
    else if constexpr (VD == 80)
      repro::wgmma_rs_m64n80k16(o, pa[kk], b);
    else
      repro::wgmma_rs_m64n64k16(o, pa[kk], b);
  }
}

// The streaming softmax of one tile for one consumer thread, in base 2:
// the scores in sc (BK/2 accumulators, rows qpos[0] and qpos[1]) become
// p = 2^(y - m) in place, with y = s log2(e) / sqrt(hd), or cap log2(e)
// tanh(s / (cap sqrt(hd))) with the softcap; m and l move on and corr =
// 2^(m_old - m_new).  Straight-line code: the softcap and the masks are
// compile-time choices (tested per score at run time, they split this
// loop into small blocks that run latency-bound).
// `k` is log2(e) / sqrt(hd), or 2 log2(e) / (cap sqrt(hd)) with the cap.
template <int BK, bool CAPPED, bool MASKED>
__device__ __forceinline__ void tile_softmax(float* sc, float* m, float* l,
                                             float* corr, const Params& p,
                                             float k, float cap2, int k0,
                                             const int* qpos, int t4) {
  constexpr int NS = BK / 8;
  // unmasked and uncapped, y stays the raw score and goes to base 2 in
  // the exponent's FMA (k > 0, so the max commutes with the scaling);
  // otherwise y is scaled first, so that a row whose keys are all masked
  // gets y - m = -2e38 - -2e38 = 0 exactly
  constexpr bool SCALED = CAPPED || MASKED;
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < NS; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float y = sc[4 * j + e];
      // tanh(x) = 1 - 2 / (e^2x + 1), about 1e-7 absolute
      if constexpr (CAPPED)
        y = cap2 - 2.f * cap2 * rcp(ex2(y * k) + 1.f);
      else if constexpr (MASKED)
        y *= k;
      if constexpr (MASKED)
        if (!key_visible(p, qpos[e >> 1], k0 + 8 * j + 2 * t4 + (e & 1)))
          y = NEG;
      sc[4 * j + e] = y;
      mx[e >> 1] = fmaxf(mx[e >> 1], y);
    }
  const float ks = SCALED ? 1.f : k;
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(repro::FULL_MASK, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(repro::FULL_MASK, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r] * ks);
    corr[r] = ex2(m[r] - m_new);
    m[r] = m_new;
  }
#pragma unroll
  for (int j = 0; j < NS; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float pe = ex2(fmaf(sc[4 * j + e], ks, -m[e >> 1]));
      sc[4 * j + e] = pe;
      rs[e >> 1] += pe;
    }
  l[0] = l[0] * corr[0] + rs[0];
  l[1] = l[1] * corr[1] + rs[1];
}

template <int HD, int VD, bool CAPPED>
__global__ void __launch_bounds__(Wg<HD, VD>::THREADS, 1)
    flash_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       const Params p) {
  using W = Wg<HD, VD>;
  constexpr int BK = W::BK, STAGES = W::STAGES, NS = BK / 8, NO = VD / 8;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(base);
  __nv_bfloat16* Ks = Qs + W::Q_ELEMS;
  __nv_bfloat16* Vs = Ks + STAGES * W::K_ELEMS;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(Vs + STAGES * W::V_ELEMS);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + STAGES;
  uint64_t* k_empty = v_full + STAGES;
  uint64_t* v_empty = k_empty + STAGES;

  const int n_qt = (p.S + W::BQ - 1) / W::BQ;
  const int qt = n_qt - 1 - (int)blockIdx.x;     // longest rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (p.H / p.KH);
  const int q0 = qt * W::BQ, q1 = min(q0 + W::BQ, p.S);
  int t_lo, t_hi;
  kv_tiles(p, q0, q1, BK, t_lo, t_hi);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&k_empty[s], 2);                 // one arrival a consumer
      mbar_init(&v_empty[s], 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer: one thread keeps the ring full.  K of a stage is
    // free once both consumers have S, V once both have added P.V.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;" ::: "memory");
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, W::Q_BYTES);
#pragma unroll
      for (int c = 0; c < HD / W::BOX; ++c)
        tma_load_3d(Qs + c * W::BQ * W::BOX, &tm_q, q_full, c * W::BOX, q0,
                    b * p.H + h);
      for (int t = t_lo, i = 0; t < t_hi; ++t, ++i) {
        const int s = i % STAGES;
        const uint32_t prev = ((i / STAGES) - 1) & 1;
        __nv_bfloat16* kd = Ks + s * W::K_ELEMS;
        __nv_bfloat16* vd = Vs + s * W::V_ELEMS;
        if (i >= STAGES) mbar_wait(&k_empty[s], prev);
        mbar_expect_tx(&k_full[s], W::K_BYTES);
#pragma unroll
        for (int c = 0; c < HD / W::BOX; ++c)
          tma_load_3d(kd + c * BK * W::BOX, &tm_k, &k_full[s], c * W::BOX,
                      t * BK, b * p.KH + kvh);
        if (i >= STAGES) mbar_wait(&v_empty[s], prev);
        mbar_expect_tx(&v_full[s], W::V_BYTES);
#pragma unroll
        for (int c = 0; c < VD / W::BOX; ++c)
          tma_load_3d(vd + c * BK * W::BOX, &tm_v, &v_full[s], c * W::BOX,
                      t * BK, b * p.KH + kvh);
      }
    }
    return;
  }

  // ---- consumers: 64 q rows each.  S of tile t and P.V of tile t - 1
  // go to the tensor cores together, and the softmax of tile t runs
  // while P.V does.  The loop is peeled (first tile, steady state, last
  // P.V) so that every wgmma reaches its wait on every path: otherwise
  // ptxas serialises all of them.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;" ::: "memory");
  const int c = wg - 1;
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int row_lo = q0 + 64 * c, row_hi = min(row_lo + 64, p.S);
  int c_lo = t_hi, c_hi = t_hi;                  // none when no rows
  if (row_lo < row_hi) kv_tiles(p, row_lo, row_hi, BK, c_lo, c_hi);
  const int qpos[2] = {row_lo + 16 * warp + g, row_lo + 16 * warp + g + 8};
  const float k = CAPPED ? 2.f * LOG2E * p.scale / p.softcap
                         : LOG2E * p.scale;
  const float cap2 = p.softcap * LOG2E;

  float o[VD / 2];
#pragma unroll
  for (int i = 0; i < VD / 2; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, corr[2];
  float sc[BK / 2];
#pragma unroll
  for (int j = 0; j < BK / 2; ++j) sc[j] = 0.f;
  uint32_t pa[BK / 16][4];

  // a tile only the other consumer's rows need
  auto skip_tile = [&](int i) {
    const int s = i % STAGES;
    const uint32_t par = (i / STAGES) & 1;
    mbar_wait(&k_full[s], par);
    mbar_wait(&v_full[s], par);
    if (tid == 0) {
      mbar_arrive(&k_empty[s]);
      mbar_arrive(&v_empty[s]);
    }
  };
  auto softmax = [&](int t) {
    const int k0 = t * BK;
    const bool edge = k0 + BK > p.S || (p.causal && k0 + BK - 1 > row_lo) ||
                      (p.window > 0 && row_hi - 1 - k0 >= p.window);
    if (edge)
      tile_softmax<BK, CAPPED, true>(sc, m, l, corr, p, k, cap2, k0, qpos,
                                     t4);
    else
      tile_softmax<BK, CAPPED, false>(sc, m, l, corr, p, k, cap2, k0, qpos,
                                      t4);
  };
  // P rounded to bf16: the S accumulators of n8 groups 2kk and 2kk + 1
  // are the A fragment of k16 step kk
  auto pack_p = [&]() {
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      pa[j / 2][(j % 2) * 2] = pack_bf16(sc[4 * j], sc[4 * j + 1]);
      pa[j / 2][(j % 2) * 2 + 1] = pack_bf16(sc[4 * j + 2], sc[4 * j + 3]);
    }
  };

  mbar_wait(q_full, 0);
  int i = 0, t = t_lo;
  for (; t < c_lo; ++t, ++i) skip_tile(i);
  if (c_lo < c_hi) {
    int s = i % STAGES;
    uint32_t par = (i / STAGES) & 1;
    mbar_wait(&k_full[s], par);
    fence_regs<BK / 2>(sc);
    wgmma_fence();
    qk_product<HD, VD>(sc, Qs, Ks + s * W::K_ELEMS, c);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs<BK / 2>(sc);
    if (tid == 0) mbar_arrive(&k_empty[s]);
    softmax(t);                                  // O is still 0
    pack_p();
    int pend = s;                                // stage of P's V
    uint32_t pend_par = par;
    for (++t, ++i; t < c_hi; ++t, ++i) {
      s = i % STAGES;
      par = (i / STAGES) & 1;
      mbar_wait(&k_full[s], par);
      mbar_wait(&v_full[pend], pend_par);
      fence_regs<BK / 2>(sc);
      fence_regs<VD / 2>(o);
      wgmma_fence();
      qk_product<HD, VD>(sc, Qs, Ks + s * W::K_ELEMS, c);
      wgmma_commit();
      pv_product<HD, VD>(o, pa, Vs + pend * W::V_ELEMS);
      wgmma_commit();
      asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
      fence_regs<BK / 2>(sc);
      if (tid == 0) mbar_arrive(&k_empty[s]);
      softmax(t);
      wgmma_wait_all();
      fence_regs<VD / 2>(o);
      if (tid == 0) mbar_arrive(&v_empty[pend]);
      // rescale O where a row's max moved (a factor of 1 changes nothing)
      if (__any_sync(repro::FULL_MASK, corr[0] != 1.f || corr[1] != 1.f)) {
#pragma unroll
        for (int n = 0; n < NO; ++n) {
          o[4 * n] *= corr[0];
          o[4 * n + 1] *= corr[0];
          o[4 * n + 2] *= corr[1];
          o[4 * n + 3] *= corr[1];
        }
      }
      pack_p();
      pend = s;
      pend_par = par;
    }
    mbar_wait(&v_full[pend], pend_par);
    fence_regs<VD / 2>(o);
    wgmma_fence();
    pv_product<HD, VD>(o, pa, Vs + pend * W::V_ELEMS);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs<VD / 2>(o);
    if (tid == 0) mbar_arrive(&v_empty[pend]);
  }
  for (; t < t_hi; ++t, ++i) skip_tile(i);

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(repro::FULL_MASK, l[r], 1);
    l[r] += __shfl_xor_sync(repro::FULL_MASK, l[r], 2);
    // acc / max(l, 1e-30) as one division a row and hd / 2 products,
    // within one float32 rounding of the quotient (bf16 keeps 8 bits)
    l[r] = 1.f / fmaxf(l[r], 1e-30f);
  }
  const size_t ooff = ((size_t)b * p.H + h) * p.S * VD;
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.o) + ooff;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (qpos[r] >= p.S) continue;
    __nv_bfloat16* orow = out + (size_t)qpos[r] * VD + 2 * t4;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<uint32_t*>(orow + n * 8) =
          pack_bf16(o[4 * n + 2 * r] * l[r], o[4 * n + 2 * r + 1] * l[r]);
  }
}

// --------------------------------------------- bf16, hd 16/32: mma.sync

constexpr int BF_BQ = 64, BF_BK = 64, BF_THREADS = 128;

__device__ inline void mma_16816(float* c, const uint32_t* a, uint32_t b0,
                                 uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ inline void ldmatrix_x4_trans(uint32_t* r, const void* ptr) {
  const unsigned addr = (unsigned)__cvta_generic_to_shared(ptr);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ inline uint32_t ld_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// rows [row0, row0 + ROWS) of a [S, HD] bf16 matrix into shared memory
// with row stride HD + 8, 16 bytes a thread; rows at or past S are zeros.
template <int HD, int ROWS>
__device__ inline void load_tile(__nv_bfloat16* dst,
                                 const __nv_bfloat16* src, int row0, int S) {
  constexpr int CPR = HD / 8;
  for (int i = threadIdx.x; i < ROWS * CPR; i += BF_THREADS) {
    const int r = i / CPR, c = i % CPR;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < S)
      val = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * HD +
                                            c * 8);
    *reinterpret_cast<uint4*>(dst + r * (HD + 8) + c * 8) = val;
  }
}

template <int HD>
__global__ void __launch_bounds__(BF_THREADS)
    flash_mma_kernel(const Params p) {
  constexpr int LD = HD + 8;
  constexpr int NS = BF_BK / 8;        // score n-tiles of 8 keys
  constexpr int NO = HD / 8;           // output n-tiles of 8 columns
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + BF_BQ * LD;
  __nv_bfloat16* Vs = Ks + BF_BK * LD;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n_qt = (p.S + BF_BQ - 1) / BF_BQ;
  const int qt = n_qt - 1 - (int)blockIdx.x;     // longest rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (p.H / p.KH);
  const int q0 = qt * BF_BQ, q1 = min(q0 + BF_BQ, p.S);
  const size_t qoff = ((size_t)b * p.H + h) * p.S * HD;
  const size_t koff = ((size_t)b * p.KH + kvh) * p.S * HD;
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(p.q) + qoff;
  const __nv_bfloat16* k = static_cast<const __nv_bfloat16*>(p.k) + koff;
  const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(p.v) + koff;

  load_tile<HD, BF_BQ>(Qs, q, q0, p.S);

  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
    o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const int qpos[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};

  int t_lo, t_hi;
  kv_tiles(p, q0, q1, BF_BK, t_lo, t_hi);
  for (int tile = t_lo; tile < t_hi; ++tile) {
    const int k0 = tile * BF_BK;
    __syncthreads();                 // the last tile's readers are done
    load_tile<HD, BF_BK>(Ks, k, k0, p.S);
    load_tile<HD, BF_BK>(Vs, v, k0, p.S);
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 keys
    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD; kk += 16) {
      const __nv_bfloat16* qa = Qs + (warp * 16 + g) * LD + kk + 2 * t;
      const uint32_t a[4] = {ld_u32(qa), ld_u32(qa + 8 * LD), ld_u32(qa + 8),
                             ld_u32(qa + 8 * LD + 8)};
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const __nv_bfloat16* kb = Ks + (j * 8 + g) * LD + kk + 2 * t;
        mma_16816(s[j], a, ld_u32(kb), ld_u32(kb + 8));
      }
    }

    // scale, softcap, mask; the streaming softmax of rows g and g + 8
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        s[j][e] = masked_score(p, s[j][e], qpos[r],
                               k0 + j * 8 + 2 * t + (e & 1));
        mx[r] = fmaxf(mx[r], s[j][e]);
      }
    float corr[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(repro::FULL_MASK, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(repro::FULL_MASK, mx[r], 2));
      corr[r] = __expf(m[r] - mx[r]);
      m[r] = mx[r];
    }
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        s[j][e] = __expf(s[j][e] - m[r]);
        rs[r] += s[j][e];
      }
    l[0] = l[0] * corr[0] + rs[0];
    l[1] = l[1] * corr[1] + rs[1];
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      o[n][0] *= corr[0];
      o[n][1] *= corr[0];
      o[n][2] *= corr[1];
      o[n][3] *= corr[1];
    }

    // O += P V: P (rounded to bf16) straight from the S accumulators
#pragma unroll
    for (int kk = 0; kk < BF_BK / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const int mi = lane >> 3, rr = lane & 7;
      const __nv_bfloat16* vrow = Vs + (16 * kk + rr + (mi & 1) * 8) * LD +
                                  (mi >> 1) * 8;
#pragma unroll
      for (int n = 0; n < NO; n += 2) {
        uint32_t bfrag[4];
        ldmatrix_x4_trans(bfrag, vrow + n * 8);
        mma_16816(o[n], a, bfrag[0], bfrag[1]);
        mma_16816(o[n + 1], a, bfrag[2], bfrag[3]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(repro::FULL_MASK, l[r], 1);
    l[r] += __shfl_xor_sync(repro::FULL_MASK, l[r], 2);
    l[r] = fmaxf(l[r], 1e-30f);
  }
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.o) + qoff;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (qpos[r] >= p.S) continue;
    __nv_bfloat16* orow = out + (size_t)qpos[r] * HD + 2 * t;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      __nv_bfloat162 val = __floats2bfloat162_rn(o[n][2 * r] / l[r],
                                                 o[n][2 * r + 1] / l[r]);
      *reinterpret_cast<__nv_bfloat162*>(orow + n * 8) = val;
    }
  }
}

// ------------------------------------------------------------------ f32

constexpr int F_BQ = 32, F_BK = 32, F_THREADS = 256;

template <int HD, int VD>
__global__ void __launch_bounds__(F_THREADS) flash_f32_kernel(const Params p) {
  constexpr int LD = HD + 1;           // odd stride: rows on distinct banks
  constexpr int LDV = VD + 1;
  constexpr int PLD = F_BK + 1;
  constexpr int CPT = VD / 8;          // output columns a thread
  extern __shared__ float fsmem[];
  float* Qs = fsmem;
  float* Ks = Qs + F_BQ * LD;
  float* Vs = Ks + F_BK * LD;
  float* Ps = Vs + F_BK * LDV;

  const int tid = threadIdx.x, r = tid >> 3, c = tid & 7;  // 8 threads a row
  const int n_qt = (p.S + F_BQ - 1) / F_BQ;
  const int qt = n_qt - 1 - (int)blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (p.H / p.KH);
  const int q0 = qt * F_BQ, q1 = min(q0 + F_BQ, p.S);
  const size_t qoff = ((size_t)b * p.H + h) * p.S * HD;
  const size_t koff = ((size_t)b * p.KH + kvh) * p.S * HD;
  const size_t voff = ((size_t)b * p.KH + kvh) * p.S * VD;
  const float* q = static_cast<const float*>(p.q) + qoff;
  const float* k = static_cast<const float*>(p.k) + koff;
  const float* v = static_cast<const float*>(p.v) + voff;

  for (int i = tid; i < F_BQ * HD; i += F_THREADS) {
    const int rr = i / HD, dd = i % HD;
    Qs[rr * LD + dd] = q0 + rr < p.S ? q[(size_t)(q0 + rr) * HD + dd] : 0.f;
  }
  float acc[CPT];
#pragma unroll
  for (int j = 0; j < CPT; ++j) acc[j] = 0.f;
  float m = -INFINITY, l = 0.f;
  const int qpos = q0 + r;

  int t_lo, t_hi;
  kv_tiles(p, q0, q1, F_BK, t_lo, t_hi);
  for (int tile = t_lo; tile < t_hi; ++tile) {
    const int k0 = tile * F_BK;
    __syncthreads();
    for (int i = tid; i < F_BK * HD; i += F_THREADS) {
      const int rr = i / HD, dd = i % HD;
      Ks[rr * LD + dd] = k0 + rr < p.S ? k[(size_t)(k0 + rr) * HD + dd] : 0.f;
    }
    for (int i = tid; i < F_BK * VD; i += F_THREADS) {
      const int rr = i / VD, dd = i % VD;
      Vs[rr * LDV + dd] = k0 + rr < p.S ? v[(size_t)(k0 + rr) * VD + dd] : 0.f;
    }
    __syncthreads();

    float s[4], mx = m;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int key = c + 8 * jj;
      float dot = 0.f;
#pragma unroll 8
      for (int d = 0; d < HD; ++d) dot += Qs[r * LD + d] * Ks[key * LD + d];
      s[jj] = masked_score(p, dot, qpos, k0 + key);
      mx = fmaxf(mx, s[jj]);
    }
#pragma unroll
    for (int off = 1; off < 8; off <<= 1)
      mx = fmaxf(mx, __shfl_xor_sync(repro::FULL_MASK, mx, off));
    const float corr = expf(m - mx);
    m = mx;
    float rs = 0.f;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const float e = expf(s[jj] - m);
      rs += e;
      Ps[r * PLD + c + 8 * jj] = e;
    }
#pragma unroll
    for (int off = 1; off < 8; off <<= 1)
      rs += __shfl_xor_sync(repro::FULL_MASK, rs, off);
    l = l * corr + rs;
    __syncwarp();                      // a row's 8 threads share one warp
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[j] *= corr;
    for (int key = 0; key < F_BK; ++key) {
      const float pk = Ps[r * PLD + key];
#pragma unroll
      for (int j = 0; j < CPT; ++j) acc[j] += pk * Vs[key * LDV + c + 8 * j];
    }
  }

  if (qpos < p.S) {
    float* orow = static_cast<float*>(p.o) +
                  ((size_t)b * p.H + h) * p.S * VD + (size_t)qpos * VD;
    const float den = fmaxf(l, 1e-30f);
#pragma unroll
    for (int j = 0; j < CPT; ++j) orow[c + 8 * j] = acc[j] / den;
  }
}

// --------------------------------------------------------------- launch

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled lives in libcuda: looked up through the CUDA
// runtime's entry-point query, so the library needs no -lcuda.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                     cudaEnableDefault, &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr,
                            cudaEnableDefault, &found);
#endif
    if (found == cudaDriverEntryPointSuccess) fn = (EncodeTiled)ptr;
  }
  return fn;
}

// [heads, S, hd] bf16 as a 3-d tensor map of boxes [1, rows, box] in the
// swizzle of box-column (2 box-byte) rows; rows past S read as zeros.
bool tensor_map(CUtensorMap* map, const void* ptr, int heads, int S, int hd,
                int rows, int box) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)hd, (cuuint64_t)S,
                              (cuuint64_t)heads};
  const cuuint64_t strides[2] = {(cuuint64_t)hd * 2,
                                 (cuuint64_t)S * hd * 2};
  const cuuint32_t boxes[3] = {(cuuint32_t)box, (cuuint32_t)rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUtensorMapSwizzle swizzle =
      box == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                : box == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                            : CU_TENSOR_MAP_SWIZZLE_32B;
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(ptr), dims, strides, boxes, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD, int VD>
int launch_wgmma(const Params& p, cudaStream_t stream) {
  using W = Wg<HD, VD>;
  CUtensorMap tq, tk, tv;
  if (!tensor_map(&tq, p.q, p.B * p.H, p.S, HD, W::BQ, W::BOX) ||
      !tensor_map(&tk, p.k, p.B * p.KH, p.S, HD, W::BK, W::BOX) ||
      !tensor_map(&tv, p.v, p.B * p.KH, p.S, VD, W::BK, W::BOX))
    return (int)cudaErrorInvalidValue;
  auto kernel = p.softcap > 0.f ? flash_wgmma_kernel<HD, VD, true>
                                : flash_wgmma_kernel<HD, VD, false>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       W::SMEM);
  const dim3 grid((p.S + W::BQ - 1) / W::BQ, p.H, p.B);
  kernel<<<grid, W::THREADS, W::SMEM, stream>>>(tq, tk, tv, p);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_mma(const Params& p, cudaStream_t stream) {
  const int smem = 3 * BF_BQ * (HD + 8) * (int)sizeof(__nv_bfloat16);
  cudaFuncSetAttribute(flash_mma_kernel<HD>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const dim3 grid((p.S + BF_BQ - 1) / BF_BQ, p.H, p.B);
  flash_mma_kernel<HD><<<grid, BF_THREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int HD, int VD>
int launch_f32(const Params& p, cudaStream_t stream) {
  const int smem = (F_BQ * (HD + 1) + F_BK * (HD + 1) + F_BK * (VD + 1) +
                    F_BQ * (F_BK + 1)) * (int)sizeof(float);
  cudaFuncSetAttribute(flash_f32_kernel<HD, VD>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const dim3 grid((p.S + F_BQ - 1) / F_BQ, p.H, p.B);
  flash_f32_kernel<HD, VD><<<grid, F_THREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// bf16 goes to the wgmma kernel from hd 64 up (boxes of 16, 32 or 64
// columns) and to the mma.sync kernel at 16 and 32; float32 to the FMA
// kernel.  A tensor map that fails to encode or a refused launch returns
// its error: nothing falls back to another kernel.
template <int HD, int VD = HD>
int launch_hd(const Params& p, int bf16, cudaStream_t stream) {
  static_assert(HD % 16 == 0 && VD % 16 == 0,
                "wgmma and m16n8k16 step 16 columns");
  if (!bf16) return launch_f32<HD, VD>(p, stream);
  if constexpr (HD >= 64 && VD >= 64)
    return launch_wgmma<HD, VD>(p, stream);
  else if constexpr (HD == VD)
    return launch_mma<HD>(p, stream);
  else
    return (int)cudaErrorInvalidValue;
}

}  // namespace

// q [B, H, S, hd], k [B, KH, S, hd], v [B, KH, S, vd], o [B, H, S, vd],
// contiguous and 16-byte aligned, all float32 (dtype 0) or all bf16
// (dtype 1); hd = vd in {16, 32, 64, 80, 128, 160, 256}, or (hd, vd) in
// {(192, 128), (96, 64)}.
REPRO_EXPORT int flash_attention_launch(const void* q, const void* k,
                                        const void* v, void* o, int B, int H,
                                        int KH, int S, int hd, int vd,
                                        int dtype, int causal, int window,
                                        float softcap, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (B <= 0 || S <= 0) return (int)cudaGetLastError();
  if (KH <= 0 || H % KH != 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  Params p{q, k, v, o, B, H, KH, S, causal, window, softcap,
           (float)(1.0 / sqrt((double)hd))};
  if (vd != hd) {
    if (hd == 192 && vd == 128) return launch_hd<192, 128>(p, dtype, stream);
    if (hd == 96 && vd == 64) return launch_hd<96, 64>(p, dtype, stream);
    return (int)cudaErrorInvalidValue;
  }
  switch (hd) {
    case 16: return launch_hd<16>(p, dtype, stream);
    case 32: return launch_hd<32>(p, dtype, stream);
    case 64: return launch_hd<64>(p, dtype, stream);
    case 80: return launch_hd<80>(p, dtype, stream);
    case 128: return launch_hd<128>(p, dtype, stream);
    case 160: return launch_hd<160>(p, dtype, stream);
    case 256: return launch_hd<256>(p, dtype, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
