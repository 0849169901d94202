// Flash attention, forward: GQA, causal, sliding window, tanh softcap.
//
// Replaces src/repro/kernels/flash_attention.py:82 (flash_attention, whose
// pl.pallas_call walks the KV sequence of one (batch, head, q block) with
// a fori_loop, carrying the streaming-softmax state m, l, acc).  The
// contract is the Pallas kernel's: q [B, H, S, hd], k/v [B, KH, S, hd]
// (H % KH == 0), positions 0..S-1 for both; scores q.k / sqrt(hd) in
// float32, tanh softcap, then the causal and window masks at -2e38;
// m, l, acc in float32 with p rounded to V's type before P.V; the output
// acc / max(l, 1e-30) in q's type.
//
// On the H100 the TPU's sequential grid becomes independent blocks: one
// block per (q tile, head, batch), the KV tiles walked by a loop inside
// it.  Tiles wholly after the diagonal (causal) or wholly before the
// window are skipped: every row keeps its own diagonal key, so a skipped
// tile would have added exp(-2e38 - m) = 0.  The last tile of a sequence
// that is not a multiple of the tile is zero-filled and masked.
//
//   bf16: 4 warps, 64 q rows (16 a warp) x 64-key tiles, Q, K and V tiles
//         in shared memory (rows padded by 8 elements, so the fragment
//         loads and ldmatrix hit 32 distinct banks); S = Q.K^T and
//         O += P.V on the tensor cores with mma.sync m16n8k16 (float32
//         accumulators in registers; P goes from the S accumulators into
//         A fragments without a trip through shared memory; V's B
//         fragments come from ldmatrix.trans).  m and l per row live in
//         registers, l as per-thread partial sums reduced over the quad
//         at the end.
//   f32:  plain FMAs (the tensor cores' TF32 would break the float32
//         contract), 256 threads, 32 q rows x 32-key tiles in shared
//         memory, 8 threads a row.  It serves the float32 checks, not
//         the serving path.
//
// What bounds it: at the main shape (B 2, H 16, KH 8, S 8192, hd 256,
// bf16) tensor-core operations: about 1.1e12 FLOP for a global layer
// (4 B H hd x the keys in range) against 0.4 GB of q, k, v and o (0.12 ms
// at 3.35 TB/s); 1.1 ms at 989 TFLOP/s.  What this simple design leaves:
// mma.sync instead of wgmma (about two thirds of the tensor-core rate at
// best), synchronous tile loads (no cp.async/TMA ring, so the tensor
// cores idle while a tile arrives; two blocks an SM hide part of it), no
// warp specialisation, and an accurate tanhf/expf per score.
#include "common.cuh"

#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr float NEG = -2.0e38f;

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

__device__ inline float masked_score(const Params& p, float dot, int qpos,
                                     int kpos) {
  float s = dot * p.scale;
  if (p.softcap > 0.f) s = tanhf(s / p.softcap) * p.softcap;
  const bool ok = kpos < p.S && (!p.causal || kpos <= qpos) &&
                  (p.window <= 0 || qpos - kpos < p.window);
  return ok ? s : NEG;
}

// ----------------------------------------------------------------- bf16

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

__device__ inline uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
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
    flash_bf16_kernel(const Params p) {
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

template <int HD>
__global__ void __launch_bounds__(F_THREADS) flash_f32_kernel(const Params p) {
  constexpr int LD = HD + 1;           // odd stride: rows on distinct banks
  constexpr int PLD = F_BK + 1;
  constexpr int CPT = HD / 8;          // output columns a thread
  extern __shared__ float fsmem[];
  float* Qs = fsmem;
  float* Ks = Qs + F_BQ * LD;
  float* Vs = Ks + F_BK * LD;
  float* Ps = Vs + F_BK * LD;

  const int tid = threadIdx.x, r = tid >> 3, c = tid & 7;  // 8 threads a row
  const int n_qt = (p.S + F_BQ - 1) / F_BQ;
  const int qt = n_qt - 1 - (int)blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (p.H / p.KH);
  const int q0 = qt * F_BQ, q1 = min(q0 + F_BQ, p.S);
  const size_t qoff = ((size_t)b * p.H + h) * p.S * HD;
  const size_t koff = ((size_t)b * p.KH + kvh) * p.S * HD;
  const float* q = static_cast<const float*>(p.q) + qoff;
  const float* k = static_cast<const float*>(p.k) + koff;
  const float* v = static_cast<const float*>(p.v) + koff;

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
      const bool in = k0 + rr < p.S;
      const size_t at = (size_t)(k0 + rr) * HD + dd;
      Ks[rr * LD + dd] = in ? k[at] : 0.f;
      Vs[rr * LD + dd] = in ? v[at] : 0.f;
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
      for (int j = 0; j < CPT; ++j) acc[j] += pk * Vs[key * LD + c + 8 * j];
    }
  }

  if (qpos < p.S) {
    float* orow = static_cast<float*>(p.o) + qoff + (size_t)qpos * HD;
    const float den = fmaxf(l, 1e-30f);
#pragma unroll
    for (int j = 0; j < CPT; ++j) orow[c + 8 * j] = acc[j] / den;
  }
}

// --------------------------------------------------------------- launch

template <int HD>
int launch_bf16(const Params& p, cudaStream_t stream) {
  const int smem = 3 * BF_BQ * (HD + 8) * (int)sizeof(__nv_bfloat16);
  cudaFuncSetAttribute(flash_bf16_kernel<HD>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const dim3 grid((p.S + BF_BQ - 1) / BF_BQ, p.H, p.B);
  flash_bf16_kernel<HD><<<grid, BF_THREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_f32(const Params& p, cudaStream_t stream) {
  const int smem =
      (3 * F_BQ * (HD + 1) + F_BQ * (F_BK + 1)) * (int)sizeof(float);
  cudaFuncSetAttribute(flash_f32_kernel<HD>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const dim3 grid((p.S + F_BQ - 1) / F_BQ, p.H, p.B);
  flash_f32_kernel<HD><<<grid, F_THREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_hd(const Params& p, int bf16, cudaStream_t stream) {
  return bf16 ? launch_bf16<HD>(p, stream) : launch_f32<HD>(p, stream);
}

}  // namespace

// q [B, H, S, hd], k/v [B, KH, S, hd], o [B, H, S, hd], contiguous, all
// float32 (dtype 0) or all bf16 (dtype 1); hd in {16, 32, 64, 128, 256}.
REPRO_EXPORT int flash_attention_launch(const void* q, const void* k,
                                        const void* v, void* o, int B, int H,
                                        int KH, int S, int hd, int dtype,
                                        int causal, int window, float softcap,
                                        void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (B <= 0 || S <= 0) return (int)cudaGetLastError();
  if (KH <= 0 || H % KH != 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  Params p{q, k, v, o, B, H, KH, S, causal, window, softcap,
           (float)(1.0 / sqrt((double)hd))};
  switch (hd) {
    case 16: return launch_hd<16>(p, dtype, stream);
    case 32: return launch_hd<32>(p, dtype, stream);
    case 64: return launch_hd<64>(p, dtype, stream);
    case 128: return launch_hd<128>(p, dtype, stream);
    case 256: return launch_hd<256>(p, dtype, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
