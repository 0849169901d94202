#!/usr/bin/env python3
"""Probes of what bounds a scatter on the card (segment sum, ELL SpMV,
segment min/max), and times of the min/max and fused kernels.

    python3 tools/scatter_probes.py
    python3 tools/scatter_probes.py --kernels SRC LABEL

Builds a few throwaway kernels with ``nvcc`` (sm_90a) into the git-ignored
``src/repro_torch/kernels/build/probes/`` and times each with CUDA events
(mean of 5 launches after a warm-up) at N = 2^26:

  (a) one read-only pass over seg [N] int32 and vals [N] float32 (16-byte
      loads): the byte floor as the card reaches it;
  (b) N ``red.global.add`` (f32 and u32) to hashed addresses in a 1 MB
      and a 16 MB array, with no loads: the L2 reduction ceiling;
  (c) the per-element atomic scatter that segment_sum and spmv_ell used
      before their redesign (one global atomic a row), counts off, at
      K = 2^18 + 1 and K = 2^22 with every id in range;
  (d) N shared-memory atomic adds (f32 and u32) to hashed addresses in a
      block-private 128 KB array;
  (e) N distributed-shared-memory atomic adds (f32 and u32) to hashed
      addresses over a 16-block cluster's 16 x 128 KB (2 MB, wordcount's
      sums and counts at K = 2^18 + 1), and over an 8-block cluster's 1 MB;
  (f) one pass that reads N ids and values with 16-byte loads and adds the
      half of the rows in range with red.global.add.f32 into 16 MB (the
      direct variant's work without its warp collapse), at 1-8 blocks of
      512 threads an SM, with and without an L2 evict-last hint;
  (g) the same pass as (f) folding the half in range into 2^22 words with
      an atomic min instead (segment_minmax's direct pass without its warp
      collapse), each call after its identity fill: an unconditional
      atomicMin on the order-preserving u32 keys of the floats; a load of
      out[id] first and an atomicMin only where the row wins, on the keys
      and on the float bits (the two-branch fold the kernel keeps in
      device memory); the load-first variants with values in random,
      increasing (the best case: late rows lose) and decreasing (the
      worst: every row wins) order of the rows; the fill alone.  Best of
      1-8 blocks of 512 an SM.

Prints one line a probe (ms and adds or bytes per second), the card's
name and power limit, and needs one CUDA card.

With ``--kernels SRC LABEL`` it instead imports the ``repro_torch`` package
under SRC (a checkout's ``src``, e.g. the parent commit unpacked into the
git-ignored ``build/``) and times, for that package, ``segment_minmax`` at
SSSP's run shape (values finite, and a third at +inf) and at its refresh
launch shapes (ids ascending), and ``fused_shuffle_reduce`` and the
composed path at the merge shapes of the main paths.  The inputs come from
this checkout's ``chip_smoke.py`` (``sssp_run_rows``,
``sssp_refresh_rows``, ``merge_rows``), so both packages and phase 2 time
the same data: CUDA events (mean of 20 after a warm-up) beside the device
busy time and the kernels of one call under ``torch.profiler``
(``chip_smoke.device_shares``).  Every line starts with [LABEL]; run
parent, change, change, parent in one call to compare two commits.

With ``--one-block SRC LABEL`` it imports the package under SRC the same
way and runs ``chip_smoke.time_one_block`` on it: the fused merge at the
one-block path's shapes (``chip_smoke.ONE_BLOCK_SHAPES``: the serving
tier's tenants and batched launches, PageRank's refresh at 4,096, 8,192
and 16,384 rows), on each route where the package exposes both; every
line starts with [LABEL].
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
OUT = ROOT / "src" / "repro_torch" / "kernels" / "build" / "probes"
N = 1 << 26

SOURCE = r"""
#include <cuda_runtime.h>
#include <cooperative_groups.h>
#include <stdint.h>
namespace cg = cooperative_groups;
#define EXPORT extern "C" __attribute__((visibility("default")))

__device__ __forceinline__ unsigned mix(unsigned long long i) {
  unsigned x = (unsigned)i * 0x9E3779B1u ^ (unsigned)(i >> 32);
  x ^= x >> 16; x *= 0x85EBCA6Bu; x ^= x >> 13; x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

__global__ void read_kernel(const int4* __restrict__ seg,
                            const int4* __restrict__ vals, long long quads,
                            int* sink) {
  int acc = 0;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < quads; i += (long long)gridDim.x * blockDim.x) {
    int4 s = __ldcs(seg + i);
    int4 v = __ldcs(vals + i);
    acc ^= s.x ^ s.y ^ s.z ^ s.w ^ v.x ^ v.y ^ v.z ^ v.w;
  }
  if (acc == 0x12345678) sink[0] = acc;
}

template <typename T>
__global__ void red_global_kernel(T* out, long long n, unsigned mask) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < n; i += (long long)gridDim.x * blockDim.x)
    atomicAdd(out + (mix(i) & mask), (T)1);
}

// the design before the redesign: one thread a (row, column), one global
// atomic a value (counts off here)
__global__ void old_segment_sum_kernel(const int32_t* __restrict__ seg,
                                       const float* __restrict__ vals,
                                       float* __restrict__ out, long long n,
                                       int d, int k) {
  const long long total = n * d;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    const long long row = i / d;
    const int col = (int)(i - row * d);
    const int s = seg[row];
    if (s < 0 || s >= k) continue;
    atomicAdd(&out[(long long)s * d + col], vals[i]);
  }
}

template <typename T>
__global__ void red_shared_kernel(long long n, unsigned mask, T* sink) {
  extern __shared__ __align__(16) unsigned char raw[];
  T* sm = (T*)raw;
  for (unsigned i = threadIdx.x; i <= mask; i += blockDim.x) sm[i] = 0;
  __syncthreads();
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < n; i += (long long)gridDim.x * blockDim.x)
    atomicAdd(sm + (mix(i) & mask), (T)1);
  __syncthreads();
  if (threadIdx.x == 0) sink[blockIdx.x] = sm[0];
}

template <typename T>
__global__ void red_dsmem_kernel(long long n, int per_log2, T* sink) {
  extern __shared__ __align__(16) unsigned char raw[];
  T* sm = (T*)raw;
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned per = 1u << per_log2;
  for (unsigned i = threadIdx.x; i < per; i += blockDim.x) sm[i] = 0;
  cluster.sync();
  const unsigned mask = per * cluster.num_blocks() - 1;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < n; i += (long long)gridDim.x * blockDim.x) {
    const unsigned a = mix(i) & mask;
    T* dst = cluster.map_shared_rank(sm, a >> per_log2);
    atomicAdd(dst + (a & (per - 1)), (T)1);
  }
  cluster.sync();
  if (threadIdx.x == 0) sink[blockIdx.x] = sm[0];
}

// read 16 bytes of ids and 16 of values a thread, then one red a live
// row (the id's low bit marks it live: half the rows), with or without an
// L2 evict-last hint on the reds
template <bool HINT>
__global__ void stream_red_kernel(const int4* __restrict__ seg,
                                  const float4* __restrict__ vals,
                                  float* out, long long quads,
                                  unsigned mask) {
  uint64_t pol = 0;
  if (HINT)
    asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;"
                 : "=l"(pol));
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < quads; i += (long long)gridDim.x * blockDim.x) {
    const int4 s = __ldcs(seg + i);
    const float4 v = __ldcs(vals + i);
    const int id[4] = {s.x, s.y, s.z, s.w};
    const float x[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (!(id[j] & 1)) continue;
      float* p = out + (((unsigned)id[j] >> 1) & mask);
      if (HINT)
        asm volatile("red.global.add.L2::cache_hint.f32 [%0], %1, %2;"
                     ::"l"(p), "f"(x[j]), "l"(pol) : "memory");
      else
        atomicAdd(p, x[j]);
    }
  }
}

// order-preserving u32 key of a float: one unsigned compare orders them
__device__ __forceinline__ unsigned fkey(float f) {
  const unsigned b = __float_as_uint(f);
  return b ^ ((b & 0x80000000u) ? 0xFFFFFFFFu : 0x80000000u);
}

// MODE 0: unconditional atomicMin on keys; 1: load first, atomicMin on
// keys where the row wins; 2: load first, two-branch fold on float bits
template <int MODE>
__global__ void stream_min_kernel(const int4* __restrict__ seg,
                                  const float4* __restrict__ vals,
                                  unsigned* out, long long quads,
                                  unsigned mask) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < quads; i += (long long)gridDim.x * blockDim.x) {
    const int4 s = __ldcs(seg + i);
    const float4 v = __ldcs(vals + i);
    const int id[4] = {s.x, s.y, s.z, s.w};
    const float x[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (!(id[j] & 1)) continue;
      unsigned* p = out + (((unsigned)id[j] >> 1) & mask);
      if (MODE == 0) {
        atomicMin(p, fkey(x[j]));
      } else if (MODE == 1) {
        const unsigned k = fkey(x[j]);
        if (k < __ldcg(p)) atomicMin(p, k);
      } else {
        const float cur = __uint_as_float(__ldcg(p));
        if (fkey(x[j]) < fkey(cur)) {
          const int b = __float_as_int(x[j]);
          if (b >= 0) atomicMin((int*)p, b);
          else atomicMax(p, (unsigned)b);
        }
      }
    }
  }
}

__global__ void fill_kernel(unsigned* out, long long n, unsigned value) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x)
    out[i] = value;
}

EXPORT int probe_stream_min(const void* seg, const void* vals, void* out,
                            long long n, unsigned mask, int blocks, int mode,
                            void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  // the identity: the key of +inf (modes 0, 1), +inf's bits (mode 2)
  fill_kernel<<<132 * 4, 512, 0, st>>>(
      (unsigned*)out, (long long)mask + 1,
      mode == 2 ? 0x7F800000u : 0xFF800000u);
  if (mode < 0) return (int)cudaGetLastError();        // the fill alone
  const int4* s = (const int4*)seg;
  const float4* v = (const float4*)vals;
  if (mode == 0)
    stream_min_kernel<0><<<blocks, 512, 0, st>>>(s, v, (unsigned*)out, n / 4,
                                                 mask);
  else if (mode == 1)
    stream_min_kernel<1><<<blocks, 512, 0, st>>>(s, v, (unsigned*)out, n / 4,
                                                 mask);
  else
    stream_min_kernel<2><<<blocks, 512, 0, st>>>(s, v, (unsigned*)out, n / 4,
                                                 mask);
  return (int)cudaGetLastError();
}

EXPORT int probe_stream_red(const void* seg, const void* vals, void* out,
                            long long n, unsigned mask, int blocks, int hint,
                            void* stream) {
  if (hint)
    stream_red_kernel<true><<<blocks, 512, 0, (cudaStream_t)stream>>>(
        (const int4*)seg, (const float4*)vals, (float*)out, n / 4, mask);
  else
    stream_red_kernel<false><<<blocks, 512, 0, (cudaStream_t)stream>>>(
        (const int4*)seg, (const float4*)vals, (float*)out, n / 4, mask);
  return (int)cudaGetLastError();
}

EXPORT int probe_read(const void* seg, const void* vals, long long n,
                      void* sink, void* stream) {
  read_kernel<<<132 * 8, 256, 0, (cudaStream_t)stream>>>(
      (const int4*)seg, (const int4*)vals, n / 4, (int*)sink);
  return (int)cudaGetLastError();
}

EXPORT int probe_red_global(void* out, long long n, unsigned mask, int f32,
                            void* stream) {
  if (f32)
    red_global_kernel<float><<<132 * 8, 256, 0, (cudaStream_t)stream>>>(
        (float*)out, n, mask);
  else
    red_global_kernel<unsigned><<<132 * 8, 256, 0, (cudaStream_t)stream>>>(
        (unsigned*)out, n, mask);
  return (int)cudaGetLastError();
}

EXPORT int probe_old(const void* seg, const void* vals, void* out,
                     long long n, int k, void* stream) {
  cudaMemsetAsync(out, 0, (size_t)k * 4, (cudaStream_t)stream);
  old_segment_sum_kernel<<<132 * 16, 256, 0, (cudaStream_t)stream>>>(
      (const int32_t*)seg, (const float*)vals, (float*)out, n, 1, k);
  return (int)cudaGetLastError();
}

EXPORT int probe_red_shared(long long n, int bytes, int f32, void* sink,
                            void* stream) {
  const unsigned mask = bytes / 4 - 1;
  if (f32) {
    cudaFuncSetAttribute(red_shared_kernel<float>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    red_shared_kernel<float><<<132, 1024, bytes, (cudaStream_t)stream>>>(
        n, mask, (float*)sink);
  } else {
    cudaFuncSetAttribute(red_shared_kernel<unsigned>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    red_shared_kernel<unsigned><<<132, 1024, bytes, (cudaStream_t)stream>>>(
        n, mask, (unsigned*)sink);
  }
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_dsmem(long long n, int per_log2, int csize, T* sink,
                        cudaStream_t stream, int* clusters) {
  const int bytes = 4 << per_log2;
  auto fn = red_dsmem_kernel<T>;
  cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       bytes);
  cudaFuncSetAttribute(fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = csize;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.blockDim = dim3(1024);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cfg.gridDim = dim3(csize);
  int active = 0;
  cudaError_t e = cudaOccupancyMaxActiveClusters(&active, fn, &cfg);
  if (e != cudaSuccess) return (int)e;
  if (active < 1) return (int)cudaErrorInvalidConfiguration;
  *clusters = active;
  cfg.gridDim = dim3(csize * active);
  e = cudaLaunchKernelEx(&cfg, fn, n, per_log2, sink);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

EXPORT int probe_red_dsmem(long long n, int per_log2, int csize, int f32,
                           void* sink, void* stream, int* clusters) {
  if (f32)
    return launch_dsmem<float>(n, per_log2, csize, (float*)sink,
                               (cudaStream_t)stream, clusters);
  return launch_dsmem<unsigned>(n, per_log2, csize, (unsigned*)sink,
                                (cudaStream_t)stream, clusters);
}

EXPORT const char* probe_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
"""


def build() -> ctypes.CDLL:
    OUT.mkdir(parents=True, exist_ok=True)
    src = OUT / "scatter_probes.cu"
    lib = OUT / "libscatter_probes.so"
    src.write_text(SOURCE)
    nvcc = shutil.which("nvcc") or str(
        Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc")
    res = subprocess.run(
        [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
         "-O3", "-shared", "-Xcompiler", "-fPIC", "-o", str(lib), str(src)],
        capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(res.stdout + res.stderr)
    so = ctypes.CDLL(str(lib))
    P, LL, I, U = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, \
        ctypes.c_uint
    so.probe_read.argtypes = [P, P, LL, P, P]
    so.probe_red_global.argtypes = [P, LL, U, I, P]
    so.probe_old.argtypes = [P, P, P, LL, I, P]
    so.probe_red_shared.argtypes = [LL, I, I, P, P]
    so.probe_red_dsmem.argtypes = [LL, I, I, I, P, P, P]
    so.probe_stream_red.argtypes = [P, P, P, LL, U, I, I, P]
    so.probe_stream_min.argtypes = [P, P, P, LL, U, I, I, P]
    so.probe_error.argtypes = [I]
    so.probe_error.restype = ctypes.c_char_p
    return so


def timed(so, fn, reps: int = 5) -> float:
    def call():
        rc = fn()
        if rc:
            raise RuntimeError(so.probe_error(rc).decode())
    call()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        call()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def time_kernels(src: str, label: str) -> None:
    """The --kernels mode: see the module's docstring."""
    sys.path.insert(0, str(Path(src).resolve()))
    sys.path.insert(1, str(ROOT))
    import numpy as np
    import chip_smoke as cs
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels.fused import fused_shuffle_reduce
    from repro_torch.kernels.ref import (fused_shuffle_reduce_ref,
                                         segment_minmax_ref)
    from repro_torch.kernels.segment_reduce import segment_minmax
    _build.build_all()
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)

    def rec(name, fn):
        ms = cs.cuda_ms(fn, reps=20)
        p = cs.device_shares(fn, dev, top=8)
        print(f"[{label}] {name}: events {ms:.4f} ms; device busy "
              f"{p['busy_ms']:.4f} ms, {p['kernels']} kernels; {p['top']}",
              flush=True)

    # SSSP's run, then with a third of the rows at +inf (unreached
    # vertices)
    vertices = k = 2**22
    seg, vals, _ = cs.sssp_run_rows(dev, vertices)
    rec("segment_minmax run", lambda: segment_minmax("min", seg, vals, k))
    vals[torch.rand(seg.numel(), device=dev) < 1 / 3] = float("inf")
    rec("segment_minmax run, a third of the rows at +inf",
        lambda: segment_minmax("min", seg, vals, k))
    del seg, vals
    # SSSP's refresh launch shapes, ids ascending
    for n, k in ((2**19, 65536), (2**17, 16384), (2**16, 8192),
                 (2**15, 4096), (2**13, 1024)):
        seg, vals, _ = cs.sssp_refresh_rows(rng, dev, n, k)
        cs.require_equal(f"segment_minmax {n}/{k}",
                         segment_minmax("min", seg, vals, k),
                         segment_minmax_ref("min", seg, vals, k))
        rec(f"segment_minmax refresh N={n} K={k}",
            lambda: segment_minmax("min", seg, vals, k))

    # the merges of the main paths (chip_smoke phase 2's), and two
    # PageRank-refresh launch shapes between them
    one_m, one_cap = cs.PR_REFRESH_ONE_BLOCK
    v = vertices
    for name, a in (
            ("N=2^20 key_cap=2048 (wordcount's update (a))",
             cs.merge_rows(rng, dev, 2**20, cs.VOCAB, 2048, 256, 0, 1024,
                           1024, ones=True)[0]),
            ("N=2^16 key_cap=4096 (PageRank's refresh)",
             cs.merge_rows(rng, dev, 2**16, v, 4096, 8, 8192, 1024, 1024)[0]),
            ("N=2^15 key_cap=4096",
             cs.merge_rows(rng, dev, 2**15, v, 4096, 4, 4096, 512, 512)[0]),
            ("N=2^14 key_cap=1024",
             cs.merge_rows(rng, dev, 2**14, v, 1024, 8, 2048, 256, 256)[0]),
            ("N=4096 key_cap=256 (one block)",
             cs.merge_rows(rng, dev, one_m, v, one_cap, 8, 1024, 128,
                           128)[0])):
        got = fused_shuffle_reduce(*a, out_dtype=torch.float32)
        want = fused_shuffle_reduce_ref(*a, out_dtype=torch.float32)
        for part, g, w in zip(("k2", "mk", "vals", "live", "perm", "acc",
                               "counts"), got, want):
            if part != "acc":
                cs.require_equal(f"fused {name} {part}", g, w)
        # the values are non-negative: the sums are the sums of |v|
        cs.sum_rel_err(f"fused {name} acc", got[5], want[5], want[5])
        rec(f"fused_shuffle_reduce {name}",
            lambda: fused_shuffle_reduce(*a, out_dtype=torch.float32))
        rec(f"composed path {name}",
            lambda: ops.shuffle_reduce("sum", *a, fused=False))


def time_one_block(src: str, label: str) -> None:
    """The --one-block mode: see the module's docstring."""
    sys.path.insert(0, str(Path(src).resolve()))
    sys.path.insert(1, str(ROOT))
    import numpy as np
    import chip_smoke as cs
    from repro_torch.kernels import _build
    _build.build_all()
    cs.log = lambda msg: print(f"[{label}] {msg.strip()}", flush=True)
    cs.time_one_block(torch.device("cuda"), np.random.default_rng(0),
                      cs.FULL_VERTICES)


def main() -> int:
    if not torch.cuda.is_available():
        print("scatter_probes: needs a CUDA card", file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--kernels"]:
        time_kernels(*sys.argv[2:4])
        return 0
    if sys.argv[1:2] == ["--one-block"]:
        time_one_block(*sys.argv[2:4])
        return 0
    so = build()
    dev = torch.device("cuda")
    st = torch.cuda.current_stream(dev).cuda_stream
    g = torch.Generator(device=dev).manual_seed(0)
    sink = torch.zeros(1 << 16, dtype=torch.int32, device=dev)

    seg = torch.randint(0, 1 << 22, (N,), device=dev, dtype=torch.int32,
                        generator=g)
    vals = torch.ones(N, device=dev)
    ms = timed(so, lambda: so.probe_read(seg.data_ptr(), vals.data_ptr(), N,
                                         sink.data_ptr(), st))
    print(f"(a) read seg + vals, N=2^26 (537 MB): {ms:.4f} ms, "
          f"{8 * N / ms / 1e9:.3f} TB/s")

    for mb, words in ((1, 1 << 18), (16, 1 << 22)):
        out = torch.zeros(words, dtype=torch.int32, device=dev)
        for f32 in (1, 0):
            ms = timed(so, lambda: so.probe_red_global(
                out.data_ptr(), N, words - 1, f32, st))
            print(f"(b) {N} red.global.add.{'f32' if f32 else 'u32'} into "
                  f"{mb} MB, no loads: {ms:.4f} ms, {N / ms / 1e6:.1f} G/s")

    for k in ((1 << 18) + 1, 1 << 22):
        ids = torch.randint(0, k, (N,), device=dev, dtype=torch.int32,
                            generator=g)
        out = torch.empty(k, device=dev)
        ms = timed(so, lambda: so.probe_old(ids.data_ptr(), vals.data_ptr(),
                                            out.data_ptr(), N, k, st))
        print(f"(c) old per-element segment_sum, counts off, N=2^26, K={k}, "
              f"all ids in range: {ms:.4f} ms, {N / ms / 1e6:.1f} G adds/s")
        del ids, out

    fsink = torch.zeros(1 << 16, device=dev)
    for f32 in (1, 0):
        ms = timed(so, lambda: so.probe_red_shared(
            N, 128 << 10, f32, fsink.data_ptr(), st))
        print(f"(d) {N} shared atomicAdd {'f32' if f32 else 'u32'}, private "
              f"128 KB a block, 132 blocks x 1024: {ms:.4f} ms, "
              f"{N / ms / 1e6:.1f} G/s")

    for csize, per_log2 in ((16, 15), (8, 15)):
        for f32 in (1, 0):
            clusters = ctypes.c_int(0)
            ms = timed(so, lambda: so.probe_red_dsmem(
                N, per_log2, csize, f32, fsink.data_ptr(), st,
                ctypes.byref(clusters)))
            mb = csize * (4 << per_log2) / 2**20
            print(f"(e) {N} distributed-shared atomicAdd "
                  f"{'f32' if f32 else 'u32'}, cluster {csize} x "
                  f"{4 << per_log2 >> 10} KB ({mb:g} MB), "
                  f"{clusters.value} clusters x 1024 threads: {ms:.4f} ms, "
                  f"{N / ms / 1e6:.1f} G/s")

    ids = torch.randint(-2**31, 2**31 - 1, (N,), device=dev,
                        dtype=torch.int32, generator=g)
    out = torch.zeros(1 << 22, device=dev)
    for blocks_per_sm in (1, 2, 4, 8):
        for hint in (0, 1):
            ms = timed(so, lambda: so.probe_stream_red(
                ids.data_ptr(), vals.data_ptr(), out.data_ptr(), N,
                (1 << 22) - 1, 132 * blocks_per_sm, hint, st))
            print(f"(f) read N=2^26 ids + values, red.global.add.f32 of the "
                  f"half in range into 16 MB{' (L2 evict_last)' if hint else ''}"
                  f", {blocks_per_sm} x 512 threads an SM: {ms:.4f} ms, "
                  f"{N / 2 / ms / 1e6:.1f} G reds/s")

    # (g): ids as in (f); values at SSSP's scale in three orders of rows
    out = torch.empty(1 << 22, dtype=torch.int32, device=dev)
    mask = (1 << 22) - 1
    ms = timed(so, lambda: so.probe_stream_min(
        ids.data_ptr(), vals.data_ptr(), out.data_ptr(), N, mask, 132, -1,
        st))
    print(f"(g) identity fill of 2^22 words alone: {ms:.4f} ms")
    rand = torch.rand(N, device=dev, generator=g) * 30
    orders = {"random": rand, "increasing": rand.sort().values,
              "decreasing": rand.sort(descending=True).values}
    variants = (("unconditional atomicMin on u32 keys", 0, ("random",)),
                ("load first, atomicMin on u32 keys where the row wins", 1,
                 tuple(orders)),
                ("load first, two-branch fold on float bits where the row "
                 "wins", 2, tuple(orders)))
    for label, mode, names in variants:
        for name in names:
            v = orders[name]
            best = min(
                (timed(so, lambda: so.probe_stream_min(
                    ids.data_ptr(), v.data_ptr(), out.data_ptr(), N, mask,
                    132 * b, mode, st)), b) for b in (1, 2, 4, 8))
            print(f"(g) read N=2^26 ids + values ({name} order), fill + "
                  f"{label}, half in range, into 2^22 words: best "
                  f"{best[0]:.4f} ms at {best[1]} x 512 threads an SM, "
                  f"{N / 2 / best[0] / 1e6:.1f} G rows/s")

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
