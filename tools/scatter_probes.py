#!/usr/bin/env python3
"""Probes of what bounds a scatter-add on the card (segment sum, ELL SpMV).

    python3 tools/scatter_probes.py

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
      512 threads an SM, with and without an L2 evict-last hint.

Prints one line a probe (ms and adds or bytes per second), the card's
name and power limit, and needs one CUDA card.
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


def main() -> int:
    if not torch.cuda.is_available():
        print("scatter_probes: needs a CUDA card", file=sys.stderr)
        return 2
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

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
