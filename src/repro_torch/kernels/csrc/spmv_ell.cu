// ELL-format SpMV: PageRank's propagation step, y[j] = sum of contrib over
// the slots (i, f) with nbrs[i, f] == j.
//
// Replaces repro/kernels/spmv_ell.py: spmv_ell.  The TPU tiles the output
// vertex range into VMEM blocks and turns the scatter into a one-hot
// matmul per (row tile, output block), O(S F V / kblk) work.  On the H100
// it is segment_sum at D = 1 with counts off over the flattened slots:
// -1 padding and ids >= V are ids outside [0, V), dropped.  So it runs on
// the same core, scatter_sum.cuh.
//
// Design, from the probes (tools/scatter_probes.py; NVIDIA H100 80GB HBM3,
// 700 W): the L2 takes ~89 G reductions/s with no other traffic and ~73
// G/s beside a stream that reads the slots, so one pass over 2^26 slots
// with 2^25 live ones cannot go below ~0.46 ms; partitioning the live
// slots by vertex first (the core's partitioned variant) measured 0.72 ms
// here, as it moves 6 bytes a live slot twice beside the 8 a slot it
// reads.  So spmv_ell takes the core's direct variant: 16-byte loads of 4
// slots, padding dropped before any add, each run of equal ids in a warp
// one red.global.add (up to 8 in flight a thread), a grid of the resident
// blocks, y zeroed on the stream first.
//
// Numbers: float32 adds in a run-dependent order, so y agrees with a
// sequential sum up to the reordering of its additions (exact on
// integer-valued data below 2^24).
#include "scatter_sum.cuh"

// Bytes of workspace the launcher needs for `slots` slots and v vertices.
REPRO_EXPORT size_t spmv_ell_workspace_bytes(long long slots, int v) {
  return repro::scatter::make_layout(slots, 1, v, 0).total;
}

// nbrs: [slots] int32 (an [S, F] array, contiguous); contrib: [slots]
// float32; y: [v] float32; ws: spmv_ell_workspace_bytes(slots, v) bytes.
// Writes every element of y.
REPRO_EXPORT int spmv_ell_launch(const void* nbrs, const void* contrib,
                                 void* y, long long slots, int v, void* ws,
                                 size_t ws_bytes, void* stream_ptr) {
  if (v <= 0) return (int)cudaGetLastError();
  return repro::scatter::launch(static_cast<const int32_t*>(nbrs), contrib,
                                y, nullptr, slots, 1, v, 1, ws, ws_bytes,
                                (cudaStream_t)stream_ptr);
}
