// Segment sum with optional per-segment row counts: the Reduce stage.
//
// Replaces repro/kernels/segment_reduce.py: segment_sum_counts_mxu and
// segment_sum_mxu (one launcher, counts on or off).  The TPU turns a
// segment sum into a one-hot matmul on its matrix unit, O(N K) work that a
// block skip trims for sorted ids.  On the H100 it is a scatter-add, and a
// scatter-add with one global atomic a row is bound by the L2's reduction
// rate, not by bytes: the first port's kernel took 1.65 ms for
// wordcount's 2^26 rows with counts, against 0.19 ms to read them
// (tools/scatter_probes.py).  It runs on the core in scatter_sum.cuh,
// which adds in shared memory and touches device memory once an output:
//   * K (D + counts) 4 bytes <= 128 KB (the accumulator's and the composed
//     merge's buckets): a block-private copy of the whole output;
//   * above, with counts or D > 1 (wordcount's and PageRank's Reduce): the
//     live rows partitioned into bins of 16,384 keys (at D = 1 with
//     counts), each bin reduced in shared memory;
//   * above, D = 1 without counts (SSSP's counts): one pass with one L2
//     add a run of equal ids, which the probes put at the card's floor for
//     one add a row.
// The source note there gives the probe numbers, the workspace and the
// shared memory.
//
// Contract: seg [n] int32, vals [n, d] int32 or float32, out [k, d];
// counts [k] int32 from the same call, or null; ids outside [0, k)
// dropped; int32 sums exact; float32 sums in a run-dependent order, exact
// on integer-valued data.  Ids need not be sorted.
#include "scatter_sum.cuh"

// Bytes of workspace the launcher needs for these sizes (counts: 0 or 1).
REPRO_EXPORT size_t segment_sum_workspace_bytes(long long n, int d, int k,
                                                int counts) {
  return repro::scatter::make_layout(n, d, k, counts).total;
}

// seg: [n] int32; vals: [n, d] float32 (is_float) or int32, contiguous;
// out: [k, d] same type; counts: [k] int32 or null; ws: workspace of
// segment_sum_workspace_bytes(n, d, k, counts != null) bytes.  Writes
// every element of out and counts.
REPRO_EXPORT int segment_sum_launch(const void* seg, const void* vals,
                                    void* out, void* counts, long long n,
                                    int d, int k, int is_float, void* ws,
                                    size_t ws_bytes, void* stream_ptr) {
  if (k <= 0) return (int)cudaGetLastError();
  return repro::scatter::launch(
      static_cast<const int32_t*>(seg), vals, out,
      static_cast<int32_t*>(counts), n, d, k, is_float, ws, ws_bytes,
      (cudaStream_t)stream_ptr);
}
