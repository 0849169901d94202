"""Segment sum (with optional row counts) and segment min/max — the Reduce
stage.

Counterpart of ``repro.kernels.segment_reduce``.  One launcher,
``csrc/segment_sum.cu``, covers both ``segment_sum_mxu`` and
``segment_sum_counts_mxu`` (counts on or off).  The TPU's one-hot matmul
and its sorted-input block skip do not carry over; on the H100 a segment
sum is a scatter-add, and one global atomic a row is bound by the L2's
reduction rate (~89 G/s; 0.75 ms for 2^26 adds against 0.19 ms to read
the rows: ``tools/scatter_probes.py``).  The core,
``csrc/scatter_sum.cuh``, adds in shared memory instead.  Its variants,
chosen by the launcher from the output's K (D + counts) words: up to
128 KB, each block sums a chunk of rows into a private copy of the whole
output; above, with counts or D > 1, the live rows are partitioned into
bins of 16,384 keys (at D = 1 with counts) and each bin is reduced in
shared memory, a hot bin split across blocks; above, at D = 1 without
counts, one pass adds each run of equal ids into the output with one L2
atomic (one add a row is all the L2 is asked for there).  At D = 1 a
thread takes 4 rows with 16-byte loads and equal adjacent ids collapse to
one add.  The workspace (``segment_sum_workspace_bytes``: ~6.75 bytes a
row plus at most 66 MB of partial slabs when partitioned) comes from the
wrapper's ``torch.empty``.  Ids need not be sorted, and ids outside
[0, K) are dropped.  int32 sums are exact; float32 adds in a
run-dependent order (exact on integer-valued data).

``segment_minmax_mxu`` becomes ``csrc/segment_minmax.cu``, on
order-preserving u32 keys (one unsigned min decides min and max, float32
and int32): the identity fill, then one pass that folds each run of equal
ids with one L2 atomic, 4 rows a thread with 16-byte loads, at every K.
A row at the identity (+-inf for float32, the int32 extreme) drops before
any memory access; no row loads the stored value first, and no block
folds into a private slab in shared memory (both measured slower: the
source's notes).  Min and max are exact and do not depend on order, so it
equals its plain version bit for bit on data without NaN.  It is bounded
by the L2's atomics beside the stream of rows.

CUDA tensors launch the kernels or raise; CPU tensors take the plain
versions :func:`ref.segment_sum_ref` and :func:`ref.segment_minmax_ref`,
and only they.
"""
from __future__ import annotations

from collections import Counter

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import segment_minmax_ref, segment_sum_ref

OUT_DTYPES = (torch.int32, torch.float32)
MAX_ROWS = 2**31 - 1          # rows a launch (32-bit positions)
MAX_SEGMENTS = 2**27          # 2048 bins of at most 2^16 keys (16-bit ids)
# words of csrc/scatter_sum.cuh's shared-memory slab: an output of at most
# this many words (K (D + counts)) takes the block-private variant
SLAB_WORDS = 32768
MINMAX_DTYPES = (torch.int32, torch.float32)


def segment_sum(seg: torch.Tensor, vals: torch.Tensor, num_segments: int, *,
                out_dtype=torch.float32, counts: bool = False):
    """seg [N] int32, vals [N, D] -> sums [K, D] in ``out_dtype``.

    With ``counts=True`` returns ``(sums, counts [K] int32)`` from the same
    launch.  Rows whose id is outside [0, K) are dropped.
    """
    if out_dtype not in OUT_DTYPES:
        raise TypeError(f"segment_sum accumulates in {OUT_DTYPES}, "
                        f"got {out_dtype}")
    if vals.ndim != 2 or seg.shape != vals.shape[:1]:
        raise ValueError(f"segment_sum takes seg [N] and vals [N, D], got "
                         f"{tuple(seg.shape)}, {tuple(vals.shape)}")
    if seg.device != vals.device:
        raise ValueError("segment_sum inputs lie on different devices")
    if vals.device.type == "cpu":
        return segment_sum_ref(seg, vals, num_segments, out_dtype=out_dtype,
                               counts=counts)
    if vals.device.type != "cuda":
        raise ValueError(f"segment_sum runs on cuda or cpu, not "
                         f"{vals.device}")
    k = max(int(num_segments), 0)
    n, d = vals.shape
    if n > MAX_ROWS or k > MAX_SEGMENTS:
        raise ValueError(f"the segment_sum kernel takes at most {MAX_ROWS} "
                         f"rows and {MAX_SEGMENTS} segments, got {n}, {k}")
    # the launcher writes every output element
    launch = bool(n and k and (d or counts))
    alloc = torch.empty if launch else torch.zeros
    out = alloc((k, d), dtype=out_dtype, device=vals.device)
    cnt = alloc(k, dtype=torch.int32, device=vals.device)
    if launch:
        lib = _build.library("segment_sum")
        seg = seg.to(torch.int32).contiguous()
        vals = vals.to(out_dtype).contiguous()
        ws = torch.empty(lib.segment_sum_workspace_bytes(n, d, k, int(counts)),
                         dtype=torch.uint8, device=vals.device)
        rc = lib.segment_sum_launch(
            seg.data_ptr(), vals.data_ptr(), out.data_ptr(),
            cnt.data_ptr() if counts else None, n, d, k,
            int(out_dtype == torch.float32), ws.data_ptr(), ws.numel(),
            _build.stream_ptr(vals.device))
        _build.check(lib, rc, "segment_sum")
        segment_sum.launches += 1
    return (out, cnt) if counts else out


segment_sum.launches = 0


def segment_minmax(kind: str, seg: torch.Tensor, vals: torch.Tensor,
                   num_segments: int) -> torch.Tensor:
    """seg [N] int32, vals [N, D] int32 or float32 -> per-segment min or max
    [K, D] in ``vals``' type.

    Rows whose id is outside [0, K) are dropped; a segment with no rows
    holds the identity (+inf / -inf for float32, the int32 extreme).
    """
    if kind not in ("min", "max"):
        raise ValueError(f"segment_minmax kind must be 'min' or 'max', "
                         f"got {kind!r}")
    if vals.ndim != 2 or seg.shape != vals.shape[:1]:
        raise ValueError(f"segment_minmax takes seg [N] and vals [N, D], "
                         f"got {tuple(seg.shape)}, {tuple(vals.shape)}")
    if seg.device != vals.device:
        raise ValueError("segment_minmax inputs lie on different devices")
    if vals.device.type == "cpu":
        return segment_minmax_ref(kind, seg, vals, num_segments)
    if vals.device.type != "cuda":
        raise ValueError(f"segment_minmax runs on cuda or cpu, not "
                         f"{vals.device}")
    if vals.dtype not in MINMAX_DTYPES:
        raise TypeError(f"the segment_minmax kernel takes {MINMAX_DTYPES}, "
                        f"got {vals.dtype}")
    k = max(int(num_segments), 0)
    n, d = vals.shape
    out = torch.empty((k, d), dtype=vals.dtype, device=vals.device)
    if k and d:
        # the launcher writes every output element
        lib = _build.library("segment_minmax")
        seg = seg.to(torch.int32).contiguous()
        vals = vals.contiguous()
        rc = lib.segment_minmax_launch(
            seg.data_ptr(), vals.data_ptr(), out.data_ptr(), n, d, k,
            int(vals.dtype == torch.float32), int(kind == "min"),
            _build.stream_ptr(vals.device))
        _build.check(lib, rc, "segment_minmax")
        segment_minmax.launches += 1
        segment_minmax.shapes[(n, k, d)] += 1
    return out


segment_minmax.launches = 0
segment_minmax.shapes = Counter()      # (N, K, D) -> launches
