"""Segment sum (with optional row counts) and segment min/max — the Reduce
stage.

Counterpart of ``repro.kernels.segment_reduce``.  One kernel,
``csrc/segment_sum.cu``, covers both ``segment_sum_mxu`` and
``segment_sum_counts_mxu`` (counts on or off).  The TPU's one-hot matmul
and its sorted-input block skip do not carry over; on the H100 the kernel
is a scatter-add, one thread per (row, column), with the row count added
by the column-0 thread in the same launch.  Ids need not be sorted, and
ids outside [0, K) are dropped.  int32 sums are exact; float32 atomics add
in a run-dependent order (exact on integer-valued data).  It is bounded by
device-memory bytes: seg and vals read once, [K, D] written once.

``segment_minmax_mxu`` becomes ``csrc/segment_minmax.cu``: the output is
filled with the identity (+-inf for float32, the int32 extreme), then one
thread per (row, column) folds its value in with an atomic min or max
(float32 through its bits, see the source).  Min and max are exact and do
not depend on order, so it equals its plain version bit for bit on data
without NaN.  It is bounded by device-memory bytes as well.

CUDA tensors launch the kernels or raise; CPU tensors take the plain
versions :func:`ref.segment_sum_ref` and :func:`ref.segment_minmax_ref`,
and only they.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import segment_minmax_ref, segment_sum_ref

OUT_DTYPES = (torch.int32, torch.float32)
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
    # the launcher zeroes its outputs on the stream before it adds
    launch = bool(n and d and k)
    alloc = torch.empty if launch else torch.zeros
    out = alloc((k, d), dtype=out_dtype, device=vals.device)
    cnt = alloc(k, dtype=torch.int32, device=vals.device)
    if launch:
        lib = _build.library("segment_sum")
        seg = seg.to(torch.int32).contiguous()
        vals = vals.to(out_dtype).contiguous()
        rc = lib.segment_sum_launch(
            seg.data_ptr(), vals.data_ptr(), out.data_ptr(),
            cnt.data_ptr() if counts else None, n, d, k,
            int(out_dtype == torch.float32), _build.stream_ptr(vals.device))
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
        # the launcher fills the identity on the stream before it folds
        lib = _build.library("segment_minmax")
        seg = seg.to(torch.int32).contiguous()
        vals = vals.contiguous()
        rc = lib.segment_minmax_launch(
            seg.data_ptr(), vals.data_ptr(), out.data_ptr(), n, d, k,
            int(vals.dtype == torch.float32), int(kind == "min"),
            _build.stream_ptr(vals.device))
        _build.check(lib, rc, "segment_minmax")
        segment_minmax.launches += 1
    return out


segment_minmax.launches = 0
