"""Stable lexicographic sort of two int32 key lanes — the shuffle sort.

Counterpart of ``repro.kernels.sort_u32``.  :func:`sort_lex` returns
``(hi_sorted, lo_sorted, perm)`` in the total order (hi, lo, row index), so
the permutation is unique and equals the reference's bit for bit.

On a CUDA tensor it launches ``csrc/sort.cu``, which replaces the TPU
bitonic network ``sort_u32.sort_lex_pallas`` (its tile, cross-tile and
finish kernels): a one-sweep LSD radix sort of the packed 64-bit key, 8
stable passes of 8 bits.  It is bounded by device-memory bytes, 24 a row a
pass at the least.  One kernel counts all 8 digits up front; each pass is
one kernel whose blocks take 4096-row tiles in arrival order, rank them in
shared memory, take their offsets by decoupled look-back and write each
digit's run contiguously; the first pass reads the lanes and the last
writes the outputs; a digit that is the same for every row is skipped on
the device, with no host synchronisation.  Workspace
(``sort_lex_workspace_bytes``): 24.5 n bytes + 16 KB; 58 KB of shared
memory a block.  Output is exactly n rows, never padded.

On a CPU tensor it takes the plain version :func:`ref.sort_lex_ref`, and
only there.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import sort_lex_ref

_MAX_ROWS = 2**31 - 1
TILE_ROWS = 4096          # rows a block of csrc/sort.cu takes (its TILE)


def _check_lanes(hi: torch.Tensor, lo: torch.Tensor) -> None:
    if hi.dtype != torch.int32 or lo.dtype != torch.int32:
        raise TypeError(f"sort_lex takes int32 lanes, got {hi.dtype}, "
                        f"{lo.dtype}")
    if hi.ndim != 1 or hi.shape != lo.shape:
        raise ValueError(f"sort_lex takes two [N] lanes, got "
                         f"{tuple(hi.shape)}, {tuple(lo.shape)}")
    if hi.device != lo.device:
        raise ValueError("sort_lex lanes lie on different devices")


def sort_lex_cuda(hi: torch.Tensor, lo: torch.Tensor, out=None):
    """Launch the one-sweep radix sort on CUDA lanes (no launch count: callers that
    are kernels of their own, like the fused path, use this directly).
    ``out``: three contiguous int32 [N] tensors for (hi_s, lo_s, perm), else
    they are allocated."""
    n = hi.shape[0]
    if n >= _MAX_ROWS:
        raise ValueError(f"sort_lex takes fewer than 2^31 rows, got {n}")
    hi = hi.contiguous()
    lo = lo.contiguous()
    if out is None:
        out = (torch.empty_like(hi), torch.empty_like(lo),
               torch.empty(n, dtype=torch.int32, device=hi.device))
    hi_s, lo_s, perm = out
    if n == 0:
        return hi_s, lo_s, perm
    lib = _build.library("sort")
    ws = torch.empty(lib.sort_lex_workspace_bytes(n), dtype=torch.uint8,
                     device=hi.device)
    rc = lib.sort_lex_launch(hi.data_ptr(), lo.data_ptr(), hi_s.data_ptr(),
                             lo_s.data_ptr(), perm.data_ptr(), n,
                             ws.data_ptr(), _build.stream_ptr(hi.device))
    _build.check(lib, rc, "sort_lex")
    return hi_s, lo_s, perm


def sort_lex(hi: torch.Tensor, lo: torch.Tensor):
    """Stable sort by (hi, lo), ties by row index; returns (hi_s, lo_s, perm).

    ``perm`` is int32 with ``hi_s == hi[perm]``.  CUDA tensors run the
    kernel (or raise); CPU tensors run the plain version.
    """
    _check_lanes(hi, lo)
    if hi.device.type == "cpu":
        return sort_lex_ref(hi, lo)
    if hi.device.type != "cuda":
        raise ValueError(f"sort_lex runs on cuda or cpu, not {hi.device}")
    out = sort_lex_cuda(hi, lo)
    if hi.shape[0]:
        sort_lex.launches += 1
    return out


sort_lex.launches = 0


def sort_kv32(keys: torch.Tensor, payload: torch.Tensor):
    """Sort int32 ``keys`` ascending (stable), permuting ``payload``."""
    ko, _, perm = sort_lex(keys, torch.zeros_like(keys))
    return ko, payload[perm.to(torch.int64)]
