"""Fused shuffle + last-writer-wins merge + Reduce — the merge hot path.

Counterpart of ``repro.kernels.fused.fused_shuffle_reduce``, on the
H100 as ``csrc/fused.cu``:

  * n <= 4096 rows: one block sorts (k2, mk, row) with a bitonic network
    in dynamic shared memory, gathers the payload, marks last writers and
    routes live rows to their affected-key slot, in one launch;
  * n > 4096 rows: the radix sort of ``csrc/sort.cu`` writes the sorted
    lanes and the permutation, then one kernel gathers the payload,
    compares each row with the next sorted row in device memory (no tile
    boundary, so no sentinel hand-off as in ``fused.py:123-126``) and adds
    live rows into ``acc``/``counts`` with atomics.

``acc`` is [key_cap, D] in device memory (up to 8 MB).  int32 sums are
exact; float32 atomics add in run-dependent order (exact on integer-valued
data).  The large path is bounded by device-memory bytes; the small path
is one block and bounded by its latency.

The kernel moves 32-bit payloads: ``vals`` is carried in ``out_dtype``
(int32 or float32) and cast back, which is lossless for the 8-, 16- and
32-bit types the dispatcher routes here.  CUDA tensors launch the kernel
or raise; CPU tensors take :func:`ref.fused_shuffle_reduce_ref`, and only
they.  One call counts one launch of this kernel, whichever path it takes
(the large path's sort is part of it and does not count as ``sort_lex``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import fused_shuffle_reduce_ref
from repro_torch.kernels.sort_u32 import sort_lex_cuda

SMALL_MAX_ROWS = 4096     # rows the single-block path sorts in shared memory
OUT_DTYPES = (torch.int32, torch.float32)


def fused_shuffle_reduce(k2, mk, vals, valid, sign, affected_keys, *,
                         out_dtype):
    """Sort (k2, mk) stably, merge last-writer-wins, sum live rows per key.

    ``vals`` is [N, D]; ``affected_keys`` is sorted ascending, unique among
    real entries, padded with int32 max; invalid rows already carry k2 =
    int32 max.  Returns ``(k2_s, mk_s, vals_s, live, perm, acc, counts)``:
    the sorted rows (length N), ``acc`` [key_cap, D] in ``out_dtype`` and
    ``counts`` [key_cap] int32.
    """
    n = k2.shape[0]
    key_cap = affected_keys.shape[0]
    if n == 0 or key_cap == 0:
        raise ValueError("fused_shuffle_reduce needs rows and affected keys")
    if out_dtype not in OUT_DTYPES:
        raise TypeError(f"fused_shuffle_reduce accumulates in {OUT_DTYPES}, "
                        f"got {out_dtype}")
    if vals.ndim != 2 or vals.shape[0] != n:
        raise ValueError(f"vals must be [N, D], got {tuple(vals.shape)}")
    if vals.device.type == "cpu":
        return fused_shuffle_reduce_ref(k2, mk, vals, valid, sign,
                                        affected_keys, out_dtype=out_dtype)
    if vals.device.type != "cuda":
        raise ValueError(f"fused_shuffle_reduce runs on cuda or cpu, not "
                         f"{vals.device}")
    if vals.element_size() > 4:
        raise TypeError(f"the fused kernel moves 32-bit payloads, got "
                        f"{vals.dtype}")
    dev = vals.device
    d = vals.shape[1]
    k2 = k2.to(torch.int32).contiguous()
    mk = mk.to(torch.int32).contiguous()
    v = vals.to(out_dtype).contiguous()
    valid = valid.to(torch.uint8).contiguous()
    sign = sign.to(torch.int8).contiguous()
    keys = affected_keys.to(torch.int32).contiguous()
    vals_s = torch.empty_like(v)
    live = torch.empty(n, dtype=torch.bool, device=dev)
    acc = torch.empty((key_cap, d), dtype=out_dtype, device=dev)
    counts = torch.empty(key_cap, dtype=torch.int32, device=dev)
    is_float = int(out_dtype == torch.float32)
    stream = _build.stream_ptr(dev)
    lib = _build.library("fused")
    if n <= SMALL_MAX_ROWS:
        k2_s = torch.empty_like(k2)
        mk_s = torch.empty_like(mk)
        perm = torch.empty(n, dtype=torch.int32, device=dev)
        rc = lib.fused_small_launch(
            k2.data_ptr(), mk.data_ptr(), v.data_ptr(), valid.data_ptr(),
            sign.data_ptr(), keys.data_ptr(), key_cap, n, d, is_float,
            k2_s.data_ptr(), mk_s.data_ptr(), vals_s.data_ptr(),
            live.data_ptr(), perm.data_ptr(), acc.data_ptr(),
            counts.data_ptr(), stream)
    else:
        k2_s, mk_s, perm = sort_lex_cuda(k2, mk)
        rc = lib.fused_lww_launch(
            k2_s.data_ptr(), mk_s.data_ptr(), perm.data_ptr(), v.data_ptr(),
            valid.data_ptr(), sign.data_ptr(), keys.data_ptr(), key_cap, n,
            d, is_float, vals_s.data_ptr(), live.data_ptr(), acc.data_ptr(),
            counts.data_ptr(), stream)
    _build.check(lib, rc, "fused_shuffle_reduce")
    fused_shuffle_reduce.launches += 1
    return k2_s, mk_s, vals_s.to(vals.dtype), live, perm, acc, counts


fused_shuffle_reduce.launches = 0
