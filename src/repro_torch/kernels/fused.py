"""Fused shuffle + last-writer-wins merge + Reduce — the merge hot path.

Counterpart of ``repro.kernels.fused.fused_shuffle_reduce``, on the
H100 as ``csrc/fused.cu``:

  * n <= 4096 rows: one block sorts (k2, mk, row) with a bitonic network
    in dynamic shared memory, gathers the payload, marks last writers and
    routes live rows to their affected-key slot with atomics, in one
    launch;
  * n > 4096 rows: the radix sort of ``csrc/sort.cu`` writes the sorted
    lanes and the permutation; then, the rows being sorted by k2, each
    affected key's rows are one run, and one kernel reduces the runs: it
    gathers the payload, marks the last writers, sums each run's live
    rows in a fixed order and writes each slot of ``acc``/``counts`` once
    (zeros where a key has no rows); a run that crosses the kernel's
    tiles leaves partials that a combine kernel adds in tile order.

int32 sums are exact.  The large path's float32 ``acc`` comes out the same
from run to run (a fixed order); the small path's float32 atomics add in a
run-dependent order (exact on integer-valued data).  The large path is
bounded by device-memory bytes and its sort's passes; the small path is
one block and bounded by its latency.

The kernel moves 32-bit payloads: ``vals`` is carried in ``out_dtype``
(int32 or float32) and cast back, which is lossless for the 8-, 16- and
32-bit types the dispatcher routes here.  It takes the dispatcher's
limits, ``key_cap`` <= 4096 (the keys sit in shared memory) and D <= 512.
CUDA tensors launch the kernel or raise; CPU tensors take
:func:`ref.fused_shuffle_reduce_ref`, and only they.  One call counts one
launch of this kernel, whichever path it takes (the large path's sort is
part of it and does not count as ``sort_lex``).
"""
from __future__ import annotations

from collections import Counter

import torch

from repro_torch.kernels import _build, count_launch
from repro_torch.kernels.ref import fused_shuffle_reduce_ref
from repro_torch.kernels.sort_u32 import sort_lex_cuda

SMALL_MAX_ROWS = 4096     # rows the single-block path sorts in shared memory
RUN_TILE_ROWS = 1024      # sorted rows a tile of the runs kernel at D = 1
MAX_KEYS = 4096           # affected-key slots (ops' cap)
MAX_D = 512               # payload width (ops' cap)
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
    d = vals.shape[1]
    if key_cap > MAX_KEYS or not 0 < d <= MAX_D:
        raise ValueError(f"the fused kernel takes key_cap <= {MAX_KEYS} and "
                         f"0 < D <= {MAX_D}, got {key_cap}, {d}")
    dev = vals.device
    k2 = k2.to(torch.int32).contiguous()
    mk = mk.to(torch.int32).contiguous()
    v = vals.to(out_dtype).contiguous()
    # a bool tensor is read as its bytes, not copied
    valid = (valid.view(torch.uint8) if valid.dtype == torch.bool
             else valid.to(torch.uint8)).contiguous()
    sign = sign.to(torch.int8).contiguous()
    keys = affected_keys.to(torch.int32).contiguous()
    lib = _build.library("fused")
    large = n > SMALL_MAX_ROWS
    # one int32 allocation: k2_s, mk_s, perm (each 16-byte aligned), counts,
    # then the large path's workspace
    n4 = -(-n // 4) * 4
    ws_words = lib.fused_runs_workspace_bytes(n, d) // 4 if large else 0
    buf = torch.empty(3 * n4 + key_cap + ws_words, dtype=torch.int32,
                      device=dev)
    k2_s, mk_s, perm = (buf[i * n4:i * n4 + n] for i in range(3))
    counts = buf[3 * n4:3 * n4 + key_cap]
    vals_s = torch.empty_like(v)
    live = torch.empty(n, dtype=torch.bool, device=dev)
    acc = torch.empty((key_cap, d), dtype=out_dtype, device=dev)
    is_float = int(out_dtype == torch.float32)
    stream = _build.stream_ptr(dev)
    if large:
        sort_lex_cuda(k2, mk, out=(k2_s, mk_s, perm))
        ws = buf[3 * n4 + key_cap:]
        rc = lib.fused_runs_launch(
            k2_s.data_ptr(), mk_s.data_ptr(), perm.data_ptr(), v.data_ptr(),
            valid.data_ptr(), sign.data_ptr(), keys.data_ptr(), key_cap, n,
            d, is_float, vals_s.data_ptr(), live.data_ptr(), acc.data_ptr(),
            counts.data_ptr(), ws.data_ptr(), 4 * ws_words, stream)
    else:
        rc = lib.fused_small_launch(
            k2.data_ptr(), mk.data_ptr(), v.data_ptr(), valid.data_ptr(),
            sign.data_ptr(), keys.data_ptr(), key_cap, n, d, is_float,
            k2_s.data_ptr(), mk_s.data_ptr(), vals_s.data_ptr(),
            live.data_ptr(), perm.data_ptr(), acc.data_ptr(),
            counts.data_ptr(), stream)
    _build.check(lib, rc, "fused_shuffle_reduce")
    count_launch(fused_shuffle_reduce,
                 (n, key_cap, d, "sort + runs" if large else "one block"))
    return k2_s, mk_s, vals_s.to(vals.dtype), live, perm, acc, counts


fused_shuffle_reduce.launches = 0
# (N, key_cap, D, path) -> launches
fused_shuffle_reduce.shapes = Counter()
