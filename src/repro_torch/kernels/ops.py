"""Dispatch for the engine's hot paths: shuffle sort, Reduce, fused merge.

Counterpart of ``repro.kernels.ops`` with the same contract: the sort's
total order is (k2, mk, row index); invalid rows are masked to int32 max
and sort to the tail; invalid rows never reach a real group; ``mean``
returns sums plus counts and ``finalize_reduce`` divides.

There is no backend name.  The device of the tensors decides: a CUDA
tensor reaches the hand-written kernel (or raises), a CPU tensor the plain
version.  The paths themselves follow the reference's pallas backend,
whose kernels these are: the fused merge whenever ``_can_fuse`` holds (the
plain fused version on the CPU gives the composed path's bits), the sum
kernel with counts riding the first leaf's launch, and the min/max kernel
for ``min``/``max`` reducers.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple, Optional

import torch

from repro_torch.kernels.fused import fused_shuffle_reduce
from repro_torch.kernels.segment_reduce import segment_minmax, segment_sum
from repro_torch.kernels.sort_u32 import sort_lex
from repro_torch.tree import tree_flatten, tree_map

_INT32_MAX = 2**31 - 1
_FUSED_MAX_D = 512       # value width cap of the fused path (as the reference)
_FUSED_MAX_KEYS = 4096   # affected-key cap of the fused path


# ---------------------------------------------------------------------------
# sort_pairs: the shuffle sort
# ---------------------------------------------------------------------------

class SortedPairs(NamedTuple):
    k2: torch.Tensor       # [N] sorted primary keys
    mk: torch.Tensor       # [N] co-sorted secondary keys
    payload: Any           # tree of [N, ...] gathered through perm
    perm: torch.Tensor     # [N] int32, k2_sorted == k2[perm]


def sort_pairs(k2: torch.Tensor, mk: Optional[torch.Tensor] = None,
               payload: Any = None, *, num_keys: int = 2) -> SortedPairs:
    """Stable lexicographic sort by (k2[, mk]); ties keep input order.

    Mask invalid rows' k2 to int32 max beforehand and they sort to the
    tail.  Every leaf of ``payload`` is gathered once through the
    permutation.
    """
    k2 = k2.to(torch.int32)
    n = k2.shape[0]
    if mk is None:
        mk = torch.zeros(n, dtype=torch.int32, device=k2.device)
        num_keys = 1
    mk = mk.to(torch.int32)
    lo = mk if num_keys >= 2 else torch.zeros_like(k2)
    k2s, los, perm = sort_lex(k2, lo)
    p = perm.to(torch.int64)
    mks = los if num_keys >= 2 else mk[p]
    return SortedPairs(k2s, mks, tree_map(lambda a: a[p], payload), perm)


# ---------------------------------------------------------------------------
# segment_reduce: the Reduce stage
# ---------------------------------------------------------------------------

def _kind_of(reducer) -> str:
    kind = getattr(reducer, "kind", reducer)
    if kind not in ("sum", "min", "max", "mean"):
        raise ValueError(f"unknown reducer kind {kind!r}")
    return kind


def _sum_dtype(dtype) -> torch.dtype:
    return torch.float32 if dtype.is_floating_point else torch.int32


def segment_reduce(reducer, segment_ids: torch.Tensor, values: Any,
                   valid: torch.Tensor, num_segments: int):
    """Reduce ``values`` into ``num_segments`` groups.

    Returns (accumulated tree [K, ...], counts [K] int32); mean returns the
    *sum*.  Invalid rows take the id ``num_segments``, which the kernels
    drop as out of range (the reference reduces them into a scratch
    segment and slices it off: the same result, without every invalid row
    contending for one output row's atomics).  Ids need not be sorted.
    """
    kind = _kind_of(reducer)
    valid = valid.to(torch.bool)
    # a Python scalar: no host-to-device copy, and the result stays int32
    seg = torch.where(valid, segment_ids.to(torch.int32), int(num_segments))
    k = num_segments
    leaves, unflatten = tree_flatten(values)
    counts = None
    outs = []
    for leaf in leaves:
        # invalid rows need no masking: the kernels never read a dropped row
        width = math.prod(leaf.shape[1:])          # -1 breaks on 0 rows
        flat = leaf.reshape(leaf.shape[0], width)
        if kind in ("sum", "mean"):
            out_dtype = _sum_dtype(leaf.dtype)
            if counts is None:
                # the counts ride the first sum leaf's launch
                out, counts = segment_sum(seg, flat, k, out_dtype=out_dtype,
                                          counts=True)
            else:
                out = segment_sum(seg, flat, k, out_dtype=out_dtype)
            out = out.to(leaf.dtype)
        else:
            out = segment_minmax(kind, seg, flat, k)
        outs.append(out.reshape((k,) + tuple(leaf.shape[1:])))
    acc = unflatten(outs)
    if counts is None:
        counts = segment_sum(seg, valid.to(torch.int32)[:, None], k,
                             out_dtype=torch.int32)[:, 0]
    return acc, counts


# ---------------------------------------------------------------------------
# shuffle_reduce: the fused shuffle + merge + Reduce hot path
# ---------------------------------------------------------------------------

class ShuffleReduced(NamedTuple):
    """Sorted+merged rows plus the per-affected-key reduction."""

    k2: torch.Tensor       # [N] sorted primary keys (invalid rows at tail)
    mk: torch.Tensor       # [N] co-sorted secondary keys
    values: Any            # tree of [N, ...] gathered through perm
    live: torch.Tensor     # [N] bool: last writer per (k2, mk), not a tombstone
    perm: torch.Tensor     # [N] int32 sort permutation
    acc: Any               # tree of [key_cap, ...] accumulated live values
    counts: torch.Tensor   # [key_cap] int32 live rows per affected key


def _can_fuse(kind: str, leaves, n: int, key_cap: int) -> bool:
    # as ops.py:276-280; the element-size test keeps 64-bit tensors (which
    # JAX without x64 never has) on the composed path, since the fused
    # kernel moves 32-bit payloads
    return (kind in ("sum", "mean") and len(leaves) == 1
            and leaves[0].ndim <= 2 and n > 0
            and 0 < key_cap <= _FUSED_MAX_KEYS
            and (leaves[0].numel() // max(n, 1)) <= _FUSED_MAX_D
            and leaves[0].element_size() <= 4)


def shuffle_reduce(reducer, k2: torch.Tensor, mk: torch.Tensor, values: Any,
                   valid: torch.Tensor, sign: torch.Tensor,
                   affected_keys: torch.Tensor, *,
                   fused: Optional[bool] = None) -> ShuffleReduced:
    """Shuffle-sort, last-writer-wins merge, and reduce in one call.

    Rows sort stably by (k2, mk) (invalid rows masked to the tail); the
    last row of each (k2, mk) run survives if its sign is positive
    (tombstones delete); live rows reduce into the slots of
    ``affected_keys`` (sorted ascending, unique, padded with int32 max).

    ``fused=None`` takes the fused kernel when the monoid supports it
    (sum/mean, one value leaf of width <= 512, 0 < key_cap <= 4096);
    ``False`` forces the composed path; ``True`` requires fusion and
    raises where unsupported.  Both paths give the same bits.
    """
    kind = _kind_of(reducer)
    n = k2.shape[0]
    key_cap = affected_keys.shape[0]
    leaves, unflatten = tree_flatten(values)
    fusable = _can_fuse(kind, leaves, n, key_cap)
    if fused and not fusable:
        raise ValueError(
            "fused shuffle_reduce requires a sum/mean reducer and a single "
            f"value leaf of width <= {_FUSED_MAX_D} with 0 < key_cap <= "
            f"{_FUSED_MAX_KEYS}")
    if fusable and fused is not False:
        return _shuffle_reduce_fused(k2, mk, leaves[0], unflatten, valid,
                                     sign, affected_keys)
    return _shuffle_reduce_composed(reducer, k2, mk, values, valid, sign,
                                    affected_keys)


def _mask_invalid_keys(k2: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    # a Python scalar: no host-to-device copy, and the result stays int32
    return torch.where(valid.to(torch.bool), k2.to(torch.int32), _INT32_MAX)


def _shuffle_reduce_composed(reducer, k2, mk, values, valid, sign,
                             affected_keys) -> ShuffleReduced:
    n = k2.shape[0]
    key_cap = affected_keys.shape[0]
    valid = valid.to(torch.bool)
    res = sort_pairs(_mask_invalid_keys(k2, valid), mk,
                     (values, valid, sign), num_keys=2)
    vals_s, valid_s, sign_s = res.payload

    # last-writer-wins per (k2, mk); tombstones delete
    nk2 = torch.roll(res.k2, -1)
    nmk = torch.roll(res.mk, -1)
    is_last = ((torch.arange(n, device=k2.device) == n - 1)
               | (nk2 != res.k2) | (nmk != res.mk))
    live = valid_s & is_last & (sign_s > 0)

    # route each live row to its affected-key slot
    if key_cap:
        local = torch.searchsorted(affected_keys, res.k2).to(torch.int32)
        in_set = affected_keys[local.clamp(0, key_cap - 1).to(torch.int64)] \
            == res.k2
    else:
        local = torch.zeros_like(res.k2)
        in_set = torch.zeros_like(live)
    acc, counts = segment_reduce(reducer, local, vals_s, live & in_set,
                                 key_cap)
    return ShuffleReduced(res.k2, res.mk, vals_s, live, res.perm, acc,
                          counts)


def _shuffle_reduce_fused(k2, mk, leaf, unflatten, valid, sign,
                          affected_keys) -> ShuffleReduced:
    key_cap = affected_keys.shape[0]
    out_dtype = _sum_dtype(leaf.dtype)
    flat = leaf.reshape(leaf.shape[0], -1)
    k2s, mks, vals_s, live, perm, acc, counts = fused_shuffle_reduce(
        _mask_invalid_keys(k2, valid), mk, flat, valid, sign, affected_keys,
        out_dtype=out_dtype)
    vals_s = vals_s.reshape(leaf.shape)
    acc = acc.to(leaf.dtype).reshape((key_cap,) + tuple(leaf.shape[1:]))
    return ShuffleReduced(k2s, mks, unflatten([vals_s]), live, perm,
                          unflatten([acc]), counts)


# ---------------------------------------------------------------------------
# group_reduce: the dql lowering shim
# ---------------------------------------------------------------------------

def group_reduce(reducer, keys: torch.Tensor, values: Any,
                 valid: torch.Tensor, num_groups: int):
    """Grouped reduce over a dense group-id space.

    Same contract as :func:`segment_reduce`, but negative or out-of-range
    keys mask the row, composing with ``valid``.
    """
    keys = keys.to(torch.int32)
    live = valid.to(torch.bool) & (keys >= 0) & (keys < num_groups)
    return segment_reduce(reducer, keys, values, live, num_groups)
