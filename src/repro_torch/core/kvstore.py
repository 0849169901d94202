"""Fixed-width key-value tensors: MapReduce records on the device.

Counterpart of ``repro.core.kvstore``.  A batch of kv-pairs is a ``KV`` of
tensors with an explicit validity mask; the MRBGraph's intermediate edges
are ``Edges`` carrying (K2, MK, V2) per the paper's Section 3.2.  Keys are
int32 ids; invalid entries carry ``INVALID_KEY`` so that the shuffle sort
pushes them to the tail.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.tree import tree_map

INVALID_KEY = 2**31 - 1
_HASH_MULT = 2654435761


class KV(NamedTuple):
    """A batch of kv-pairs.  ``values`` may be any tree of [N, ...] tensors."""

    keys: torch.Tensor       # [N] int32
    values: Any              # tree of [N, ...]
    valid: torch.Tensor      # [N] bool

    @property
    def capacity(self) -> int:
        return self.keys.shape[0]

    def count(self) -> torch.Tensor:
        return self.valid.to(torch.int32).sum()


class Edges(NamedTuple):
    """MRBGraph edges: fine-grain intermediate state (K2, MK, V2).

    ``sign`` marks insertions (+1) and deletion tombstones (-1) in a delta
    MRBGraph; a preserved MRBGraph has sign == +1 everywhere.
    """

    k2: torch.Tensor         # [E] int32  destination Reduce instance
    mk: torch.Tensor         # [E] int32  globally unique Map instance key
    v2: Any                  # tree of [E, ...] edge values
    valid: torch.Tensor      # [E] bool
    sign: torch.Tensor       # [E] int8   +1 insert, -1 delete

    @property
    def capacity(self) -> int:
        return self.k2.shape[0]

    def count(self) -> torch.Tensor:
        return self.valid.to(torch.int32).sum()


def as_tensor(a, dtype=None) -> torch.Tensor:
    """A tensor of ``a``: tensors stay on their device, host data lands on
    the CPU."""
    if isinstance(a, torch.Tensor):
        return a if dtype is None else a.to(dtype)
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def make_kv(keys, values, valid=None) -> KV:
    keys = as_tensor(keys, torch.int32)
    if valid is None:
        valid = torch.ones(keys.shape[0], dtype=torch.bool,
                           device=keys.device)
    return KV(keys, tree_map(as_tensor, values),
              as_tensor(valid, torch.bool))


def make_edges(k2, mk, v2, valid=None, sign=None) -> Edges:
    k2 = as_tensor(k2, torch.int32)
    mk = as_tensor(mk, torch.int32)
    n, dev = k2.shape[0], k2.device
    if valid is None:
        valid = torch.ones(n, dtype=torch.bool, device=dev)
    if sign is None:
        sign = torch.ones(n, dtype=torch.int8, device=dev)
    return Edges(k2, mk, tree_map(as_tensor, v2),
                 as_tensor(valid, torch.bool), as_tensor(sign, torch.int8))


def hash32(keys: torch.Tensor, buckets: int) -> torch.Tensor:
    """Knuth multiplicative hash onto ``buckets`` partitions.

    The reference computes in uint32 with wraparound; here the product is
    formed in int64 from two 16-bit halves of the multiplier (no int64
    overflow) and masked to 32 bits, which gives the same bits.
    """
    k = keys.to(torch.int64) & 0xFFFFFFFF
    lo = k * (_HASH_MULT & 0xFFFF)
    hi = ((k * (_HASH_MULT >> 16)) & 0xFFFF) << 16
    h = ((lo + hi) & 0xFFFFFFFF) >> 16
    return (h % buckets).to(torch.int32)


# ---------------------------------------------------------------------------
# Sorting (the shuffle sort) — thin wrappers over repro_torch.kernels.ops
# ---------------------------------------------------------------------------

def _mask_keys(keys: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    return torch.where(valid, keys.to(torch.int32),
                       torch.tensor(INVALID_KEY, dtype=torch.int32,
                                    device=keys.device))


def sort_edges(edges: Edges, *, num_keys: int = 2) -> Edges:
    """Lexicographic stable sort of edges by (k2[, mk]).

    Invalid edges get k2 = INVALID_KEY so they land at the tail: the
    MapReduce shuffle, where pairs reach a Reduce task sorted by K2 and,
    within a chunk, by MK.
    """
    k2 = _mask_keys(edges.k2, edges.valid)
    res = ops.sort_pairs(k2, edges.mk, (edges.v2, edges.valid, edges.sign),
                         num_keys=num_keys)
    v2, valid, sign = res.payload
    return Edges(res.k2, res.mk, v2, valid, sign)


def sort_kv(kv: KV) -> KV:
    keys = _mask_keys(kv.keys, kv.valid)
    res = ops.sort_pairs(keys, None, (kv.values, kv.valid), num_keys=1)
    values, valid = res.payload
    return KV(res.k2, values, valid)


# ---------------------------------------------------------------------------
# Reducers (the Reduce function as a segment monoid)
# ---------------------------------------------------------------------------

def _type_max(dtype):
    return (torch.finfo(dtype) if dtype.is_floating_point
            else torch.iinfo(dtype)).max


def _type_min(dtype):
    return (torch.finfo(dtype) if dtype.is_floating_point
            else torch.iinfo(dtype)).min


class Reducer(NamedTuple):
    """Associative Reduce functions as segment monoids.

    ``invertible`` marks monoids that are abelian groups (sum): deletions
    can then be applied as inverse contributions without the MRBGraph.
    """

    kind: str                                 # 'sum' | 'min' | 'max' | 'mean'
    finalize: Optional[Callable] = None       # (key, acc, count) -> value
    invertible: bool = False

    def identity_like(self, v2_leaf: torch.Tensor) -> torch.Tensor:
        if self.kind in ("sum", "mean"):
            return torch.zeros_like(v2_leaf)
        if self.kind == "min":
            return torch.full_like(v2_leaf, _type_max(v2_leaf.dtype))
        if self.kind == "max":
            return torch.full_like(v2_leaf, _type_min(v2_leaf.dtype))
        raise ValueError(self.kind)


def sum_reducer(finalize=None) -> Reducer:
    return Reducer("sum", finalize, invertible=True)


def min_reducer(finalize=None) -> Reducer:
    return Reducer("min", finalize)


def max_reducer(finalize=None) -> Reducer:
    return Reducer("max", finalize)


def mean_reducer(finalize=None) -> Reducer:
    return Reducer("mean", finalize)


def segment_reduce(reducer: Reducer, segment_ids: torch.Tensor, values: Any,
                   valid: torch.Tensor, num_segments: int):
    """Reduce ``values`` into ``num_segments`` groups; returns
    (accumulated tree [K, ...], counts [K] int32).  Invalid rows never
    reach a real group."""
    return ops.segment_reduce(reducer, segment_ids, values, valid,
                              num_segments)


def finalize_reduce(reducer: Reducer, keys: torch.Tensor, acc: Any,
                    counts: torch.Tensor):
    """Apply mean division and the user finalize hook."""
    if reducer.kind == "mean":
        denom = counts.clamp_min(1)
        acc = tree_map(
            lambda a: a / denom.reshape((-1,) + (1,) * (a.ndim - 1)).to(
                a.dtype), acc)
    if reducer.finalize is not None:
        acc = reducer.finalize(keys, acc, counts)
    return acc


# ---------------------------------------------------------------------------
# Compaction and host transfer
# ---------------------------------------------------------------------------

def next_bucket(n: int, minimum: int = 256) -> int:
    """Round up to the next power-of-two capacity bucket.

    Buckets fix shapes, and so results: the same ladder as the reference.
    """
    n = max(int(n), 1)
    b = minimum
    while b < n:
        b *= 2
    return b


def compact_edges(edges: Edges, capacity: int) -> Edges:
    """Gather valid edges to the front of a ``capacity``-sized buffer."""
    order = torch.sort((~edges.valid).to(torch.uint8), stable=True).indices
    n = order.shape[0]
    if capacity > n:
        order = torch.cat([order, order.new_zeros(capacity - n)])
    take = order[:capacity]
    g = lambda leaf: leaf[take]
    n_valid = edges.valid.to(torch.int32).sum()
    new_valid = torch.arange(capacity, device=take.device) < n_valid
    ik = torch.tensor(INVALID_KEY, dtype=torch.int32, device=take.device)
    return Edges(
        torch.where(new_valid, g(edges.k2), ik),
        torch.where(new_valid, g(edges.mk), ik),
        tree_map(g, edges.v2),
        new_valid,
        torch.where(new_valid, g(edges.sign),
                    torch.zeros((), dtype=torch.int8, device=take.device)),
    )


def edges_to_host(edges: Edges, *, sorted_valid_first: bool = False) -> dict:
    """Pull valid edges to host numpy (index maintenance lives host-side).

    ``sorted_valid_first=True`` (sorted buffers): slice the valid prefix on
    the device before the copy, so the transfer is O(valid), not
    O(capacity).
    """
    if sorted_valid_first:
        nvalid = int(edges.valid.sum())
        cap = min(edges.capacity, next_bucket(max(nvalid, 1), 64))
        sl = lambda a: a[:cap]
        edges = Edges(sl(edges.k2), sl(edges.mk), tree_map(sl, edges.v2),
                      sl(edges.valid), sl(edges.sign))
    valid = edges.valid.cpu().numpy()
    idx = np.nonzero(valid)[0]
    host = lambda a: a.cpu().numpy()[idx]
    return {
        "k2": host(edges.k2),
        "mk": host(edges.mk),
        "v2": tree_map(host, edges.v2),
        "sign": host(edges.sign),
    }
