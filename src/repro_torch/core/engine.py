"""One-step MapReduce engine on tensors.

Counterpart of ``repro.core.engine``: Map is a user function over the
whole record batch, the shuffle is the lexicographic sort of the
intermediate (K2, MK, V2) edges, and Reduce is a segment reduction over K2
groups.  The engine can preserve the sorted edges — the MRBGraph of
Section 3.2 — which is what enables fine-grain incremental refresh.

The Map function carries a per-record ``sign`` (+1/-1): a full run passes
all +1; the incremental engine passes the delta's insert/delete marks, and
the emit helpers stamp them onto the edges so that edges of deleted
records become tombstones.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch

from repro_torch.core.kvstore import (
    KV, Edges, Reducer, finalize_reduce, segment_reduce, sort_edges,
)
from repro_torch.tree import tree_map

# map_fn(kv, record_sign) -> Edges.  Fanout is fixed; helpers below derive
# globally unique MKs from (record id, slot).
MapFn = Callable[[KV, torch.Tensor], Edges]


@dataclass(frozen=True)
class JobSpec:
    """A one-step MapReduce job over a dense int key space [0, num_keys)."""

    map_fn: MapFn
    reducer: Reducer
    num_keys: int
    name: str = "job"


class JobResult:
    def __init__(self, results: KV, edges: Optional[Edges],
                 counts: torch.Tensor):
        self.results = results      # KV over the dense key space
        self.edges = edges          # preserved MRBGraph (sorted) or None
        self.counts = counts        # [num_keys] in-edge counts per reduce key


def make_mk(record_ids: torch.Tensor, slot: int, fanout: int) -> torch.Tensor:
    """Globally unique Map key derived from record id x slot, stable across
    jobs — required for delta matching."""
    return record_ids.to(torch.int32) * fanout + slot


def run_onestep(spec: JobSpec, inp: KV, *,
                preserve: bool = False) -> JobResult:
    """Run a full (non-incremental) MapReduce job on ``inp``'s device.

    ``preserve=True`` also returns the sorted MRBGraph edges, ready for
    :class:`repro_torch.core.mrbg_store.MRBGStore`.  Engine-internal: user
    code drives jobs through ``repro_torch.api.Session``.
    """
    sign = torch.ones(inp.capacity, dtype=torch.int8, device=inp.keys.device)
    edges = spec.map_fn(inp, sign)
    acc, counts = segment_reduce(spec.reducer, edges.k2, edges.v2,
                                 edges.valid, spec.num_keys)
    keys = torch.arange(spec.num_keys, dtype=torch.int32,
                        device=inp.keys.device)
    values = finalize_reduce(spec.reducer, keys, acc, counts)
    results = KV(keys, values, counts > 0)
    preserved = sort_edges(edges) if preserve else None
    return JobResult(results, preserved, counts)


# ---------------------------------------------------------------------------
# Map helpers: build Edges from per-record emissions
# ---------------------------------------------------------------------------

def emit_single(k2, v2, record_ids, valid, record_sign=None,
                slot: int = 0, fanout: int = 1) -> Edges:
    """Each record emits exactly one intermediate kv-pair."""
    mk = make_mk(record_ids, slot, fanout)
    n = mk.shape[0]
    sign = (torch.ones(n, dtype=torch.int8, device=mk.device)
            if record_sign is None else record_sign.to(torch.int8))
    return Edges(k2.to(torch.int32), mk, v2, valid.to(torch.bool), sign)


def emit_multi(k2_slots, v2_slots, record_ids, valid_slots,
               record_sign=None) -> Edges:
    """Each record emits F intermediate kv-pairs (fixed fanout F).

    Args are [N, F] (+ value trailing dims); the result is flattened [N*F].
    ``mk = rid * F + slot`` stays int32, as in the reference.
    """
    n, f = k2_slots.shape
    dev = k2_slots.device
    rid = record_ids.to(torch.int32).repeat_interleave(f)
    slot = torch.arange(f, dtype=torch.int32, device=dev).repeat(n)
    mk = rid * f + slot
    if record_sign is None:
        sign = torch.ones(n * f, dtype=torch.int8, device=dev)
    else:
        sign = record_sign.to(torch.int8).repeat_interleave(f)
    flat_v2 = tree_map(lambda l: l.reshape((n * f,) + tuple(l.shape[2:])),
                       v2_slots)
    return Edges(k2_slots.reshape(-1).to(torch.int32), mk, flat_v2,
                 valid_slots.reshape(-1).to(torch.bool), sign)
