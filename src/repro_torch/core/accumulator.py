"""Accumulator-Reduce optimization (paper Section 3.5) + invertible fast path.

Counterpart of ``repro.core.accumulator``.  When Reduce is a distributive
accumulation, the engine keeps only the Reduce output and folds f(delta)
into it: f(D u delta) = f(D) (+) f(delta).  For abelian groups (sum),
deletions and updates accumulate the negated contribution of '-' records,
so no MRBGraph is needed at all; ``mean`` keeps (sum, count) partials.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.core.engine import JobSpec
from repro_torch.core.incremental import DeltaKV, ResultView, _pad_edges
from repro_torch.core.kvstore import (
    INVALID_KEY, KV, Edges, Reducer, edges_to_host, finalize_reduce,
    next_bucket, segment_reduce,
)
from repro_torch.tree import tree_map


def _delta_map_acc(map_fn, delta: DeltaKV) -> Edges:
    # no shuffle sort: the accumulator path needs neither chunk grouping
    # nor merge order (its §3.5 saving)
    kv = KV(delta.keys, delta.values, delta.valid)
    return map_fn(kv, delta.sign)


def _accumulate(reducer: Reducer, key_cap: int, edges: Edges,
                affected_keys: torch.Tensor, old_acc: Any,
                old_counts: torch.Tensor):
    """Fold the delta edges' contribution into the old accumulators."""
    if reducer.kind in ("sum", "mean"):
        # signed contribution: deletions subtract (group inverse)
        signf = edges.sign.to(torch.float32)
        v2 = tree_map(
            lambda a: a * signf.reshape((-1,) + (1,) * (a.ndim - 1)).to(
                a.dtype), edges.v2)
    else:
        v2 = edges.v2   # insert-only (checked by caller)

    local = torch.searchsorted(affected_keys, edges.k2).to(torch.int32)
    in_set = affected_keys[local.clamp(0, key_cap - 1).to(torch.int64)] \
        == edges.k2
    ok = edges.valid & in_set
    acc_d, _ = segment_reduce(reducer, local, v2, ok, key_cap)
    # signed count delta: a second sum, of the +-1 signs as int32
    cnt_d, _ = segment_reduce("sum", local, edges.sign.to(torch.int32), ok,
                              key_cap)

    if reducer.kind in ("sum", "mean"):
        acc = {n: o + acc_d[n].to(o.dtype) for n, o in old_acc.items()}
    else:
        pick = torch.minimum if reducer.kind == "min" else torch.maximum
        acc = {n: torch.where(old_counts.reshape((-1,) + (1,) * (o.ndim - 1))
                              > 0, pick(o, acc_d[n]), acc_d[n])
               for n, o in old_acc.items()}
    counts = old_counts + cnt_d
    values = finalize_reduce(reducer, affected_keys, acc, counts)
    return acc, counts, values


class AccumulatorJob:
    """Incremental job that preserves only <K3,V3> (no MRBGraph).

    Keeps raw accumulators host-side (partial sums for mean) so that later
    deltas can be folded in; ``view`` holds finalized values.
    """

    def __init__(self, spec: JobSpec):
        if not (spec.reducer.invertible or spec.reducer.kind in
                ("min", "max", "sum", "mean")):
            raise ValueError("reducer is not accumulative")
        self.spec = spec
        self.raw_acc: Dict[str, np.ndarray] = {}
        self.view: ResultView = None  # type: ignore

    def initial_run(self, inp: KV) -> ResultView:
        spec = self.spec
        dev = inp.keys.device
        edges = _delta_map_acc(
            spec.map_fn,
            DeltaKV(inp.keys, inp.keys, inp.values, inp.valid,
                    torch.ones(inp.capacity, dtype=torch.int8, device=dev)))
        acc, counts = segment_reduce(spec.reducer, edges.k2, edges.v2,
                                     edges.valid, spec.num_keys)
        keys = torch.arange(spec.num_keys, dtype=torch.int32, device=dev)
        values = finalize_reduce(spec.reducer, keys, acc, counts)
        self.raw_acc = {n: a.cpu().numpy().copy() for n, a in acc.items()}
        counts_h = counts.cpu().numpy().copy()
        self.view = ResultView(
            spec.num_keys, {n: a.cpu().numpy().copy()
                            for n, a in values.items()},
            counts_h > 0, counts_h)
        return self.view

    def incremental_run(self, delta: DeltaKV) -> ResultView:
        red = self.spec.reducer
        dev = delta.keys.device
        if red.kind in ("min", "max"):
            sign = delta.sign.cpu().numpy()[delta.valid.cpu().numpy()]
            if bool(np.any(sign < 0)):
                raise ValueError(
                    f"accumulator path for '{red.kind}' requires insert-only "
                    "deltas (paper §3.5); use the MRBGraph engine instead")
        edges = _delta_map_acc(self.spec.map_fn, delta)
        eh = edges_to_host(edges)
        affected = np.unique(eh["k2"])
        if affected.size == 0:
            return self.view
        key_cap = next_bucket(affected.size, 64)
        keys_pad = np.full(key_cap, np.int32(INVALID_KEY), np.int32)
        keys_pad[:affected.size] = affected.astype(np.int32)
        idx = np.minimum(keys_pad, self.spec.num_keys - 1)

        edge_cap = next_bucket(max(int(eh["k2"].shape[0]), 1), 64)
        v2 = eh["v2"] if isinstance(eh["v2"], dict) else {"v": eh["v2"]}
        dev_edges = _pad_edges(eh["k2"], eh["mk"], v2, eh["sign"], edge_cap,
                               device=dev)

        old_acc = {n: torch.from_numpy(a[idx]).to(dev)
                   for n, a in self.raw_acc.items()}
        old_counts = torch.from_numpy(
            self.view.counts[idx].astype(np.int32)).to(dev)
        acc, counts, values = _accumulate(red, key_cap, dev_edges,
                                          torch.from_numpy(keys_pad).to(dev),
                                          old_acc, old_counts)
        sel = slice(0, affected.size)
        for n, a in acc.items():
            self.raw_acc[n][affected] = a.cpu().numpy()[sel]
        self.view.patch(affected,
                        {n: a.cpu().numpy()[sel] for n, a in values.items()},
                        counts.cpu().numpy()[sel])
        return self.view
