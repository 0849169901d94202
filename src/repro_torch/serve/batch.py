"""Batched cross-tenant refresh: many tenants' deltas, one kernel launch.

Counterpart of ``repro.serve.batch``.  A fleet of small tenants makes the
per-tenant refresh path dispatch-bound: every micro-batch pays its own
delta Map, shuffle sort and merge even when the delta holds a handful of
rows.  This module stacks compatible tenants' prepared deltas into one
``[T, cap]`` batch and drives the union through a *single* pass of the
existing engine:

1. one delta Map over the flattened ``[T * cap]`` rows.  The reference
   ``vmap``s the Map over the tenant lane; here the Map runs once on the
   flattened rows, which gives the same edges in the same order because
   a Map emits row-major with a fixed fanout (``emit_single`` /
   ``emit_multi``): edge ``i`` belongs to tenant ``i // (E / T)``;
2. a **tenant-id lane** on K2 — each tenant's keys are offset by
   ``tenant * num_keys``, so the per-tenant key spaces become disjoint
   ranges of one global key space and one shuffle sort (the sort kernel)
   serves everyone;
3. one bucketed :func:`~repro_torch.core.incremental._combine_edges` +
   :func:`~repro_torch.core.incremental._merge_reduce` launch (the fused
   merge kernel while the union's affected keys fit its one-block or
   sorted-runs path, the composed path past them; the same power-of-two
   bucket ladder as the solo path);
4. a host-side split of the merged chunks and reduced values back to each
   tenant's MRBG store and result view.

Steady-state cost becomes launches-per-*batch* instead of
launches-per-*tenant*.  Per-tenant outputs are bit-for-bit identical to a
solo refresh: the key ranges are disjoint, the shuffle sort is stable,
and within every (k2, mk) segment the row order (preserved rows before
delta rows, emission order within each) matches what the tenant's own
refresh would have fed the reducer.

Every launch goes to the calling thread's current stream (the serving
tier's sweep thread when it runs one).  A batch is marked ``retraced``
as the stream layer marks one: when ``jitcache.generation()`` moved
since its coalescing began.  The batched Map counts one trace
(``serve._batched_delta_map``) the first time it meets a (Map, key
count, tenant bucket, row bucket, device) combination, where the
reference's ``jax.jit`` traces.
"""
from __future__ import annotations

import threading
import time
from contextlib import ExitStack
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.incremental import (
    DeltaKV, _combine_edges, _merge_reduce, _v2_dict,
)
from repro_torch.core.kvstore import (
    KV, Edges, edges_to_host, next_bucket, sort_edges,
)
from repro_torch.kernels import jitcache

MAX_GLOBAL_KEY = 2**31 - 1

_seen_lock = threading.Lock()
_seen: set = set()          # static keys the batched Map has met


def batch_signature(ss, prep) -> Optional[tuple]:
    """Group key for tenants whose prepared refreshes can share a launch;
    ``None`` when the tenant must refresh solo.

    Only ``onestep-mrbg`` drivers with an ``update`` decision batch — the
    iterative, accumulator and query paths (and rerun/noop decisions) keep
    the per-tenant path.  Two tenants share a signature when they run the
    same Map *function object*, the same reducer, key count and device,
    and emit identical delta value schemas.  The device takes the place of
    the reference's resolved backend: tenants on different devices never
    share a launch.
    """
    drv = ss.session._driver
    if getattr(drv, "kind", None) != "onestep-mrbg":
        return None
    if prep.decision is None or prep.decision.action != "update":
        return None
    spec = ss.session.spec
    delta = prep.res.delta
    leaves = tuple(sorted(
        (name, str(a.dtype), tuple(a.shape[1:]))
        for name, a in _v2_dict(delta.values).items()))
    return (id(spec.map_fn), spec.reducer, spec.num_keys,
            str(ss.session.device), leaves)


def _batched_delta_map(map_fn, num_keys: int, delta: DeltaKV,
                       n_lanes: int) -> Edges:
    """The delta Map over ``n_lanes`` stacked tenants flattened tenant-major
    (``[n_lanes * cap]`` rows), the tenant-id K2 offset, then ONE shuffle
    sort over the union."""
    key = (id(map_fn), num_keys, n_lanes, delta.capacity,
           str(delta.keys.device))
    with _seen_lock:
        first = key not in _seen
        _seen.add(key)
    if first:
        jitcache.count_trace("serve._batched_delta_map")
    edges = map_fn(KV(delta.keys, delta.values, delta.valid), delta.sign)
    n = edges.k2.shape[0]
    if n % n_lanes:
        raise ValueError(
            f"the Map emitted {n} edges for {n_lanes} tenant lanes; a "
            f"batched Map needs a fixed fanout per record (emit_single / "
            f"emit_multi)")
    lane = torch.arange(n, dtype=torch.int32,
                        device=edges.k2.device) // (n // n_lanes)
    gk2 = torch.where(edges.valid, edges.k2.to(torch.int32)
                      + lane * num_keys, 0)
    return sort_edges(Edges(gk2, edges.mk, edges.v2, edges.valid,
                            edges.sign))


def _stack_tenants(deltas: List[DeltaKV], cap: int, t_pad: int,
                   device) -> DeltaKV:
    """Stack per-tenant deltas (row-padded to ``cap``) into ``t_pad * cap``
    rows, tenant-major, on ``device``; padding rows and padding tenants
    are all-invalid (zeros, as ``pad_delta`` pads)."""
    def lane(get):
        arrs = [get(d).cpu().numpy() for d in deltas]
        out = np.zeros((t_pad, cap) + arrs[0].shape[1:], arrs[0].dtype)
        for t, a in enumerate(arrs):
            out[t, :a.shape[0]] = a
        flat = out.reshape((t_pad * cap,) + arrs[0].shape[1:])
        return torch.from_numpy(flat).to(device)

    return DeltaKV(lane(lambda d: d.keys),
                   lane(lambda d: d.record_ids),
                   {n: lane(lambda d, n=n: d.values[n])
                    for n in deltas[0].values},
                   lane(lambda d: d.valid),
                   lane(lambda d: d.sign))


def execute_group(items: List[Tuple[object, object]],
                  delta_bucket_min: int = 64) -> Dict[str, int]:
    """Run one batched refresh for ``items`` — ``(handle, prep)`` pairs
    sharing a :func:`batch_signature` — and commit every participant.

    On any failure every participant's mirror is rolled back and the
    exception re-raised; no tenant is left half-refreshed.  Each tenant's
    scheduler observes its *share* of the batch wall-clock, so the EWMA
    cost model learns the amortized batched cost.  Returns the launch's
    sizes: tenants, combined rows, affected keys and the key bucket.
    """
    t0 = time.perf_counter()
    with ExitStack() as stack:
        for h, _ in items:
            stack.enter_context(h.ss._lock)
        try:
            sizes = _run(items, delta_bucket_min)
        except BaseException:
            for h, prep in items:
                h.ss.rollback_batch(prep)
            raise
        wall = time.perf_counter() - t0
        share = wall / len(items)
        gen = jitcache.generation()
        for h, prep in items:
            h.ss.session.absorb_refresh(share)
            h.ss.last_split = {"coalesce": prep.coalesce_s,
                               "mirror": prep.mirror_s, "refresh": share}
            h.ss.commit_batch(prep, "update", share, gen != prep.gen0)
    return sizes


def _run(items, delta_bucket_min: int) -> Dict[str, int]:
    session0 = items[0][0].ss.session
    spec = session0.spec
    num_keys = spec.num_keys
    device = session0.device
    reducer = spec.reducer

    t_pad = next_bucket(len(items), 1)
    if t_pad * num_keys > MAX_GLOBAL_KEY:
        raise ValueError(
            f"tenant-id lane overflow: {t_pad} tenants x {num_keys} keys "
            f"exceeds int32; lower ServeTier(max_batch_tenants=...)")
    cap = next_bucket(max(p.res.delta.capacity for _, p in items),
                      delta_bucket_min)
    stacked = _stack_tenants([p.res.delta for _, p in items], cap, t_pad,
                             device)

    # 1-2) one delta Map + one shuffle sort for the whole group
    edges = _batched_delta_map(spec.map_fn, num_keys, stacked, t_pad)
    dh = edges_to_host(edges, sorted_valid_first=True)
    affected_g = np.unique(dh["k2"])        # global (tenant-offset) keys
    for h, _ in items:
        for store in h.ss.session.stores:
            store.reset_stats()
    sizes = {"tenants": len(items), "combined": 0,
             "affected": int(affected_g.size), "key_cap": 0}
    if affected_g.size == 0:
        for h, _ in items:
            h.ss.session._driver._affected = 0
        return sizes

    # 3) per-tenant store queries, re-offset into the global key space;
    # concatenated tenant-major so preserved rows precede delta rows and
    # the stable shuffle sort keeps solo-identical segment order.  Global
    # keys sort tenant-major, so each tenant's keys (and below, its merged
    # rows) are one contiguous slice: where the reference masks the whole
    # union once a tenant, the port cuts it at the lane boundaries
    lanes = np.arange(len(items) + 1, dtype=np.int64) * num_keys
    acut = np.searchsorted(affected_g, lanes)
    dv2 = _v2_dict(dh["v2"])
    pk_parts, pmk_parts = [], []
    pv_parts = {n: [] for n in dv2}
    for t, (h, _) in enumerate(items):
        local = (affected_g[acut[t]:acut[t + 1]]
                 - t * num_keys).astype(affected_g.dtype)
        pk2, pmk, pv2, _plen = h.ss.session.store.query(local)
        if pv2 is None or pk2.shape[0] == 0:
            continue
        pk_parts.append(pk2.astype(np.int64) + t * num_keys)
        pmk_parts.append(pmk)
        for n, a in _v2_dict(pv2).items():
            pv_parts[n].append(a)
    if pk_parts:
        pk2_all = np.concatenate(pk_parts).astype(np.int32)
        pmk_all = np.concatenate(pmk_parts)
        pv2_all = {n: np.concatenate(parts) for n, parts in pv_parts.items()}
    else:
        pk2_all = np.zeros(0, np.int32)
        pmk_all = np.zeros(0, np.int32)
        pv2_all = {n: np.zeros((0,) + a.shape[1:], a.dtype)
                   for n, a in dv2.items()}

    # 4-5) ONE bucketed merge + segment reduce over the union
    key_cap = next_bucket(affected_g.size, 64)
    combined = _combine_edges(pk2_all, pmk_all, pv2_all,
                              dh["k2"], dh["mk"], dv2,
                              np.asarray(dh["sign"], np.int8), device=device)
    sizes.update(combined=int(pk2_all.shape[0] + dh["k2"].shape[0]),
                 key_cap=key_cap)
    keys_pad = np.full(key_cap, np.int32(MAX_GLOBAL_KEY), np.int32)
    keys_pad[:affected_g.size] = affected_g.astype(np.int32)
    merged, values, counts = _merge_reduce(
        reducer, key_cap, combined, torch.from_numpy(keys_pad).to(device))
    del combined

    # 6) split the merged chunks / reduced values back per tenant
    mh = edges_to_host(merged)
    mcut = np.searchsorted(mh["k2"], lanes)
    m_local = (mh["k2"] % num_keys).astype(mh["k2"].dtype)
    mv2 = _v2_dict(mh["v2"])
    counts_h = counts.cpu().numpy()[:affected_g.size]
    vals_h = {n: a.cpu().numpy()[:affected_g.size]
              for n, a in _v2_dict(values).items()}
    for t, (h, _) in enumerate(items):
        drv = h.ss.session._driver
        sel = slice(mcut[t], mcut[t + 1])
        drv.store.append(m_local[sel], mh["mk"][sel],
                         {n: a[sel] for n, a in mv2.items()})
        asl = slice(acut[t], acut[t + 1])
        local = (affected_g[asl] - t * num_keys).astype(affected_g.dtype)
        c_t = counts_h[asl]
        drv.store.mark_deleted(local[c_t == 0])
        drv.view.patch(local, {n: a[asl] for n, a in vals_h.items()}, c_t)
        drv._affected = int(local.size)
        drv._counts = drv.view.counts
        drv.mode = "incremental"
    return sizes
