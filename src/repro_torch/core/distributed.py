"""Distributed MapReduce shuffle over P logical shards on one device (§4.3).

Counterpart of ``repro.core.distributed``.  The reference maps the paper's
Hadoop runtime onto a TPU mesh with ``shard_map``; the reference's own mesh
tests run it as P devices in one process.  The port runs the same program as
**P logical shards in one process, on one device**: a :class:`LocalMesh`
names the shard axes, each shard's work is one pass of a Python loop (its
own launches of the sort, segment-reduce and fused-merge kernels), and the
all_to_all is a transpose of the stacked send buffers (:func:`all_to_all`).

  * partitions: one per shard along the ``data`` axis, or the flattened
    (``pod``, ``data``) axes: shard index = pod * |data| + data, the order
    of the reference's flattened all_to_all.  So a (2, 4) mesh lays the
    data out exactly as a flat mesh of 8.
  * dependency-aware partitioning (Eq. 1/2): structure records are placed
    by ``hash(project(SK))`` and state kv-pairs by ``hash(DK)`` with the
    same hash (``DK mod P``), so the prime Map's state gather stays on its
    shard and the prime Reduce's output lands where the next Map reads it.
  * shuffle: each shard buckets its edges by owner (``K2 mod P``) into
    ``[P, cap]`` send buffers; overflow is counted, and the converge loop
    regrows ``cap`` up the bucket ladder (never drops silently).
  * reduce: received edges are sorted by (K2, MK), so that ties keep their
    order of source shard, then rank, and reduced over the shard's dense
    local key range (local key = K2 // P).

Fine-grain refresh splits an epoch in two, as the reference does: the
*delta exchange* (:func:`make_delta_exchange_step`: re-Map the delta rows
against the local state slice, route the edges to their owners with the
full per-shard edge capacity, so nothing can drop) and the *per-shard
merge* (:func:`merge_shard_delta`) against each shard's host-side
MRBG-Store slice with the single-device path's ``_combine_edges`` /
``_merge_reduce``, which is what makes the meshed result equal the
single-device one.

Trace accounting follows ``jax.jit``: a step counts one
``jitcache`` trace (``distributed.step`` / ``distributed.delta_exchange``)
the first time it meets an input signature (P, capacity bucket, shapes,
device).  Engine-internal: user code drives this through
``repro_torch.api.Session`` with ``RunConfig(mesh=MeshConfig(...))``.
"""
from __future__ import annotations

import os
import threading
import time
from types import MappingProxyType
from typing import Dict, Iterable, List, Mapping, Optional

import numpy as np
import torch

from repro_torch.core.incremental import _combine_edges, _merge_reduce, _v2_dict
from repro_torch.core.iterative import IterSpec, gather_state
from repro_torch.core.kvstore import (
    INVALID_KEY, KV, Edges, Reducer, edges_to_host, finalize_reduce,
    next_bucket, segment_reduce, sort_edges,
)
from repro_torch.core.mrbg_store import MRBGStore
from repro_torch.kernels import jitcache, ops
from repro_torch.tree import tree_flatten, tree_map

_IK = np.int32(INVALID_KEY)


class LocalMesh:
    """A mesh of logical shards in one process, on one device.

    ``MeshConfig`` reads only ``.shape`` (axis name -> size), as it reads a
    ``jax.sharding.Mesh``'s: ``LocalMesh({"data": 8})`` or
    ``LocalMesh({"pod": 2, "data": 4})``.  Every shard lives on
    ``RunConfig.device``.
    """

    __slots__ = ("_shape",)

    def __init__(self, shape: Mapping[str, int]):
        shape = dict(shape)
        if not shape:
            raise ValueError("LocalMesh needs at least one axis")
        for name, size in shape.items():
            if not isinstance(name, str) or int(size) != size or size < 1:
                raise ValueError(f"LocalMesh axis {name!r} must be a name "
                                 f"with a size >= 1, got {size!r}")
        object.__setattr__(self, "_shape",
                           MappingProxyType({n: int(s)
                                             for n, s in shape.items()}))

    def __setattr__(self, name, value):
        raise AttributeError("LocalMesh is immutable")

    @property
    def shape(self) -> Mapping[str, int]:
        return self._shape

    def __repr__(self) -> str:
        return f"LocalMesh({dict(self._shape)!r})"


def n_parts_of(mesh, axis: str, pod_axis: Optional[str] = None) -> int:
    """Shards of the flattened (pod, data) exchange axis."""
    return mesh.shape[axis] * (mesh.shape[pod_axis] if pod_axis else 1)


# ---------------------------------------------------------------------------
# Partitioning (host side, Eq. 1/2)
# ---------------------------------------------------------------------------

def partition_of(keys: torch.Tensor, n: int) -> torch.Tensor:
    """Equation (1)/(2): the shared partition hash (keys as uint32, mod n)."""
    return ((keys.to(torch.int64) & 0xFFFFFFFF) % n).to(torch.int32)


def _pid_host(keys: np.ndarray, n: int) -> np.ndarray:
    return (np.asarray(keys).astype(np.uint32) % np.uint32(n)).astype(np.int32)


def _project_host(project, keys: np.ndarray) -> np.ndarray:
    """``project`` on a CPU tensor of the host keys."""
    return project(torch.from_numpy(np.ascontiguousarray(keys))).numpy()


def _host(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _place(pid: np.ndarray, valid: np.ndarray, n_parts: int, cap: int,
           what: str):
    """Rows to scatter: the valid rows of each partition, in input order,
    at the front of their partition.  Returns (rows, partition, rank)."""
    rows = np.nonzero(valid)[0]
    part = pid[rows]
    order = np.argsort(part, kind="stable")
    rows, part = rows[order], part[order]
    load = np.bincount(part, minlength=n_parts)
    if load.size and load.max() > cap:
        p = int(load.argmax())
        raise ValueError(f"{what} {p} overflow ({int(load[p])} > {cap})")
    rank = np.arange(rows.size) - (np.cumsum(load) - load)[part]
    return rows, part, rank


def partition_struct(spec: IterSpec, struct_keys: np.ndarray,
                     struct_values: Dict[str, np.ndarray],
                     valid: np.ndarray, n_parts: int, cap: int):
    """Host-side pre-partitioning of structure data (Equation 2):
    ``(keys [P, cap], values {name: [P, cap, ...]}, valid [P, cap])``."""
    pid = _pid_host(_project_host(spec.project, struct_keys), n_parts)
    rows, part, rank = _place(pid, np.asarray(valid, bool), n_parts, cap,
                              "partition")
    out_keys = np.full((n_parts, cap), _IK, np.int32)
    out_keys[part, rank] = struct_keys[rows]
    out_vals = {}
    for n, a in struct_values.items():
        buf = np.zeros((n_parts, cap) + a.shape[1:], a.dtype)
        buf[part, rank] = a[rows]
        out_vals[n] = buf
    out_valid = np.zeros((n_parts, cap), bool)
    out_valid[part, rank] = True
    return out_keys, out_vals, out_valid


def partition_state(state_values: Dict[str, torch.Tensor], num_state: int,
                    n_parts: int) -> Dict[str, torch.Tensor]:
    """Equation (1): state kv-pair DK lives on shard DK mod P at local row
    DK // P (dense ``[P, rows, ...]``; rows past ``num_state`` hold
    zeros)."""
    rows = (num_state + n_parts - 1) // n_parts
    out = {}
    for n, a in state_values.items():
        trail = tuple(a.shape[1:])
        buf = a.new_zeros((rows * n_parts,) + trail)
        buf[:num_state] = a[:num_state]
        out[n] = buf.reshape((rows, n_parts) + trail).transpose(
            0, 1).contiguous()
    return out


def unpartition_state(parts: Dict[str, torch.Tensor],
                      num_state: int) -> Dict[str, torch.Tensor]:
    """The inverse of :func:`partition_state`: dense ``[num_state, ...]``."""
    out = {}
    for n, a in parts.items():
        n_parts, rows = a.shape[:2]
        out[n] = a.transpose(0, 1).reshape(
            (rows * n_parts,) + tuple(a.shape[2:]))[:num_state].contiguous()
    return out


# ---------------------------------------------------------------------------
# The exchange: bucket edges by owner shard + one all_to_all
# ---------------------------------------------------------------------------

def all_to_all(send: torch.Tensor) -> torch.Tensor:
    """The exchange: stacked send buffers ``[P_src, P_dst, cap, ...]`` to
    received ones ``[P_dst, P_src * cap, ...]``, source shards in order.

    ``jax.lax.all_to_all(split_axis=0, concat_axis=0, tiled=False)`` over
    the shard axis, with every shard on one device: a transpose.
    """
    p_src, p_dst, cap = send.shape[:3]
    return send.transpose(0, 1).reshape(
        (p_dst, p_src * cap) + tuple(send.shape[3:]))


def _bucket(edges: Edges, n_parts: int, cap: int):
    """Shard-local half of the shuffle: each edge's slot in the flat
    ``[P * cap]`` send buffer (``P * cap`` for an edge that is not sent),
    the count of edges sent, and the count of valid edges beyond ``cap``
    for their owner (``drop``).  Device tensors; nothing syncs."""
    dest = partition_of(edges.k2, n_parts)
    dest = torch.where(edges.valid.to(torch.bool), dest, n_parts)
    # stable sort by owner (the sort kernel), then the rank within each
    # owner; stability keeps equal-(k2, mk) edges in emission order, which
    # last-writer-wins merging downstream depends on
    res = ops.sort_pairs(dest, None, num_keys=1)
    sdest = res.k2
    n = sdest.shape[0]
    rank = torch.arange(n, device=sdest.device) - torch.searchsorted(
        sdest, sdest, side="left")
    real = sdest < n_parts
    ok = real & (rank < cap)
    drop = (real & (rank >= cap)).sum()
    sent = ok.sum()
    slot_sorted = torch.where(ok, sdest.to(torch.int64) * cap + rank,
                              n_parts * cap)
    slot = torch.empty_like(slot_sorted)
    slot[res.perm.to(torch.int64)] = slot_sorted
    return slot, sent, drop


def _exchange(edge_shards: Iterable[Edges], n_parts: int,
              cap: Optional[int]):
    """Bucket every shard's edges (``edge_shards`` in shard order) and run
    the one all_to_all.  ``cap=None`` takes the shards' edge capacity
    (the delta path, which can then never drop).

    Returns ``(recv, sent [P], drop [P], cap)``: ``recv`` is one Edges of
    ``[P_dst, P_src * cap]`` leaves.  Send slots that no edge fills hold
    INVALID_KEY keys, ``valid`` False, sign 0 and zero values.
    """
    send = None
    sent, drop = [], []
    total = 0
    for s, edges in enumerate(edge_shards):
        if send is None:
            cap = edges.capacity if cap is None else int(cap)
            total = n_parts * n_parts * cap
            dev = edges.k2.device
            # one scratch slot at the end takes the edges that are not sent
            full = lambda dtype, fill, trail=(): torch.full(
                (total + 1,) + trail, fill, dtype=dtype, device=dev)
            send = Edges(
                full(torch.int32, INVALID_KEY), full(torch.int32, INVALID_KEY),
                tree_map(lambda a: full(a.dtype, 0, tuple(a.shape[1:])),
                         edges.v2),
                full(torch.bool, False), full(torch.int8, 0))
        slot, n_sent, n_drop = _bucket(edges, n_parts, cap)
        base = s * n_parts * cap
        idx = torch.where(slot < n_parts * cap, slot + base, total)
        src, _ = tree_flatten(Edges(edges.k2.to(torch.int32),
                                    edges.mk.to(torch.int32), edges.v2,
                                    torch.ones_like(edges.valid,
                                                    dtype=torch.bool),
                                    edges.sign.to(torch.int8)))
        for buf, leaf in zip(tree_flatten(send)[0], src):
            buf[idx] = leaf.to(buf.dtype)
        sent.append(n_sent)
        drop.append(n_drop)
    del edges, src, slot, idx
    leaves, unflatten = tree_flatten(send)
    del send
    recv = []
    while leaves:                  # each send buffer goes once it is moved
        b = leaves.pop(0)
        recv.append(all_to_all(b[:total].view(
            (n_parts, n_parts, cap) + tuple(b.shape[1:]))))
        del b
    return unflatten(recv), torch.stack(sent), torch.stack(drop), cap


def _shard(tree, p: int):
    return tree_map(lambda a: a[p], tree)


class _Traced:
    """A step that counts a ``jitcache`` trace the first time it meets an
    input signature (shapes, dtypes, device), where ``jax.jit`` traces."""

    def __init__(self, name: str, fn):
        self.name = name
        self.fn = fn
        self._seen: set = set()
        self._lock = threading.Lock()

    def __call__(self, *args):
        leaves, _ = tree_flatten(args)
        sig = tuple((tuple(a.shape), a.dtype, str(a.device))
                    for a in leaves)
        with self._lock:
            first = sig not in self._seen
            self._seen.add(sig)
        if first:
            jitcache.count_trace(self.name)
        return self.fn(*args)


# ---------------------------------------------------------------------------
# The distributed iteration (one prime Map -> shuffle -> prime Reduce)
# ---------------------------------------------------------------------------

def _local_state(spec: IterSpec, kv: KV, state_local, n_parts: int):
    """The prime Map's state, gathered from the shard's own slice (rows of
    padding read row 0; their edges are invalid)."""
    if spec.replicate_state:
        return state_local
    dks = spec.project(kv.keys).to(torch.int64)
    local = torch.where(kv.valid.to(torch.bool), dks // n_parts, 0)
    return gather_state(state_local, local)


def make_distributed_step(spec: IterSpec, mesh, axis: str, shuffle_cap: int,
                          *, pod_axis: Optional[str] = None,
                          preserve: bool = False):
    """The iteration over the P shards of ``axis`` (+ optional pod axis).

    Called as ``step(struct_keys [P, cap], struct_vals, struct_valid,
    state_vals [P, rows, ...])``; returns ``(new_vals [P, rows, ...],
    counts [P, rows], drop [P], sent [P])``, and with ``preserve=True``
    also the list of each shard's received edges sorted by (K2, MK)
    (``P * cap`` rows each): the shard's MRBG slice for the iteration.
    """
    n_parts = n_parts_of(mesh, axis, pod_axis)
    rows = (spec.num_state + n_parts - 1) // n_parts

    def step(struct_keys, struct_vals, struct_valid, state_vals):
        def shard_edges():
            for p in range(n_parts):
                kv = KV(struct_keys[p], _shard(struct_vals, p),
                        struct_valid[p])
                dv = _local_state(spec, kv, _shard(state_vals, p), n_parts)
                sign = torch.ones(kv.capacity, dtype=torch.int8,
                                  device=kv.keys.device)
                yield spec.map_fn(kv, dv, sign)

        recv, sent, drop, _cap = _exchange(shard_edges(), n_parts,
                                           shuffle_cap)
        outs, counts, kept = [], [], []
        for p in range(n_parts):
            # sort by (K2, MK) before reducing: per-key accumulation order
            # then matches the single-device shuffle, and the sorted buffer
            # doubles as the shard's preserved MRBG slice
            r = sort_edges(_shard(recv, p), num_keys=2)
            local = torch.div(r.k2, n_parts, rounding_mode="floor")
            acc, cnt = segment_reduce(spec.reducer, local, r.v2, r.valid,
                                      rows)
            keys = torch.arange(rows, dtype=torch.int32,
                                device=r.k2.device) * n_parts + p
            outs.append(finalize_reduce(spec.reducer, keys, acc, cnt))
            counts.append(cnt)
            if preserve:
                kept.append(r)
        del recv
        # zero backward transfer: each shard's output stays in its row
        per = [tree_flatten(o)[0] for o in outs]
        _, unflatten = tree_flatten(outs[0])
        new_vals = unflatten([torch.stack([q[i] for q in per])
                              for i in range(len(per[0]))])
        res = (new_vals, torch.stack(counts), drop, sent)
        return res + (kept,) if preserve else res

    return _Traced("distributed.step", step)


def _edge_capacity(spec: IterSpec, skeys, svals, state, rows: int) -> int:
    """Static per-shard edge capacity of the prime Map: the Map runs on
    ``meta`` tensors of one shard's shapes (no data, no device work).
    This bounds how far the shuffle capacity can usefully regrow."""
    cap = skeys.shape[1]
    meta = lambda a, lead: torch.empty((lead,) + tuple(a.shape[2:]),
                                       dtype=_torch_dtype(a), device="meta")
    kv = KV(torch.empty(cap, dtype=torch.int32, device="meta"),
            tree_map(lambda a: meta(a, cap), svals),
            torch.empty(cap, dtype=torch.bool, device="meta"))
    lead = rows if spec.replicate_state else cap
    dv = tree_map(lambda a: meta(a, lead), state)
    sign = torch.empty(cap, dtype=torch.int8, device="meta")
    return int(spec.map_fn(kv, dv, sign).k2.shape[0])


def _torch_dtype(a) -> torch.dtype:
    if isinstance(a, torch.Tensor):
        return a.dtype
    return torch.from_numpy(np.zeros(0, np.asarray(a).dtype)).dtype


def _valid_prefix_to_host(edges: Edges, n_valid: int, with_sign: bool):
    """The first ``n_valid`` rows of a sorted shard (its valid edges: the
    sort puts them first) as host numpy; nothing past them is copied."""
    sl = lambda a: a[:n_valid].cpu().numpy()
    out = {"k2": sl(edges.k2), "mk": sl(edges.mk),
           "v2": tree_map(sl, edges.v2)}
    if with_sign:
        out["sign"] = sl(edges.sign)
    return out


def _shards_to_host(shards: List[Edges], with_sign: bool) -> List[dict]:
    """Per-shard sorted edges as host dicts of each shard's valid prefix
    (one sync for the P counts)."""
    n_valid = torch.stack([e.valid.sum() for e in shards]).tolist()
    return [_valid_prefix_to_host(e, int(n), with_sign)
            for e, n in zip(shards, n_valid)]


def run_distributed(spec: IterSpec, mesh, struct_parts, state_parts, *,
                    axis: str = "data", pod_axis: Optional[str] = None,
                    shuffle_cap: int = 4096, max_iters: int = 50,
                    tol: float = 1e-6, device=None, auto_grow: bool = True,
                    preserve_last: bool = False,
                    step_cache: Optional[dict] = None):
    """Drive the distributed prime loop to convergence.

    ``struct_parts`` are :func:`partition_struct`'s host arrays;
    ``state_parts`` a dict of ``[P, rows, ...]`` tensors.  The loop runs
    on ``device`` (default: the state's) and returns the new state as
    tensors there.

    Overflowing the per-(src, dst) shuffle capacity regrows it up the
    power-of-two ladder and redoes the iteration (``auto_grow=True``),
    bounded by the per-shard edge capacity; with ``auto_grow=False`` (or
    at the bound) it raises.  ``state_parts`` is never mutated, and a
    failed iteration's output is discarded.

    ``preserve_last=True`` keeps the final iteration's per-shard received
    edges in ``history["last_edges"]`` (one host dict per shard, sorted by
    (K2, MK)): ``reduce(last_edges[p]) == state[p]``, which seeds the
    per-shard MRBG-Stores of fine-grain refresh.  ``step_cache`` (a
    caller-owned dict) keeps steps, and their trace counts, across calls.
    """
    skeys, svals, svalid = struct_parts
    first = next(iter(state_parts.values()))
    device = first.device if device is None else torch.device(device)
    to_dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    state = {n: a.to(device) for n, a in state_parts.items()}
    rows = first.shape[1]
    cap_ceiling = next_bucket(
        _edge_capacity(spec, skeys, svals, state, rows), 1)
    cap = int(shuffle_cap)
    cache = step_cache if step_cache is not None else {}

    def get_step(c):
        key = ("step", c, bool(preserve_last), axis, pod_axis)
        if key not in cache:
            cache[key] = make_distributed_step(
                spec, mesh, axis, c, pod_axis=pod_axis,
                preserve=preserve_last)
        return cache[key]

    history = {"iters": 0, "max_change": [], "dropped": 0, "sent": 0,
               "exchange_seconds": [], "shuffle_cap": cap, "regrows": 0,
               "last_edges": None}
    dkeys, dvals, dvalid = to_dev(skeys), tree_map(to_dev, svals), \
        to_dev(svalid)
    last_pres = None
    for it in range(max_iters):
        while True:
            t0 = time.perf_counter()
            outs = get_step(cap)(dkeys, dvals, dvalid, state)
            new_vals, _counts, drop, sent = outs[:4]
            nd = int(drop.sum())
            if nd == 0:
                history["exchange_seconds"].append(
                    time.perf_counter() - t0)
                break
            history["dropped"] += nd
            if not auto_grow or cap >= cap_ceiling:
                raise RuntimeError(
                    f"shuffle capacity overflow: {nd} edges dropped; raise "
                    f"shuffle_cap")
            cap = min(next_bucket(cap + 1, 1), cap_ceiling)
            history["regrows"] += 1
            history["shuffle_cap"] = cap
        history["sent"] += int(sent.sum())
        if preserve_last:
            last_pres = outs[4]
        flat = lambda a: a.reshape((-1,) + tuple(a.shape[2:]))
        change = float(spec.difference(tree_map(flat, new_vals),
                                       tree_map(flat, state)).max())
        state = new_vals
        history["iters"] = it + 1
        history["max_change"].append(change)
        if change < tol:
            break
    if last_pres is not None:
        history["last_edges"] = _shards_to_host(last_pres, with_sign=False)
    return state, history


# ---------------------------------------------------------------------------
# Fine-grain refresh, phase 1: the delta exchange
# ---------------------------------------------------------------------------

def partition_delta(delta, n_parts: int, cap: int, project=None):
    """Host-side partitioning of delta rows by ``hash(project(SK))``
    (Eq. 2; ``project=None``, the one-step flavour, partitions by the
    record key itself).

    Submission order is kept within each shard, so an update's '-' row
    stays ahead of its '+' row (both land on one shard: updates keep
    ``project(SK)``).  Returns host ``(keys, values, valid, sign)``, each
    ``[n_parts, cap, ...]``.
    """
    keys = _host(delta.keys)
    valid = _host(delta.valid).astype(bool)
    sign = _host(delta.sign)
    dks = keys if project is None else _project_host(project, keys)
    rows, part, rank = _place(_pid_host(dks, n_parts), valid, n_parts, cap,
                              "delta partition")
    out_keys = np.full((n_parts, cap), _IK, np.int32)
    out_keys[part, rank] = keys[rows]
    out_valid = np.zeros((n_parts, cap), bool)
    out_valid[part, rank] = True
    out_sign = np.zeros((n_parts, cap), np.int8)
    out_sign[part, rank] = sign[rows]

    def place(a):
        a = _host(a)
        buf = np.zeros((n_parts, cap) + a.shape[1:], a.dtype)
        buf[part, rank] = a[rows]
        return buf

    return out_keys, tree_map(place, delta.values), out_valid, out_sign


def make_delta_exchange_step(spec, mesh, axis: str, *,
                             pod_axis: Optional[str] = None):
    """Phase 1 of fine-grain distributed refresh, as a step.

    ``step(dkeys, dvals, dvalid, dsign[, state_vals])`` with ``[P, cap]``
    inputs: each shard re-Maps its delta rows (gathering its *local* state
    slice when ``spec`` is iterative) and one all_to_all routes the
    emitted edges to their owners.  The send capacity is the full
    per-shard edge capacity, so the delta path never drops an edge.

    Returns ``(recv, sent [P], drop [P], cap)``: ``recv`` lists each
    shard's received edges (``[P * cap]`` rows) sorted by (K2, MK), global
    keys, sign kept.
    """
    n_parts = n_parts_of(mesh, axis, pod_axis)
    iterative = hasattr(spec, "project")

    def step(dkeys, dvals, dvalid, dsign, state_vals=None):
        def shard_edges():
            for p in range(n_parts):
                kv = KV(dkeys[p], _shard(dvals, p), dvalid[p])
                if iterative:
                    dv = _local_state(spec, kv, _shard(state_vals, p),
                                      n_parts)
                    yield spec.map_fn(kv, dv, dsign[p])
                else:
                    yield spec.map_fn(kv, dsign[p])

        recv, sent, drop, cap = _exchange(shard_edges(), n_parts, None)
        pres = [sort_edges(_shard(recv, p), num_keys=2)
                for p in range(n_parts)]
        return pres, sent, drop, cap

    return _Traced("distributed.delta_exchange", step)


def delta_exchange_to_host(outs):
    """A delta-exchange step's outputs as per-shard host dicts.

    Returns ``(shards, sent, dropped)``; each shard dict holds the valid
    received delta edges (global keys, (K2, MK)-sorted, sign kept).  Only
    each shard's valid prefix is copied, never the padding.
    """
    recv, sent, drop, _cap = outs
    return (_shards_to_host(recv, with_sign=True), int(sent.sum()),
            int(drop.sum()))


# ---------------------------------------------------------------------------
# Fine-grain refresh, phase 2: the per-shard MRBG merge
# ---------------------------------------------------------------------------

def merge_shard_delta(reducer: Reducer, store: MRBGStore, shard: int,
                      n_parts: int, dk2, dmk, dv2, dsign, *, device):
    """Merge one shard's received delta edges into its local MRBG slice.

    ``dk2`` arrives in *global* keys ((K2, MK)-sorted); the store is keyed
    by local ids (K2 // P), while the merge runs in global keys so that
    ``finalize_reduce`` sees true K2s.  Runs the single-device path's
    ``_combine_edges`` / ``_merge_reduce`` on ``device``: preserved rows
    first, stable sort, last writer wins, tombstones delete.

    Returns (affected global keys, values dict, counts), each sized to the
    affected set, for the caller to patch the view and the state slice.
    """
    dk2 = np.asarray(dk2, np.int32)
    affected = np.unique(dk2)
    if affected.size == 0:
        return affected.astype(np.int32), {}, np.zeros(0, np.int32)
    local = ((affected.astype(np.int64) - shard) // n_parts).astype(np.int32)
    dv2 = _v2_dict(dv2)
    pk2l, pmk, pv2, _plen = store.query(local)
    if pv2 is None:
        pv2 = {n: np.zeros((0,) + a.shape[1:], a.dtype)
               for n, a in dv2.items()}
    pk2g = (pk2l.astype(np.int64) * n_parts + shard).astype(np.int32)

    key_cap = next_bucket(affected.size, 64)
    combined = _combine_edges(pk2g, pmk, pv2, dk2, np.asarray(dmk, np.int32),
                              dv2, np.asarray(dsign, np.int8), device=device)
    keys_pad = np.full(key_cap, _IK, np.int32)
    keys_pad[:affected.size] = affected
    merged, values, counts = _merge_reduce(
        reducer, key_cap, combined, torch.from_numpy(keys_pad).to(device))
    del combined

    mh = edges_to_host(merged)
    mlocal = ((mh["k2"].astype(np.int64) - shard) // n_parts).astype(np.int32)
    store.append(mlocal, mh["mk"], _v2_dict(mh["v2"]))
    counts_h = counts[:affected.size].cpu().numpy()
    gone = affected[counts_h == 0]
    store.mark_deleted(
        ((gone.astype(np.int64) - shard) // n_parts).astype(np.int32))
    vals_h = {n: a[:affected.size].cpu().numpy()
              for n, a in _v2_dict(values).items()}
    return affected.astype(np.int32), vals_h, counts_h


def merge_shards_parallel(reducer: Reducer, stores, n_parts: int, shards,
                          *, device, workers: int = 0):
    """:func:`merge_shard_delta` for every non-empty shard, on threads.

    Each shard merges against its own store and a disjoint global key set,
    so the merges are independent; their launches share the device's
    current stream.  ``workers=0`` sizes the pool as ``min(8, cpus,
    jobs)``; ``workers=1`` runs them in order on the caller's thread.
    Returns ``[(p, affected, vals, counts), ...]`` in shard order either
    way, so that callers apply their updates deterministically.
    """
    jobs = [(p, sh) for p, sh in enumerate(shards) if sh["k2"].size]
    if not jobs:
        return []

    def _one(job):
        p, sh = job
        aff, vals, counts = merge_shard_delta(
            reducer, stores[p], p, n_parts, sh["k2"], sh["mk"], sh["v2"],
            sh["sign"], device=device)
        return p, aff, vals, counts

    if workers == 0:
        workers = min(8, os.cpu_count() or 1, len(jobs))
    if workers <= 1 or len(jobs) == 1:
        return [_one(j) for j in jobs]
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(max_workers=workers) as ex:
        return list(ex.map(_one, jobs))       # map keeps shard order
