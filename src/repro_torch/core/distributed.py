"""Distributed MapReduce shuffle over P shards (§4.3).

Counterpart of ``repro.core.distributed``.  The reference maps the paper's
Hadoop runtime onto a TPU mesh with ``shard_map``; the reference's own mesh
tests run it as P devices in one process.  The port runs the same program
on either of two meshes:

  * :class:`LocalMesh`: **P logical shards in one process, on one
    device**.  Each shard's work is one pass of a Python loop (its own
    launches of the sort, segment-reduce and fused-merge kernels), and the
    all_to_all is a transpose of the stacked send buffers
    (:func:`all_to_all`).
  * :class:`RankMesh`: **one process (rank) a shard**, over an initialised
    ``torch.distributed`` process group.  A rank maps, buckets, sorts,
    reduces and preserves its own shard only, on its own device; the
    exchange is one ``all_to_all_single`` a leaf (NCCL on device tensors,
    or gloo through host memory, as the caller chose), and every decision
    that steers the loop (regrow, converge, CPC, MRBG-off) reads values
    reduced over all ranks, so that every rank takes it the same way.
    The program is SPMD: every rank builds the same session on the same
    host inputs and gets the same full result back (``all_gather``).

Both give the same results, iteration counts and ``ShuffleStats`` at the
same P:

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

import math
import os
import threading
import time
from types import MappingProxyType
from typing import Dict, Iterable, List, Mapping, Optional

import numpy as np
import torch
import torch.distributed as tdist

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

    ``LocalMesh({"data": 8})`` or ``LocalMesh({"pod": 2, "data": 4})``:
    axis name -> size (``.shape``), as a ``jax.sharding.Mesh``'s.  Every
    shard lives on ``RunConfig.device``.  It has :class:`RankMesh`'s
    interface to the engine (``shards``, ``exchange``, ``all_reduce``,
    ``gather_shards``, ``all_gather_object``), each for one process that
    runs every shard, so that the drivers call the mesh alike on both.
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

    def shards(self, axes) -> List[int]:
        """The shards of the flattened ``axes`` this process runs: all."""
        return list(range(math.prod(self._shape[a] for a in axes)))

    def exchange(self, send: torch.Tensor, axes) -> torch.Tensor:
        """Every shard's send buffers ``[P, P, cap, ...]`` to what each
        receives, ``[P, P * cap, ...]``: :func:`all_to_all`."""
        return all_to_all(send)

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """One process holds every shard's share: ``t`` itself."""
        return t

    def gather_shards(self, t: torch.Tensor) -> torch.Tensor:
        """``[P, ...]`` rows of this process's shards: already all P."""
        return t

    def all_gather_object(self, obj) -> list:
        return [obj]


BACKENDS = ("nccl", "gloo")
# leaves whose dtype a backend may not carry (gloo has no bool, bfloat16
# or int16) travel as their bytes, viewed as uint8 along the last axis
_WIRE = (torch.bool, torch.bfloat16, torch.float16)


class RankMesh:
    """A mesh of one process (rank) per shard, over the initialised default
    ``torch.distributed`` process group.

    ``RankMesh({"data": 4}, device="cuda:0", backend="gloo")``: the axes
    and their sizes as :class:`LocalMesh`'s, whose product must equal the
    group's world size (else it raises).  Ranks lie on the axes in row
    order (the last axis fastest), so the engine's shard index pod *
    |data| + data is the rank on a ``{"pod": ..., "data": ...}`` mesh.
    ``device`` is this rank's device and ``backend`` the group's, both
    chosen by the caller: ``"nccl"`` exchanges device tensors and needs a
    card; ``"gloo"`` copies each send buffer to host memory and what it
    receives back to ``device`` (nothing to copy on the CPU).  Neither is
    ever swapped for the other, and a failed collective raises.  Every
    rank must build its meshes, and call their collectives, in the same
    order (a sub-group is made by every rank, the first time any axis set
    asks for it).
    """

    __slots__ = ("_shape", "rank", "world", "device", "backend", "coords",
                 "_groups")

    def __init__(self, shape: Mapping[str, int], *, device, backend: str):
        shape = dict(LocalMesh(shape).shape)
        if backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}, got "
                             f"{backend!r}")
        device = torch.device(device)
        if backend == "nccl":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "RankMesh(backend='nccl') needs a CUDA card, and "
                    "torch.cuda.is_available() is False; use gloo")
            if device.type != "cuda":
                raise ValueError(f"RankMesh(backend='nccl') exchanges "
                                 f"device tensors: device {device} is not "
                                 f"a CUDA device")
        if not (tdist.is_available() and tdist.is_initialized()):
            raise RuntimeError("RankMesh is built over an initialised "
                               "process group: call torch.distributed."
                               "init_process_group first")
        world = tdist.get_world_size()
        size = math.prod(shape.values())
        if size != world:
            raise ValueError(f"RankMesh {shape} has {size} ranks, but the "
                             f"process group's world size is {world}")
        group_backend = str(tdist.get_backend())
        if group_backend != backend:
            raise ValueError(f"RankMesh(backend={backend!r}) over a process "
                             f"group of backend {group_backend!r}")
        if device.type == "cuda":
            torch.cuda.set_device(device)
        rank = tdist.get_rank()
        for name, value in (("_shape", MappingProxyType(shape)),
                            ("rank", rank), ("world", world),
                            ("device", device), ("backend", backend),
                            ("_groups", {})):
            object.__setattr__(self, name, value)
        object.__setattr__(self, "coords",
                           MappingProxyType(self.coords_of(rank)))

    def __setattr__(self, name, value):
        raise AttributeError("RankMesh is immutable")

    @property
    def shape(self) -> Mapping[str, int]:
        return self._shape

    def __repr__(self) -> str:
        return (f"RankMesh({dict(self._shape)!r}, rank={self.rank}, "
                f"device={str(self.device)!r}, backend={self.backend!r})")

    def coords_of(self, rank: int) -> Dict[str, int]:
        """A rank's index on every axis (row order, the last fastest)."""
        coords = {}
        for name in reversed(list(self._shape)):
            coords[name] = rank % self._shape[name]
            rank //= self._shape[name]
        return {n: coords[n] for n in self._shape}

    def index(self, axes, rank: Optional[int] = None) -> int:
        """The flattened index over ``axes`` (the last fastest) of this
        rank, or of ``rank``."""
        coords = self.coords if rank is None else self.coords_of(rank)
        i = 0
        for a in axes:
            i = i * self._shape[a] + coords[a]
        return i

    def _rank_of(self, coords: Mapping[str, int]) -> int:
        r = 0
        for a, size in self._shape.items():
            r = r * size + coords[a]
        return r

    def group(self, axes):
        """The process group of the ranks that share this rank's
        coordinates off ``axes`` (None: the whole world).  Its ranks, in
        torch's order (by global rank), must be in the flattened order of
        ``axes``, so ``axes`` must follow the mesh's own order, or this
        raises.  Every group of the axis set is made on first use, by
        every rank in the same order."""
        axes = tuple(axes)
        if axes not in self._groups:
            if list(axes) != [a for a in self._shape if a in axes]:
                raise ValueError(f"axes {axes} must follow the mesh's order "
                                 f"{tuple(self._shape)}")
            others = [a for a in self._shape if a not in axes]
            sizes = [self._shape[a] for a in axes]
            mine = None
            for off in np.ndindex(*[self._shape[a] for a in others]):
                base = dict(zip(others, off))
                members = [self._rank_of({**base, **dict(zip(axes, on))})
                           for on in np.ndindex(*sizes)]
                g = None if len(members) == self.world \
                    else tdist.new_group(members)
                if self.rank in members:
                    mine = g
            self._groups[axes] = mine
        return self._groups[axes]

    # -- the wire ------------------------------------------------------------
    def _wire(self, t: torch.Tensor) -> torch.Tensor:
        t = t.contiguous()
        if t.dtype in _WIRE:
            t = t.view(torch.uint8)
        return t.cpu() if self.backend == "gloo" else t.to(self.device)

    def _unwire(self, t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        t = t.to(self.device)
        return t.view(dtype) if dtype in _WIRE else t

    def shards(self, axes) -> List[int]:
        """The shards of the flattened ``axes`` this process runs: its
        own."""
        return [self.index(axes)]

    def exchange(self, send: torch.Tensor, axes) -> torch.Tensor:
        """This rank's send buffers ``[1, P, cap, ...]`` to what it
        receives, ``[1, P * cap, ...]``."""
        return self.all_to_all(send[0], axes)[None]

    def gather_shards(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's ``[1, ...]`` rows as every shard's ``[P, ...]``
        (the ranks are the shards, in order)."""
        return self.all_gather(t[0])

    def all_to_all(self, send: torch.Tensor, axes) -> torch.Tensor:
        """Send buffers ``[n, cap, ...]``, one a destination in the
        flattened order of ``axes``, to the received ``[n * cap, ...]``,
        one block a source in the same order (``jax.lax.all_to_all(...,
        tiled=True)`` over ``axes``)."""
        out = self._wire(send)
        recv = torch.empty_like(out)
        tdist.all_to_all_single(recv, out, group=self.group(axes))
        return self._unwire(recv, send.dtype).reshape(
            (-1,) + tuple(send.shape[2:]))

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` from every rank, stacked in rank order: ``[world, ...]``."""
        w = self._wire(t)
        parts = [torch.empty_like(w) for _ in range(self.world)]
        tdist.all_gather(parts, w)
        return self._unwire(torch.stack(parts), t.dtype)

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """``t`` summed (or maxed) over the ranks; a new tensor."""
        if t.dtype in _WIRE:
            raise TypeError(f"all_reduce of {t.dtype}: reduce a wider "
                            f"dtype")
        w = self._wire(t).clone()
        tdist.all_reduce(w, op={"sum": tdist.ReduceOp.SUM,
                                "max": tdist.ReduceOp.MAX}[op])
        return self._unwire(w, t.dtype)

    def all_gather_object(self, obj) -> list:
        """A picklable object from every rank, in rank order."""
        out = [None] * self.world
        tdist.all_gather_object(out, obj)
        return out


def n_parts_of(mesh, axis: str, pod_axis: Optional[str] = None) -> int:
    """Shards of the flattened (pod, data) exchange axis."""
    return mesh.shape[axis] * (mesh.shape[pod_axis] if pod_axis else 1)


def exchange_axes(axis: str, pod_axis: Optional[str] = None) -> tuple:
    return (pod_axis, axis) if pod_axis else (axis,)


def local_shards(mesh, axis: str, pod_axis: Optional[str] = None
                 ) -> List[int]:
    """The shards this process runs: all P on a :class:`LocalMesh`, the
    rank's own on a :class:`RankMesh`."""
    return mesh.shards(exchange_axes(axis, pod_axis))


def local_rows(parts, shards: List[int], n_parts: int):
    """The rows of ``[P, ...]`` arrays or tensors that ``shards`` own
    (everything, uncopied, when they are all P)."""
    if len(shards) == n_parts:
        return parts
    return tree_map(lambda a: a[shards], parts)


def global_sum(mesh, t: torch.Tensor) -> int:
    """``t.sum()`` over every shard: this process's, reduced over the
    ranks on a :class:`RankMesh`."""
    return int(mesh.all_reduce(t.sum().to(torch.int64)))


def global_max(mesh, value: float) -> float:
    return float(mesh.all_reduce(torch.tensor(float(value),
                                              dtype=torch.float64), "max"))


def gather_parts(mesh, parts: Dict[str, torch.Tensor]
                 ) -> Dict[str, torch.Tensor]:
    """Every shard's ``[rows, ...]`` slice as ``[P, rows, ...]`` in shard
    order: this process's ``parts`` on a :class:`LocalMesh`, the ranks'
    ``[1, rows, ...]`` gathered on a :class:`RankMesh` (whose ranks are
    the shards, in shard order: the exchange's group holds the axes in
    the mesh's order)."""
    return {n: mesh.gather_shards(a) for n, a in parts.items()}


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
              cap: Optional[int], mesh=None, axes: tuple = ("data",)):
    """Bucket the edges of this process's shards (``edge_shards``, in
    shard order) and run the one all_to_all (``mesh.exchange`` a leaf): a
    transpose on a :class:`LocalMesh` (the default, of ``n_parts``
    shards), one ``all_to_all_single`` a leaf over ``axes`` on a
    :class:`RankMesh`.  ``cap=None`` takes the shards' edge capacity
    (the delta path, which can then never drop).

    Returns ``(recv, sent [L], drop [L], cap)`` for the L local shards:
    ``recv`` is one Edges of ``[L, P_src * cap]`` leaves.  Send slots that
    no edge fills hold INVALID_KEY keys, ``valid`` False, sign 0 and zero
    values.
    """
    if mesh is None:
        mesh = LocalMesh({axes[0]: n_parts})
    send = None
    sent, drop = [], []
    total = 0
    n_local = len(mesh.shards(axes))
    for s, edges in enumerate(edge_shards):
        if send is None:
            cap = edges.capacity if cap is None else int(cap)
            total = n_local * n_parts * cap
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
        recv.append(mesh.exchange(b[:total].view(
            (n_local, n_parts, cap) + tuple(b.shape[1:])), axes))
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

    Called as ``step(struct_keys [L, cap], struct_vals, struct_valid,
    state_vals [L, rows, ...])`` with the rows of this process's L shards
    (:func:`local_shards`: all P on a LocalMesh, one on a RankMesh);
    returns ``(new_vals [L, rows, ...], counts [L, rows], drop [L], sent
    [L])``, and with ``preserve=True`` also the list of each local shard's
    received edges sorted by (K2, MK) (``P * cap`` rows each): the shard's
    MRBG slice for the iteration.
    """
    n_parts = n_parts_of(mesh, axis, pod_axis)
    rows = (spec.num_state + n_parts - 1) // n_parts
    shards = local_shards(mesh, axis, pod_axis)
    axes = exchange_axes(axis, pod_axis)

    def step(struct_keys, struct_vals, struct_valid, state_vals):
        def shard_edges():
            for i in range(len(shards)):
                kv = KV(struct_keys[i], _shard(struct_vals, i),
                        struct_valid[i])
                dv = _local_state(spec, kv, _shard(state_vals, i), n_parts)
                sign = torch.ones(kv.capacity, dtype=torch.int8,
                                  device=kv.keys.device)
                yield spec.map_fn(kv, dv, sign)

        recv, sent, drop, _cap = _exchange(shard_edges(), n_parts,
                                           shuffle_cap, mesh, axes)
        outs, counts, kept = [], [], []
        for i, p in enumerate(shards):
            # sort by (K2, MK) before reducing: per-key accumulation order
            # then matches the single-device shuffle, and the sorted buffer
            # doubles as the shard's preserved MRBG slice
            r = sort_edges(_shard(recv, i), num_keys=2)
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

    ``struct_parts`` are :func:`partition_struct`'s host arrays of all P
    shards; ``state_parts`` a dict of ``[L, rows, ...]`` tensors, the
    state of this process's shards (:func:`local_shards`).  Every decision
    (regrow, converge) reads counts and changes reduced over all shards,
    so that on a :class:`RankMesh` every rank takes it alike.  The loop runs
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
    n_parts = n_parts_of(mesh, axis, pod_axis)
    skeys, svals, svalid = local_rows(
        struct_parts, local_shards(mesh, axis, pod_axis), n_parts)
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
            nd = global_sum(mesh, drop)
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
        history["sent"] += global_sum(mesh, sent)
        if preserve_last:
            last_pres = outs[4]
        flat = lambda a: a.reshape((-1,) + tuple(a.shape[2:]))
        change = global_max(mesh, float(spec.difference(
            tree_map(flat, new_vals), tree_map(flat, state)).max()))
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

    ``step(dkeys, dvals, dvalid, dsign[, state_vals])`` with ``[L, cap]``
    inputs, the rows of this process's L shards (:func:`local_shards`):
    each shard re-Maps its delta rows (gathering its *local* state
    slice when ``spec`` is iterative) and one all_to_all routes the
    emitted edges to their owners.  The send capacity is the full
    per-shard edge capacity, so the delta path never drops an edge.

    Returns ``(recv, sent [L], drop [L], cap)``: ``recv`` lists each local
    shard's received edges (``[P * cap]`` rows) sorted by (K2, MK), global
    keys, sign kept.
    """
    n_parts = n_parts_of(mesh, axis, pod_axis)
    n_local = len(local_shards(mesh, axis, pod_axis))
    axes = exchange_axes(axis, pod_axis)
    iterative = hasattr(spec, "project")

    def step(dkeys, dvals, dvalid, dsign, state_vals=None):
        def shard_edges():
            for i in range(n_local):
                kv = KV(dkeys[i], _shard(dvals, i), dvalid[i])
                if iterative:
                    dv = _local_state(spec, kv, _shard(state_vals, i),
                                      n_parts)
                    yield spec.map_fn(kv, dv, dsign[i])
                else:
                    yield spec.map_fn(kv, dsign[i])

        recv, sent, drop, cap = _exchange(shard_edges(), n_parts, None,
                                          mesh, axes)
        pres = [sort_edges(_shard(recv, i), num_keys=2)
                for i in range(n_local)]
        return pres, sent, drop, cap

    return _Traced("distributed.delta_exchange", step)


def delta_exchange_to_host(outs, mesh):
    """A delta-exchange step's outputs as per-shard host dicts.

    Returns ``(shards, sent, dropped)``; each local shard's dict holds the
    valid received delta edges (global keys, (K2, MK)-sorted, sign kept),
    and ``sent`` and ``dropped`` count every shard's.  Only each shard's
    valid prefix is copied, never the padding.
    """
    recv, sent, drop, _cap = outs
    return (_shards_to_host(recv, with_sign=True), global_sum(mesh, sent),
            global_sum(mesh, drop))


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
                          *, device, workers: int = 0, shard_ids=None):
    """:func:`merge_shard_delta` for every non-empty shard, on threads.

    ``stores[i]`` and ``shards[i]`` belong to shard ``shard_ids[i]``
    (default ``i``: every shard of a LocalMesh; a RankMesh's rank passes
    its one shard).  Each shard merges against its own store and a
    disjoint global key set, so the merges are independent; their launches
    share the device's current stream.  ``workers=0`` sizes the pool as
    ``min(8, cpus, jobs)``; ``workers=1`` runs them in order on the
    caller's thread.  Returns ``[(p, affected, vals, counts), ...]`` in
    shard order either way, so that callers apply their updates
    deterministically.
    """
    ids = list(range(len(shards))) if shard_ids is None else list(shard_ids)
    jobs = [(i, sh) for i, sh in enumerate(shards) if sh["k2"].size]
    if not jobs:
        return []

    def _one(job):
        i, sh = job
        aff, vals, counts = merge_shard_delta(
            reducer, stores[i], ids[i], n_parts, sh["k2"], sh["mk"],
            sh["v2"], sh["sign"], device=device)
        return ids[i], aff, vals, counts

    if workers == 0:
        workers = min(8, os.cpu_count() or 1, len(jobs))
    if workers <= 1 or len(jobs) == 1:
        return [_one(j) for j in jobs]
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(max_workers=workers) as ex:
        return list(ex.map(_one, jobs))       # map keeps shard order
