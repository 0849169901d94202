"""Fine-grain incremental one-step processing (paper Section 3.3).

Counterpart of ``repro.core.incremental``.  For a delta input against a
preserved job:

  1. incremental Map on the changed records only; edges of '-' records
     become tombstones (sign = -1);
  2. shuffle: sort the delta MRBGraph by (K2, MK);
  3. the affected K2 set is queried against the host-side MRBG-Store;
  4. merge: preserved rows + delta rows, one stable sort; for each
     (K2, MK) the last version wins and tombstones delete (an update
     arrives as '-' then '+');
  5. incremental Reduce of the affected K2 groups only; the dense result
     view is patched;
  6. the merged chunks are appended to the store and the index repointed.

Capacities are power-of-two buckets, as in the reference, so that work
scales with |delta| and results match it bit for bit.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple

import numpy as np
import torch

from repro_torch.core.engine import JobSpec, run_onestep
from repro_torch.core.kvstore import (
    INVALID_KEY, KV, Edges, Reducer, as_tensor, edges_to_host,
    finalize_reduce, next_bucket, sort_edges,
)
from repro_torch.core.mrbg_store import MRBGStore
from repro_torch.kernels import ops
from repro_torch.tree import tree_map


class DeltaKV(NamedTuple):
    """A delta input: kv-pairs marked '+' (insert) or '-' (delete).

    An update is a deletion followed by an insertion of the same record id,
    so the replayed Map instance overwrites its previous edges.
    """

    keys: torch.Tensor       # [N] int32 (K1; semantic only)
    record_ids: torch.Tensor  # [N] int32 Map-instance identity (drives MK)
    values: Any              # tree of [N, ...]
    valid: torch.Tensor      # [N] bool
    sign: torch.Tensor       # [N] int8 (+1 / -1)

    @property
    def capacity(self) -> int:
        return self.keys.shape[0]


def make_delta(record_ids, values, sign, *, keys=None,
               valid=None) -> DeltaKV:
    """Build a :class:`DeltaKV`; ``keys`` defaults to ``record_ids``."""
    record_ids = as_tensor(record_ids, torch.int32)
    keys = record_ids if keys is None else as_tensor(keys, torch.int32)
    if valid is None:
        valid = torch.ones(keys.shape[0], dtype=torch.bool,
                           device=keys.device)
    return DeltaKV(keys, record_ids, tree_map(as_tensor, values),
                   as_tensor(valid, torch.bool), as_tensor(sign, torch.int8))


def pad_delta(delta: DeltaKV, capacity: int) -> DeltaKV:
    """Pad a delta to a bucketed row capacity (padding rows are invalid)."""
    n = delta.capacity
    if capacity < n:
        raise ValueError(f"pad_delta capacity {capacity} < delta rows {n}")
    if capacity == n:
        return delta

    def ext(a):
        pad = torch.zeros((capacity - n,) + tuple(a.shape[1:]),
                          dtype=a.dtype, device=a.device)
        return torch.cat([a, pad])

    return DeltaKV(ext(delta.keys), ext(delta.record_ids),
                   tree_map(ext, delta.values), ext(delta.valid),
                   ext(delta.sign))


def apply_delta_host(keys: np.ndarray, values: Dict[str, np.ndarray],
                     valid: np.ndarray, delta: DeltaKV) -> None:
    """Apply a signed delta to a host-side record mirror, in place: '-'
    rows invalidate a record slot, '+' rows (re)write it."""
    rid = delta.record_ids.cpu().numpy()
    sgn = delta.sign.cpu().numpy()
    dvalid = delta.valid.cpu().numpy()
    dkeys = delta.keys.cpu().numpy()
    dvals = {n: a.cpu().numpy() for n, a in delta.values.items()}
    for i in np.nonzero(dvalid)[0]:
        r = int(rid[i])
        if sgn[i] < 0:
            valid[r] = False
        else:
            valid[r] = True
            keys[r] = int(dkeys[i])
            for n, a in values.items():
                a[r] = dvals[n][i]


def pad_mirror(keys: np.ndarray, values: Dict[str, np.ndarray],
               valid: np.ndarray, capacity: int):
    """A host record mirror extended with invalid rows up to ``capacity``
    (returned as new ``(keys, values, valid)``; never shrinks)."""
    pad = capacity - keys.shape[0]
    if pad <= 0:
        return keys, values, valid
    grow = lambda a: np.concatenate(
        [a, np.zeros((pad,) + a.shape[1:], a.dtype)])
    return grow(keys), {n: grow(a) for n, a in values.items()}, grow(valid)


class ResultView:
    """Host-side dense view of the job's current output <K3,V3> (K3 == K2);
    incremental runs patch only the affected keys."""

    def __init__(self, num_keys: int, values: Dict[str, np.ndarray],
                 valid: np.ndarray, counts: np.ndarray):
        self.num_keys = num_keys
        self.values = values
        self.valid = valid
        self.counts = counts

    @classmethod
    def from_job(cls, num_keys: int, results, counts) -> "ResultView":
        values = {n: a.cpu().numpy().copy()
                  for n, a in results.values.items()}
        return cls(num_keys, values, results.valid.cpu().numpy().copy(),
                   counts.cpu().numpy().copy())

    def patch(self, keys: np.ndarray, values: Dict[str, np.ndarray],
              counts: np.ndarray) -> None:
        keys = np.asarray(keys)
        sel = keys < self.num_keys
        k = keys[sel]
        for name, arr in values.items():
            self.values[name][k] = np.asarray(arr)[sel]
        self.counts[k] = np.asarray(counts)[sel]
        self.valid[k] = self.counts[k] > 0

    def as_dict(self) -> Dict[str, np.ndarray]:
        return {n: np.where(
            self.valid.reshape((-1,) + (1,) * (a.ndim - 1)), a, 0)
            for n, a in self.values.items()}


class IncrementalJob:
    """Owns the preserved MRBGraph + result view of one MapReduce job."""

    def __init__(self, spec: JobSpec, value_bytes: int = 8,
                 policy: str = "multi-dynamic-window"):
        self.spec = spec
        self.store = MRBGStore(spec.num_keys, value_bytes, policy=policy)
        self.view: ResultView = None  # type: ignore

    def initial_run(self, inp: KV) -> ResultView:
        res = run_onestep(self.spec, inp, preserve=True)
        host = edges_to_host(res.edges)
        self.store.append(host["k2"], host["mk"], _v2_dict(host["v2"]))
        self.view = ResultView.from_job(self.spec.num_keys, res.results,
                                        res.counts)
        return self.view

    def incremental_run(self, delta: DeltaKV) -> ResultView:
        assert self.view is not None, "initial_run first"
        incremental_onestep(self.spec, delta, self.store, self.view)
        return self.view


def _v2_dict(v2) -> Dict[str, Any]:
    if isinstance(v2, dict):
        return v2
    return {"v": v2}


# ---------------------------------------------------------------------------
# delta map -> merge -> incremental reduce
# ---------------------------------------------------------------------------

def _delta_map(map_fn, delta: DeltaKV) -> Edges:
    kv = KV(delta.keys, delta.values, delta.valid)
    return sort_edges(map_fn(kv, delta.sign))


def _merge_reduce(reducer: Reducer, key_cap: int, combined: Edges,
                  affected_keys: torch.Tensor):
    """Join preserved chunks with delta edges; reduce affected groups.

    ``combined`` holds preserved rows first, then delta rows, so that the
    stable sort leaves equal-(k2, mk) delta rows after the preserved
    version and last-writer-wins overrides.  (The reference donates it to
    sort in place; here the sort writes fresh buffers and ``combined`` is
    dropped by the caller.)  ``affected_keys`` is sorted ascending, padded
    with INVALID_KEY.  Returns (merged edges [sorted, valid = live],
    values tree [key_cap], counts [key_cap]).
    """
    sr = ops.shuffle_reduce(reducer, combined.k2, combined.mk, combined.v2,
                            combined.valid, combined.sign, affected_keys)
    n = sr.k2.shape[0]
    merged = Edges(sr.k2, sr.mk, sr.values, sr.live,
                   torch.ones(n, dtype=torch.int8, device=sr.k2.device))
    values = finalize_reduce(reducer, affected_keys, sr.acc, sr.counts)
    return merged, values, sr.counts


def incremental_onestep(spec: JobSpec, delta: DeltaKV, store: MRBGStore,
                        view: ResultView) -> Dict[str, Any]:
    """One incremental refresh on the delta's device; patches ``view`` and
    ``store`` in place."""
    device = delta.keys.device
    # 1-2) incremental Map + shuffle of the delta MRBGraph
    delta_edges = _delta_map(spec.map_fn, delta)
    dh = edges_to_host(delta_edges, sorted_valid_first=True)

    # 3) affected keys, queried against the store in sorted order
    affected = np.unique(dh["k2"])
    if affected.size == 0:
        return {"affected": 0, "merged": 0}
    pk2, pmk, pv2, _plen = store.query(affected)
    if pv2 is None:
        pv2 = {n: np.zeros((0,) + a.shape[1:], a.dtype)
               for n, a in _v2_dict(dh["v2"]).items()}

    # 4-5) pad to buckets and merge + reduce on the device
    key_cap = next_bucket(affected.size, 64)
    dsign = np.asarray(dh["sign"], np.int8)
    combined = _combine_edges(pk2, pmk, pv2, dh["k2"], dh["mk"],
                              _v2_dict(dh["v2"]), dsign, device=device)
    keys_pad = np.full(key_cap, np.int32(INVALID_KEY), np.int32)
    keys_pad[:affected.size] = affected.astype(np.int32)
    merged, values, counts = _merge_reduce(
        spec.reducer, key_cap, combined,
        torch.from_numpy(keys_pad).to(device))
    del combined

    # 6) preserve merged chunks + patch results
    mh = edges_to_host(merged)
    store.append(mh["k2"], mh["mk"], _v2_dict(mh["v2"]))
    counts_h = counts.cpu().numpy()[:affected.size]
    gone = affected[counts_h == 0]
    store.mark_deleted(gone)
    vals_h = {n: a.cpu().numpy()[:affected.size]
              for n, a in _v2_dict(values).items()}
    view.patch(affected, vals_h, counts_h)
    return {"affected": int(affected.size), "merged": int(mh["k2"].shape[0]),
            "deleted_keys": int(gone.size)}


def _to_edges(k2, mk, v2, valid, sign, device) -> Edges:
    dev = lambda a: torch.from_numpy(a).to(device)
    return Edges(dev(k2), dev(mk), {n: dev(a) for n, a in v2.items()},
                 dev(valid), dev(sign))


def _pad_edges(k2: np.ndarray, mk: np.ndarray, v2: Dict[str, np.ndarray],
               sign: np.ndarray, cap: int, *, device) -> Edges:
    n = int(k2.shape[0])
    ik = np.int32(INVALID_KEY)
    out_k2 = np.full(cap, ik, np.int32); out_k2[:n] = k2
    out_mk = np.full(cap, ik, np.int32); out_mk[:n] = mk
    out_sign = np.zeros(cap, np.int8); out_sign[:n] = sign
    valid = np.zeros(cap, bool); valid[:n] = True
    out_v2 = {}
    for name, a in v2.items():
        buf = np.zeros((cap,) + a.shape[1:], a.dtype)
        buf[:n] = a
        out_v2[name] = buf
    return _to_edges(out_k2, out_mk, out_v2, valid, out_sign, device)


def _combine_edges(pk2: np.ndarray, pmk: np.ndarray,
                   pv2: Dict[str, np.ndarray],
                   dk2: np.ndarray, dmk: np.ndarray,
                   dv2: Dict[str, np.ndarray], dsign: np.ndarray,
                   minimum: int = 64, *, device) -> Edges:
    """One bucketed buffer on ``device``: preserved rows first, then delta
    rows (one bucket per total edge count)."""
    n_p, n_d = int(pk2.shape[0]), int(dk2.shape[0])
    cap = next_bucket(max(n_p + n_d, 1), minimum)
    ik = np.int32(INVALID_KEY)
    out_k2 = np.full(cap, ik, np.int32)
    out_k2[:n_p] = pk2; out_k2[n_p:n_p + n_d] = dk2
    out_mk = np.full(cap, ik, np.int32)
    out_mk[:n_p] = pmk; out_mk[n_p:n_p + n_d] = dmk
    out_sign = np.zeros(cap, np.int8)
    out_sign[:n_p] = 1; out_sign[n_p:n_p + n_d] = dsign
    valid = np.zeros(cap, bool); valid[:n_p + n_d] = True
    out_v2 = {}
    for name, a in dv2.items():
        buf = np.zeros((cap,) + a.shape[1:], a.dtype)
        buf[:n_p] = pv2[name]; buf[n_p:n_p + n_d] = a
        out_v2[name] = buf
    return _to_edges(out_k2, out_mk, out_v2, valid, out_sign, device)
