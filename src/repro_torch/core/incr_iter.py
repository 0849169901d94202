"""Incremental iterative processing (paper Section 5).

Counterpart of ``repro.core.incr_iter``.  A refresh job A_i starts from job
A_{i-1}'s *converged* state D_{i-1} and the preserved MRBGraph of
A_{i-1}'s final iteration (§5.1):

  * iteration 1's delta input is the **delta structure data**: changed
    records are re-Mapped ('-' rows reproduce the old edges as tombstones:
    Map is pure and the state is still the converged one, so the replay is
    exact), merged against the preserved MRBGraph, and only affected
    Reduce instances re-run;
  * iteration j>=2's delta input is the **delta state data**: the reverse
    dependency index (DK -> structure records, from Project) selects the
    Map instances affected by emitted state changes.

**Change propagation control** (§5.3): per-DK changes accumulate; a DK is
emitted to the next iteration only when its accumulated change exceeds the
filter threshold.  **Auto MRBG-off** (§5.2): when the emitted fraction P_Δ
exceeds ``pdelta_threshold`` the job falls back to plain iterative
recomputation from the current state (iterMR mode) and rebuilds the
MRBGraph in one preserving pass.

In the port's own idiom: the reverse-index lookup is one vectorised CSR
gather, and the state stays on the device, where each incremental
iteration writes only the affected rows (the reference copies the whole
state to the host and back).  The results are the same.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.incremental import (
    DeltaKV, _combine_edges, _merge_reduce, _v2_dict, apply_delta_host,
    pad_mirror,
)
from repro_torch.core.iterative import (
    IterSpec, State, gather_state, run_iterative,
)
from repro_torch.core.kvstore import (
    INVALID_KEY, KV, Edges, edges_to_host, next_bucket, sort_edges,
)
from repro_torch.core.mrbg_store import MRBGStore
from repro_torch.tree import tree_flatten, tree_map


def build_reverse_index(project, struct_keys: np.ndarray,
                        struct_valid: np.ndarray, num_state: int):
    """CSR reverse image of Project: DK -> structure record ids.

    ``project`` is applied to the host mirror's keys as a CPU tensor.
    Returns ``(indptr [num_state+1] int64, record_ids int32, dks_host)``.
    """
    dks = project(torch.from_numpy(np.ascontiguousarray(struct_keys)))
    dks = np.asarray(dks.cpu().numpy())
    dks = np.where(struct_valid, dks, num_state)
    order = np.argsort(dks, kind="stable")
    sorted_dks = dks[order]
    counts = np.bincount(sorted_dks, minlength=num_state + 1)
    indptr = np.concatenate(
        [[0], np.cumsum(counts[:num_state])]).astype(np.int64)
    ids = order[:indptr[-1]].astype(np.int32)
    return indptr, ids, dks.astype(np.int32)


def records_of_dks(indptr: np.ndarray, ids: np.ndarray,
                   dks: np.ndarray) -> np.ndarray:
    """The unique structure records whose Map instances read any of
    ``dks`` (the delta state data's reverse dependency set), sorted.

    One gather over the CSR rows of ``dks``: each row's span is laid out
    back to back by a running offset, then ``np.unique`` sorts and dedups.
    """
    dks = np.asarray(dks, np.int64)
    starts = indptr[dks]
    lens = indptr[dks + 1] - starts
    total = int(lens.sum())
    if total == 0:
        return np.zeros(0, np.int32)
    # position p of the output reads ids[starts[row(p)] + p - first(row(p))]
    first = np.cumsum(lens) - lens
    pos = np.repeat(starts - first, lens) + np.arange(total)
    return np.unique(ids[pos]).astype(np.int32)


@dataclass
class IterationLog:
    iteration: int
    n_input_changes: int        # delta records (it 1) or changed DKs (it>=2)
    n_affected_dks: int         # reduce instances re-run (propagated pairs)
    n_emitted: int              # survived CPC filter
    mrbg_on: bool
    seconds: float
    io_reads: int = 0
    io_bytes: int = 0


class IncrIterJob:
    """Owns structure data, converged state, MRBGraph store, CPC
    accumulators.  Runs on ``device``; the structure mirror, the reverse
    index, the store and the CPC accumulators live on the host."""

    def __init__(self, spec: IterSpec, struct: KV, *, device,
                 value_bytes: int = 8,
                 policy: str = "multi-dynamic-window",
                 cpc_threshold: float = 0.0,
                 pdelta_threshold: float = 0.5,
                 store_kw: Optional[Dict[str, Any]] = None):
        self.spec = spec
        self.device = torch.device(device)
        self.cpc_threshold = cpc_threshold
        self.pdelta_threshold = pdelta_threshold
        self._store_kw = dict(store_kw or {})
        self.store = MRBGStore(spec.num_state, value_bytes, policy=policy,
                               **self._store_kw)
        self.mrbg_on = True

        # host mirror of the structure data (the partitioned structure file)
        host = lambda a: a.cpu().numpy().copy()
        self.struct_values = {n: host(a) for n, a in struct.values.items()}
        self.struct_valid = host(struct.valid)
        self.struct_keys = host(struct.keys)
        self.capacity = struct.capacity
        self._rebuild_reverse_index()

        self.state: Optional[State] = None
        # state values as of each DK's last emission (what the preserved
        # edges were computed from) -- needed to replay '-' for
        # topology-changing Maps
        self.emitted_values: Optional[Dict[str, torch.Tensor]] = None
        self.cpc_accum = np.zeros(spec.num_state, np.float32)
        self.logs: List[IterationLog] = []
        self._last_max_change = np.inf

    # ------------------------------------------------------------------
    def _rebuild_reverse_index(self) -> None:
        """CSR: DK -> structure record ids (Project's reverse image)."""
        self.rev_indptr, self.rev_ids, self.dks_host = build_reverse_index(
            self.spec.project, self.struct_keys, self.struct_valid,
            self.spec.num_state)

    def grow_records(self, capacity: int) -> None:
        """Extend the structure mirror with invalid rows (record ids past
        the seed capacity) and rebuild the reverse dependency index.
        Shrinking is never performed."""
        capacity = int(capacity)
        if capacity <= self.struct_keys.shape[0]:
            return
        self.struct_keys, self.struct_values, self.struct_valid = pad_mirror(
            self.struct_keys, self.struct_values, self.struct_valid, capacity)
        self.capacity = capacity
        self._rebuild_reverse_index()

    def _records_of_dks(self, dks: np.ndarray) -> np.ndarray:
        if self.spec.replicate_state:
            return np.nonzero(self.struct_valid)[0].astype(np.int32)
        return records_of_dks(self.rev_indptr, self.rev_ids, dks)

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        # a copy on every device: the host mirror is later edited in place
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device,
                                                             copy=True)

    def _struct_kv(self) -> KV:
        return KV(self._dev(self.struct_keys),
                  {n: self._dev(a) for n, a in self.struct_values.items()},
                  self._dev(self.struct_valid))

    # ------------------------------------------------------------------
    def initial_converge(self, *, max_iters: int = 100, tol: float = 1e-4):
        """Job A_0: full iterative run; preserve final-iteration MRBGraph."""
        state, hist = run_iterative(self.spec, self._struct_kv(), None,
                                    max_iters=max_iters, tol=tol,
                                    preserve_last=True)
        self.state = state
        self.emitted_values = dict(state.values)
        self._preserve(hist["last_edges"])
        return state, hist

    def _preserve(self, edges: Edges) -> None:
        host = edges_to_host(edges, sorted_valid_first=True)
        self.store.append(host["k2"], host["mk"], _v2_dict(host["v2"]))

    # ------------------------------------------------------------------
    def refresh(self, delta_struct: DeltaKV, *, max_iters: int = 100,
                tol: float = 1e-6, cpc_threshold: Optional[float] = None):
        """Job A_i: incremental refresh after a structure delta."""
        assert self.state is not None, "initial_converge first"
        thresh = self.cpc_threshold if cpc_threshold is None \
            else cpc_threshold
        spec = self.spec
        self.logs = []
        self._last_max_change = np.inf

        # -- apply the delta to the structure mirror ----------------------
        n_input = int(delta_struct.valid.sum())
        apply_delta_host(self.struct_keys, self.struct_values,
                         self.struct_valid, delta_struct)
        self._rebuild_reverse_index()

        if spec.replicate_state or not self.mrbg_on:
            # Kmeans-style: fine-grain state is pointless (P_Δ = 100%);
            # iterate from the previously converged state (iterMR mode).
            return self._fallback_iterate(max_iters, tol)

        # -- iteration 1: delta input = delta structure data --------------
        t0 = time.perf_counter()
        self.store.reset_stats()
        dev = lambda a: a.to(self.device)
        changed = self._incr_iteration(
            kv=KV(dev(delta_struct.keys), tree_map(dev, delta_struct.values),
                  dev(delta_struct.valid)),
            sign=dev(delta_struct.sign),
            sel_dks=spec.project(dev(delta_struct.keys)),
            thresh=thresh, iteration=1, n_input=n_input, t0=t0)
        if changed is None:          # P_Δ blew past the threshold
            return self._fallback_iterate(max_iters, tol)

        # -- iterations >= 2: delta input = delta state data ---------------
        for it in range(2, max_iters + 1):
            if changed.size == 0 or self._last_max_change < tol:
                break
            t0 = time.perf_counter()
            self.store.reset_stats()
            recs = self._records_of_dks(changed)
            if recs.size == 0:
                break
            cap = next_bucket(recs.size, 64)
            sel = np.zeros(cap, np.int32)
            sel[:recs.size] = recs
            ok = np.zeros(cap, bool)
            ok[:recs.size] = True
            kv = KV(self._dev(self.struct_keys[sel]),
                    {n: self._dev(a[sel])
                     for n, a in self.struct_values.items()},
                    self._dev(ok & self.struct_valid[sel]))
            changed = self._incr_iteration(
                kv=kv,
                sign=torch.ones(cap, dtype=torch.int8, device=self.device),
                sel_dks=self._dev(self.dks_host[sel]), thresh=thresh,
                iteration=it, n_input=int(changed.size), t0=t0)
            if changed is None:
                return self._fallback_iterate(max_iters - it, tol)

        return self.state, {"iters": len(self.logs), "logs": self.logs,
                            "mode": "i2"}

    # ------------------------------------------------------------------
    def _incr_iteration(self, kv: KV, sign, sel_dks, thresh,
                        iteration: int, n_input: int, t0: float):
        """One incremental iteration; returns emitted DKs (or None => P_Δ
        exceeded, caller should fall back)."""
        spec = self.spec
        state_vals = self.state.values

        if spec.stable_topology:
            edges = _delta_map_iter(spec, kv, sign, sel_dks, state_vals)
        else:
            # topology may change: tombstone-replay with the last-emitted
            # state, then insert with the current state
            old_edges = _delta_map_iter(spec, kv, -sign.abs(), sel_dks,
                                        self.emitted_values)
            new_edges = _delta_map_iter(spec, kv, sign, sel_dks, state_vals)
            edges = _concat_edges(old_edges, new_edges)

        dh = edges_to_host(edges, sorted_valid_first=True)
        affected = np.unique(dh["k2"])
        if affected.size == 0:
            self.logs.append(IterationLog(iteration, n_input, 0, 0, True,
                                          time.perf_counter() - t0))
            return np.zeros(0, np.int64)

        pk2, pmk, pv2, _ = self.store.query(affected)
        v2_t = _v2_dict(dh["v2"])
        if pv2 is None or pk2.shape[0] == 0:
            pv2 = {n: np.zeros((0,) + a.shape[1:], a.dtype)
                   for n, a in v2_t.items()}
            pk2 = np.zeros(0, np.int32)
            pmk = np.zeros(0, np.int32)

        key_cap = next_bucket(affected.size, 64)
        combined = _combine_edges(pk2, pmk, pv2, dh["k2"], dh["mk"], v2_t,
                                  np.asarray(dh["sign"], np.int8),
                                  device=self.device)
        keys_pad = np.full(key_cap, np.int32(INVALID_KEY), np.int32)
        keys_pad[:affected.size] = affected.astype(np.int32)
        merged, values, counts = _merge_reduce(spec.reducer, key_cap,
                                               combined, self._dev(keys_pad))
        del combined

        # preserve merged chunks
        mh = edges_to_host(merged)
        self.store.append(mh["k2"], mh["mk"], _v2_dict(mh["v2"]))
        counts_h = counts.cpu().numpy()[:affected.size]
        self.store.mark_deleted(affected[counts_h == 0])

        # CPC: accumulate per-DK change; emit above-threshold keys
        n_aff = affected.size
        aff_idx = self._dev(affected.astype(np.int64))
        old_vals = {n: a[aff_idx] for n, a in state_vals.items()}
        new_vals = {n: v[:n_aff] for n, v in values.items()}
        change = spec.difference(new_vals, old_vals).cpu().numpy()
        self._last_max_change = float(change.max()) if change.size else 0.0
        self.cpc_accum[affected] += change
        emit_mask = self.cpc_accum[affected] > thresh
        emitted = affected[emit_mask]
        self.cpc_accum[emitted] = 0.0

        # always record the refreshed values (deferred emission only); the
        # state and the emitted values are written out of place, since the
        # two may share tensors
        self.state = State({n: a.index_copy(0, aff_idx, new_vals[n])
                            for n, a in state_vals.items()},
                           self.state.valid)
        emit_pos = self._dev(np.nonzero(emit_mask)[0])
        emit_idx = aff_idx[emit_pos]
        self.emitted_values = {
            n: a.index_copy(0, emit_idx, new_vals[n][emit_pos])
            for n, a in self.emitted_values.items()}

        st = self.store.stats
        self.logs.append(IterationLog(
            iteration, n_input, int(n_aff), int(emitted.size), True,
            time.perf_counter() - t0, st.n_reads, st.bytes_read))

        # P_Δ detection (§5.2): the *delta state data* |ΔD_i| is what
        # drives the next iteration's recomputation.
        p_delta = emitted.size / max(self.spec.num_state, 1)
        if p_delta > self.pdelta_threshold:
            self.mrbg_on = False
            return None
        return emitted

    # ------------------------------------------------------------------
    def _fallback_iterate(self, max_iters: int, tol: float):
        """iterMR mode from the current state; rebuild MRBGraph at the end."""
        t0 = time.perf_counter()
        state, hist = run_iterative(self.spec, self._struct_kv(),
                                    self.state, max_iters=max_iters,
                                    tol=tol, preserve_last=True)
        self.state = state
        self.emitted_values = dict(state.values)
        self.store = MRBGStore(self.spec.num_state,
                               self.store.record_bytes - 8,
                               policy=self.store.policy, **self._store_kw)
        if hist["last_edges"] is not None:
            self._preserve(hist["last_edges"])
        self.mrbg_on = True
        self.cpc_accum[:] = 0.0
        self.logs.append(IterationLog(-1, 0, self.spec.num_state,
                                      self.spec.num_state, False,
                                      time.perf_counter() - t0))
        return self.state, {"iters": hist["iters"], "logs": self.logs,
                            "mode": "iterMR-fallback"}


# ---------------------------------------------------------------------------

def _delta_map_iter(spec: IterSpec, kv: KV, sign: torch.Tensor,
                    sel_dks: torch.Tensor, state_values) -> Edges:
    """Prime Map over a selected subset of structure records, sorted."""
    dv = state_values if spec.replicate_state \
        else gather_state(state_values, sel_dks)
    return sort_edges(spec.map_fn(kv, dv, sign.to(torch.int8)))


def _concat_edges(a: Edges, b: Edges) -> Edges:
    """Both edge sets in one buffer (``a`` first), sorted."""
    la, unflatten = tree_flatten(a)
    lb, _ = tree_flatten(b)
    return sort_edges(unflatten([torch.cat([x, y]) for x, y in zip(la, lb)]))
