"""Micro-batch coalescer: cancel opposing +/- rows before the engine runs.

Counterpart of ``repro.stream.coalesce``.  A streaming producer that
updates record r three times in one micro-batch emits six rows ('-' old,
'+' new, three times); the engine only needs two: a tombstone for the value
the preserved MRBGraph was computed from, and an insert of the newest
value.  Per record id the net effect of an in-order signed row sequence is
fully determined by its first and last rows:

  first '-' , last '+'   ->  keep both   (update: tombstone old, insert new)
  first '-' , last '-'   ->  keep first  (net delete)
  first '+' , last '+'   ->  keep last   (net insert)
  first '+' , last '-'   ->  keep none   (created and destroyed in-batch)

The device part runs on ``device``: a stable lexicographic sort by
(record id, arrival index) through :func:`repro_torch.kernels.ops.sort_pairs`
(the sort kernel, ``csrc/sort.cu``) groups each record's rows in arrival
order; the group-boundary flags and segment ids are elementwise passes
(``torch.roll``, ``torch.cumsum``); an int32 segment sum of the signs with
counts through :func:`repro_torch.kernels.ops.segment_reduce` (the
segment-sum kernel, ``csrc/segment_sum.cu``) gives each record's net row
balance.  Only the final variable-length compaction of the surviving rows
runs on the host, as in the reference.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.incremental import DeltaKV, make_delta
from repro_torch.core.kvstore import INVALID_KEY, next_bucket
from repro_torch.kernels import ops

PAD_ID = 2**31 - 1        # record id of the padding rows


class CoalesceResult(NamedTuple):
    delta: Optional[DeltaKV]   # None when every row cancelled out
    n_in: int                  # rows entering the coalescer
    n_out: int                 # rows surviving (== delta rows)
    n_records: int             # distinct record ids touched
    n_inserts: int             # records whose net effect is an insert
    n_deletes: int             # records whose net effect is a delete

    @property
    def n_cancelled(self) -> int:
        return self.n_in - self.n_out


def _coalesce_kernel(rid: torch.Tensor, sign: torch.Tensor,
                     valid: torch.Tensor):
    """Device part on ``cap`` padded rows: sort + group-boundary flags +
    per-record net sign.  Returns (perm, keep, first-of-record, net,
    counts), every one [cap], on the inputs' device."""
    cap = rid.shape[0]
    iota = torch.arange(cap, dtype=torch.int32, device=rid.device)
    rid_m = torch.where(valid, rid, INVALID_KEY)
    srt = ops.sort_pairs(rid_m, iota, payload=(sign, valid), num_keys=2)
    sg, v = srt.payload
    k2 = srt.k2
    first = (iota == 0) | (k2 != torch.roll(k2, 1))
    last = (iota == cap - 1) | (k2 != torch.roll(k2, -1))
    keep = v & ((first & (sg < 0)) | (last & (sg > 0)))
    # net row balance per record: +1 net insert, -1 net delete, 0 update
    seg = torch.cumsum(first.to(torch.int32), 0, dtype=torch.int32) - 1
    net, cnt = ops.segment_reduce("sum", seg, sg.to(torch.int32), v, cap)
    return srt.perm, keep, first & v, net, cnt


def pad_rows(record_ids: np.ndarray, sign: np.ndarray, cap: int,
             device) -> tuple:
    """The kernel's inputs: ``cap`` rows on ``device``, the tail padded
    with invalid rows of record id ``PAD_ID``."""
    n = record_ids.shape[0]
    rid_pad = np.full(cap, np.int32(PAD_ID), np.int32)
    rid_pad[:n] = record_ids
    sg_pad = np.zeros(cap, np.int8)
    sg_pad[:n] = sign
    valid = np.zeros(cap, bool)
    valid[:n] = True
    dev = lambda a: torch.from_numpy(a).to(device)
    return dev(rid_pad), dev(sg_pad), dev(valid)


def coalesce_rows(record_ids: np.ndarray, values: Dict[str, np.ndarray],
                  sign: np.ndarray, *, device="cuda") -> CoalesceResult:
    """Coalesce one micro-batch of signed rows (arrival order) into the
    minimal equivalent :class:`DeltaKV` (host tensors), with the device
    part on ``device``."""
    record_ids = np.asarray(record_ids, np.int32)
    sign = np.asarray(sign, np.int8)
    n = int(record_ids.shape[0])
    if n == 0:
        return CoalesceResult(None, 0, 0, 0, 0, 0)
    cap = next_bucket(n, 64)
    out = _coalesce_kernel(*pad_rows(record_ids, sign, cap, device))
    perm, keep, firsts, net, cnt = (a.cpu().numpy() for a in out)

    # host compaction: surviving rows in (record id, arrival) order
    sel = perm[keep]
    n_records = int(firsts.sum())
    real = cnt > 0                      # segments holding valid rows
    n_inserts = int(((net > 0) & real).sum())
    n_deletes = int(((net < 0) & real).sum())
    if sel.size == 0:
        return CoalesceResult(None, n, 0, n_records, n_inserts, n_deletes)
    delta = make_delta(record_ids[sel],
                       {nm: np.asarray(a)[sel] for nm, a in values.items()},
                       sign[sel])
    return CoalesceResult(delta, n, int(sel.size), n_records, n_inserts,
                          n_deletes)


def concat_records(records: Sequence[Any]):
    """Concatenate DeltaRecords (arrival order) into flat row arrays."""
    rids = np.concatenate([np.asarray(r.record_ids, np.int32)
                           for r in records])
    signs = np.concatenate([np.asarray(r.sign, np.int8) for r in records])
    names = records[0].values.keys()
    values = {n: np.concatenate([np.asarray(r.values[n]) for r in records])
              for n in names}
    return rids, values, signs


def coalesce(records: Sequence[Any], *, device="cuda") -> CoalesceResult:
    """Coalesce a sequence of :class:`repro_torch.stream.DeltaRecord`s."""
    if not records:
        return CoalesceResult(None, 0, 0, 0, 0, 0)
    rids, values, signs = concat_records(records)
    return coalesce_rows(rids, values, signs, device=device)
