"""The stream coalescer re-derived as a two-branch plan over the algebra.

Counterpart of ``repro.dql.derived``, with torch lambdas; the two group_bys
reach the min/max and segment-sum kernels through ``ops.group_reduce``.

``stream/coalesce.py`` keeps, per record id, the first row iff it is a
'-' and the last row iff it is a '+'.  That first-'-'/last-'+' rule is a
pair of grouped monoid reductions plus an equi-join — i.e. expressible in
:mod:`repro.dql` with no bespoke kernel code:

  * a **min**-aggregated ``group_by(rid)`` over four arrival-index lanes::

        a_first      = arr                       -> min = first arrival
        first_neg    = arr  if sign<0 else BIG   -> min = first '-' arrival
        a_last_neg   = -arr                      -> min = -(last arrival)
        last_pos_neg = -arr if sign>0 else BIG   -> min = -(last '+' arrival)

    The first row of record r is a '-' iff ``min(first_neg) ==
    min(a_first)`` (the earliest '-' *is* the earliest row); symmetrically
    the last row is a '+' iff ``min(last_pos_neg) == min(a_last_neg)``.

  * a **sum**-aggregated ``group_by(rid)`` of the signs — the net row
    balance (+1 insert / -1 delete / 0 update), which is exactly the
    ``n_inserts``/``n_deletes`` telemetry.

  * an equi-``join`` of the two branches on rid, giving one relation row
    per touched record carrying both the keep flags and the net balance.

:func:`coalesce_rows_dql` evaluates that plan (storelessly, via
:func:`repro_torch.dql.query.evaluate` -> ``ops.group_reduce``) and
decodes a :class:`~repro_torch.stream.coalesce.CoalesceResult` that is
*bit-for-bit* what ``coalesce_rows`` produces on the same batch (asserted
in ``tests/test_torch_dql.py``).  One honest divergence: the algebra's
group_by is dense, so this version needs a record-id space bound
(``num_records``); the production kernel sorts arbitrary int32 ids.  The
production path stays — this module exists to prove subsumption.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.core.kvstore import make_kv
from repro_torch.dql.algebra import Q, scan
from repro_torch.dql.query import evaluate
from repro_torch.stream.coalesce import CoalesceResult, make_delta

_BIG = 2 ** 30                 # > any in-batch arrival index


def coalesce_plan(num_records: int) -> Q:
    """The first-'-'/last-'+' rule as a plan: two group_bys joined on rid."""
    rows = scan("rows")
    ends = (rows
            .map(lambda v: {
                "rid": v["rid"],
                "a_first": v["arr"],
                "first_neg": torch.where(v["sign"] < 0, v["arr"], _BIG),
                "a_last_neg": -v["arr"],
                "last_pos_neg": torch.where(v["sign"] > 0, -v["arr"],
                                            _BIG),
            })
            .group_by("rid", num_keys=num_records, agg="min",
                      value={n: n for n in ("a_first", "first_neg",
                                            "a_last_neg", "last_pos_neg")},
                      name="ends"))
    nets = rows.group_by(
        "rid", num_keys=num_records, agg="sum",
        value={"net": lambda v: v["sign"].to(torch.int32)},
        name="nets")
    return ends.join(nets, name="coalesce")


def coalesce_rows_dql(record_ids: np.ndarray, values: Dict[str, np.ndarray],
                      sign: np.ndarray, *,
                      num_records: Optional[int] = None,
                      device="cuda") -> CoalesceResult:
    """Drop-in for :func:`repro_torch.stream.coalesce.coalesce_rows`,
    evaluated through the delta algebra (dense rid space of size
    ``num_records``) on ``device``."""
    record_ids = np.asarray(record_ids, np.int32)
    sign = np.asarray(sign, np.int8)
    n = int(record_ids.shape[0])
    if n == 0:
        return CoalesceResult(None, 0, 0, 0, 0, 0)
    if num_records is None:
        num_records = int(record_ids.max()) + 1

    data = make_kv(np.arange(n, dtype=np.int32),
                   {"rid": record_ids,
                    "arr": np.arange(n, dtype=np.int32),
                    "sign": sign.astype(np.int32)})
    vals, valid = evaluate(coalesce_plan(num_records), {"rows": data},
                           device=device)

    live = np.nonzero(valid)[0]           # touched rids, ascending
    a_first = vals["a_first"][live]
    a_last = -vals["a_last_neg"][live]
    keep_f = vals["first_neg"][live] == a_first
    keep_l = vals["last_pos_neg"][live] == vals["a_last_neg"][live]
    net = vals["net"][live]

    n_records = int(live.size)
    n_inserts = int((net > 0).sum())
    n_deletes = int((net < 0).sum())

    # surviving rows in (rid, arrival) order — the production kernel's
    # perm[keep] order (within a record the kept first precedes the kept
    # last; keeping both implies two distinct rows)
    rid_rep = np.concatenate([live[keep_f], live[keep_l]])
    arr_rep = np.concatenate([a_first[keep_f], a_last[keep_l]])
    order = np.lexsort((arr_rep, rid_rep))
    sel = arr_rep[order].astype(np.int64)
    if sel.size == 0:
        return CoalesceResult(None, n, 0, n_records, n_inserts, n_deletes)
    delta = make_delta(record_ids[sel],
                       {nm: np.asarray(a)[sel] for nm, a in values.items()},
                       sign[sel])
    return CoalesceResult(delta, n, int(sel.size), n_records, n_inserts,
                          n_deletes)
