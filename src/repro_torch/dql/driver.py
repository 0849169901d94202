"""Query runtime: per-stage incremental state on the existing engine.

Counterpart of ``repro.dql.driver``.  A lowered
:class:`~repro_torch.dql.lower.QuerySpec` runs as a DAG of engine jobs.
Each stage owns

  * a ``JobSpec`` (built once: its map_fn / reducer objects stay the same
    across refreshes),
  * its own :class:`~repro_torch.core.mrbg_store.MRBGStore` slice
    preserving the stage's fine-grain MRBGraph edges, and
  * a :class:`RecordingView` — a ``ResultView`` that remembers which keys
    each ``incremental_onestep`` patch touched and what they held before.

Change propagation *is* the delta algebra: after a stage refreshes, the
recorded (key, old value, old valid) triples become the downstream signed
rows — '-' rows carrying the previous relation values (so computed keys
and filters in the consumer's fused chain route the tombstone correctly)
followed by '+' rows with the new values.  A stage whose inputs produced
no rows this batch is skipped outright.

Host <-> device encoding mirrors ``Session.update()``'s bucketed ladder
(``next_bucket``, ``RunConfig.delta_bucket_min``): every synthesized feed
is padded up a geometric capacity ladder, so shapes (and therefore
results) follow the reference's.  The encoding runs on the host; each
stage's run and refresh run on the session's device (the sort, segment
sum or min/max, and fused merge kernels on ``cuda``).

:func:`evaluate` is the storeless one-shot path: the same fused map
functions feed :func:`repro_torch.kernels.ops.group_reduce` directly —
used by ``dql.derived`` (the re-derived coalescer) where preserving state
across batches would be pure overhead.  The reference ``jax.jit``s that
stage (``_eval_stage``); here it is a plain function.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.api.session import _to
from repro_torch.core.engine import JobSpec, run_onestep
from repro_torch.core.incremental import (
    DeltaKV, ResultView, _v2_dict, incremental_onestep, make_delta,
    pad_delta,
)
from repro_torch.core.kvstore import (
    KV, edges_to_host, finalize_reduce, make_kv, next_bucket,
)
from repro_torch.core.mrbg_store import IOStats, MRBGStore
from repro_torch.dql.lower import QuerySpec, StagePlan, apply_chain
from repro_torch.kernels import ops

Schema = Dict[str, Tuple[tuple, str]]      # col -> (row shape, dtype str)


def _np(a) -> np.ndarray:
    """A host array of a tensor (any device) or an array."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _host_chain(chain, vals: Dict[str, np.ndarray], valid: np.ndarray):
    """Run a stateless chain over host relation columns: the lambdas see
    CPU tensors, the caller gets numpy back."""
    tv, tvalid = apply_chain(chain,
                             {n: torch.from_numpy(np.ascontiguousarray(a))
                              for n, a in vals.items()},
                             torch.from_numpy(np.ascontiguousarray(valid)))
    return ({n: _np(a) for n, a in tv.items()}, _np(tvalid).astype(bool))


def _having(plan: StagePlan, vals: Dict[str, np.ndarray]) -> np.ndarray:
    return _np(plan.having(vals)).astype(bool)


# ---------------------------------------------------------------------------
# RecordingView: ResultView that captures pre-patch state for propagation
# ---------------------------------------------------------------------------

class RecordingView(ResultView):
    """Dense stage output that records what each patch overwrote."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self._changes: list = []

    def patch(self, keys, values, counts) -> None:
        keys = np.asarray(keys)
        k = keys[keys < self.num_keys]
        old_vals = {n: a[k].copy() for n, a in self.values.items()}
        old_valid = self.valid[k].copy()
        super().patch(keys, values, counts)
        self._changes.append((k, old_vals, old_valid))

    def take_changes(self):
        """(keys, old values, old valid) since the last take, or None."""
        if not self._changes:
            return None
        ch, self._changes = self._changes, []
        keys = np.concatenate([c[0] for c in ch])
        vals = {n: np.concatenate([c[1][n] for c in ch]) for n in ch[0][1]}
        valid = np.concatenate([c[2] for c in ch])
        return keys, vals, valid


# ---------------------------------------------------------------------------
# Feed encoders (host side; shared by the driver and evaluate())
# ---------------------------------------------------------------------------

def _schema_of(values) -> Schema:
    """Column -> (row shape, numpy dtype name): the reference's layout, so
    that checkpoints carry the same schemas in both packages."""
    out = {}
    for n, a in values.items():
        a = _np(a)
        out[n] = (tuple(a.shape[1:]), str(a.dtype))
    return out


def _zeros_cols(schema: Schema, cap: int) -> Dict[str, np.ndarray]:
    return {n: np.zeros((cap,) + shape, dtype=np.dtype(dt))
            for n, (shape, dt) in schema.items()}


def _rows_of_delta(delta: DeltaKV):
    """Valid rows of a user DeltaKV as host (keys, values, sign)."""
    rows = np.nonzero(_np(delta.valid))[0]
    keys = _np(delta.keys)[rows].astype(np.int32)
    vals = {n: _np(a)[rows] for n, a in delta.values.items()}
    sign = _np(delta.sign)[rows]
    return keys, vals, sign


def _encode_group_rows(rows, bucket_min: int) -> DeltaKV:
    """Signed relation rows -> a bucket-padded DeltaKV for a group stage.

    The relation key doubles as the record id so the preserved edge of a
    key is tombstoned by exactly that key's '-' row (mk == key)."""
    keys, vals, sign = rows
    n = len(keys)
    cap = next_bucket(max(n, 1), bucket_min)
    k = np.zeros(cap, np.int32)
    k[:n] = keys
    valid = np.zeros(cap, np.bool_)
    valid[:n] = True
    sg = np.ones(cap, np.int8)
    sg[:n] = sign
    buf = {}
    for c, a in vals.items():
        a = np.asarray(a)
        buf[c] = np.zeros((cap,) + a.shape[1:], a.dtype)
        buf[c][:n] = a
    return make_delta(k, buf, sg, keys=k, valid=valid)


def _fill_join_rows(sides, schemas: List[Schema], cap: int):
    """Lay out per-side row blocks in the union-schema join encoding:
    key' = key*2 + side, off-side columns zero-filled from the captured
    schema so the column set is identical whichever side feeds."""
    keys = np.zeros(cap, np.int32)
    side_lane = np.zeros(cap, np.int32)
    valid = np.zeros(cap, np.bool_)
    sign = np.ones(cap, np.int8)
    lcols = _zeros_cols(schemas[0], cap)
    rcols = _zeros_cols(schemas[1], cap)
    pos = 0
    for s, (k, vals, sg, vmask) in sides:
        m = len(k)
        sl = slice(pos, pos + m)
        keys[sl] = np.where(vmask, k, 0) * 2 + s
        side_lane[sl] = s
        valid[sl] = vmask
        sign[sl] = sg
        tgt = lcols if s == 0 else rcols
        for c, a in vals.items():
            if c not in tgt:
                raise KeyError(
                    f"join side {s} fed unknown column {c!r}; the side's "
                    f"schema (captured at Query.run) has {sorted(tgt)}")
            tgt[c][sl] = np.asarray(a)
        pos += m
    values = {"_l": lcols, "_r": rcols, "_side": side_lane}
    return keys, values, valid, sign


def _encode_join_kv(sides, schemas) -> KV:
    """Initial (full) input of a join stage: both sides' full row sets."""
    total = sum(len(s[1][0]) for s in sides)
    keys, values, valid, _ = _fill_join_rows(sides, schemas, max(total, 1))
    return make_kv(keys, values, valid)


def _encode_join_feed(feeds, schemas, bucket_min: int) -> DeltaKV:
    """Signed per-side feeds -> one bucket-padded DeltaKV."""
    sides = []
    for s, (k, vals, sg) in feeds:
        sides.append((s, (k, vals, sg, np.ones(len(k), np.bool_))))
    total = sum(len(f[1][0]) for f in feeds)
    cap = next_bucket(max(total, 1), bucket_min)
    keys, values, valid, sign = _fill_join_rows(sides, schemas, cap)
    return make_delta(keys, values, sign, keys=keys, valid=valid)


# ---------------------------------------------------------------------------
# Per-stage runtime
# ---------------------------------------------------------------------------

class _StageRT:
    """One stage's live state: JobSpec + MRBGStore slice + RecordingView."""

    def __init__(self, plan: StagePlan, cfg, device: torch.device):
        self.plan = plan
        self.cfg = cfg
        self.device = device
        # built once: the (map_fn, reducer) objects stay the same
        self.spec = JobSpec(plan.map_fn, plan.reducer, plan.num_keys,
                            plan.name)
        self.store = self._fresh_store()
        self.view: Optional[RecordingView] = None
        self.schemas: List[Optional[Schema]] = [None] * len(plan.inputs)

    def _fresh_store(self) -> MRBGStore:
        return MRBGStore(self.plan.num_keys, self.cfg.value_bytes,
                         policy=self.cfg.store_policy, **self.cfg.store_kw())

    def run_initial(self, kv: KV) -> None:
        self.store = self._fresh_store()
        res = run_onestep(self.spec, _to(kv, self.device), preserve=True)
        host = edges_to_host(res.edges)
        self.store.append(host["k2"], host["mk"], _v2_dict(host["v2"]))
        self.view = RecordingView.from_job(self.plan.num_keys, res.results,
                                           res.counts)

    def update(self, enc: DeltaKV) -> dict:
        self.store.reset_stats()
        return incremental_onestep(self.spec, _to(enc, self.device),
                                   self.store, self.view)

    # -- the stage's *relation* (view masked by having) --------------------
    def visible(self) -> List[str]:
        return [n for n in self.view.values if not n.startswith("_")]

    def rel_valid(self) -> np.ndarray:
        v = self.view.valid
        if self.plan.having is not None:
            v = v & _having(self.plan, self.view.values)
        return v

    def take_rows(self):
        """Signed downstream rows from the patches of the last update.

        For every touched key whose relation row was live before, emit a
        '-' row with the old values; for every key live after, a '+' row
        with the new values.  Consumers see a plain signed-relation delta.
        """
        ch = self.view.take_changes() if self.view is not None else None
        if ch is None:
            return None
        keys, old_vals, old_valid = ch
        old_rv = old_valid
        if self.plan.having is not None:
            old_rv = old_rv & _having(self.plan, old_vals)
        new_vals = {n: self.view.values[n][keys]
                    for n in self.view.values}
        new_rv = self.view.valid[keys]
        if self.plan.having is not None:
            new_rv = new_rv & _having(self.plan, new_vals)
        out_keys = np.concatenate([keys[old_rv], keys[new_rv]])
        if out_keys.size == 0:
            return None
        vis = self.visible()
        out_vals = {n: np.concatenate([old_vals[n][old_rv],
                                       new_vals[n][new_rv]]) for n in vis}
        sign = np.concatenate([
            np.full(int(old_rv.sum()), -1, np.int8),
            np.ones(int(new_rv.sum()), np.int8)])
        return out_keys.astype(np.int32), out_vals, sign


# ---------------------------------------------------------------------------
# The Session driver (kind = "query")
# ---------------------------------------------------------------------------

class _QueryDriver:
    """Drives a QuerySpec through the uniform Session protocol."""

    kind = "query"

    def __init__(self, spec: QuerySpec, cfg, device: torch.device):
        self.spec = spec
        self.cfg = cfg
        self.device = device
        self.stages = [_StageRT(p, cfg, device) for p in spec.stages]
        self.mode = "query"
        self._affected = -1

    @property
    def stores(self) -> List[MRBGStore]:
        return [st.store for st in self.stages]

    @property
    def view(self):
        return self.stages[self.spec.out_stage].view

    # -- full evaluation ---------------------------------------------------
    def run(self, data) -> None:
        datas = self._norm_sources(data, KV, "run")
        for st in self.stages:
            kv = self._full_input(st, datas)
            st.run_initial(kv)
            if st.view is not None:
                st.view.take_changes()       # initial run is not a delta
        self._affected = -1
        self.mode = "query"

    def _full_input(self, st: _StageRT, datas) -> KV:
        plan = st.plan
        if plan.kind == "group":
            (ip,) = plan.inputs
            if ip.ref[0] == "source":
                kv = datas[ip.ref[1]]
                st.schemas[0] = _schema_of(kv.values)
                return kv
            parent = self.stages[ip.ref[1]]
            st.schemas[0] = _schema_of(
                {n: parent.view.values[n] for n in parent.visible()})
            return self._rel_kv(parent)
        sides = []
        for i, ip in enumerate(plan.inputs):
            if ip.ref[0] == "source":
                kv = datas[ip.ref[1]]
                vals = {n: _np(a) for n, a in kv.values.items()}
                st.schemas[i] = _schema_of(vals)
                sides.append((ip.side, (_np(kv.keys), vals,
                                        np.ones(kv.capacity, np.int8),
                                        _np(kv.valid))))
            else:
                parent = self.stages[ip.ref[1]]
                vals = {n: parent.view.values[n] for n in parent.visible()}
                st.schemas[i] = _schema_of(vals)
                valid = parent.rel_valid()
                sides.append((ip.side, (
                    np.arange(parent.plan.num_keys, dtype=np.int32), vals,
                    np.ones(parent.plan.num_keys, np.int8), valid)))
        return _encode_join_kv(sides, st.schemas)

    @staticmethod
    def _rel_kv(parent: _StageRT) -> KV:
        vals = {n: parent.view.values[n] for n in parent.visible()}
        return make_kv(np.arange(parent.plan.num_keys, dtype=np.int32),
                       vals, parent.rel_valid())

    # -- incremental refresh -------------------------------------------------
    def update(self, delta) -> None:
        datas = self._norm_sources(delta, DeltaKV, "update")
        affected = 0
        stage_rows: Dict[int, Any] = {}
        for idx, st in enumerate(self.stages):
            enc = self._delta_input(st, datas, stage_rows)
            if enc is None:
                stage_rows[idx] = None
                continue
            stats = st.update(enc)
            affected += int(stats.get("affected", 0))
            stage_rows[idx] = st.take_rows()
        self._affected = affected
        self.mode = "query-incremental"

    def _delta_input(self, st: _StageRT, datas, stage_rows):
        plan = st.plan
        if plan.kind == "group":
            (ip,) = plan.inputs
            if ip.ref[0] == "source":
                d = datas.get(ip.ref[1])
                return None if d is None else self._pad(d)
            rows = stage_rows.get(ip.ref[1])
            return None if rows is None else _encode_group_rows(
                rows, self.cfg.delta_bucket_min)
        feeds = []
        for i, ip in enumerate(plan.inputs):
            if ip.ref[0] == "source":
                d = datas.get(ip.ref[1])
                if d is not None:
                    feeds.append((ip.side, _rows_of_delta(d)))
            else:
                rows = stage_rows.get(ip.ref[1])
                if rows is not None:
                    feeds.append((ip.side, rows))
        if not feeds:
            return None
        return _encode_join_feed(feeds, st.schemas,
                                 self.cfg.delta_bucket_min)

    def _pad(self, delta: DeltaKV) -> DeltaKV:
        cap = next_bucket(delta.capacity, self.cfg.delta_bucket_min)
        return delta if cap == delta.capacity else pad_delta(delta, cap)

    def _norm_sources(self, data, leaf_cls, what: str) -> dict:
        srcs = self.spec.sources
        if isinstance(data, leaf_cls):
            if len(srcs) != 1:
                raise ValueError(
                    f"{what}() on a {len(srcs)}-source query needs a dict "
                    f"{{source: {leaf_cls.__name__}}}; sources: {list(srcs)}")
            return {srcs[0]: data}
        if not isinstance(data, dict):
            raise TypeError(
                f"{what}() takes a {leaf_cls.__name__} or a dict keyed by "
                f"source name, got {type(data).__name__}")
        unknown = set(data) - set(srcs)
        if unknown:
            raise ValueError(f"unknown sources {sorted(unknown)}; "
                             f"this query reads {list(srcs)}")
        if what == "run" and set(data) != set(srcs):
            raise ValueError(f"run() needs every source; missing "
                             f"{sorted(set(srcs) - set(data))}")
        return dict(data)

    # -- output / reporting --------------------------------------------------
    def relation(self):
        """(values, valid) of the output relation after the sink chain."""
        st = self.stages[self.spec.out_stage]
        vals = {n: np.array(st.view.values[n]) for n in st.visible()}
        valid = st.rel_valid().copy()
        if self.spec.sink:
            vals, valid = _host_chain(self.spec.sink, vals, valid)
        return vals, valid

    def result(self) -> Dict[str, np.ndarray]:
        vals, valid = self.relation()
        return {n: np.where(valid.reshape((-1,) + (1,) * (a.ndim - 1)),
                            a, 0) for n, a in vals.items()}

    def fill(self, rep) -> None:
        st = self.stages[self.spec.out_stage]
        rep.counts = None if st.view is None else st.view.counts
        rep.affected_keys = self._affected
        io = IOStats()
        for s in self.stages:
            io.add(s.store.stats)
        rep.io = io
        rep.store_bytes = sum(s.store.file_bytes() for s in self.stages)
        rep.live_bytes = sum(s.store.live_bytes() for s in self.stages)
        rep.store_batches = sum(s.store.n_batches for s in self.stages)


# ---------------------------------------------------------------------------
# Eager one-shot evaluation (no preserved state) via ops.group_reduce
# ---------------------------------------------------------------------------

def _eval_stage(plan: StagePlan, kv: KV):
    sign = torch.ones(kv.capacity, dtype=torch.int8, device=kv.keys.device)
    edges = plan.map_fn(kv, sign)
    acc, counts = ops.group_reduce(plan.reducer, edges.k2, edges.v2,
                                   edges.valid & (edges.sign > 0),
                                   plan.num_keys)
    keys = torch.arange(plan.num_keys, dtype=torch.int32,
                        device=kv.keys.device)
    return finalize_reduce(plan.reducer, keys, acc, counts), counts


def evaluate(spec: Union[JobSpec, QuerySpec], data, *,
             device: Union[str, torch.device] = "cuda"):
    """Evaluate a lowered spec once, storelessly, on ``device``.

    Returns ``(values, valid)`` of the output relation as host arrays.
    The same fused map functions the incremental driver uses feed
    :func:`repro_torch.kernels.ops.group_reduce` directly — no MRBG store,
    no view, no preserved edges; right when the caller will never refresh
    (e.g. the derived per-batch coalescer in
    :mod:`repro_torch.dql.derived`).
    """
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("evaluate(device='cuda') but "
                           "torch.cuda.is_available() is False; pass "
                           "device='cpu' to run the plain versions")
    if isinstance(spec, JobSpec):
        if isinstance(data, dict):        # single-pipeline plan, named scan
            if len(data) != 1:
                raise ValueError("a JobSpec-lowered plan reads one source; "
                                 f"got {sorted(data)}")
            (data,) = data.values()
        spec = QuerySpec(name=spec.name,
                         stages=(StagePlan(
                             name=spec.name, kind="group",
                             num_keys=spec.num_keys, reducer=spec.reducer,
                             map_fn=spec.map_fn,
                             inputs=_sole_source_inputs(),
                         ),),
                         sources=("input",), out_stage=0)
    datas = {}
    if isinstance(data, KV):
        if len(spec.sources) != 1:
            raise ValueError("multi-source query: pass {source: KV}")
        datas = {spec.sources[0]: data}
    else:
        datas = dict(data)
    rels: Dict[int, Tuple[dict, np.ndarray]] = {}
    for idx, plan in enumerate(spec.stages):
        kv = _to(_eval_input(plan, datas, rels), device)
        vals, counts = _eval_stage(plan, kv)
        vals = {n: _np(a) for n, a in vals.items()}
        counts = _np(counts)
        valid = counts > 0
        if plan.having is not None:
            valid = valid & _having(plan, vals)
        rels[idx] = (vals, valid)
    vals, valid = rels[spec.out_stage]
    vals = {n: a for n, a in vals.items() if not n.startswith("_")}
    if spec.sink:
        vals, valid = _host_chain(spec.sink, vals, valid)
    return vals, valid


def _sole_source_inputs():
    from repro_torch.dql.lower import InputPlan
    return (InputPlan(("source", "input")),)


def _eval_input(plan: StagePlan, datas, rels) -> KV:
    def rel_rows(idx):
        vals, valid = rels[idx]
        vis = {n: a for n, a in vals.items() if not n.startswith("_")}
        K = valid.shape[0]
        return np.arange(K, dtype=np.int32), vis, valid

    if plan.kind == "group":
        (ip,) = plan.inputs
        if ip.ref[0] == "source":
            return datas[ip.ref[1]]
        keys, vis, valid = rel_rows(ip.ref[1])
        return make_kv(keys, vis, valid)
    sides, schemas = [], []
    for ip in plan.inputs:
        if ip.ref[0] == "source":
            kv = datas[ip.ref[1]]
            vals = {n: _np(a) for n, a in kv.values.items()}
            keys, valid = _np(kv.keys), _np(kv.valid)
        else:
            keys, vals, valid = rel_rows(ip.ref[1])
        schemas.append(_schema_of(vals))
        sides.append((ip.side, (keys, vals,
                                np.ones(len(keys), np.int8), valid)))
    return _encode_join_kv(sides, schemas)
