"""Query: a compiled delta plan bound to a ``repro_torch.api.Session``.

Counterpart of ``repro.dql.query``; it runs on ``config.device`` (``cuda``
unless the caller asks for the CPU).

``Q.compile(config)`` returns one of these.  It is a thin, stateful
convenience over the uniform session surface — a compiled query *is* just
another session kind (driver kind ``"query"``; single-pipeline plans lower
all the way to a plain ``JobSpec`` and run the engine's accumulator/MRBG
one-step paths untouched), so ``RunReport``, checkpoint/restore, the
streaming scheduler's cost model, and the serving tier all work on it
with no query-specific code.

On top of the session it keeps host *input mirrors* (one per source,
indexed by record id — the same role ``StreamSession``'s mirror plays) so
``rerun()`` — the Fig. 8 alternative once |Δ| outgrows the incremental
crossover — needs no caller-side bookkeeping::

    q = (dql.scan("edges").group_by(key="dst", value="w", num_keys=K)
            .compile(RunConfig()))
    q.run(edges_kv)
    q.update(delta)          # |Δ|-proportional, preserved-state refresh
    q.rerun()                # full recompute on the mutated mirrors
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Union

import numpy as np

from repro_torch.api.config import RunConfig, StreamConfig
from repro_torch.api.session import Session
from repro_torch.core.engine import JobSpec
from repro_torch.core.incremental import DeltaKV, apply_delta_host
from repro_torch.core.kvstore import KV, make_kv, next_bucket
from repro_torch.dql.driver import evaluate as _evaluate_spec
from repro_torch.dql.lower import QuerySpec, lower
from repro_torch.stream.session import _host


class Query:
    """A lowered plan + its Session + per-source input mirrors."""

    def __init__(self, q, config: Optional[RunConfig] = None):
        from repro_torch.dql.algebra import Q
        self.plan = q.node if isinstance(q, Q) else q
        self.qspec: Union[JobSpec, QuerySpec] = lower(self.plan)
        self.config = config or RunConfig()
        self.session = Session(self.qspec, self.config)
        self._mirrors: Optional[Dict[str, list]] = None

    @property
    def sources(self) -> tuple:
        if isinstance(self.qspec, QuerySpec):
            return self.qspec.sources
        from repro_torch.dql.lower import sources_of
        return sources_of(self.plan)

    @property
    def name(self) -> str:
        return self.qspec.name

    # -- lifecycle (mirrors Session.run/update/rerun) ----------------------
    def run(self, data):
        """Initial full evaluation.  ``data``: a KV, or {source: KV}."""
        datas = self._as_source_dict(data, KV)
        self._mirrors = {
            name: [_host(kv.keys),
                   {n: _host(a) for n, a in kv.values.items()},
                   _host(kv.valid)]
            for name, kv in datas.items()}
        return self.session.run(self._session_arg(datas))

    def update(self, delta):
        """Incremental refresh.  ``delta``: a DeltaKV, or {source: DeltaKV}
        for multi-source plans (absent sources are unchanged)."""
        deltas = self._as_source_dict(delta, DeltaKV, partial=True)
        rep = self.session.update(self._session_arg(deltas))
        for name, d in deltas.items():        # after: no mirror roll-back
            self._apply_mirror(name, d)
        return rep

    def rerun(self):
        """Full recompute on the mutated input mirrors (scheduler's
        alternative past the update-vs-rerun crossover)."""
        if self._mirrors is None:
            raise RuntimeError("rerun() needs the input mirrors captured by "
                               "run(); a restored Query must run() or "
                               "update() only")
        datas = {name: make_kv(m[0], m[1], m[2])
                 for name, m in self._mirrors.items()}
        return self.session.rerun(self._session_arg(datas))

    # -- outputs -----------------------------------------------------------
    @property
    def result(self) -> Dict[str, np.ndarray]:
        return self.session.result

    def relation(self):
        """(values, valid) of the output relation (invalid rows unmasked)."""
        drv = self.session._driver
        rel = getattr(drv, "relation", None)
        if rel is not None:
            return rel()
        view = self.session.view
        return view.as_dict(), view.valid.copy()

    def report(self, include_result: bool = True):
        return self.session.report(include_result)

    def explain(self) -> str:
        from repro_torch.dql.algebra import explain
        return explain(self.plan)

    # -- fault tolerance ---------------------------------------------------
    def checkpoint(self, path: Optional[str] = None):
        return self.session.checkpoint(path)

    @classmethod
    def restore(cls, q, path: str,
                config: Optional[RunConfig] = None) -> "Query":
        obj = cls.__new__(cls)
        from repro_torch.dql.algebra import Q
        obj.plan = q.node if isinstance(q, Q) else q
        obj.qspec = lower(obj.plan)
        obj.config = config or RunConfig()
        obj.session = Session.restore(obj.qspec, path, config)
        obj._mirrors = None
        return obj

    # -- streaming adapter -------------------------------------------------
    def stream(self, data, source=None, *,
               stream: Optional[StreamConfig] = None, name: str = "query"):
        """Bind this query's spec to a
        :class:`repro_torch.stream.StreamSession`.

        Single-source plans only (the stream layer feeds one delta
        stream); the StreamSession owns its own session + mirror, so use
        either the returned object *or* this Query, not both.
        """
        from repro_torch.stream.session import StreamSession
        if len(self.sources) != 1:
            raise ValueError(
                f"stream() supports single-source queries; this plan reads "
                f"{list(self.sources)} — drive multi-source updates via "
                f"Query.update({{source: delta}})")
        if isinstance(data, dict):
            data = data[self.sources[0]]
        return StreamSession(self.qspec, data, source=source,
                             config=self.config, stream=stream, name=name)

    # -- internals ---------------------------------------------------------
    def _as_source_dict(self, data, leaf_cls, partial: bool = False) -> dict:
        srcs = self.sources
        if isinstance(data, leaf_cls):
            if len(srcs) != 1:
                raise ValueError(
                    f"this query reads {list(srcs)}; pass a dict "
                    f"{{source: {leaf_cls.__name__}}}")
            return {srcs[0]: data}
        if not isinstance(data, dict):
            raise TypeError(f"expected {leaf_cls.__name__} or dict, got "
                            f"{type(data).__name__}")
        unknown = set(data) - set(srcs)
        if unknown:
            raise ValueError(f"unknown sources {sorted(unknown)}; this "
                             f"query reads {list(srcs)}")
        if not partial and set(data) != set(srcs):
            raise ValueError(f"missing sources "
                             f"{sorted(set(srcs) - set(data))}")
        return dict(data)

    def _session_arg(self, datas: dict):
        # single-source plans speak bare KV/DeltaKV to the session (the
        # JobSpec lowering requires it; for QuerySpec it lets
        # Session.update's bucketed-ladder padding kick in)
        if len(self.sources) == 1:
            return datas[self.sources[0]]
        return datas

    def _apply_mirror(self, name: str, delta: DeltaKV) -> None:
        if self._mirrors is None or name not in self._mirrors:
            return
        m = self._mirrors[name]
        rid = _host(delta.record_ids)
        dvalid = _host(delta.valid)
        if dvalid.any():
            need = int(rid[dvalid].max()) + 1
            if need > m[0].shape[0]:
                self._grow_mirror(m, next_bucket(need, m[0].shape[0]))
        keys, values, valid = m
        apply_delta_host(keys, values, valid, delta)

    @staticmethod
    def _grow_mirror(m, capacity: int) -> None:
        pad = capacity - m[0].shape[0]
        m[0] = np.concatenate(
            [m[0], np.zeros((pad,) + m[0].shape[1:], m[0].dtype)])
        m[1] = {n: np.concatenate([a, np.zeros((pad,) + a.shape[1:],
                                               a.dtype)])
                for n, a in m[1].items()}
        m[2] = np.concatenate([m[2], np.zeros(pad, bool)])


def evaluate(q, data, *, device="cuda"):
    """One-shot, storeless evaluation of a plan (or compiled spec).

    Returns ``(values, valid)`` of the output relation.  Use this when the
    result is consumed once and never refreshed — it skips the MRBG store
    and view entirely and feeds the fused map functions straight into
    ``kernels.ops.group_reduce``.
    """
    from repro_torch.dql.algebra import Q
    if isinstance(q, Q):
        q = lower(q.node)
    return _evaluate_spec(q, data, device=device)
