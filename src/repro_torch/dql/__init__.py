"""repro_torch.dql: a composable delta algebra compiled to the kernels.

Counterpart of ``repro.dql``, with the same modules and names.  Build a
plan with :func:`scan` and the fluent operators (``map``/``filter``/
``project``/``window``/``group_by``/``join``), ``compile()`` it into a
:class:`Query` — just another :class:`repro_torch.api.Session` kind — and
refresh it with signed deltas::

    from repro_torch import dql
    q = (dql.scan("docs")
            .map(lambda v: {"w": v["w"],
                            "c": torch.ones_like(v["w"], dtype=torch.float32)})
            .group_by("w", num_keys=vocab, value="c")
            .compile(RunConfig()))             # on cuda
    q.run(docs_kv)
    q.update(delta)        # preserved-state, |Δ|-proportional refresh

User lambdas receive torch tensors on the query's device.  See
:mod:`repro_torch.dql.algebra` for the operator/delta-rule table,
:mod:`repro_torch.dql.lower` for the planner,
:mod:`repro_torch.dql.driver` for the incremental runtime,
:mod:`repro_torch.dql.derived` for the coalescer re-derivation, and
:mod:`repro_torch.dql.workloads` for ready-made plans.
"""
from repro_torch.dql.algebra import AGG_KINDS, Q, explain, scan
from repro_torch.dql.lower import QuerySpec, lower
from repro_torch.dql.query import Query, evaluate

__all__ = ["AGG_KINDS", "Q", "Query", "QuerySpec", "evaluate", "explain",
           "lower", "scan"]
