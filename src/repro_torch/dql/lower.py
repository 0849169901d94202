"""Planner: fuse stateless chains, lower stateful ops to engine stages.

Counterpart of ``repro.dql.lower``.  The fused Map functions run torch
on the stage's device (the user's lambdas see torch tensors there); the
sink chain runs on host tensors of the dense relation.

A plan tree lowers to a DAG of *stages*, one per stateful operator
(``group_by`` / ``join``).  Each stage is exactly one engine job — a
``JobSpec`` whose Map function applies the fused stateless chain
(map/filter/project/window) and emits signed (K2, MK, V2) edges — so both
the initial evaluation and every incremental refresh ride the existing
kernel layer unchanged: ``run_onestep`` (sort_pairs + segment_reduce) for
the first run, ``incremental_onestep`` (shuffle_reduce against the stage's
own ``MRBGStore`` slice) for ``Query.update()``.

Single-pipeline plans (``scan -> chain -> group_by``) lower all the way to
a plain :class:`repro_torch.core.engine.JobSpec`: such a query is
indistinguishable from a hand-written app (``apps/wordcount.py`` parity is
bit-for-bit because the emitted Edges are identical arrays).  Anything
with multiple stages, a join, or a trailing stateless chain lowers to a
:class:`QuerySpec` driven by :class:`repro_torch.dql.driver._QueryDriver`.

Lowering choices:

  * **MK discipline** — stage inputs are keyed so the engine's
    ``make_mk(record_id, slot, fanout)`` stays globally unique and stable
    across epochs: group stages use the upstream key as record id
    (mk == key * fanout + slot); join stages use ``key*2 + side`` so each
    side of a key owns one Map instance and a '-'/'+' pair from either
    side tombstones exactly its own preserved edges.
  * **join as one keyed merge** — both sides' rows emit into the group of
    their join key with per-side presence lanes (``_pl``/``_pr``, summed);
    a key is in the join output iff both lanes are positive.  The three
    delta terms of Δ(R ⋈ S) collapse into the engine's affected-key
    re-reduce against preserved edges.
  * **window as key-space expansion** — a row fans out (static fanout
    ceil(size/slide)) to composite keys ``window * num_keys + key`` before
    the grouped reduce; num_windows bounds the dense output space.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core.engine import JobSpec, emit_multi, emit_single
from repro_torch.core.kvstore import (
    Reducer, max_reducer, mean_reducer, min_reducer, sum_reducer,
)
from repro_torch.dql.algebra import (
    Filter, GroupBy, Join, Map, Node, Project, Scan, Window, explain,
)

_REDUCERS = {"sum": sum_reducer, "min": min_reducer, "max": max_reducer,
             "mean": mean_reducer}

# ref to a stage input: ("source", name) | ("stage", index)
Ref = Tuple[str, Any]


# ---------------------------------------------------------------------------
# Lowered specs
# ---------------------------------------------------------------------------

@dataclass
class InputPlan:
    """One upstream feed of a stage."""

    ref: Ref
    side: Optional[int] = None        # 0/1 for join sides, None for group


@dataclass
class StagePlan:
    """One stateful stage: exactly one engine job over a dense key space."""

    name: str
    kind: str                         # "group" | "join"
    num_keys: int
    reducer: Reducer
    map_fn: Callable                  # fused chain + emit; stable object
    inputs: Tuple[InputPlan, ...]
    having: Optional[Callable] = None  # values-dict -> bool [K] relation mask
    out_cols: Optional[Tuple[str, ...]] = None   # None: resolved at runtime


@dataclass
class QuerySpec:
    """A lowered multi-stage delta query; ``repro_torch.api.Session``
    accepts it exactly like a ``JobSpec``/``IterSpec`` (driver kind
    ``"query"``)."""

    name: str
    stages: Tuple[StagePlan, ...]
    sources: Tuple[str, ...]
    out_stage: int
    sink: Tuple[tuple, ...] = ()      # stateless chain applied to the output

    def __repr__(self) -> str:
        return (f"QuerySpec({self.name!r}, {len(self.stages)} stages, "
                f"sources={list(self.sources)})")


# ---------------------------------------------------------------------------
# Fused stateless chains
# ---------------------------------------------------------------------------

def _t(a, like: torch.Tensor) -> torch.Tensor:
    """``a`` as a tensor on ``like``'s device (tensors stay where they
    are)."""
    if isinstance(a, torch.Tensor):
        return a
    return torch.as_tensor(np.asarray(a), device=like.device)


def apply_chain(chain, values, valid):
    """Run a fused stateless chain on (values dict, valid mask), torch
    tensors on one device: inside a Map function on the stage's device,
    and on the CPU for the sink chain over the dense host relation
    (``relation()`` converts numpy to tensors and back).
    """
    for kind, arg in chain:
        if kind == "map":
            values = dict(arg(values))
        elif kind == "filter":
            valid = valid & _t(arg(values), valid).to(torch.bool)
        elif kind == "project":
            values = {n: values[n] for n in arg}
        else:                          # pragma: no cover
            raise ValueError(f"unknown chain op {kind!r}")
    return values, valid


def _key_of(key, values, like: torch.Tensor):
    keys = _t(values[key] if isinstance(key, str) else key(values), like)
    return keys.to(torch.int32)


def _value_of(spec, values, keys):
    """Materialize one value column, broadcast to the emission key shape."""
    if isinstance(spec, str):
        v = _t(values[spec], keys)
    elif callable(spec):
        v = _t(spec(values), keys)
    else:                              # numeric constant (bare count)
        return torch.full(keys.shape, spec, dtype=torch.float32,
                          device=keys.device)
    if keys.ndim == 2 and (v.ndim < 2 or v.shape[:2] != keys.shape):
        # per-row value fanned out across the key slots
        v = v[:, None].expand(tuple(keys.shape[:2]) + tuple(v.shape[1:]))
    return v


# ---------------------------------------------------------------------------
# Map-function builders (one closure per stage, built exactly once at
# lowering time: object identity keys the serving tier's batch groups)
# ---------------------------------------------------------------------------

def _build_group_map(chain, window: Optional[Window], gb: GroupBy):
    value_specs = dict(gb.value)
    key_spec = gb.key
    if window is not None:
        n_win = max(1, math.ceil(window.size / window.slide))

    def map_fn(kv, sign):
        vals, valid = apply_chain(chain, kv.values, kv.valid)
        keys = _key_of(key_spec, vals, kv.keys)
        if window is not None:
            if keys.ndim != 1:
                raise ValueError("windowed group_by needs a per-row key")
            t = _t(vals[window.time], keys).to(torch.int32)
            wins = (t // window.slide)[:, None] - torch.arange(
                n_win, dtype=torch.int32, device=t.device)[None, :]
            in_win = ((wins >= 0) & (wins < window.num_windows) &
                      (t[:, None] < wins * window.slide + window.size))
            keys = wins * gb.num_keys + keys[:, None]
            v2 = {n: _value_of(s, vals, keys)
                  for n, s in value_specs.items()}
            slot_valid = valid[:, None] & in_win & (keys >= 0)
            return emit_multi(keys, v2, kv.keys, slot_valid,
                              record_sign=sign)
        v2 = {n: _value_of(s, vals, keys) for n, s in value_specs.items()}
        if keys.ndim == 1:
            return emit_single(keys, v2, kv.keys, valid & (keys >= 0),
                               record_sign=sign)
        return emit_multi(keys, v2, kv.keys,
                          valid[:, None] & (keys >= 0), record_sign=sign)

    return map_fn


def _build_join_map(lchain, rchain, jn: Join):
    lpfx, rpfx = jn.lprefix, jn.rprefix

    def _mask(a, m):
        a = _t(a, m)
        return torch.where(m.reshape((-1,) + (1,) * (a.ndim - 1)), a,
                           torch.zeros((), dtype=a.dtype, device=a.device))

    def map_fn(kv, sign):
        vals = kv.values
        is_l = vals["_side"] == 0
        lv, lvalid = apply_chain(lchain, vals["_l"], kv.valid)
        rv, rvalid = apply_chain(rchain, vals["_r"], kv.valid)
        overlap = {lpfx + n for n in lv} & {rpfx + n for n in rv}
        if overlap:
            raise ValueError(
                f"join output columns collide: {sorted(overlap)}; "
                f"disambiguate with lprefix=/rprefix=")
        valid = kv.valid & torch.where(is_l, lvalid, rvalid)
        out = {lpfx + n: _mask(a, is_l) for n, a in lv.items()}
        out.update({rpfx + n: _mask(a, ~is_l) for n, a in rv.items()})
        # per-side presence lanes: a key is in the join iff both sum > 0
        out["_pl"] = is_l.to(torch.int32)
        out["_pr"] = (~is_l).to(torch.int32)
        return emit_single(kv.keys // 2, out, kv.keys, valid,
                           record_sign=sign)

    return map_fn


def _join_having(values) -> Any:
    return (values["_pl"] > 0) & (values["_pr"] > 0)


# ---------------------------------------------------------------------------
# The lowering walk
# ---------------------------------------------------------------------------

def lower(root: Node) -> Union[JobSpec, QuerySpec]:
    """Lower a plan tree to a ``JobSpec`` (single pipeline) or a
    ``QuerySpec``."""
    stages: List[StagePlan] = []
    seen: Dict[int, Ref] = {}         # stateful node id -> stage ref (DAG)
    sources: List[str] = []

    def visit(node: Node) -> Tuple[Ref, list]:
        if isinstance(node, Scan):
            if node.source not in sources:
                sources.append(node.source)
            return ("source", node.source), []
        if isinstance(node, Map):
            ref, chain = visit(node.parent)
            return ref, chain + [("map", node.fn)]
        if isinstance(node, Filter):
            ref, chain = visit(node.parent)
            return ref, chain + [("filter", node.pred)]
        if isinstance(node, Project):
            ref, chain = visit(node.parent)
            return ref, chain + [("project", node.cols)]
        if isinstance(node, Window):
            ref, chain = visit(node.parent)
            return ref, chain + [("window", node)]
        if id(node) in seen:          # shared subplan: one stage, many readers
            return seen[id(node)], []
        if isinstance(node, GroupBy):
            ref, chain = visit(node.parent)
            chain, window = _pop_window(chain, node.name)
            plan = StagePlan(
                name=node.name, kind="group",
                num_keys=_total_keys(node, window),
                reducer=_REDUCERS[node.agg](),
                map_fn=_build_group_map(tuple(chain), window, node),
                inputs=(InputPlan(ref),),
                out_cols=tuple(node.value.keys()))
            stages.append(plan)
            out = ("stage", len(stages) - 1)
            seen[id(node)] = out
            return out, []
        if isinstance(node, Join):
            lref, lchain = visit(node.left)
            rref, rchain = visit(node.right)
            for ch, side in ((lchain, "left"), (rchain, "right")):
                if any(k == "window" for k, _ in ch):
                    raise ValueError(f"window on the {side} side of a join "
                                     f"must be followed by a group_by")
            plan = StagePlan(
                name=node.name, kind="join", num_keys=node.num_keys,
                reducer=sum_reducer(),
                map_fn=_build_join_map(tuple(lchain), tuple(rchain), node),
                inputs=(InputPlan(lref, 0), InputPlan(rref, 1)),
                having=_join_having)
            stages.append(plan)
            out = ("stage", len(stages) - 1)
            seen[id(node)] = out
            return out, []
        raise TypeError(f"unknown plan node {type(node).__name__}")

    ref, sink = visit(root)
    if ref[0] == "source":
        raise ValueError(
            f"a query needs at least one group_by or join; got only "
            f"stateless operators over scan({ref[1]!r})")
    if any(k == "window" for k, _ in sink):
        raise ValueError("a trailing window must be followed by a group_by")

    out_idx = ref[1]
    name = stages[out_idx].name

    # single source->chain->group_by pipeline with nothing after it lowers
    # to a plain JobSpec: the query is just another engine app
    if (len(stages) == 1 and not sink and stages[0].kind == "group"
            and stages[0].inputs[0].ref[0] == "source"
            and stages[0].having is None):
        st = stages[0]
        return JobSpec(st.map_fn, st.reducer, st.num_keys, st.name)

    return QuerySpec(name=name, stages=tuple(stages),
                     sources=tuple(sources), out_stage=out_idx,
                     sink=tuple(sink))


def sources_of(node: Node) -> Tuple[str, ...]:
    """Scan names of a plan, in first-reference order."""
    out: List[str] = []

    def walk(n: Node) -> None:
        if isinstance(n, Scan):
            if n.source not in out:
                out.append(n.source)
        elif isinstance(n, Join):
            walk(n.left)
            walk(n.right)
        elif isinstance(n, (Map, Filter, Project, Window, GroupBy)):
            walk(n.parent)

    walk(node)
    return tuple(out)


def _pop_window(chain: list, name: str) -> Tuple[list, Optional[Window]]:
    """A window annotation must sit at the tail of the chain feeding the
    group_by that consumes it."""
    window = None
    if chain and chain[-1][0] == "window":
        window = chain[-1][1]
        chain = chain[:-1]
    if any(k == "window" for k, _ in chain):
        raise ValueError(f"window feeding {name!r} must be the last "
                         f"stateless operator before the group_by")
    return chain, window


def _total_keys(gb: GroupBy, window: Optional[Window]) -> int:
    if window is None:
        return gb.num_keys
    return gb.num_keys * window.num_windows
