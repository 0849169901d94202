"""Logical delta-query algebra: operators that carry their own delta rule.

Counterpart of ``repro.dql.algebra`` (host-only plan objects, copied).
User functions given to ``map`` / ``filter`` / computed keys and values
receive the rows' columns as torch tensors on the stage's device and
return torch tensors (or anything ``torch.as_tensor`` takes).

Every operator of the algebra is a homomorphism over *signed relations* —
bags of rows tagged +1 (insert) / -1 (delete), exactly the
:class:`repro_torch.core.incremental.DeltaKV` encoding the engine already
refreshes against.  The delta rule of each operator says how a change in
its input becomes a change in its output (Fegaras' incremental stream
algebra; Elghandour et al.'s delta-query derivation):

  ============  ========================================================
  operator      delta rule
  ============  ========================================================
  scan          Δ(R) = ΔR                       (the stream itself)
  map f         Δ(f(R)) = f(ΔR)                 (applied to both signs)
  filter σ      Δ(σ(R)) = σ(ΔR)                 ('-' rows re-test the
                                                 *old* value: a tombstone
                                                 is emitted iff the old
                                                 row had passed)
  project π     Δ(π(R)) = π(ΔR)
  group_by ⊕    Δ-rows re-reduce only affected groups: the signed
                segment-reduce homomorphism the engine's fine-grain
                refresh (§3.3) implements — tombstones cancel preserved
                MRBGraph edges, survivors re-reduce per group
  join ⋈        Δ(R ⋈ S) = ΔR ⋈ S  ∪  R ⋈ ΔS  ∪  ΔR ⋈ ΔS.  Lowered to
                a keyed merge: both sides' rows land in one group per
                join key with per-side presence counts, so patching one
                side re-evaluates the join output exactly for the
                affected keys — the three delta terms collapse into one
                affected-key re-reduce against preserved state
  window        key-space expansion *before* group_by: a row at time t
                fans out to every window containing t, so its delta
                rule is map's (each window bucket is just another group)
  ============  ========================================================

The builder is fluent and immutable::

    from repro_torch import dql
    q = (dql.scan("docs")
            .map(lambda v: {"w": v["w"],
                            "c": torch.ones_like(v["w"], dtype=torch.float32)})
            .group_by(key="w", value="c", agg="sum", num_keys=vocab))
    compiled = q.compile(RunConfig())      # on cuda
    compiled.run(data)                     # full evaluation
    compiled.update(delta)                 # |Δ|-proportional refresh

Stateless operators (map / filter / project / window) never materialize:
the planner (:mod:`repro_torch.dql.lower`) fuses each maximal stateless chain
into the Map function of the next stateful stage, so one kernel sequence
serves the whole chain.  Conventions:

  * column names starting with ``_`` are reserved for the planner
    (presence lanes, the join side lane);
  * '-' delta rows carry the record's *previous* values (the same
    convention ``apply_delta_host`` / the synthetic sources follow) so
    computed keys and filters route tombstones to the groups the old
    value contributed to;
  * group keys are int32; negative keys mask the emission (the idiom
    ``apps/wordcount.py`` uses for padded fanout).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Mapping, Optional, Tuple, Union

AGG_KINDS = ("sum", "min", "max", "mean")

# a value spec: an existing column, a computed column, or a constant
ValueSpec = Union[str, Callable, int, float]


# ---------------------------------------------------------------------------
# Plan nodes (immutable; the builder below wraps them)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Node:
    pass


@dataclass(frozen=True)
class Scan(Node):
    """A named delta-stream input (one ``KV`` + its ``DeltaKV`` stream)."""

    source: str = "input"


@dataclass(frozen=True)
class Map(Node):
    """Row-wise transform: ``fn(values) -> values`` (vectorized torch)."""

    parent: Node = None
    fn: Callable = None


@dataclass(frozen=True)
class Filter(Node):
    """Row predicate: ``pred(values) -> bool [N]``."""

    parent: Node = None
    pred: Callable = None


@dataclass(frozen=True)
class Project(Node):
    """Keep only the named columns."""

    parent: Node = None
    cols: Tuple[str, ...] = ()


@dataclass(frozen=True)
class Window(Node):
    """Tumbling/sliding window annotation, consumed by the next group_by.

    A row whose ``time`` column is t belongs to every window w with
    ``w*slide <= t < w*slide + size`` (tumbling when slide == size).  The
    next ``group_by`` emits into composite groups ``w * num_keys + key``.
    """

    parent: Node = None
    size: int = 0
    slide: int = 0
    time: str = "t"
    num_windows: int = 0


@dataclass(frozen=True)
class GroupBy(Node):
    """Signed grouped aggregation over a dense int key space."""

    parent: Node = None
    key: Union[str, Callable] = None
    value: Any = None            # normalized to {name: ValueSpec} by builder
    agg: str = "sum"
    num_keys: int = 0
    name: str = "group_by"


@dataclass(frozen=True)
class Join(Node):
    """Equi-join of two keyed relations on their (dense int) key.

    Each side holds at most one live row per key (true of group_by outputs
    and of scans keyed by record id); the output carries both sides'
    columns, optionally prefixed, for keys live on *both* sides.
    """

    left: Node = None
    right: Node = None
    num_keys: int = 0
    lprefix: str = ""
    rprefix: str = ""
    name: str = "join"


# ---------------------------------------------------------------------------
# Fluent builder
# ---------------------------------------------------------------------------

class Q:
    """Immutable handle around a plan node; every method returns a new Q."""

    def __init__(self, node: Node):
        self.node = node

    # -- stateless operators (fused by the planner) ------------------------
    def map(self, fn: Callable) -> "Q":
        return Q(Map(self.node, fn))

    def filter(self, pred: Callable) -> "Q":
        return Q(Filter(self.node, pred))

    def project(self, *cols: str) -> "Q":
        return Q(Project(self.node, tuple(cols)))

    def window(self, size: int, slide: Optional[int] = None, *,
               time: str = "t", num_windows: int) -> "Q":
        slide = size if slide is None else slide
        if size <= 0 or slide <= 0:
            raise ValueError("window size and slide must be positive")
        return Q(Window(self.node, int(size), int(slide), time,
                        int(num_windows)))

    # -- stateful operators ------------------------------------------------
    def group_by(self, key: Union[str, Callable], *, num_keys: int,
                 value: Any = None, agg: str = "sum",
                 name: str = "group_by") -> "Q":
        if agg not in AGG_KINDS:
            raise ValueError(f"agg must be one of {AGG_KINDS}, got {agg!r}")
        return Q(GroupBy(self.node, key, _norm_value(value), agg,
                         int(num_keys), name))

    def join(self, other: "Q", *, num_keys: Optional[int] = None,
             lprefix: str = "", rprefix: str = "",
             name: str = "join") -> "Q":
        ln = _keyspace_of(self.node)
        rn = _keyspace_of(other.node)
        nk = num_keys
        for side in (ln, rn):
            if side is not None:
                nk = side if nk is None else nk
                if side != nk:
                    raise ValueError(
                        f"join sides disagree on key space: {ln} vs {rn}")
        if nk is None:
            raise ValueError("join of two scans needs num_keys=")
        return Q(Join(self.node, other.node, int(nk), lprefix, rprefix,
                      name))

    # -- compilation -------------------------------------------------------
    def compile(self, config=None):
        """Lower the plan and bind it to a :class:`repro_torch.api.Session`."""
        from repro_torch.dql.query import Query
        return Query(self, config)

    def spec(self):
        """The lowered spec: a plain ``JobSpec`` when the plan is a single
        source->chain->group_by pipeline, a ``QuerySpec`` otherwise."""
        from repro_torch.dql.lower import lower
        return lower(self.node)

    def __repr__(self) -> str:
        return f"Q({explain(self.node)})"


def scan(source: str = "input") -> Q:
    """Root of every plan: the named delta-stream input."""
    return Q(Scan(source))


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _norm_value(value: Any) -> Dict[str, ValueSpec]:
    """Normalize the group_by ``value=`` argument to {name: spec}."""
    if value is None:
        return {"n": 1.0}                 # bare count
    if isinstance(value, str):
        return {value: value}
    if isinstance(value, Mapping):
        return dict(value)
    raise TypeError("value= must be None, a column name, or a "
                    "{name: column|callable|constant} mapping")


def _keyspace_of(node: Node) -> Optional[int]:
    """Output key space of a keyed node; None for scans (caller supplies)."""
    if isinstance(node, GroupBy):
        return node.num_keys
    if isinstance(node, Join):
        return node.num_keys
    if isinstance(node, (Map, Filter, Project, Window)):
        return _keyspace_of(node.parent)
    return None


def explain(node: Node) -> str:
    """One-line plan rendering (leaf -> root)."""
    if isinstance(node, Scan):
        return f"scan({node.source})"
    if isinstance(node, Map):
        return f"{explain(node.parent)} -> map"
    if isinstance(node, Filter):
        return f"{explain(node.parent)} -> filter"
    if isinstance(node, Project):
        return f"{explain(node.parent)} -> project{list(node.cols)}"
    if isinstance(node, Window):
        kind = "tumbling" if node.size == node.slide else "sliding"
        return (f"{explain(node.parent)} -> window[{kind} "
                f"{node.size}/{node.slide}]")
    if isinstance(node, GroupBy):
        return (f"{explain(node.parent)} -> group_by[{node.agg}, "
                f"K={node.num_keys}]")
    if isinstance(node, Join):
        return (f"({explain(node.left)}) ⋈ ({explain(node.right)}) "
                f"[K={node.num_keys}]")
    return type(node).__name__
