"""General-purpose iterative MapReduce model (paper Section 4).

Counterpart of ``repro.core.iterative``.  Two kinds of data:

  * **structure** kv-pairs <SK, SV>: loop-invariant (graph adjacency,
    points, matrix blocks).  Dense SK record ids in [0, num_struct).
  * **state** kv-pairs <DK, DV>: loop-variant, updated by each iteration's
    prime Reduce.  Dense DK ids in [0, num_state).

``project(SK) -> DK`` declares the interdependency (one-to-one or
many-to-one; all-to-one is ``replicate_state=True``).  State lives as a
dense device tensor indexed by DK, the structure/state merge-join is a
gather, and the prime loop calls the same ``_iter_step`` every iteration.
PyTorch runs eagerly, so there is no compiled step to keep warm.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.core.kvstore import (
    KV, Edges, Reducer, finalize_reduce, segment_reduce, sort_edges,
)
from repro_torch.kernels import ops
from repro_torch.tree import tree_map

# prime Map: map_fn(struct_kv, state_dv, record_sign) -> Edges
#   state_dv is the gathered DV tree aligned to the structure records
#   ([N, ...]), or the *whole* state tree when replicate_state=True.
IterMapFn = Callable[[KV, Any, torch.Tensor], Edges]


def default_difference(curr: Dict[str, torch.Tensor],
                       prev: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Max-abs change across all DV leaves, per state key."""
    diffs = []
    for n in curr:
        d = (curr[n].to(torch.float32) - prev[n].to(torch.float32)).abs()
        diffs.append(d.reshape(d.shape[0], -1).amax(dim=1))
    return functools.reduce(torch.maximum, diffs)


@dataclass(frozen=True)
class IterSpec:
    map_fn: IterMapFn
    reducer: Reducer
    project: Callable[[torch.Tensor], torch.Tensor]   # [N] SK -> [N] DK
    num_state: int
    init_state: Callable[[torch.Tensor], Any]         # [K] DK -> DV tree
    # difference(DV_curr, DV_prev) -> [K] per-key change magnitude;
    # None resolves to default_difference, so readers may call it directly
    difference: Optional[Callable[[Any, Any], torch.Tensor]] = None
    replicate_state: bool = False                     # all-to-one (Kmeans)
    stable_topology: bool = True                      # map K2 fanout fixed
    name: str = "iter_job"

    def __post_init__(self):
        if self.difference is None:
            object.__setattr__(self, "difference", default_difference)


class State:
    """Dense loop-variant state <DK, DV> on the device."""

    def __init__(self, values: Dict[str, torch.Tensor], valid: torch.Tensor):
        self.values = values
        self.valid = valid

    @classmethod
    def init(cls, spec: IterSpec, device) -> "State":
        dks = torch.arange(spec.num_state, dtype=torch.int32, device=device)
        return cls(spec.init_state(dks),
                   torch.ones(spec.num_state, dtype=torch.bool,
                              device=device))

    def to_host(self) -> Dict[str, np.ndarray]:
        return {n: a.cpu().numpy().copy() for n, a in self.values.items()}


def gather_state(state_values: Any, dks: torch.Tensor) -> Any:
    """The DV rows of ``dks``, aligned to the structure records."""
    idx = dks.to(torch.int64)
    return tree_map(lambda a: a[idx], state_values)


# ---------------------------------------------------------------------------
# One full (non-incremental) iteration
# ---------------------------------------------------------------------------

def _iter_step(spec: IterSpec, struct: KV, state_values: Any,
               dks: torch.Tensor):
    """One prime Map -> shuffle -> prime Reduce pass over the full input.

    Returns the new state values, the in-edge counts and the Map's edges
    (unsorted); the caller sorts them only on the iteration it preserves.
    """
    dv = state_values if spec.replicate_state \
        else gather_state(state_values, dks)
    sign = torch.ones(struct.capacity, dtype=torch.int8,
                      device=struct.keys.device)
    edges = spec.map_fn(struct, dv, sign)
    acc, counts = segment_reduce(spec.reducer, edges.k2, edges.v2,
                                 edges.valid, spec.num_state)
    keys = torch.arange(spec.num_state, dtype=torch.int32,
                        device=struct.keys.device)
    new_values = finalize_reduce(spec.reducer, keys, acc, counts)
    return new_values, counts, edges


def run_iterative(spec: IterSpec, struct: KV, state: Optional[State] = None,
                  *, max_iters: int = 50, tol: float = 1e-4,
                  preserve_last: bool = False,
                  on_iteration: Optional[Callable] = None):
    """Run the prime loop to convergence (iterMR recomp mode) on the
    structure's device.

    Returns (state, history dict).  ``preserve_last`` also returns the final
    iteration's sorted MRBGraph edges (to seed incremental jobs, §5.1);
    only that iteration's edges are sorted.  Engine-internal: user code
    drives jobs through ``repro_torch.api.Session``.
    """
    device = struct.keys.device
    if state is None:
        state = State.init(spec, device)
    dks = torch.zeros(struct.capacity, dtype=torch.int32, device=device) \
        if spec.replicate_state else spec.project(struct.keys)
    history = {"iters": 0, "max_change": []}
    edges = None
    counts = None
    for it in range(max_iters):
        new_values, counts, edges = _iter_step(spec, struct, state.values,
                                               dks)
        change = spec.difference(new_values, state.values)
        max_change = float(torch.where(state.valid, change,
                                       torch.zeros_like(change)).max())
        if not preserve_last:
            edges = None
        elif max_change < tol or it == max_iters - 1:
            edges = sort_edges(edges)
        state = State(new_values, state.valid)
        history["iters"] = it + 1
        history["max_change"].append(max_change)
        if on_iteration is not None:
            on_iteration(it, state, max_change)
        if max_change < tol:
            break
    history["counts"] = counts
    history["last_edges"] = edges
    return state, history


def run_plain(spec: IterSpec, struct: KV, state: Optional[State] = None,
              **kw):
    """plainMR recomp baseline: same math, but models vanilla-MapReduce
    cost by re-shuffling the *structure* data every iteration (the extra
    join job of Algorithm 5 / HaLoop).  Results equal
    :func:`run_iterative`'s.  Engine-internal: ``Session`` with
    ``RunConfig(plain_shuffle=True)`` drives it."""
    def on_it(it, st, ch):
        # the extra structure shuffle: sort structure kv-pairs by key and
        # gather every value column through the permutation
        ops.sort_pairs(struct.keys, None, struct.values, num_keys=1)
    kw.setdefault("on_iteration", on_it)
    return run_iterative(spec, struct, state, **kw)
