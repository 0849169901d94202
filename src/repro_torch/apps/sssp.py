"""Single-Source Shortest Path on the iterative engine (one-to-one).

Counterpart of ``repro.apps.sssp``.  Structure: SK = vertex id, SV =
padded out-neighbors + weights.  State: DK = vertex id, DV = {"d": dist}.
Map emits <j, d_i + w_ij>; Reduce is **min**; a virtual root record emits
<src, 0> so the source anchors the fixpoint.

Contributions come only from in-edges, so the MRBGraph merge handles
deletions and weight increases: min is the non-invertible reducer for
which the paper's fine-grain preserved state is required.  A vertex whose
in-edges are all gone reduces to +inf (the min identity), which
``difference`` treats like INF: unreachable.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.engine import emit_multi
from repro_torch.core.iterative import IterSpec
from repro_torch.core.kvstore import KV, make_kv, min_reducer

INF = np.float32(3.4e38) / 4
_INF = float(INF)
_HALF_INF = float(INF / 2)


def make_struct(nbrs: np.ndarray, w: np.ndarray, src: int,
                valid_rows=None) -> KV:
    """Row i: out-edges of vertex i-1; row 0 is the virtual root -> src.

    nbrs/w: [S, F]; the caller provides vertex rows; we prepend the root.
    """
    s, f = nbrs.shape
    root_n = np.full((1, f), -1, np.int32)
    root_n[0, 0] = src
    root_w = np.zeros((1, f), np.float32)
    root_w[0, 0] = -INF   # so that d_root + w = 0 given d_root = INF sentinel
    nbrs2 = np.concatenate([root_n, nbrs]).astype(np.int32)
    w2 = np.concatenate([root_w, w.astype(np.float32)])
    if valid_rows is None:
        valid_rows = np.ones(s, bool)
    valid2 = np.concatenate([[True], valid_rows])
    return make_kv(np.arange(s + 1, dtype=np.int32),
                   {"nbrs": nbrs2, "w": w2}, valid2)


def map_fn(struct: KV, dv, sign):
    nbrs = struct.values["nbrs"]             # [N, F]
    w = struct.values["w"]
    dist = dv["d"]                           # [N]
    is_root = (struct.keys == 0)
    # root emits exactly 0; vertices emit min(d_i, INF) + w.  Unreachable
    # sources contribute ~INF (never the min), keeping the emission topology
    # state-independent so stable_topology incremental replay is exact.
    contrib = torch.where(is_root[:, None], 0.0,
                          dist[:, None].clamp_max(_INF) + w)
    nvalid = (nbrs >= 0) & struct.valid[:, None]
    return emit_multi(nbrs, {"d": contrib.to(torch.float32)}, struct.keys,
                      nvalid, record_sign=sign)


def _init_state(dks):
    return {"d": torch.full((dks.shape[0],), _INF, dtype=torch.float32,
                            device=dks.device)}


def _difference(c, p):
    both_far = (c["d"] > _HALF_INF) & (p["d"] > _HALF_INF)
    return torch.where(both_far, 0.0,
                       (c["d"].clamp_max(_INF) - p["d"].clamp_max(_INF)).abs())


def make_spec(num_vertices: int) -> IterSpec:
    return IterSpec(
        map_fn=map_fn,
        reducer=min_reducer(),
        # structure record r corresponds to vertex r-1 (root -> src handled
        # in map); its state key is r-1 (root projects to a scratch key 0 --
        # the root's map never reads state)
        project=lambda sk: (sk - 1).clamp_min(0),
        num_state=num_vertices,
        init_state=_init_state,
        difference=_difference,
        stable_topology=True,
        name="sssp",
    )


def make_job(nbrs: np.ndarray, w: np.ndarray, src: int, valid_rows=None):
    """Uniform app entry: ``(spec, data)`` ready for
    ``repro_torch.api.Session``."""
    return make_spec(nbrs.shape[0]), make_struct(nbrs, w, src, valid_rows)


def oracle(nbrs: np.ndarray, w: np.ndarray, src: int,
           valid_rows=None) -> np.ndarray:
    """Bellman-Ford reference in float64, all edges relaxed at once per
    round; unreachable vertices hold INF."""
    s = nbrs.shape[0]
    if valid_rows is None:
        valid_rows = np.ones(s, bool)
    ok = (nbrs >= 0) & np.asarray(valid_rows, bool)[:, None]
    i, f = np.nonzero(ok)
    j = nbrs[i, f]
    wij = w[i, f].astype(np.float64)
    d = np.full(s, np.float64(INF))
    d[src] = 0.0
    for _ in range(s):
        live = d[i] < INF / 2
        nd = d.copy()
        np.minimum.at(nd, j[live], d[i[live]] + wij[live])
        if not (nd < d - 1e-12).any():
            break
        d = nd
    return d


def random_weighted_graph(num_vertices: int, max_out: int, seed: int = 0,
                          p_edge: float = 0.5):
    rng = np.random.default_rng(seed)
    nbrs = rng.integers(0, num_vertices, size=(num_vertices, max_out))
    mask = rng.random((num_vertices, max_out)) < p_edge
    nbrs = np.where(mask, nbrs, -1).astype(np.int32)
    w = np.abs(rng.normal(1.0, 0.3, size=(num_vertices, max_out))
               ).astype(np.float32)
    return nbrs, w
