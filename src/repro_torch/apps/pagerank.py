"""PageRank on the iterative engine (paper Algorithm 2, one-to-one).

Counterpart of ``repro.apps.pagerank``.  Structure <SK, SV>: SK = vertex
id, SV = padded out-neighbor array.  State <DK, DV>: DK = vertex id,
DV = rank score {"r": [K]}.  project = identity; Map emits <j, R_i/|N_i|>
per out-edge; Reduce sums with the damping finalize R_j = d * sum + (1 - d).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.engine import emit_multi
from repro_torch.core.iterative import IterSpec
from repro_torch.core.kvstore import KV, make_kv, sum_reducer

DAMPING = 0.85


def make_struct(nbrs: np.ndarray, valid_rows=None) -> KV:
    """nbrs: [S, F] int32 out-neighbor ids, -1 = padding.  Host (CPU)
    tensors; ``Session.run`` moves them to its device."""
    s = nbrs.shape[0]
    if valid_rows is None:
        valid_rows = np.ones(s, bool)
    return make_kv(np.arange(s, dtype=np.int32),
                   {"nbrs": np.asarray(nbrs, np.int32)}, valid_rows)


def map_fn(struct: KV, dv, sign):
    nbrs = struct.values["nbrs"]                     # [N, F]
    rank = dv["r"]                                   # [N]
    nvalid = (nbrs >= 0) & struct.valid[:, None]
    deg = nvalid.sum(dim=1).clamp_min(1)
    contrib = (rank / deg.to(rank.dtype))[:, None].expand(nbrs.shape)
    return emit_multi(nbrs, {"r": contrib}, struct.keys, nvalid,
                      record_sign=sign)


def _finalize(keys, acc, counts):
    return {"r": DAMPING * acc["r"] + (1.0 - DAMPING)}


def _init_state(dks):
    return {"r": torch.ones(dks.shape[0], dtype=torch.float32,
                            device=dks.device)}


def _difference(c, p):
    return (c["r"] - p["r"]).abs()


def make_spec(num_vertices: int) -> IterSpec:
    return IterSpec(
        map_fn=map_fn,
        reducer=sum_reducer(_finalize),
        project=lambda sk: sk,
        num_state=num_vertices,
        init_state=_init_state,
        difference=_difference,
        stable_topology=True,
        name="pagerank",
    )


def make_job(nbrs: np.ndarray, valid_rows=None):
    """Uniform app entry: ``(spec, data)`` ready for
    ``repro_torch.api.Session``."""
    return make_spec(nbrs.shape[0]), make_struct(nbrs, valid_rows)


def graph_mutator(num_vertices: int, p_edge: float = 0.5):
    """Evolving-graph mutator: rewire the selected vertices' out-edges."""
    def mut(rng, rows, old):
        shape = old["nbrs"].shape
        return {"nbrs": np.where(rng.random(shape) < p_edge,
                                 rng.integers(0, num_vertices, shape),
                                 -1).astype(np.int32)}
    return mut


def oracle(nbrs: np.ndarray, valid_rows=None, iters: int = 200,
           tol: float = 1e-12) -> np.ndarray:
    """Dense float64 power iteration with identical semantics, one
    ``np.bincount`` per iteration."""
    s, f = nbrs.shape
    if valid_rows is None:
        valid_rows = np.ones(s, bool)
    ok = (nbrs >= 0) & np.asarray(valid_rows, bool)[:, None]
    deg = np.maximum(ok.sum(axis=1), 1)
    src = np.repeat(np.arange(s), f)[ok.ravel()]
    dst = nbrs.ravel()[ok.ravel()]
    share = 1.0 / deg[src]
    r = np.ones(s, np.float64)
    for _ in range(iters):
        acc = np.bincount(dst, weights=r[src] * share, minlength=s)
        new = DAMPING * acc + (1 - DAMPING)
        done = np.abs(new - r).max() < tol
        r = new
        if done:
            break
    return r


def random_graph(num_vertices: int, max_out: int, seed: int = 0,
                 p_edge: float = 0.5) -> np.ndarray:
    rng = np.random.default_rng(seed)
    nbrs = rng.integers(0, num_vertices, size=(num_vertices, max_out))
    mask = rng.random((num_vertices, max_out)) < p_edge
    return np.where(mask, nbrs, -1).astype(np.int32)
