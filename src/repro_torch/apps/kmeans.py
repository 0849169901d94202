"""Kmeans on the iterative engine (paper Algorithm 3, all-to-one).

Counterpart of ``repro.apps.kmeans``.  Structure: SK = point id, SV =
feature vector [dim].  State: DK = centroid id, DV = {"c": centroid
[dim]}; every Map instance needs *all* centroids, so
``replicate_state=True`` (the paper's all-to-one case: state is broadcast
rather than co-partitioned).

Map assigns each point to the nearest centroid and emits
<cid, (pval, 1)>; Reduce averages via (sum, count) partial accumulators.
Any input change moves centroids, which changes every assignment: P_Δ =
100%, so the engine always runs Kmeans refreshes in iterMR mode — the
paper's Fig. 8 behaviour.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.engine import emit_single
from repro_torch.core.iterative import IterSpec
from repro_torch.core.kvstore import KV, make_kv, sum_reducer


def make_struct(points: np.ndarray, valid_rows=None) -> KV:
    s = points.shape[0]
    if valid_rows is None:
        valid_rows = np.ones(s, bool)
    return make_kv(np.arange(s, dtype=np.int32),
                   {"p": np.asarray(points, np.float32)}, valid_rows)


def map_fn(struct: KV, dv, sign):
    pts = struct.values["p"]                 # [N, dim]
    cents = dv["c"]                          # [K, dim] (replicated state)
    d2 = ((pts[:, None, :] - cents[None, :, :]) ** 2).sum(-1)   # [N, K]
    cid = torch.argmin(d2, dim=1).to(torch.int32)
    ones = torch.ones(pts.shape[0], dtype=torch.float32, device=pts.device)
    return emit_single(cid, {"sum": pts, "cnt": ones}, struct.keys,
                       struct.valid, record_sign=sign)


def _finalize(keys, acc, counts):
    cnt = acc["cnt"].clamp_min(1e-9)
    return {"c": acc["sum"] / cnt[:, None], "cnt_out": acc["cnt"]}


def make_spec(k: int, dim: int, init_centroids: np.ndarray) -> IterSpec:
    """``init_centroids`` moves to the state's device at ``State.init``."""
    init = torch.as_tensor(np.asarray(init_centroids, np.float32))

    def init_state(dks):
        return {"c": init.to(dks.device, copy=True),
                "cnt_out": torch.zeros(k, dtype=torch.float32,
                                       device=dks.device)}

    return IterSpec(
        map_fn=map_fn,
        reducer=sum_reducer(_finalize),
        project=lambda sk: torch.zeros_like(sk),
        num_state=k,
        init_state=init_state,
        difference=lambda c, p: (c["c"] - p["c"]).abs().amax(dim=1),
        replicate_state=True,
        stable_topology=False,
        name="kmeans",
    )


def make_job(points: np.ndarray, init_centroids: np.ndarray,
             valid_rows=None):
    """Uniform app entry: ``(spec, data)`` ready for
    ``repro_torch.api.Session``."""
    k, dim = init_centroids.shape
    return make_spec(k, dim, init_centroids), make_struct(points, valid_rows)


def oracle(points: np.ndarray, init_centroids: np.ndarray,
           iters: int = 100, tol: float = 1e-6, valid_rows=None):
    pts = points.astype(np.float64)
    if valid_rows is not None:
        pts = pts[valid_rows]
    c = init_centroids.astype(np.float64).copy()
    for _ in range(iters):
        d2 = ((pts[:, None, :] - c[None, :, :]) ** 2).sum(-1)
        a = d2.argmin(1)
        newc = c.copy()
        for j in range(c.shape[0]):
            sel = pts[a == j]
            if sel.shape[0]:
                newc[j] = sel.mean(0)
        if np.abs(newc - c).max() < tol:
            c = newc
            break
        c = newc
    return c
