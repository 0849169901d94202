"""Query-expressed workloads: plans, synthetic data, oracles, delta makers.

Counterpart of ``repro.dql.workloads``: the same plans with torch lambdas,
the same data from the same seeds (host tensors), and the same oracles,
vectorised with ``np.add.at`` (which adds in row order, as the reference's
loops do, so the float64 sums are the same).

Four workloads demonstrating that "add a workload" is now a query
expression rather than a bespoke engine path:

  * ``wordcount_query``      — ``scan -> map -> group_by(sum)``; lowers to a
    plain ``JobSpec`` whose emitted Edges are bit-for-bit identical to
    ``apps/wordcount.py`` (asserted in ``tests/test_torch_dql.py``);
  * ``join_query``           — incremental equi-join of two keyed sources
    (per-user spend ⋈ visits);
  * ``windowed_query``       — sliding/tumbling window aggregation over
    timestamped events (single stage: the window is key-space expansion);
  * ``cooccurrence_query``   — adjacent-token co-occurrence counts over
    token matrices, the embedding-stats feed the dormant ``models/`` stack
    wants (vocab x vocab count table).

Every workload ships a data generator, a NumPy oracle, and a '-old'/'+new'
delta maker (the convention of ``benchmarks/common.graph_update_delta``:
'-' rows carry the previous values so tombstones route correctly).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.incremental import DeltaKV, make_delta
from repro_torch.core.kvstore import KV, make_kv
from repro_torch.dql.algebra import Q, scan
from repro_torch.dql.driver import _np


# ---------------------------------------------------------------------------
# wordcount as a query (parity target: apps/wordcount.py)
# ---------------------------------------------------------------------------

def wordcount_query(vocab: int) -> Q:
    """``scan(docs) -> map(ones) -> group_by(w, sum)``; lowers to a JobSpec
    emitting exactly the Edges of ``apps.wordcount.make_spec(vocab)``."""
    return (scan("docs")
            .map(lambda v: {"w": v["w"],
                            "c": torch.ones(v["w"].shape, dtype=torch.float32,
                                            device=v["w"].device)})
            .group_by("w", num_keys=vocab, value="c", agg="sum",
                      name="wordcount"))


# ---------------------------------------------------------------------------
# incremental equi-join: per-user spend ⋈ visits
# ---------------------------------------------------------------------------

def join_query(num_users: int) -> Q:
    return scan("spend").join(scan("visits"), num_keys=num_users,
                              name="user_join")


def join_data(num_users: int, seed: int = 0) -> Dict[str, KV]:
    rng = np.random.default_rng(seed)
    uid = np.arange(num_users, dtype=np.int32)
    spend = make_kv(uid,
                    {"amt": rng.uniform(1, 100, num_users)
                     .astype(np.float32)},
                    rng.random(num_users) < 0.9)
    visits = make_kv(uid,
                     {"n": rng.integers(1, 50, num_users)
                      .astype(np.float32)},
                     rng.random(num_users) < 0.85)
    return {"spend": spend, "visits": visits}


def join_oracle(datas: Dict[str, KV]):
    """Dense (values, valid) of spend ⋈ visits."""
    sp, vi = datas["spend"], datas["visits"]
    valid = _np(sp.valid) & _np(vi.valid)
    vals = {"amt": np.where(valid, _np(sp.values["amt"]), 0),
            "n": np.where(valid, _np(vi.values["n"]), 0)}
    return vals, valid


def join_delta(datas: Dict[str, KV], frac: float,
               seed: int = 1) -> Dict[str, DeltaKV]:
    """Mutate a fraction of each side: '-' old row, '+' new value."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, col in (("spend", "amt"), ("visits", "n")):
        kv = datas[name]
        n = kv.capacity
        k = max(1, int(n * frac))
        rows = rng.choice(n, size=k, replace=False).astype(np.int32)
        old = _np(kv.values[col])[rows]
        new = rng.uniform(1, 100, k).astype(np.float32)
        dk = np.repeat(rows, 2)
        sign = np.tile(np.array([-1, 1], np.int8), k)
        buf = np.empty(2 * k, np.float32)
        buf[0::2] = old
        buf[1::2] = new
        # '-' rows of never-valid users are harmless (the engine finds no
        # preserved edge to cancel) but skew oracles; keep them anyway and
        # let apply_delta_host make the row live with the '+' value
        out[name] = make_delta(dk, {col: buf}, sign)
    return out


# ---------------------------------------------------------------------------
# windowed aggregation over timestamped events
# ---------------------------------------------------------------------------

def windowed_query(num_keys: int, *, size: int, slide: Optional[int] = None,
                   num_windows: int) -> Q:
    """Sum of ``v`` per (window, key); output space num_windows*num_keys."""
    return (scan("events")
            .window(size, slide, time="t", num_windows=num_windows)
            .group_by("k", num_keys=num_keys, value="v", agg="sum",
                      name="windowed"))


def events_data(n_events: int, num_keys: int, *, t_max: int,
                seed: int = 0) -> KV:
    rng = np.random.default_rng(seed)
    return make_kv(np.arange(n_events, dtype=np.int32),
                   {"t": rng.integers(0, t_max, n_events).astype(np.int32),
                    "k": rng.integers(0, num_keys, n_events)
                    .astype(np.int32),
                    "v": rng.uniform(0, 10, n_events).astype(np.float32)})


def windowed_oracle(kv: KV, num_keys: int, *, size: int, slide: int,
                    num_windows: int) -> np.ndarray:
    """[num_windows*num_keys] sums; row w*num_keys+k is window w, key k."""
    out = np.zeros(num_windows * num_keys, np.float64)
    valid = _np(kv.valid)
    t = _np(kv.values["t"])[valid].astype(np.int64)
    k = _np(kv.values["k"])[valid].astype(np.int64)
    v = _np(kv.values["v"])[valid].astype(np.float64)
    # each event's windows, newest first (the reference's loop order)
    fan = -(-size // slide)
    w = t[:, None] // slide - np.arange(fan)[None, :]
    hit = (w >= 0) & (w * slide + size > t[:, None]) & (w < num_windows)
    rows, slots = np.nonzero(hit)              # event-major order
    np.add.at(out, w[rows, slots] * num_keys + k[rows], v[rows])
    return out


def events_delta(kv: KV, frac: float, *, t_max: int,
                 seed: int = 1) -> DeltaKV:
    """Re-time and re-value a fraction of events ('-' old, '+' new)."""
    rng = np.random.default_rng(seed)
    n = kv.capacity
    m = max(1, int(n * frac))
    rows = rng.choice(n, size=m, replace=False).astype(np.int32)
    dk = np.repeat(rows, 2)
    sign = np.tile(np.array([-1, 1], np.int8), m)

    def pair(old, new):
        buf = np.empty(2 * m, old.dtype)
        buf[0::2] = old
        buf[1::2] = new
        return buf

    t = _np(kv.values["t"])[rows]
    k = _np(kv.values["k"])[rows]
    v = _np(kv.values["v"])[rows]
    return make_delta(dk, {
        "t": pair(t, rng.integers(0, t_max, m).astype(np.int32)),
        "k": pair(k, k),                      # key is stable; time/value move
        "v": pair(v, rng.uniform(0, 10, m).astype(np.float32)),
    }, sign)


# ---------------------------------------------------------------------------
# co-occurrence counts (adjacent-token bigrams, vocab x vocab)
# ---------------------------------------------------------------------------

def cooccurrence_query(vocab: int) -> Q:
    """Count adjacent-token pairs over [N, L] token matrices; group key is
    the flattened pair id ``a*vocab + b`` (negative tokens mask the slot —
    the padded-fanout idiom)."""
    def pairs(v):
        w = v["w"]
        a, b = w[:, :-1], w[:, 1:]
        return {"pk": torch.where((a >= 0) & (b >= 0), a * vocab + b, -1)}
    return (scan("docs")
            .map(pairs)
            .group_by("pk", num_keys=vocab * vocab, name="cooccur"))


def cooccurrence_oracle(docs: KV, vocab: int) -> np.ndarray:
    """[vocab*vocab] bigram counts."""
    out = np.zeros(vocab * vocab, np.float64)
    w = _np(docs.values["w"])[_np(docs.valid)].astype(np.int64)
    a, b = w[:, :-1], w[:, 1:]
    ok = (a >= 0) & (b >= 0)
    np.add.at(out, a[ok] * vocab + b[ok], 1.0)
    return out
