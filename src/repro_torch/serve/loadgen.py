"""Synthetic multi-tenant load generation for the serving tier.

Builds fleets of small wordcount tenants (the dispatch-bound regime the
batched cross-tenant refresh targets) and drives them with closed-loop
rounds (throughput cells) or open-loop paced offered load (overload
cells).  Counterpart of ``repro.serve.loadgen``, on the port's wordcount
and ``StreamSession``; ``device`` takes the place of the reference's
``backend`` and ``cache_dir`` (the kernels' build directory is the cache).
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Optional

import numpy as np

from repro_torch.api import RunConfig, StreamConfig
from repro_torch.apps import wordcount as wc
from repro_torch.serve.sched import SLOClass
from repro_torch.serve.tier import ServeTier
from repro_torch.stream.session import StreamSession


def make_fleet(tier: ServeTier, n_tenants: int, *, vocab: int = 64,
               n_docs: int = 8, doc_len: int = 4, seed: int = 0,
               device: str = "cuda", value_bytes: int = 4,
               slo_of: Optional[Callable[[int], SLOClass]] = None,
               group_of: Optional[Callable[[int], Optional[str]]] = None,
               crossover: float = 100.0) -> Dict[str, np.ndarray]:
    """Admit ``n_tenants`` small wordcount tenants; returns the per-tenant
    corpus mirrors the caller mutates alongside its submits.  The high
    default ``crossover`` pins every refresh on the incremental ``update``
    path, which is what the batched launch rides."""
    rng = np.random.default_rng(seed)
    mirrors: Dict[str, np.ndarray] = {}
    for i in range(n_tenants):
        docs = rng.integers(0, vocab, (n_docs, doc_len)).astype(np.int32)
        name = f"t{i:04d}"
        spec, data = wc.make_job(docs, vocab)
        tier.add(StreamSession(
            spec, data, name=name,
            config=RunConfig(device=device, onestep_path="mrbg",
                             value_bytes=value_bytes),
            stream=StreamConfig(max_batch_delay=0.0, crossover=crossover,
                                prewarm=False)),
            slo=slo_of(i) if slo_of is not None else None,
            group=group_of(i) if group_of is not None else None)
        mirrors[name] = docs.copy()
    return mirrors


def submit_update(tier: ServeTier, mirrors: Dict[str, np.ndarray],
                  name: str, rng, vocab: int,
                  rows_per_update: int = 1) -> bool:
    """One document-rewrite record ('-' old row, '+' new row, for
    ``rows_per_update`` distinct documents) for ``name``.  Returns False
    when admission shed it (the mirror is left untouched, mirroring what
    a real producer would retry later).  Wider records shift cost from
    the submit path to the refresh engine — how overload cells saturate
    the tier without the submission loop being the bottleneck."""
    docs = mirrors[name]
    k = min(rows_per_update, len(docs))
    rows = rng.choice(len(docs), size=k, replace=False)
    new = rng.integers(0, vocab, (k,) + docs.shape[1:]).astype(np.int32)
    rids = np.repeat(rows.astype(np.int32), 2)
    buf = np.empty((2 * k,) + docs.shape[1:], np.int32)
    buf[0::2] = docs[rows]
    buf[1::2] = new
    admitted = tier.submit(name, rids, {"w": buf},
                           np.tile(np.array([-1, 1], np.int8), k))
    if admitted:
        docs[rows] = new
    return admitted


def run_rounds(tier: ServeTier, mirrors: Dict[str, np.ndarray],
               rounds: int, *, vocab: int = 64, seed: int = 1,
               rows_per_update: int = 1,
               timeout: float = 600.0) -> Dict[str, float]:
    """Closed-loop throughput cell: one update per tenant per round, drain
    between rounds.  Returns wall-clock and sustained updates/sec."""
    rng = np.random.default_rng(seed)
    names = list(mirrors)
    admitted = 0
    t0 = time.perf_counter()
    for _ in range(rounds):
        for name in names:
            admitted += submit_update(tier, mirrors, name, rng, vocab,
                                      rows_per_update)
        tier.drain(timeout=timeout)
    wall = time.perf_counter() - t0
    return {"wall_s": wall, "updates": admitted,
            "updates_per_sec": admitted / wall if wall > 0 else 0.0}


def open_loop_rate(tier: ServeTier, mirrors: Dict[str, np.ndarray],
                   updates: int, *, vocab: int = 64, seed: int = 3,
                   rows_per_update: int = 1,
                   timeout: float = 600.0) -> float:
    """Measured service capacity in updates/sec: submit ``updates``
    round-robin as fast as they are accepted (no per-round drain barrier),
    then drain.  Run with the tier's scheduler thread on, so the rate
    includes real submit/refresh overlap — this is what an overload cell
    should be calibrated against, not the stricter closed-loop rate."""
    rng = np.random.default_rng(seed)
    names = list(mirrors)
    t0 = time.perf_counter()
    for i in range(updates):
        submit_update(tier, mirrors, names[i % len(names)], rng, vocab,
                      rows_per_update)
    tier.drain(timeout=timeout)
    return updates / (time.perf_counter() - t0)


def overload_run(tier: ServeTier, mirrors: Dict[str, np.ndarray], *,
                 latency_tenant: str, duration_s: float,
                 offered_per_sec: float, latency_interval_s: float = 0.05,
                 vocab: int = 64, seed: int = 2, rows_per_update: int = 1,
                 timeout: float = 600.0) -> Dict[str, float]:
    """Open-loop overload cell: offer ``offered_per_sec`` updates/sec
    round-robin across the best-effort tenants (no waiting for drains)
    plus a steady trickle to ``latency_tenant``; admission control is what
    keeps the tier standing.  Call with the tier's scheduler thread
    running."""
    rng = np.random.default_rng(seed)
    best_effort = [n for n in mirrors if n != latency_tenant]
    interval = 1.0 / offered_per_sec
    t0 = time.perf_counter()
    offered = admitted = lat_updates = 0
    next_latency = t0
    while True:
        now = time.perf_counter()
        if now - t0 >= duration_s:
            break
        if now >= next_latency:
            submit_update(tier, mirrors, latency_tenant, rng, vocab)
            lat_updates += 1
            next_latency = now + latency_interval_s
        target = t0 + offered * interval
        if now < target:
            time.sleep(min(target - now, 0.005))
            continue
        name = best_effort[offered % len(best_effort)]
        admitted += submit_update(tier, mirrors, name, rng, vocab,
                                  rows_per_update)
        offered += 1
    tier.drain(timeout=timeout)
    return {"offered": offered, "admitted": admitted,
            "shed": offered - admitted,
            "shed_fraction": (offered - admitted) / max(offered, 1),
            "latency_updates": lat_updates,
            "duration_s": time.perf_counter() - t0}
