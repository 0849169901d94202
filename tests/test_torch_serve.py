"""The serving tier, port vs JAX: batched refresh, scheduling, spill, shim.

The same seeds drive fleets of small wordcount tenants through
``repro.serve`` on backend="xla" and ``repro_torch.serve`` on the CPU (the
kernels' plain versions), synchronously (``drain`` sweeps on the caller's
thread), so both packages see the same micro-batches.  Every tenant's
counts are bitwise equal across the packages, between the batched and the
per-tenant refresh, and to ``np.bincount`` of its mirror.  The batched
delta Map's sort and each tenant's merged chunks are bitwise equal to the
tenant's solo refresh.  Scheduling, admission, budget and spill, churn
and the ``MultiSessionServer`` shim are held to the reference's own
tests' expectations.
"""
import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro.serve import ServeTier as JTier
from repro.serve import batch as jbatch
from repro.serve import loadgen as jloadgen
from repro_torch.api import RunConfig, StreamConfig
from repro_torch.apps import wordcount as wc
from repro_torch.core.engine import JobSpec
from repro_torch.core.incremental import _delta_map, pad_delta
from repro_torch.core.kvstore import edges_to_host, next_bucket, sum_reducer
from repro_torch.core.mrbg_store import store_blobs
from repro_torch.serve import (
    AdmissionController, ServeTier, SLOClass, deadline_slack,
    order_by_priority,
)
from repro_torch.serve import batch, loadgen
from repro_torch.stream import StreamSession

VOCAB = 32


def _fleet(tier, n, *, seed=0, n_docs=6, **kw):
    return loadgen.make_fleet(tier, n, device="cpu", seed=seed, vocab=VOCAB,
                              n_docs=n_docs, **kw)


def _apply_rounds(tier, mirrors, rounds, *, seed=1, lib=loadgen):
    """Scripted update stream: deterministic across tiers with equal
    seeds.  Synchronous (no scheduler thread): submit one round, drain."""
    rng = np.random.default_rng(seed)
    for _ in range(rounds):
        for name in mirrors:
            lib.submit_update(tier, mirrors, name, rng, VOCAB)
        tier.drain(timeout=120)


def _check_bincount(tier, mirrors):
    for name, docs in mirrors.items():
        np.testing.assert_array_equal(tier[name].result["c"],
                                      wc.oracle(docs, VOCAB))


# ---------------------------------------------------------------------------
# SLO scheduling units
# ---------------------------------------------------------------------------

def test_slo_class_units():
    lat = SLOClass.latency(target_p95_ms=50.0)
    thr = SLOClass.throughput()
    be = SLOClass.best_effort()
    assert lat.rank < thr.rank < be.rank
    assert lat.deadline_ms == 50.0          # defaults to the p95 target
    assert not lat.sheddable and not thr.sheddable and be.sheddable
    with pytest.raises(ValueError):
        SLOClass(kind="gold")
    with pytest.raises(ValueError):
        SLOClass(deadline_ms=-1.0)


def test_order_by_priority_ranks_then_slack():
    tier = ServeTier(batch_refresh=False)
    mirrors = _fleet(tier, 3, seed=3)
    names = list(mirrors)
    tier.handle(names[0]).slo = SLOClass.best_effort()
    tier.handle(names[1]).slo = SLOClass.latency(target_p95_ms=20.0)
    tier.handle(names[2]).slo = SLOClass.throughput()
    ordered = order_by_priority(list(tier.handles.values()))
    assert [h.name for h in ordered] == [names[1], names[2], names[0]]
    assert deadline_slack(tier.handle(names[1])) <= 0.020 + 1e-9


# ---------------------------------------------------------------------------
# batched cross-tenant refresh: bit for bit
# ---------------------------------------------------------------------------

def test_batched_equals_reference_solo_and_bincount():
    results = {}
    for mode in ("batched", "solo"):
        tier = ServeTier(batch_refresh=(mode == "batched"))
        mirrors = _fleet(tier, 4, seed=11)
        _apply_rounds(tier, mirrors, rounds=3, seed=12)
        _check_bincount(tier, mirrors)
        results[mode] = {n: (tier[n].result["c"],
                             tier[n].session.store_bytes())
                         for n in mirrors}
        if mode == "batched":
            stats = tier.stats()
            assert stats["batched_launches"] == 3
            assert stats["batched_refreshes"] == 12
            assert [e["tenants"] for e in tier.launch_log] == [4, 4, 4]
    ref = JTier()
    jm = jloadgen.make_fleet(ref, 4, backend="xla", seed=11, vocab=VOCAB,
                             n_docs=6)
    _apply_rounds(ref, jm, rounds=3, seed=12, lib=jloadgen)
    assert ref.stats()["batched_launches"] == 3
    for name, (got, nbytes) in results["batched"].items():
        np.testing.assert_array_equal(got, results["solo"][name][0])
        np.testing.assert_array_equal(got, np.asarray(ref[name].result["c"]))
        assert nbytes == results["solo"][name][1] == \
            ref[name].session.store_bytes()


def _submit_one_round(tier, mirrors, seed):
    rng = np.random.default_rng(seed)
    for name in mirrors:
        loadgen.submit_update(tier, mirrors, name, rng, VOCAB,
                              rows_per_update=3)


def test_batched_sort_and_merged_chunks_equal_solo():
    """The batched Map's sorted union, split by tenant, is each tenant's
    solo sorted delta; each tenant's store after a batched refresh holds
    exactly the chunks of its solo refresh."""
    probe = ServeTier()
    mirrors = _fleet(probe, 3, seed=5, n_docs=8)
    _submit_one_round(probe, mirrors, 6)
    items = []
    for h in probe.handles.values():
        h.ss._ingest()
        with h.ss._lock:
            items.append((h, h.ss.prepare_batch()))
    deltas = [p.res.delta for _, p in items]
    cap = next_bucket(max(d.capacity for d in deltas), 64)
    t_pad = next_bucket(len(items), 1)
    stacked = batch._stack_tenants(deltas, cap, t_pad, torch.device("cpu"))
    glob = edges_to_host(
        batch._batched_delta_map(wc.map_fn, VOCAB, stacked, t_pad),
        sorted_valid_first=True)
    owner = glob["k2"] // VOCAB
    for t, d in enumerate(deltas):
        solo = edges_to_host(_delta_map(wc.map_fn, pad_delta(d, cap)),
                             sorted_valid_first=True)
        sel = owner == t
        np.testing.assert_array_equal(glob["k2"][sel] - t * VOCAB,
                                      solo["k2"])
        for key in ("mk", "sign"):
            np.testing.assert_array_equal(glob[key][sel], solo[key])
        np.testing.assert_array_equal(glob["v2"]["c"][sel], solo["v2"]["c"])

    tiers = {m: ServeTier(batch_refresh=(m == "batched"))
             for m in ("batched", "solo")}
    for tier in tiers.values():
        _submit_one_round(tier, _fleet(tier, 3, seed=5, n_docs=8), 6)
        tier.drain(timeout=120)
    assert tiers["batched"].stats()["batched_launches"] == 1
    for name in mirrors:
        got = store_blobs(tiers["batched"][name].session.store)
        want = store_blobs(tiers["solo"][name].session.store)
        assert set(got) == set(want)
        for key in want:
            np.testing.assert_array_equal(got[key], want[key])


def test_one_launch_per_compatible_group():
    tier = ServeTier()
    mirrors = _fleet(tier, 5, seed=21)
    rng = np.random.default_rng(22)
    for name in mirrors:
        loadgen.submit_update(tier, mirrors, name, rng, VOCAB)
    tier.drain(timeout=120)     # synchronous: all five due on one sweep
    stats = tier.stats()
    assert stats["batched_launches"] == 1
    assert stats["batched_refreshes"] == 5
    _check_bincount(tier, mirrors)


def test_group_partitions_batching():
    tier = ServeTier()
    mirrors = _fleet(tier, 4, seed=31,
                     group_of=lambda i: "a" if i < 2 else "b")
    rng = np.random.default_rng(32)
    for name in mirrors:
        loadgen.submit_update(tier, mirrors, name, rng, VOCAB)
    tier.drain(timeout=120)
    assert tier.stats()["batched_launches"] == 2
    assert sorted(e["tenants"] for e in tier.launch_log) == [2, 2]


def _fake_items(num_keys, n):
    """(handle, prep) stand-ins whose spec has ``num_keys`` keys."""
    rolled = []
    spec = JobSpec(wc.map_fn, sum_reducer(), num_keys)
    ss = SimpleNamespace(
        session=SimpleNamespace(spec=spec, device=torch.device("cpu"),
                                config=SimpleNamespace(backend="xla")),
        rollback_batch=rolled.append, _lock=threading.RLock())
    return [(SimpleNamespace(ss=ss), i) for i in range(n)], rolled


@pytest.mark.parametrize("lib", [batch, jbatch], ids=["port", "reference"])
def test_tenant_lane_overflow_raises(lib):
    items, rolled = _fake_items(2**30, 3)       # 4 lanes x 2^30 > int32
    with pytest.raises(ValueError, match="tenant-id lane overflow: 4 "
                       "tenants x 1073741824 keys exceeds int32"):
        lib.execute_group(items)
    assert rolled == [0, 1, 2]                  # every mirror rolled back
    assert lib.MAX_GLOBAL_KEY == 2**31 - 1


# ---------------------------------------------------------------------------
# admission control
# ---------------------------------------------------------------------------

def test_admission_sheds_best_effort_only():
    tier = ServeTier(admission=AdmissionController(max_backlog_seconds=1e-9))
    mirrors = _fleet(tier, 2, seed=41,
                     slo_of=lambda i: (SLOClass.latency(target_p95_ms=1e4)
                                       if i == 0 else SLOClass.best_effort()))
    lat, be = list(mirrors)
    _apply_rounds(tier, mirrors, rounds=2, seed=42)
    h = tier.handle(be)
    shed0 = h.shed_submits
    rng = np.random.default_rng(43)
    assert loadgen.submit_update(tier, mirrors, be, rng, VOCAB)  # empty
    assert not loadgen.submit_update(tier, mirrors, be, rng, VOCAB)
    assert loadgen.submit_update(tier, mirrors, lat, rng, VOCAB)  # never
    assert h.shed_submits == shed0 + 1 and h.shed_rows == 2 * (shed0 + 1)
    assert tier.stats()["admission"]["shed_submits"] == shed0 + 1
    tier.drain(timeout=120)
    assert loadgen.submit_update(tier, mirrors, be, rng, VOCAB)
    tier.drain(timeout=120)
    _check_bincount(tier, mirrors)


def test_admission_prices_fleet_without_samples_at_zero():
    ctl = AdmissionController(max_backlog_seconds=0.5)
    tier = ServeTier(admission=ctl)
    mirrors = _fleet(tier, 2, seed=51)
    rng = np.random.default_rng(52)
    for name in mirrors:
        assert loadgen.submit_update(tier, mirrors, name, rng, VOCAB)
    assert ctl.backlog_seconds(tier.handles.values()) == 0.0
    tier.drain(timeout=120)


# ---------------------------------------------------------------------------
# spill / reload, budget order
# ---------------------------------------------------------------------------

def test_spill_reload_bit_identical(tmp_path):
    results = {}
    for mode in ("spilled", "resident"):
        tier = ServeTier(spill_dir=tmp_path / mode)
        mirrors = _fleet(tier, 2, seed=61)
        cold_name, _ = list(mirrors)
        _apply_rounds(tier, mirrors, rounds=2, seed=62)
        if mode == "spilled":
            h = tier.handle(cold_name)
            freed = tier.spill.spill(h)
            assert freed > 0 and h.spilled
            assert tier[cold_name].store_bytes() == 0
            assert list((tmp_path / mode).glob("*.npz"))
        _apply_rounds(tier, mirrors, rounds=1, seed=63)
        if mode == "spilled":
            assert not tier.handle(cold_name).spilled
            assert not list((tmp_path / mode).glob("*.npz"))
        _check_bincount(tier, mirrors)
        results[mode] = {n: (tier[n].result["c"],
                             store_blobs(tier[n].session.store))
                         for n in mirrors}
    for name, (got, blobs) in results["spilled"].items():
        want, wblobs = results["resident"][name]
        np.testing.assert_array_equal(got, want)
        for key in wblobs:
            np.testing.assert_array_equal(blobs[key], wblobs[key])


def test_remove_reloads_spilled_tenant(tmp_path):
    tier = ServeTier(spill_dir=tmp_path)
    mirrors = _fleet(tier, 1, seed=71)
    (name,) = mirrors
    _apply_rounds(tier, mirrors, rounds=1, seed=72)
    tier.spill.spill(tier.handle(name))
    ss = tier.remove(name)
    assert ss.store_bytes() > 0            # resident again
    assert not ss._managed


def test_budget_compacts_obsolete_bytes_first():
    tier = ServeTier(batch_refresh=False)
    mirrors = _fleet(tier, 2, seed=81)
    churned, quiet = list(mirrors)
    rng = np.random.default_rng(82)
    for _ in range(6):                     # churn -> obsolete store bytes
        loadgen.submit_update(tier, mirrors, churned, rng, VOCAB)
        tier.drain(timeout=120)
    loadgen.submit_update(tier, mirrors, quiet, rng, VOCAB)
    tier.drain(timeout=120)
    assert tier[churned].session.store_obsolete_bytes() > 0
    tier.store_budget_bytes = 1            # force enforcement
    tier._enforce_budget()
    stats = tier.stats()
    assert stats["reclaimed_bytes"][churned] > 0
    assert stats["classes"][churned]["reclaimed_bytes"] > 0
    assert stats["over_budget"]            # no spill_dir: compaction only


def test_budget_spills_lru_after_compaction(tmp_path):
    tier = ServeTier(spill_dir=tmp_path)
    mirrors = _fleet(tier, 3, seed=91)
    _apply_rounds(tier, mirrors, rounds=2, seed=92)
    names = list(mirrors)
    events = []
    for i, n in enumerate(names):          # deterministic LRU order
        h = tier.handle(n)
        h.last_active = float(i)
        real_compact = h.ss.compact_store
        h.ss.compact_store = (lambda n=n, f=real_compact:
                              (events.append(("compact", n)), f())[1])
    real_spill = tier.spill.spill
    tier.spill.spill = lambda h: (events.append(("spill", h.name)),
                                  real_spill(h))[1]
    tier.store_budget_bytes = 1            # force enforcement
    tier._enforce_budget()
    kinds = [k for k, _ in events]
    assert kinds == ["compact"] * 3 + ["spill"] * 3    # compaction first
    assert [n for k, n in events if k == "spill"] == names   # LRU order
    assert all(h.spilled for h in tier.handles.values())
    assert tier.total_store_bytes() == 0
    snap = tier.stats()["spill"]
    assert snap["spills"] == 3 and snap["bytes_spilled"] > 0
    tier.store_budget_bytes = None
    _apply_rounds(tier, mirrors, rounds=1, seed=93)   # reload, stay exact
    assert not any(h.spilled for h in tier.handles.values())
    _check_bincount(tier, mirrors)


# ---------------------------------------------------------------------------
# tenant churn, the managed flag, the shim
# ---------------------------------------------------------------------------

def test_tenant_churn_add_remove_readd(tmp_path):
    before = threading.active_count()
    tier = ServeTier(spill_dir=tmp_path)
    mirrors = _fleet(tier, 3, seed=101)
    names = list(mirrors)
    with tier:
        _apply_rounds(tier, mirrors, rounds=1, seed=102)
        tier.spill.spill(tier.handle(names[0]))
        parked = tier.remove(names[0])
        assert parked.store_bytes() > 0
        rng = np.random.default_rng(103)
        loadgen.submit_update(tier, mirrors, names[1], rng, VOCAB)
        tier.drain(timeout=120)
        tier.add(parked, slo=SLOClass.throughput())
        assert tier.handle(names[0]).slo.kind == "throughput"
        _apply_rounds(tier, mirrors, rounds=1, seed=104)
    twin = ServeTier()
    twin_mirrors = _fleet(twin, 3, seed=101)
    _apply_rounds(twin, twin_mirrors, rounds=1, seed=102)
    rng = np.random.default_rng(103)
    loadgen.submit_update(twin, twin_mirrors, names[1], rng, VOCAB)
    twin.drain(timeout=120)
    _apply_rounds(twin, twin_mirrors, rounds=1, seed=104)
    for n in names:
        np.testing.assert_array_equal(tier[n].result["c"],
                                      twin[n].result["c"])
    _check_bincount(tier, mirrors)
    tier.stop()
    assert threading.active_count() == before          # no leaked threads
    with pytest.raises(ValueError, match="already registered"):
        tier.add(parked)


def test_drain_of_managed_tenant_never_steps(monkeypatch):
    tier = ServeTier()
    mirrors = _fleet(tier, 2, seed=111)
    name = list(mirrors)[0]
    ss = tier[name]
    assert ss._managed
    calls = []
    monkeypatch.setattr(ss, "step", lambda: calls.append(1) or False)
    rng = np.random.default_rng(112)
    loadgen.submit_update(tier, mirrors, name, rng, VOCAB)
    with pytest.raises(TimeoutError):
        ss.drain(timeout=0.05)             # no sweep runs: nothing drains
    with tier:                             # the tier's thread is consumer
        ss.drain(timeout=60)
    assert calls == []
    _check_bincount(tier, mirrors)


def test_multi_session_server_shim():
    from repro_torch.stream import MultiSessionServer

    with pytest.warns(DeprecationWarning,
                      match="repro_torch.serve.ServeTier"):
        server = MultiSessionServer(store_budget_bytes=64 * 1024)
    assert isinstance(server, ServeTier)
    assert not server.batch_refresh        # old per-tenant refresh path
    batched = ServeTier()
    mirrors = {}
    for tier in (server, batched):
        mirrors[tier] = _fleet(tier, 3, seed=121)
        with tier:
            _apply_rounds(tier, mirrors[tier], rounds=2, seed=122)
    stats = server.stats()
    for key in ("tenants", "total_store_bytes", "sweeps", "jit"):
        assert key in stats
    assert stats["batched_launches"] == 0
    for name, docs in mirrors[server].items():
        np.testing.assert_array_equal(server[name].result["c"],
                                      batched[name].result["c"])
        np.testing.assert_array_equal(server[name].result["c"],
                                      wc.oracle(docs, VOCAB))
    ss = StreamSession(*wc.make_job(np.zeros((2, 3), np.int32), VOCAB),
                       config=RunConfig(device="cpu"),
                       stream=StreamConfig(max_batch_delay=0.0))
    server.add(ss)
    assert server["session"]._managed
