"""Distributed execution on P logical shards: port vs port vs reference.

``RunConfig(mesh=MeshConfig(LocalMesh(...)))`` runs a job as P shards in
one process, on the CPU here (the kernels' plain versions).  The sizes are
those of the reference's ``tests/test_dist_refresh.py`` and
``tests/test_distributed.py`` (wordcount VOCAB 32 x 64 documents of 4
words; PageRank S 256, F 5).

Tolerances: the plain versions add in row order, and the received edges
are sorted by (K2, MK) before every Reduce and merge, so a port session at
P = 8 equals the port at P = 1 and the port's single-device session bit
for bit, for wordcount, SSSP and PageRank.  Against the reference's
single-device ``Session(backend="xla")``: wordcount and SSSP bitwise,
PageRank within 1e-5 (XLA's segment_sum may add in another order).  One
subprocess test runs the reference's own mesh (8 forced host devices) and
compares results, iteration counts and ``ShuffleStats`` with the port's
P = 8.
"""
import functools
import json
import os
import subprocess
import sys
import threading

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.api import RunConfig as JConfig, Session as JSession
from repro.api import make_delta as jmake_delta
from repro.apps import pagerank as jpr
from repro.apps import sssp as jsssp
from repro.apps import wordcount as jwc
import repro_torch.core.distributed as dist_mod
from repro_torch.api import (
    LocalMesh, MeshConfig, RunConfig, Session, StreamConfig, make_delta,
)
from repro_torch.apps import kmeans, pagerank as pr, sssp, wordcount as wc
from repro_torch.core.iterative import IterSpec
from repro_torch.kernels import count_launch, jitcache
from repro_torch.stream import StreamSession

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
VOCAB, L, N_DOCS = 32, 4, 64
S, F = 256, 5
MESH8 = LocalMesh({"data": 8})
PR_KW = dict(max_iters=60, tol=1e-7, cpc_threshold=5e-4,
             pdelta_threshold=1.0)


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """A meshed step is many small ops a shard; with the test workers
    sharing the cores, each op's fan-out over every core costs more than
    the op.  One intra-op thread for these tests, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _jspec(make_spec, *args):
    """One reference spec per app and size: the reference caches its
    compiled steps per spec, so sharing one spec compiles them once."""
    return make_spec(*args)


def _mesh(mesh=MESH8, **kw):
    # one merge thread: the CPU tests share the machine with other workers
    # (test_merge_workers_one_against_four compares 1 with 4)
    kw.setdefault("merge_workers", 1)
    return MeshConfig(mesh, **kw)


def _docs():
    return np.random.default_rng(7).integers(
        0, VOCAB, (N_DOCS, L)).astype(np.int32)


def _doc_deltas(docs, pairs=(4, 12, 4), seed=8):
    """'-' old then '+' new rows of random documents; returns the deltas
    (record ids, values, signs) and the corpus after each."""
    rng = np.random.default_rng(seed)
    mirror = docs.copy()
    out = []
    for n in pairs:
        rows = rng.choice(len(mirror), size=n, replace=False)
        new = rng.integers(0, VOCAB, (n, L)).astype(np.int32)
        buf = np.empty((2 * n, L), np.int32)
        buf[0::2], buf[1::2] = mirror[rows], new
        mirror[rows] = new
        out.append(((np.repeat(rows.astype(np.int32), 2), {"w": buf},
                     np.tile(np.int8([-1, 1]), n)), mirror.copy()))
    return out


def _graph():
    return pr.random_graph(S, F, seed=11, p_edge=0.5)


def _graph_deltas(nbrs, rows_each=(4, 4, 4), seed=5):
    rng = np.random.default_rng(seed)
    mirror = nbrs.copy()
    out = []
    for n in rows_each:
        rows = rng.choice(S, n, replace=False)
        new = np.where(rng.random((n, F)) < 0.5,
                       rng.integers(0, S, (n, F)), -1).astype(np.int32)
        buf = np.empty((2 * n, F), np.int32)
        buf[0::2], buf[1::2] = mirror[rows], new
        mirror[rows] = new
        out.append(((np.repeat(rows.astype(np.int32), 2), {"nbrs": buf},
                     np.tile(np.int8([-1, 1]), n)), mirror.copy()))
    return out


def _jdelta(rid, values, sign):
    return jmake_delta(rid, {n: jnp.asarray(a) for n, a in values.items()},
                       sign)


def _logs(rep):
    return [(l.iteration, l.n_input_changes, l.n_affected_dks, l.n_emitted,
             l.mrbg_on, l.io_reads, l.io_bytes) for l in rep.logs]


# ---------------------------------------------------------------------------
# The engine pieces
# ---------------------------------------------------------------------------

def test_partition_and_all_to_all():
    rng = np.random.default_rng(0)
    a = rng.random((37, 3)).astype(np.float32)
    parts = dist_mod.partition_state({"a": torch.from_numpy(a)}, 37, 8)
    assert parts["a"].shape == (8, 5, 3)
    for p in range(8):
        ids = np.arange(p, 37, 8)
        np.testing.assert_array_equal(parts["a"][p, :ids.size].numpy(),
                                      a[ids])
        assert not parts["a"][p, ids.size:].any()
    np.testing.assert_array_equal(
        dist_mod.unpartition_state(parts, 37)["a"].numpy(), a)

    # all_to_all: received[d] = concat over sources s of send[s, d]
    send = torch.arange(4 * 4 * 3 * 2).reshape(4, 4, 3, 2)
    recv = dist_mod.all_to_all(send)
    assert recv.shape == (4, 12, 2)
    for d in range(4):
        torch.testing.assert_close(
            recv[d], torch.cat([send[s, d] for s in range(4)]))

    # structure partitioning keeps input order per shard; overflow raises
    keys = np.arange(20, dtype=np.int32)
    valid = np.ones(20, bool)
    valid[3] = False
    k, v, ok = dist_mod.partition_struct(
        pr.make_spec(20), keys, {"x": keys * 10}, valid, 4, 8)
    for p in range(4):
        want = keys[(keys % 4 == p) & valid]
        np.testing.assert_array_equal(k[p, :want.size], want)
        np.testing.assert_array_equal(v["x"][p, :want.size], want * 10)
        assert ok[p].sum() == want.size
    with pytest.raises(ValueError, match="partition 0 overflow"):
        dist_mod.partition_struct(pr.make_spec(20), keys, {}, valid, 4, 2)


def test_exchange_buckets_in_emission_order_and_counts_drops():
    k2 = torch.tensor([5, 1, 3, 5, 2, 7, 1, 9], dtype=torch.int32)
    mk = torch.arange(8, dtype=torch.int32)
    valid = torch.tensor([1, 1, 1, 1, 0, 1, 1, 1], dtype=torch.bool)
    edges = dist_mod.Edges(k2, mk, {"v": mk.float()}, valid,
                           torch.ones(8, dtype=torch.int8))
    recv, sent, drop, cap = dist_mod._exchange([edges], 1, 3)
    # one shard: owner 0 for all; 7 valid edges, 3 fit
    assert (int(sent[0]), int(drop[0]), cap) == (3, 4, 3)
    np.testing.assert_array_equal(recv.mk[0].numpy(), [0, 1, 2])
    recv, sent, drop, cap = dist_mod._exchange([edges, edges], 2, None)
    assert cap == 8 and sent.tolist() == [7, 7] and drop.tolist() == [0, 0]
    # destination 1 (odd keys) receives source 0's then source 1's rows,
    # each in emission order
    odd = [0, 1, 2, 3, 5, 6, 7]
    np.testing.assert_array_equal(recv.mk[1][:7].numpy(), odd)
    np.testing.assert_array_equal(recv.mk[1][8:15].numpy(), odd)
    assert not recv.valid[1][7] and recv.k2[1][7] == 2**31 - 1
    assert not recv.valid[0].any()


def test_meshconfig_validation():
    mesh = LocalMesh({"pod": 2, "data": 4})
    mc = MeshConfig(mesh, axis="data", pod_axis="pod")
    assert mc.n_parts == 8
    assert dict(mesh.shape) == {"pod": 2, "data": 4}
    with pytest.raises(ValueError, match="axis"):
        MeshConfig(mesh, axis="model")
    with pytest.raises(ValueError, match="pod axis"):
        MeshConfig(mesh, pod_axis="rack")
    with pytest.raises(ValueError, match="differ"):
        MeshConfig(mesh, pod_axis="data")
    with pytest.raises(ValueError, match="shuffle_cap"):
        MeshConfig(mesh, shuffle_cap=0)
    with pytest.raises(ValueError, match="partition_cap"):
        MeshConfig(mesh, partition_cap=0)
    with pytest.raises(ValueError, match="refresh"):
        MeshConfig(mesh, refresh="lukewarm")
    with pytest.raises(ValueError, match="merge_workers"):
        MeshConfig(mesh, merge_workers=-1)
    with pytest.raises(ValueError, match="mesh"):
        MeshConfig(object())
    with pytest.raises(ValueError, match="size"):
        LocalMesh({"data": 0})
    with pytest.raises(AttributeError):
        mesh.shape = {}
    with pytest.raises(TypeError, match="MeshConfig"):
        RunConfig(mesh=mesh)
    cfg = RunConfig(device="cpu", mesh=mc)
    assert cfg.mesh is mc and cfg.replace(tol=1e-5).mesh is mc


def test_replicate_state_is_refused():
    spec = kmeans.make_spec(2, 2, np.zeros((2, 2), np.float32))
    with pytest.raises(ValueError, match="replicate_state"):
        Session(spec, RunConfig(device="cpu", mesh=_mesh()))
    # a JobSpec with a mesh drives the per-shard one-step engine
    sess = Session(wc.make_spec(4), RunConfig(device="cpu", mesh=_mesh()))
    assert sess._driver.kind == "distributed-onestep"


def test_launch_and_trace_counts_are_exact_under_threads():
    def fake():
        pass
    fake.launches = 0
    from collections import Counter
    fake.shapes = Counter()

    def bump():
        for _ in range(2000):
            count_launch(fake, (1, 2))

    # more threads than cores, switching often: a lost update would show
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ts = [threading.Thread(target=bump) for _ in range(32)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in ts)
    assert fake.launches == 64000 and fake.shapes[(1, 2)] == 64000

    # a step traces once per input signature, not once per call
    step = dist_mod._Traced("distributed.test", lambda x: x)
    before = jitcache.trace_counts().get("distributed.test", 0)
    for n in (4, 4, 8, 4):
        step(torch.zeros(n))
    assert jitcache.trace_counts()["distributed.test"] - before == 2


# ---------------------------------------------------------------------------
# One-step: wordcount, bitwise against everything
# ---------------------------------------------------------------------------

def test_onestep_update_parity_bitwise():
    docs = _docs()
    spec, data = wc.make_job(docs, VOCAB)
    cfg = dict(device="cpu", value_bytes=4)
    single = Session(spec, RunConfig(onestep_path="mrbg", **cfg))
    ref = JSession(_jspec(jwc.make_spec, VOCAB),
                   JConfig(backend="xla", onestep_path="mrbg",
                           value_bytes=4))
    meshed = [Session(spec, RunConfig(mesh=_mesh(LocalMesh({"data": p})),
                                      **cfg)) for p in (1, 8)]
    single.run(data)
    ref.run(jwc.make_job(docs, VOCAB)[1])
    for s in meshed:
        rep = s.run(data)
        assert rep.mode == "distributed"
        assert rep.shuffle.edges_exchanged == N_DOCS * L
        assert rep.shuffle.bytes_moved == N_DOCS * L * 14
    for delta, cur in _doc_deltas(docs):
        r1 = single.update(make_delta(*delta))
        ref.update(_jdelta(*delta))
        for s in meshed:
            r2 = s.update(make_delta(*delta))
            assert r2.mode == "distributed-incr"
            assert r2.shuffle.edges_exchanged == delta[0].size * L
            assert r2.shuffle.bytes_moved == r2.shuffle.edges_exchanged * 14
            assert r2.affected_keys == r1.affected_keys
            np.testing.assert_array_equal(s.result["c"], single.result["c"])
            np.testing.assert_array_equal(s.result["c"],
                                          np.asarray(ref.result["c"]))
            np.testing.assert_array_equal(r2.counts, r1.counts)
        np.testing.assert_array_equal(meshed[1].result["c"],
                                      wc.oracle(cur, VOCAB))
    assert len(meshed[1].stores) == 8
    assert meshed[1].store is None and meshed[1].store_bytes() > 0


def test_pod_axis_flattens_like_a_flat_mesh():
    docs = _docs()
    spec, data = wc.make_job(docs, VOCAB)
    pod = _mesh(LocalMesh({"pod": 2, "data": 4}), pod_axis="pod")
    flat, podded = (Session(spec, RunConfig(device="cpu", mesh=m))
                    for m in (_mesh(), pod))
    for s in (flat, podded):
        s.run(data)
    delta = _doc_deltas(docs)[0][0]
    r1, r2 = (s.update(make_delta(*delta)) for s in (flat, podded))
    np.testing.assert_array_equal(flat.result["c"], podded.result["c"])
    key = lambda sh: (sh.edges_exchanged, sh.bytes_moved, sh.shuffle_cap,
                      sh.regrows)
    assert key(r1.shuffle) == key(r2.shuffle)

    # the converge loop too
    nbrs = _graph()
    spec, struct = pr.make_job(nbrs)
    out = []
    for m in (_mesh(shuffle_cap=512), pod.replace(shuffle_cap=512)):
        s = Session(spec, RunConfig(device="cpu", mesh=m, **PR_KW))
        s.run(struct)
        s.update(make_delta(*_graph_deltas(nbrs)[0][0]))
        out.append(s.result["r"])
    np.testing.assert_array_equal(out[0], out[1])


# ---------------------------------------------------------------------------
# Iterative: PageRank and SSSP
# ---------------------------------------------------------------------------

def test_iterative_cpc_update_parity():
    nbrs = _graph()
    spec, struct = pr.make_job(nbrs)
    single = Session(spec, RunConfig(device="cpu", **PR_KW))
    ref = JSession(_jspec(jpr.make_spec, S), JConfig(backend="xla", **PR_KW))
    meshed = [Session(spec, RunConfig(
        device="cpu", mesh=_mesh(LocalMesh({"data": p}), shuffle_cap=512),
        **PR_KW)) for p in (1, 8)]
    r1 = single.run(struct)
    ref.run(jpr.make_struct(nbrs))
    for s in meshed:
        r2 = s.run(struct)
        assert (r2.mode, r2.iters) == ("distributed", r1.iters)
        assert r2.max_change == r1.max_change
        np.testing.assert_array_equal(s.result["r"], single.result["r"])
    np.testing.assert_allclose(meshed[1].result["r"],
                               np.asarray(ref.result["r"]), atol=1e-5)
    for i, (delta, _) in enumerate(_graph_deltas(nbrs)):
        r1 = single.update(make_delta(*delta))
        assert r1.mode == "i2"
        if i == 0:
            # the reference compiles each new refresh shape, so it takes
            # one update here (the mesh test below takes two more)
            ref.update(_jdelta(*delta))
            np.testing.assert_allclose(single.result["r"],
                                       np.asarray(ref.result["r"]), atol=1e-5)
        for s in meshed:
            r2 = s.update(make_delta(*delta))
            assert r2.mode == "distributed-i2" and r2.iters == r1.iters
            assert [(l.n_affected_dks, l.n_emitted) for l in r2.logs] == \
                [(l.n_affected_dks, l.n_emitted) for l in r1.logs]
            np.testing.assert_array_equal(s.result["r"], single.result["r"])
            assert r2.shuffle.edges_exchanged > 0


def test_sssp_parity_bitwise():
    v = 96
    nbrs, w = sssp.random_weighted_graph(v, 4, seed=2)
    spec, struct = sssp.make_job(nbrs, w, 0)
    single = Session(spec, RunConfig(device="cpu"))
    ref = JSession(_jspec(jsssp.make_spec, v), JConfig(backend="xla"))
    meshed = Session(spec, RunConfig(device="cpu", mesh=_mesh()))
    r1, r2 = single.run(struct), meshed.run(struct)
    ref.run(jsssp.make_struct(nbrs, w, 0))
    assert (r2.mode, r2.iters) == ("distributed", r1.iters)
    np.testing.assert_array_equal(meshed.result["d"], single.result["d"])
    np.testing.assert_array_equal(meshed.result["d"],
                                  np.asarray(ref.result["d"]))
    # delete 30% of 10 rows' slots, then every in-edge of one vertex
    rng = np.random.default_rng(9)
    cur = nbrs.copy()
    d = sssp.oracle(cur, w, 0)
    target = int(np.nonzero((d > 0) & (d < sssp.INF / 2))[0][-1])
    rows_a = rng.choice(v, 10, replace=False)
    new_a = cur[rows_a].copy()
    new_a[rng.random(new_a.shape) < 0.3] = -1
    for rows, new in ((rows_a, new_a), (None, None)):
        if rows is None:
            rows = np.nonzero((cur == target).any(axis=1))[0]
            new = np.where(cur[rows] == target, -1, cur[rows]).astype(
                np.int32)
        k = rows.size
        nb = np.empty((2 * k, 4), np.int32)
        nb[0::2], nb[1::2] = cur[rows], new
        delta = (np.repeat(rows + 1, 2).astype(np.int32),
                 {"nbrs": nb, "w": np.repeat(w[rows], 2, axis=0)},
                 np.tile(np.int8([-1, 1]), k))
        cur[rows] = new
        r1 = single.update(make_delta(*delta))
        r2 = meshed.update(make_delta(*delta))
        ref.update(_jdelta(*delta))
        assert (r1.mode, r2.mode) == ("i2", "distributed-i2")
        assert r2.iters == r1.iters
        np.testing.assert_array_equal(meshed.result["d"], single.result["d"])
        np.testing.assert_array_equal(meshed.result["d"],
                                      np.asarray(ref.result["d"]))
        np.testing.assert_allclose(
            np.minimum(meshed.result["d"], sssp.INF), sssp.oracle(cur, w, 0),
            rtol=1e-5)
    assert meshed.result["d"][target] == np.inf


def test_fallback_parity_bitwise():
    """P_delta past the threshold: the meshed session falls back like the
    single-device engine (same bits) and re-seeds its slices."""
    nbrs = _graph()
    spec, struct = pr.make_job(nbrs)
    kw = dict(PR_KW, pdelta_threshold=0.05)
    single = Session(spec, RunConfig(device="cpu", **kw))
    meshed = Session(spec, RunConfig(device="cpu",
                                     mesh=_mesh(shuffle_cap=512), **kw))
    single.run(struct)
    meshed.run(struct)
    (big, _), (small, _) = _graph_deltas(nbrs, rows_each=(32, 2))
    r1, r2 = single.update(make_delta(*big)), meshed.update(make_delta(*big))
    assert (r1.mode, r2.mode) == ("iterMR-fallback", "distributed-warm")
    np.testing.assert_array_equal(meshed.result["r"], single.result["r"])
    assert meshed._driver.mrbg_on and meshed._driver.stores
    r1 = single.update(make_delta(*small))
    r2 = meshed.update(make_delta(*small))
    mode_map = {"i2": "distributed-i2", "iterMR-fallback": "distributed-warm"}
    assert r2.mode == mode_map[r1.mode]
    np.testing.assert_array_equal(meshed.result["r"], single.result["r"])


def test_warm_refresh_and_unstable_topology():
    """refresh="warm", or a Map whose topology is not stable, re-converges
    from the current state: mode distributed-warm, the same result as a
    warm re-converge at P = 1."""
    nbrs = _graph()
    spec, struct = pr.make_job(nbrs)
    unstable = IterSpec(spec.map_fn, spec.reducer, spec.project,
                        spec.num_state, spec.init_state, spec.difference,
                        stable_topology=False, name="pagerank")
    sessions = [
        Session(spec, RunConfig(device="cpu", mesh=_mesh(
            LocalMesh({"data": 1}), shuffle_cap=512, refresh="warm"),
            **PR_KW)),
        Session(spec, RunConfig(device="cpu", mesh=_mesh(
            shuffle_cap=512, refresh="warm"), **PR_KW)),
        Session(unstable, RunConfig(device="cpu",
                                    mesh=_mesh(shuffle_cap=512), **PR_KW))]
    delta = _graph_deltas(nbrs)[0][0]
    for s in sessions:
        s.run(struct)
        rep = s.update(make_delta(*delta))
        assert rep.mode == "distributed-warm" and not rep.logs
        assert s._driver.stores is None
        np.testing.assert_array_equal(s.result["r"],
                                      sessions[0].result["r"])


# ---------------------------------------------------------------------------
# Failure atomicity, capacity overflow and regrow
# ---------------------------------------------------------------------------

def test_update_failure_rolls_back(monkeypatch):
    nbrs = _graph()
    spec, struct = pr.make_job(nbrs)
    s = Session(spec, RunConfig(device="cpu", mesh=_mesh(shuffle_cap=512),
                                **PR_KW))
    s.run(struct)
    before = s.result["r"].copy()
    bytes_before = s.store_bytes()
    delta = _graph_deltas(nbrs)[0][0]

    orig = dist_mod.merge_shard_delta
    calls = []

    def bomb(*a, **k):
        if len(calls) >= 2:        # after two shards already merged
            raise RuntimeError("injected merge failure")
        calls.append(1)
        return orig(*a, **k)

    monkeypatch.setattr(dist_mod, "merge_shard_delta", bomb)
    with pytest.raises(RuntimeError, match="injected"):
        s.update(make_delta(*delta))
    monkeypatch.setattr(dist_mod, "merge_shard_delta", orig)
    np.testing.assert_array_equal(s.result["r"], before)
    assert s.store_bytes() == bytes_before and s.epoch == 0
    assert s.update(make_delta(*delta)).mode == "distributed-i2"

    # the warm path: the converge itself dies
    warm = Session(spec, RunConfig(device="cpu", mesh=_mesh(
        shuffle_cap=512, refresh="warm"), **PR_KW))
    warm.run(struct)
    wbefore = warm.result["r"].copy()

    def boom(*a, **k):
        raise RuntimeError("shuffle capacity overflow: injected")

    monkeypatch.setattr(dist_mod, "run_distributed", boom)
    with pytest.raises(RuntimeError, match="injected"):
        warm.update(make_delta(*delta))
    monkeypatch.undo()
    np.testing.assert_array_equal(warm.result["r"], wbefore)
    np.testing.assert_array_equal(warm._driver._keys, struct.keys.numpy())
    assert warm.update(make_delta(*delta)).mode == "distributed-warm"


def test_overflow_raises_without_auto_grow_and_regrows_with_it():
    nbrs = _graph()
    spec, struct = pr.make_job(nbrs)
    with pytest.raises(RuntimeError, match="overflow"):
        Session(spec, RunConfig(
            device="cpu", max_iters=2,
            mesh=_mesh(shuffle_cap=2, auto_grow=False))).run(struct)
    grown = Session(spec, RunConfig(device="cpu", max_iters=60, tol=1e-7,
                                    mesh=_mesh(shuffle_cap=2)))
    rep = grown.run(struct)
    assert rep.shuffle.regrows >= 1 and rep.shuffle.shuffle_cap > 2
    single = Session(spec, RunConfig(device="cpu", max_iters=60, tol=1e-7))
    single.run(struct)
    np.testing.assert_array_equal(grown.result["r"], single.result["r"])


# ---------------------------------------------------------------------------
# Threads, traces, streaming
# ---------------------------------------------------------------------------

def test_merge_workers_one_against_four():
    nbrs = _graph()
    spec, struct = pr.make_job(nbrs)
    out = []
    for workers in (1, 4):
        s = Session(spec, RunConfig(device="cpu", mesh=_mesh(
            shuffle_cap=512, merge_workers=workers), **PR_KW))
        s.run(struct)
        reps = [s.update(make_delta(*d)) for d, _ in _graph_deltas(nbrs)]
        out.append((s.result["r"], [(r.mode, r.iters, _logs(r))
                                    for r in reps], s.store_bytes()))
    np.testing.assert_array_equal(out[0][0], out[1][0])
    assert out[0][1:] == out[1][1:]


def test_delta_exchange_zero_steady_retrace():
    docs = _docs()
    spec, data = wc.make_job(docs, VOCAB)
    s = Session(spec, RunConfig(device="cpu", mesh=_mesh(), value_bytes=4))
    s.run(data)
    deltas = _doc_deltas(docs, pairs=(4, 12, 24, 3, 10, 20))
    for delta, _ in deltas[:3]:               # warm the row buckets
        s.update(make_delta(*delta))
    gen0 = jitcache.generation()
    for delta, cur in deltas[3:]:             # same buckets, other sizes
        s.update(make_delta(*delta))
    assert jitcache.generation() == gen0, jitcache.trace_counts()
    np.testing.assert_array_equal(s.result["c"], wc.oracle(cur, VOCAB))


def test_meshed_stream_session_prewarm():
    """Prewarm goes through ``session.update``, so it covers the delta
    exchange's bucket ladder: the first real batch traces nothing."""
    docs = _docs()
    ss = StreamSession(*wc.make_job(docs, VOCAB),
                       config=RunConfig(device="cpu", mesh=_mesh(),
                                        value_bytes=4),
                       stream=StreamConfig(max_batch_delay=0.0,
                                           crossover=2.0,
                                           max_batch_records=64,
                                           prewarm=True))
    ss.start(background=False)
    gen0 = jitcache.generation()
    (rid, values, sign), cur = _doc_deltas(docs, pairs=(32,))[0]
    ss.submit(rid, values, sign)
    assert ss.step()
    assert jitcache.generation() == gen0, jitcache.trace_counts()
    assert ss.metrics.retrace_batches == 0
    assert ss.report().mode == "distributed-incr"
    np.testing.assert_array_equal(ss.result["c"], wc.oracle(cur, VOCAB))


# ---------------------------------------------------------------------------
# The reference's own mesh, 8 forced host devices
# ---------------------------------------------------------------------------

_REF_SCRIPT = """
import json, sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh
from repro.api import Session, RunConfig, MeshConfig, make_delta
from repro.apps import pagerank as pr, wordcount as wc
z = np.load(sys.argv[1])
mesh = Mesh(np.array(jax.devices()[:8]), ("data",))

def stats(rep):
    sh = rep.shuffle
    return {"mode": rep.mode, "iters": rep.iters,
            "edges": sh.edges_exchanged, "bytes": sh.bytes_moved,
            "cap": sh.shuffle_cap, "regrows": sh.regrows}

def drive(spec, data, cfg, deltas, key):
    s = Session(spec, cfg)
    out = [stats(s.run(data))]
    res = [np.asarray(s.result[key]).tolist()]
    for rid, vals, sign in deltas:
        out.append(stats(s.update(make_delta(
            rid, {n: jnp.asarray(a) for n, a in vals.items()}, sign))))
        res.append(np.asarray(s.result[key]).tolist())
    return {"stats": out, "results": res}

n_wc, n_pr = int(z["n_wc"]), int(z["n_pr"])
wc_d = [(z[f"wc_rid{i}"], {"w": z[f"wc_w{i}"]}, z[f"wc_sign{i}"])
        for i in range(n_wc)]
pr_d = [(z[f"pr_rid{i}"], {"nbrs": z[f"pr_n{i}"]}, z[f"pr_sign{i}"])
        for i in range(n_pr)]
out = {
    "wc": drive(*wc.make_job(z["docs"], int(z["vocab"])),
                RunConfig(backend="xla", value_bytes=4,
                          mesh=MeshConfig(mesh)), wc_d, "c"),
    "pr": drive(*pr.make_job(z["nbrs"]),
                RunConfig(backend="xla", mesh=MeshConfig(mesh, shuffle_cap=16),
                          **json.loads(sys.argv[2])), pr_d, "r"),
}
print("RESULT " + json.dumps(out))
"""


def _stats(rep):
    sh = rep.shuffle
    return {"mode": rep.mode, "iters": rep.iters,
            "edges": sh.edges_exchanged, "bytes": sh.bytes_moved,
            "cap": sh.shuffle_cap, "regrows": sh.regrows}


def test_shuffle_stats_match_reference_mesh(tmp_path):
    docs, nbrs = _docs(), _graph()
    wc_d = [d for d, _ in _doc_deltas(docs, pairs=(4, 12))]
    pr_d = [d for d, _ in _graph_deltas(nbrs, rows_each=(4, 4))]
    arrays = {"docs": docs, "vocab": VOCAB, "nbrs": nbrs,
              "n_wc": len(wc_d), "n_pr": len(pr_d)}
    for i, (rid, v, sign) in enumerate(wc_d):
        arrays.update({f"wc_rid{i}": rid, f"wc_w{i}": v["w"],
                       f"wc_sign{i}": sign})
    for i, (rid, v, sign) in enumerate(pr_d):
        arrays.update({f"pr_rid{i}": rid, f"pr_n{i}": v["nbrs"],
                       f"pr_sign{i}": sign})
    np.savez(tmp_path / "case.npz", **arrays)
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu", PYTHONPATH=SRC)
    r = subprocess.run([sys.executable, "-c", _REF_SCRIPT,
                        str(tmp_path / "case.npz"), json.dumps(PR_KW)],
                       capture_output=True, text=True, env=env, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    want = json.loads(r.stdout.split("RESULT ", 1)[1])

    def drive(spec, data, cfg, deltas, key):
        s = Session(spec, cfg)
        stats = [_stats(s.run(data))]
        res = [s.result[key]]
        for d in deltas:
            stats.append(_stats(s.update(make_delta(*d))))
            res.append(s.result[key])
        return stats, res

    stats, res = drive(*wc.make_job(docs, VOCAB),
                       RunConfig(device="cpu", value_bytes=4, mesh=_mesh()),
                       wc_d, "c")
    assert stats == want["wc"]["stats"]
    for got, exp in zip(res, want["wc"]["results"]):
        np.testing.assert_array_equal(got, np.asarray(exp, np.float32))
    stats, res = drive(*pr.make_job(nbrs),
                       RunConfig(device="cpu", mesh=_mesh(shuffle_cap=16),
                                 **PR_KW), pr_d, "r")
    assert stats == want["pr"]["stats"]
    assert stats[0]["regrows"] >= 1
    for got, exp in zip(res, want["pr"]["results"]):
        np.testing.assert_allclose(got, np.asarray(exp, np.float32),
                                   atol=1e-5)
