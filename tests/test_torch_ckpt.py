"""Checkpoint and restore across packages, and the rest of ``Session``.

A snapshot written by ``repro`` (backend="xla") at epoch 1 restores in
``repro_torch`` (on the CPU, the kernels' plain versions), and the
reverse, for every kind: ``onestep-mrbg`` and ``onestep-accumulator``
(wordcount), ``incr-iter`` (SSSP and PageRank), ``plain-iter`` (SSSP),
the meshed ``distributed`` (PageRank) and ``distributed-onestep``
(wordcount), and ``query``.  The restored session equals the writer, and
its next ``update`` equals the writer's next ``update``: bitwise for
wordcount and SSSP, within 1e-5 for PageRank (the packages may add floats
in another order, as ``tests/test_torch_iterative.py`` holds it).  Then
the rest of the surface: the auto-checkpoint cadence, ``rerun`` against a
fresh ``run``, the store accounting against the reference's,
``absorb_refresh``, ``core.ft`` and ``kernels.jitcache``.
"""
import json

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.api import RunConfig as JConfig, Session as JSession
from repro.api import make_delta as jmake_delta
from repro.apps import pagerank as jpr
from repro.apps import sssp as jsssp
from repro.apps import wordcount as jwc
from repro.core import ft as jft
from repro_torch.api import RunConfig, Session, make_delta
from repro_torch.apps import pagerank as pr
from repro_torch.apps import sssp
from repro_torch.apps import wordcount as wc
from repro_torch.core import ft
from repro_torch.kernels import jitcache

VOCAB, N, L = 40, 32, 6
V = 64


def _wc_case(rng):
    docs = rng.integers(0, VOCAB, (N, L)).astype(np.int32)
    deltas = []
    cur = docs.copy()
    for rows in ([1, 4, 9], [4, 20, 30, 31]):
        new = rng.integers(0, VOCAB, (len(rows), L)).astype(np.int32)
        w = np.empty((2 * len(rows), L), np.int32)
        w[0::2], w[1::2] = cur[rows], new
        cur[rows] = new
        deltas.append((np.repeat(rows, 2).astype(np.int32), {"w": w},
                       np.tile(np.int8([-1, 1]), len(rows))))
    return ((wc.make_spec(VOCAB), wc.make_input(np.arange(N), docs)),
            (jwc.make_spec(VOCAB), jwc.make_input(np.arange(N), docs)),
            deltas)


def _sssp_case(rng):
    nbrs, w = sssp.random_weighted_graph(V, 4, seed=2)
    deltas, cur = [], nbrs.copy()
    for _ in range(2):
        rows = rng.choice(V, 5, replace=False)
        new = cur[rows].copy()
        new[rng.random(new.shape) < 0.4] = -1
        nb = np.empty((10, 4), np.int32)
        nb[0::2], nb[1::2] = cur[rows], new
        cur[rows] = new
        deltas.append((np.repeat(rows + 1, 2).astype(np.int32),
                       {"nbrs": nb, "w": np.repeat(w[rows], 2, axis=0)},
                       np.tile(np.int8([-1, 1]), 5)))
    return ((sssp.make_spec(V), sssp.make_struct(nbrs, w, 0)),
            (jsssp.make_spec(V), jsssp.make_struct(nbrs, w, 0)), deltas)


def _pagerank_case(rng):
    nbrs = pr.random_graph(V, 4, seed=3)
    deltas, cur = [], nbrs.copy()
    mut = pr.graph_mutator(V)
    for _ in range(2):
        rows = np.sort(rng.choice(V, 2, replace=False))
        new = mut(rng, rows, {"nbrs": cur[rows]})["nbrs"]
        nb = np.empty((4, 4), np.int32)
        nb[0::2], nb[1::2] = cur[rows], new
        cur[rows] = new
        deltas.append((np.repeat(rows, 2).astype(np.int32), {"nbrs": nb},
                       np.tile(np.int8([-1, 1]), 2)))
    return ((pr.make_spec(V), pr.make_struct(nbrs)),
            (jpr.make_spec(V), jpr.make_struct(nbrs)), deltas)


# kind -> (case, config knobs, tolerance: 0 = bitwise)
CASES = {
    "onestep-mrbg": (_wc_case, {"onestep_path": "mrbg"}, 0),
    "onestep-accumulator": (_wc_case, {"onestep_path": "accumulator"}, 0),
    "incr-iter-sssp": (_sssp_case, {}, 0),
    "incr-iter-pagerank": (_pagerank_case, {"cpc_threshold": 1e-4}, 1e-5),
    "plain-iter": (_sssp_case, {"plain_shuffle": True}, 0),
}


class _Side:
    """One package's Session constructors, so a test can swap writer and
    reader."""

    def __init__(self, port: bool, knobs: dict):
        self.port = port
        self.knobs = knobs
        self.cls = Session if port else JSession

    def config(self, **kw):
        if self.port:
            return RunConfig(device="cpu", **self.knobs, **kw)
        return JConfig(backend="xla", **self.knobs, **kw)

    def delta(self, rid, values, sign):
        if self.port:
            return make_delta(rid, values, sign)
        return jmake_delta(
            rid, {n: jnp.asarray(a) for n, a in values.items()}, sign)


def _same(got, want, tol):
    assert got.keys() == want.keys()
    for n in want:
        g, w = np.asarray(got[n]), np.asarray(want[n])
        if tol:
            np.testing.assert_allclose(g, w, rtol=0, atol=tol)
        else:
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("writer", ["repro", "repro_torch"])
@pytest.mark.parametrize("kind", list(CASES))
def test_checkpoint_restores_across_packages(tmp_path, kind, writer):
    make, knobs, tol = CASES[kind]
    port_job, ref_job, deltas = make(np.random.default_rng(0))
    w_side = _Side(writer == "repro_torch", knobs)
    r_side = _Side(writer != "repro_torch", knobs)
    (w_spec, w_data), (r_spec, _) = ((port_job, ref_job) if w_side.port
                                     else (ref_job, port_job))
    w = w_side.cls(w_spec, w_side.config())
    w.run(w_data)
    w.update(w_side.delta(*deltas[0]))
    w.checkpoint(str(tmp_path))
    meta = json.loads((tmp_path / "session.json").read_text())
    assert meta["kind"] == ("incr-iter" if kind.startswith("incr-iter")
                            else kind)

    r = r_side.cls.restore(r_spec, str(tmp_path), r_side.config())
    assert r.epoch == w.epoch == 1
    _same(r.result, w.result, tol)
    got = r.update(r_side.delta(*deltas[1]))
    want = w.update(w_side.delta(*deltas[1]))
    _same(r.result, w.result, tol)
    assert (got.mode, got.epoch) == (want.mode, want.epoch)
    if kind == "onestep-mrbg":
        assert (got.store_bytes, got.live_bytes, got.affected_keys) == \
            (want.store_bytes, want.live_bytes, want.affected_keys)
        np.testing.assert_array_equal(got.counts, want.counts)


def test_auto_checkpoint_cadence_and_restore(tmp_path):
    (spec, data), _, deltas = _wc_case(np.random.default_rng(1))
    s = Session(spec, RunConfig(device="cpu", onestep_path="mrbg",
                                checkpoint_dir=str(tmp_path),
                                checkpoint_every=2))
    s.run(data)
    for d in deltas + deltas[:1]:
        s.update(make_delta(*d))
    assert sorted(p.name for p in tmp_path.glob("ep_*")) == \
        ["ep_000000", "ep_000002"]
    r = Session.restore(spec, str(tmp_path), RunConfig(device="cpu"))
    assert r.epoch == 2 and r.report().mode == "incremental"
    with pytest.raises(ValueError, match="no checkpoint path"):
        Session(spec, RunConfig(device="cpu")).checkpoint()


@pytest.fixture
def one_intra_op_thread():
    """Meshed sessions run many small ops a shard; with the test workers
    sharing the cores, one intra-op thread (restored after) keeps them
    from fanning each op out over every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_restore_of_kinds_not_ported_raises(tmp_path, one_intra_op_thread):
    # every kind is ported now.  The distributed kinds restore across
    # packages: the reference on an in-process mesh of one device (P = 1)
    # into the port and back; the port at P = 8 into the port
    import jax
    from jax.sharding import Mesh
    from repro.api import MeshConfig as JMesh
    from repro_torch.api import LocalMesh, MeshConfig
    jmesh = JMesh(Mesh(np.array(jax.devices()[:1]), ("data",)),
                  shuffle_cap=512)
    port_mesh = lambda p: MeshConfig(LocalMesh({"data": p}), shuffle_cap=512,
                                     merge_workers=1)
    for kind, case in (("distributed", "incr-iter-pagerank"),
                       ("distributed-onestep", "onestep-mrbg")):
        make, knobs, tol = CASES[case]
        (spec, data), (jspec, jdata), deltas = make(np.random.default_rng(0))
        jside, pside = _Side(False, knobs), _Side(True, knobs)
        ref = JSession(jspec, jside.config(mesh=jmesh))
        ref.run(jdata)
        ref.update(jside.delta(*deltas[0]))
        ref.checkpoint(str(tmp_path / kind / "ref"))
        assert json.loads((tmp_path / kind / "ref" / "session.json")
                          .read_text())["kind"] == kind
        got = Session.restore(spec, str(tmp_path / kind / "ref"),
                              pside.config(mesh=port_mesh(1)))
        assert got.epoch == 1 and len(got.stores) == 1
        _same(got.result, ref.result, tol)
        g = got.update(pside.delta(*deltas[1]))
        w = ref.update(jside.delta(*deltas[1]))
        assert g.mode == w.mode
        _same(got.result, ref.result, tol)
        got.checkpoint(str(tmp_path / kind / "port1"))
        back = JSession.restore(jspec, str(tmp_path / kind / "port1"),
                                jside.config(mesh=jmesh))
        assert back.epoch == 2 and len(back.stores) == 1
        _same(back.result, got.result, 0)

        # the port at P = 8, restored at P = 8: bitwise, stores included
        w8 = Session(spec, pside.config(mesh=port_mesh(8)))
        w8.run(data)
        w8.update(pside.delta(*deltas[0]))
        w8.checkpoint(str(tmp_path / kind / "port8"))
        r8 = Session.restore(spec, str(tmp_path / kind / "port8"),
                             pside.config(mesh=port_mesh(8)))
        assert r8.store_bytes() == w8.store_bytes()
        _same(r8.result, w8.result, 0)
        g, w = (s.update(pside.delta(*deltas[1])) for s in (r8, w8))
        assert g.mode == w.mode and g.mode.startswith("distributed-")
        _same(r8.result, w8.result, 0)
        with pytest.raises(ValueError, match="RunConfig\\(mesh"):
            Session.restore(spec, str(tmp_path / kind / "port8"),
                            pside.config())

    # another part count: a one-step snapshot cannot re-key its slices
    # and raises; an iterative one drops them and re-converges warm
    spec = wc.make_spec(VOCAB)
    with pytest.raises(ValueError, match="same part count"):
        Session.restore(spec, str(tmp_path / "distributed-onestep" / "port8"),
                        RunConfig(device="cpu", mesh=port_mesh(4)))
    make, knobs, tol = CASES["incr-iter-pagerank"]
    (spec, _), _, deltas = make(np.random.default_rng(0))
    r4 = Session.restore(spec, str(tmp_path / "distributed" / "port8"),
                         RunConfig(device="cpu", mesh=port_mesh(4), **knobs))
    assert r4.stores == []
    assert r4.update(make_delta(*deltas[1])).mode == "distributed-warm"
    assert len(r4.stores) == 4
    with pytest.raises(TypeError, match="MeshConfig"):
        RunConfig(mesh=object())

    # the query kind is ported: a reference snapshot restores here, and a
    # spec that is no engine kind is refused by type
    from repro.dql import workloads as jwl
    from repro_torch.dql import Query, workloads as wl
    users = 16
    ref = jwl.join_query(users).compile(JConfig(backend="xla"))
    ref.run(jwl.join_data(users, seed=2))
    ref.checkpoint(str(tmp_path / "q"))
    got = Query.restore(wl.join_query(users), str(tmp_path / "q"),
                        RunConfig(device="cpu"))
    assert got.session.epoch == 0 and got.report().mode == "query"
    vals, valid = got.relation()
    ovals, ovalid = wl.join_oracle(wl.join_data(users, seed=2))
    np.testing.assert_array_equal(valid, ovalid)
    for c in ovals:
        np.testing.assert_array_equal(np.where(valid, vals[c], 0), ovals[c])

    class QuerySpec:
        name = "q"
    with pytest.raises(TypeError, match="QuerySpec"):
        Session(QuerySpec(), RunConfig(device="cpu"))


@pytest.mark.parametrize("path", ["mrbg", "accumulator"])
def test_rerun_equals_fresh_run(path):
    rng = np.random.default_rng(2)
    (spec, data), _, deltas = _wc_case(rng)
    cfg = RunConfig(device="cpu", onestep_path=path)
    s = Session(spec, cfg)
    s.run(data)
    s.update(make_delta(*deltas[0]))
    docs = rng.integers(0, VOCAB, (N, L)).astype(np.int32)
    rep = s.rerun(wc.make_input(np.arange(N), docs))
    assert (rep.epoch, rep.mode, len(s.history)) == (2, "onestep", 3)
    fresh = Session(spec, cfg)
    fresh.run(wc.make_input(np.arange(N), docs))
    _same(s.result, fresh.result, 0)
    np.testing.assert_array_equal(s.result["c"], wc.oracle(docs, VOCAB))
    # the rerun's fresh preserved state takes the next update
    s.update(make_delta(*deltas[1]))
    fresh.update(make_delta(*deltas[1]))
    _same(s.result, fresh.result, 0)


def test_store_accounting_matches_reference():
    (spec, data), (jspec, jdata), deltas = _wc_case(np.random.default_rng(3))
    port = Session(spec, RunConfig(device="cpu", onestep_path="mrbg"))
    ref = JSession(jspec, JConfig(backend="xla", onestep_path="mrbg"))
    port.run(data)
    ref.run(jdata)
    side = _Side(False, {})
    for d in deltas + deltas:
        port.update(make_delta(*d))
        ref.update(side.delta(*d))

    def acct(s):
        return (len(s.stores), s.store_bytes(), s.store_live_bytes(),
                s.store_obsolete_bytes())
    assert acct(port) == acct(ref) and port.store_obsolete_bytes() > 0
    assert port.compact_store() == ref.compact_store() > 0
    assert acct(port) == acct(ref) and port.store_obsolete_bytes() == 0
    acc = Session(spec, RunConfig(device="cpu"))
    acc.run(data)
    assert acct(acc) == (0, 0, 0, 0) and acc.compact_store() == 0


def test_absorb_refresh_advances_epoch_and_history():
    (spec, data), _, _ = _wc_case(np.random.default_rng(4))
    s = Session(spec, RunConfig(device="cpu"))
    with pytest.raises(RuntimeError, match="before run"):
        s.absorb_refresh(0.1)
    with pytest.raises(RuntimeError, match="before run"):
        s.rerun(data)
    s.run(data)
    rep = s.absorb_refresh(0.25)
    assert rep.epoch == s.epoch == 1 and len(s.history) == 2
    assert rep.seconds >= 0.25


def test_ft_job_roundtrip_and_helpers(tmp_path):
    (spec, data), _, deltas = _sssp_case(np.random.default_rng(5))
    s = Session(spec, RunConfig(device="cpu"))
    s.run(data)
    ft.checkpoint_job(s._driver.job, str(tmp_path), 0)
    job = ft.restore_job(spec, str(tmp_path), device="cpu")
    _same(job.state.to_host(), s.result, 0)
    np.testing.assert_array_equal(job.cpc_accum, s._driver.job.cpc_accum)
    assert job.cpc_accum.dtype == np.float32
    assert job.store.file_bytes() == s.store_bytes()
    with pytest.raises(FileNotFoundError):
        ft.restore_job(spec, str(tmp_path / "none"), device="cpu")

    inj, jinj = ft.FailureInjector(2), jft.FailureInjector(2)
    for i in range(4):
        for f in (inj, jinj):
            if i == 2 and not f.fired:
                with pytest.raises(RuntimeError, match="injected"):
                    f(i)
            else:
                f(i)
    for work in ([10, 10, 11], [50, 10, 12, 9], [3, 1]):
        m, jm = ft.SkewMonitor(), jft.SkewMonitor()
        m.observe(np.array(work))
        jm.observe(np.array(work))
        assert m.plan() == jm.plan()


def test_jitcache_counters():
    snap = jitcache.snapshot()
    g = jitcache.generation()
    jitcache.count_trace("test:probe")
    jitcache.count_compile(2, 0.5)
    assert jitcache.generation() == g + 1
    assert jitcache.trace_counts()["test:probe"] >= 1
    after = jitcache.snapshot()
    assert after["traces"] == snap["traces"] + 1 == jitcache.traces_total()
    assert after["compiles"] == snap["compiles"] + 2 == \
        jitcache.compiles_total()
    assert jitcache.compile_seconds_total() == after["compile_seconds"]
