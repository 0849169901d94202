"""Delta queries, port vs JAX: plans, refreshes, the derived coalescer.

The same numpy inputs, made from a seed, go through ``repro.dql`` on
backend="xla" and ``repro_torch.dql`` on the CPU (the kernels' plain
versions); the plans are the same but for their lambdas (``jnp`` there,
torch here; operator-only lambdas serve both).  ``wordcount_query`` lowers
to the Edges of ``apps.wordcount`` bit for bit and refreshes bitwise equal
to the app and to ``np.bincount``.  Joins, min/max and co-occurrence
counts are exact against the reference and the oracles; windowed sums
within the reference's own 1e-4.  ``update(delta)`` equals a fresh run on
the mutated input over random plans (the reference's hypothesis
property), the derived coalescer equals the production one, and a
``query`` checkpoint written by either package restores in the other.
"""
import numpy as np
import pytest
import torch

from tests._hyp import given, settings, st
from repro import dql as jdql
from repro.api import RunConfig as JConfig
from repro.apps import wordcount as jwc
from repro.dql import workloads as jwl
from repro.dql.derived import coalesce_rows_dql as jcoalesce_rows_dql
from repro.stream.coalesce import coalesce_rows as jcoalesce_rows
from repro_torch import dql
from repro_torch.api import RunConfig, Session
from repro_torch.apps import wordcount as wc
from repro_torch.core.engine import JobSpec
from repro_torch.core.incremental import apply_delta_host, make_delta
from repro_torch.core.kvstore import make_kv, sum_reducer
from repro_torch.dql import workloads as wl
from repro_torch.dql.derived import coalesce_plan, coalesce_rows_dql
from repro_torch.kernels import ops
from repro_torch.stream import DeltaRecord, QueueSource
from repro_torch.stream.coalesce import coalesce_rows

VOCAB = 16
CPU = RunConfig(device="cpu", value_bytes=4)
XLA = JConfig(backend="xla", value_bytes=4)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Many small torch ops: without this, 6 pytest-xdist workers on 8
    cores slow them, and the reference's tests beside them, by intra-op
    fan-out."""
    was = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(was)


def _jkv(kv):
    """The reference's KV of a port KV (same host arrays)."""
    from repro.core.kvstore import make_kv as jmake_kv
    return jmake_kv(kv.keys.numpy(), {n: a.numpy()
                                      for n, a in kv.values.items()},
                    kv.valid.numpy())


def _jdelta(d):
    from repro.core.incremental import make_delta as jmake_delta
    return jmake_delta(d.record_ids.numpy(),
                       {n: a.numpy() for n, a in d.values.items()},
                       d.sign.numpy(), keys=d.keys.numpy(),
                       valid=d.valid.numpy())


def _same_relation(got, want):
    (vals, ok), (wvals, wok) = got, want
    np.testing.assert_array_equal(np.asarray(ok), np.asarray(wok))
    assert set(vals) == set(wvals)
    for c in vals:
        np.testing.assert_array_equal(np.where(ok, vals[c], 0),
                                      np.where(wok, np.asarray(wvals[c]), 0))


def _doc_delta(rng, docs, k):
    """'-old'/'+new' rewrite of ``k`` random documents, mutating ``docs``."""
    rows = rng.choice(len(docs), size=k, replace=False).astype(np.int32)
    new = rng.integers(0, VOCAB, (k, docs.shape[1])).astype(np.int32)
    dk = np.repeat(rows, 2)
    sg = np.tile(np.array([-1, 1], np.int8), k)
    buf = np.empty((2 * k, docs.shape[1]), np.int32)
    buf[0::2] = docs[rows]
    buf[1::2] = new
    docs[rows] = new
    return make_delta(dk, {"w": buf}, sg)


# ---------------------------------------------------------------------------
# wordcount as a query: bit for bit with apps.wordcount
# ---------------------------------------------------------------------------

def test_wordcount_lowers_to_app_edges():
    plan = wl.wordcount_query(VOCAB)
    spec = plan.spec()
    assert isinstance(spec, JobSpec)
    assert spec.num_keys == VOCAB and spec.name == "wordcount"
    assert plan.compile(CPU).sources == ("docs",)
    rng = np.random.default_rng(3)
    docs = rng.integers(-1, VOCAB, (12, 5)).astype(np.int32)
    _, data = wc.make_job(docs, VOCAB)
    sign = torch.tensor(rng.choice(np.int8([-1, 1]), 12))
    got, want = spec.map_fn(data, sign), wc.map_fn(data, sign)
    for a, b in zip(got[:2] + got[3:], want[:2] + want[3:]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    np.testing.assert_array_equal(got.v2["c"].numpy(), want.v2["c"].numpy())


def test_wordcount_bitwise_parity():
    rng = np.random.default_rng(7)
    docs = rng.integers(0, VOCAB, (24, 4)).astype(np.int32)
    spec, data = wc.make_job(docs, VOCAB)
    app = Session(spec, CPU)
    rep_app = app.run(data)
    q = wl.wordcount_query(VOCAB).compile(CPU)
    rep_q = q.run(data)
    ref = jwl.wordcount_query(VOCAB).compile(XLA)
    ref.run(jwc.make_input(np.arange(len(docs)), docs))
    assert rep_q.mode == rep_app.mode
    np.testing.assert_array_equal(q.result["c"], app.result["c"])
    mirror = docs.copy()
    for _ in range(3):
        d = _doc_delta(rng, mirror, 3)
        app.update(d)
        q.update(d)
        ref.update(_jdelta(d))
        np.testing.assert_array_equal(q.result["c"], app.result["c"])
        np.testing.assert_array_equal(q.result["c"],
                                      np.asarray(ref.result["c"]))
    np.testing.assert_array_equal(q.result["c"].ravel(),
                                  wc.oracle(mirror, VOCAB))


# ---------------------------------------------------------------------------
# the workload family against the reference and the oracles
# ---------------------------------------------------------------------------

def test_join_matches_reference_oracle_and_fresh_run():
    users = 32
    datas = wl.join_data(users, seed=3)
    jdatas = jwl.join_data(users, seed=3)
    q = wl.join_query(users).compile(CPU)
    ref = jwl.join_query(users).compile(XLA)
    q.run(datas)
    ref.run(jdatas)
    _same_relation(q.relation(), wl.join_oracle(datas))
    _same_relation(q.relation(), ref.relation())

    d = wl.join_delta(datas, 0.125, seed=5)
    rep = q.update(d)
    ref.update(jwl.join_delta(jdatas, 0.125, seed=5))
    assert rep.mode == "query-incremental" and rep.affected_keys >= 0
    _same_relation(q.relation(), ref.relation())

    mutated = {}
    for name, kv in datas.items():
        k, ok = kv.keys.numpy().copy(), kv.valid.numpy().copy()
        v = {c: a.numpy().copy() for c, a in kv.values.items()}
        apply_delta_host(k, v, ok, d[name])
        mutated[name] = make_kv(k, v, ok)
    twin = wl.join_query(users).compile(CPU)
    twin.run(mutated)
    _same_relation(q.relation(), twin.relation())
    _same_relation(q.relation(), wl.join_oracle(mutated))
    q.rerun()
    _same_relation(q.relation(), twin.relation())


def test_windowed_matches_reference_and_oracle():
    keys, size, slide, wins, n = 8, 8, 4, 8, 64
    t_max = wins * slide
    kv = wl.events_data(n, keys, t_max=t_max, seed=2)
    jkv = jwl.events_data(n, keys, t_max=t_max, seed=2)
    q = wl.windowed_query(keys, size=size, slide=slide,
                          num_windows=wins).compile(CPU)
    ref = jwl.windowed_query(keys, size=size, slide=slide,
                             num_windows=wins).compile(XLA)
    assert isinstance(q.qspec, JobSpec)      # window is key-space expansion
    q.run(kv)
    ref.run(jkv)
    kw = dict(size=size, slide=slide, num_windows=wins)
    oracle = wl.windowed_oracle(kv, keys, **kw)
    # the vectorised oracle adds in the reference loop's order: exact
    np.testing.assert_array_equal(oracle, jwl.windowed_oracle(jkv, keys,
                                                              **kw))
    np.testing.assert_allclose(q.result["v"].ravel(), oracle, atol=1e-4)
    np.testing.assert_allclose(q.result["v"], np.asarray(ref.result["v"]),
                               atol=1e-4)

    d = wl.events_delta(kv, 0.1, t_max=t_max, seed=4)
    q.update(d)
    ref.update(jwl.events_delta(jkv, 0.1, t_max=t_max, seed=4))
    k, ok = kv.keys.numpy().copy(), kv.valid.numpy().copy()
    v = {c: a.numpy().copy() for c, a in kv.values.items()}
    apply_delta_host(k, v, ok, d)
    oracle = wl.windowed_oracle(make_kv(k, v, ok), keys, **kw)
    np.testing.assert_allclose(q.result["v"].ravel(), oracle, atol=1e-4)
    np.testing.assert_allclose(q.result["v"], np.asarray(ref.result["v"]),
                               atol=1e-4)


def test_cooccurrence_counts():
    rng = np.random.default_rng(11)
    vocab, n, words = 8, 20, 5
    docs = rng.integers(0, vocab, (n, words)).astype(np.int32)
    docs[rng.random((n, words)) < 0.1] = -1        # padded slots
    kv = make_kv(np.arange(n, dtype=np.int32), {"w": docs})
    q = wl.cooccurrence_query(vocab).compile(CPU)
    q.run(kv)
    oracle = wl.cooccurrence_oracle(kv, vocab)
    np.testing.assert_array_equal(oracle,
                                  jwl.cooccurrence_oracle(_jkv(kv), vocab))
    np.testing.assert_array_equal(q.result["n"].ravel(), oracle)

    mirror = docs.copy()
    rows = np.array([0, 3, 7], np.int32)
    new = rng.integers(0, vocab, (3, words)).astype(np.int32)
    buf = np.empty((6, words), np.int32)
    buf[0::2] = mirror[rows]
    buf[1::2] = new
    mirror[rows] = new
    q.update(make_delta(np.repeat(rows, 2), {"w": buf},
                        np.tile(np.array([-1, 1], np.int8), 3)))
    np.testing.assert_array_equal(
        q.result["n"].ravel(),
        wl.cooccurrence_oracle(
            make_kv(np.arange(n, dtype=np.int32), {"w": mirror}), vocab))


def _chained_plan(lib, k1, k2, to_bucket):
    return (lib.scan("x")
            .group_by("k", num_keys=k1, value="v", agg="sum", name="per_key")
            .filter(lambda v: v["v"] > 5)
            .map(lambda v: {"b": to_bucket(v["v"]), "v": v["v"]})
            .group_by("b", num_keys=k2, value="v", agg="sum", name="bucket"))


def test_chained_group_by_matches_reference():
    rng = np.random.default_rng(5)
    n, k1, k2 = 48, 16, 4
    k = rng.integers(0, k1, n).astype(np.int32)
    v = rng.integers(0, 10, n).astype(np.float32)
    q = _chained_plan(dql, k1, k2, lambda x: (x / 8).to(torch.int32)
                      .clamp(0, k2 - 1)).compile(CPU)
    ref = _chained_plan(jdql, k1, k2, lambda x: (x / 8).astype("int32")
                        .clip(0, k2 - 1)).compile(XLA)
    kv = make_kv(np.arange(n, dtype=np.int32), {"k": k, "v": v})
    q.run(kv)
    ref.run(_jkv(kv))
    _same_relation(q.relation(), ref.relation())
    rows = rng.choice(n, size=4, replace=False).astype(np.int32)
    kb, vb = np.empty(8, np.int32), np.empty(8, np.float32)
    kb[0::2], kb[1::2] = k[rows], rng.integers(0, k1, 4)
    vb[0::2], vb[1::2] = v[rows], rng.integers(0, 10, 4)
    d = make_delta(np.repeat(rows, 2), {"k": kb, "v": vb},
                   np.tile(np.array([-1, 1], np.int8), 4))
    assert q.update(d).mode == "query-incremental"
    ref.update(_jdelta(d))
    _same_relation(q.relation(), ref.relation())


@pytest.mark.parametrize("agg", ["min", "max", "mean"])
def test_group_by_min_max_mean_match_reference(agg):
    rng = np.random.default_rng(9)
    n, nk = 40, 8
    kv = make_kv(np.arange(n, dtype=np.int32),
                 {"k": rng.integers(0, nk, n).astype(np.int32),
                  "v": rng.integers(-20, 20, n).astype(np.float32)})
    q = dql.scan("x").group_by("k", num_keys=nk, value="v",
                               agg=agg).compile(CPU)
    ref = jdql.scan("x").group_by("k", num_keys=nk, value="v",
                                  agg=agg).compile(XLA)
    q.run(kv)
    ref.run(_jkv(kv))
    np.testing.assert_array_equal(q.result["v"], np.asarray(ref.result["v"]))
    rows = np.array([1, 4, 9], np.int32)
    vb = np.empty(6, np.float32)
    vb[0::2], vb[1::2] = kv.values["v"].numpy()[rows], [-50, 50, 0]
    kb = np.repeat(kv.values["k"].numpy()[rows], 2)
    d = make_delta(np.repeat(rows, 2), {"k": kb, "v": vb},
                   np.tile(np.array([-1, 1], np.int8), 3))
    q.update(d)
    ref.update(_jdelta(d))
    np.testing.assert_array_equal(q.result["v"], np.asarray(ref.result["v"]))


# ---------------------------------------------------------------------------
# property: update(delta) == a fresh run on the mutated input (and == the
# reference), over random map/filter/group_by/join plans
# ---------------------------------------------------------------------------

_OPS = (          # operator-only lambdas: torch and jnp alike
    lambda q: q.map(lambda v: {**v, "v": v["v"] * 2}),
    lambda q: q.map(lambda v: {**v, "v": v["v"] + 1}),
    lambda q: q.filter(lambda v: (v["r"] % 3) > 0),
)


def _rand_plan(lib, seed, n_ops, with_join, agg, num_keys):
    q = lib.scan("x")
    for i in range(n_ops):
        q = _OPS[(seed + i) % len(_OPS)](q)
    g = q.group_by("k", num_keys=num_keys, value="v", agg=agg, name="a")
    if not with_join:
        return g
    h = q.group_by("k", num_keys=num_keys, value={"u": "v"}, agg="sum",
                   name="b")
    return g.join(h, name="j")


@settings(max_examples=8, deadline=None)
@given(st.integers(0, 10**6), st.integers(0, 3), st.booleans(),
       st.sampled_from(("sum", "min", "max")))
def test_update_equals_full_run(seed, n_ops, with_join, agg):
    rng = np.random.default_rng(seed)
    n, num_keys = 24, 8
    k = rng.integers(0, num_keys, n).astype(np.int32)
    v = rng.integers(0, 10, n).astype(np.float32)
    r = rng.integers(0, 6, n).astype(np.int32)
    kv0 = make_kv(np.arange(n, dtype=np.int32),
                  {"k": k.copy(), "v": v.copy(), "r": r.copy()})
    q = _rand_plan(dql, seed, n_ops, with_join, agg, num_keys).compile(CPU)
    ref = _rand_plan(jdql, seed, n_ops, with_join, agg,
                     num_keys).compile(XLA)
    q.run(kv0)
    ref.run(_jkv(kv0))

    m = int(rng.integers(1, 6))
    rows = rng.choice(n, size=m, replace=False).astype(np.int32)
    cols = {}
    for name, arr, new in (
            ("k", k, rng.integers(0, num_keys, m).astype(np.int32)),
            ("v", v, rng.integers(0, 10, m).astype(np.float32)),
            ("r", r, rng.integers(0, 6, m).astype(np.int32))):
        buf = np.empty(2 * m, arr.dtype)
        buf[0::2], buf[1::2] = arr[rows], new
        cols[name] = buf
        arr[rows] = new
    d = make_delta(np.repeat(rows, 2), cols,
                   np.tile(np.array([-1, 1], np.int8), m))
    q.update(d)
    ref.update(_jdelta(d))

    twin = _rand_plan(dql, seed, n_ops, with_join, agg,
                      num_keys).compile(CPU)
    twin.run(make_kv(np.arange(n, dtype=np.int32),
                     {"k": k, "v": v, "r": r}))
    _same_relation(q.relation(), twin.relation())
    _same_relation(q.relation(), ref.relation())


# ---------------------------------------------------------------------------
# storeless evaluate(), group_reduce, the derived coalescer
# ---------------------------------------------------------------------------

def test_evaluate_matches_oracle_and_reference():
    users = 16
    datas = wl.join_data(users, seed=1)
    got = dql.evaluate(wl.join_query(users), datas, device="cpu")
    _same_relation(got, wl.join_oracle(datas))
    _same_relation(got, jdql.evaluate(jwl.join_query(users),
                                      jwl.join_data(users, seed=1),
                                      backend="xla"))


def test_group_reduce_masks_out_of_range():
    keys = torch.tensor([0, 1, -1, 5, 2, 1], dtype=torch.int32)
    vals = {"v": torch.tensor([1., 2., 3., 4., 5., 6.])}
    valid = torch.tensor([1, 1, 1, 1, 0, 1], dtype=torch.bool)
    acc, counts = ops.group_reduce(sum_reducer(), keys, vals, valid, 4)
    np.testing.assert_allclose(acc["v"].numpy(), [1., 8., 0., 0.])
    np.testing.assert_array_equal(counts.numpy(), [1, 2, 0, 0])


def _same_coalesce(got, want):
    assert tuple(got[1:]) == tuple(want[1:])
    if want.delta is None:
        assert got.delta is None
        return
    for a, b in ((got.delta.record_ids, want.delta.record_ids),
                 (got.delta.sign, want.delta.sign)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for c in want.delta.values:
        np.testing.assert_array_equal(np.asarray(got.delta.values[c]),
                                      np.asarray(want.delta.values[c]))


def test_derived_plan_shape():
    spec = coalesce_plan(8).spec()
    assert [s.kind for s in spec.stages] == ["group", "group", "join"]
    assert spec.sources == ("rows",)


@settings(max_examples=6, deadline=None)
@given(st.integers(0, 10**6), st.integers(0, 24))
def test_derived_equals_production_coalescer(seed, n):
    rng = np.random.default_rng(seed)
    rid = rng.integers(0, max(n // 2, 1), n).astype(np.int32)
    sg = rng.choice(np.int8([-1, 1]), n)
    vals = {"w": rng.integers(0, 50, (n, 2)).astype(np.int32)}
    got = coalesce_rows_dql(rid, vals, sg, device="cpu")
    _same_coalesce(got, coalesce_rows(rid, vals, sg, device="cpu"))
    _same_coalesce(got, jcoalesce_rows_dql(rid, vals, sg, backend="xla"))
    _same_coalesce(got, jcoalesce_rows(rid, vals, sg, backend="xla"))


# ---------------------------------------------------------------------------
# checkpoint/restore across packages, the streaming adapter
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("writer", ["port", "reference"])
def test_query_checkpoint_restores_across_packages(writer, tmp_path):
    users = 32
    datas, jdatas = wl.join_data(users, seed=6), jwl.join_data(users, seed=6)
    port = wl.join_query(users).compile(CPU)
    ref = jwl.join_query(users).compile(XLA)
    port.run(datas)
    ref.run(jdatas)
    port.update(wl.join_delta(datas, 0.1, seed=20))
    ref.update(jwl.join_delta(jdatas, 0.1, seed=20))
    root = str(tmp_path / "ck")
    if writer == "port":
        assert port.checkpoint(root).name == "ep_000001"
        restored = jdql.Query.restore(jwl.join_query(users), root, XLA)
        live = ref
    else:
        assert ref.checkpoint(root).name == "ep_000001"
        restored = dql.Query.restore(wl.join_query(users), root, CPU)
        live = port
    _same_relation(restored.relation(), live.relation())
    for q, dd, mod in ((port, datas, wl), (ref, jdatas, jwl)):
        q.update(mod.join_delta(dd, 0.1, seed=21))
    rdd, rmod = (jdatas, jwl) if writer == "port" else (datas, wl)
    restored.update(rmod.join_delta(rdd, 0.1, seed=21))
    _same_relation(restored.relation(), live.relation())
    _same_relation(port.relation(), ref.relation())
    with pytest.raises(RuntimeError):
        restored.rerun()          # restored queries have no input mirrors


def test_stream_adapter_over_query():
    rng = np.random.default_rng(13)
    docs = rng.integers(0, VOCAB, (24, 4)).astype(np.int32)
    mirror = docs.copy()
    src = QueueSource(capacity=4)
    for e in range(3):
        d = _doc_delta(rng, mirror, 3)
        src.push(DeltaRecord(record_ids=d.record_ids.numpy(),
                             values={"w": d.values["w"].numpy()},
                             sign=d.sign.numpy(), epoch=e))
    src.seal()
    q = wl.wordcount_query(VOCAB).compile(CPU)
    ss = q.stream(wc.make_input(np.arange(len(docs)), docs), source=src)
    ss.start(background=False)
    ss.drain(timeout=60)
    np.testing.assert_array_equal(ss.session.result["c"].ravel(),
                                  wc.oracle(mirror, VOCAB))
    ss.stop()


# ---------------------------------------------------------------------------
# planner error surface (the reference's messages)
# ---------------------------------------------------------------------------

def _trailing_window():
    (dql.scan("x").group_by("k", num_keys=4, value="v", name="g")
     .window(4, num_windows=2).compile(CPU))


def _collision():
    uid = np.arange(8, dtype=np.int32)
    kv = {n: make_kv(uid, {"v": np.ones(8, np.float32)}) for n in "ab"}
    dql.scan("a").join(dql.scan("b"), num_keys=8).compile(CPU).run(kv)


@pytest.mark.parametrize("make, match", [
    (lambda: dql.scan("x").map(lambda v: v).compile(CPU),
     "at least one group_by or join"),
    (_trailing_window, "trailing window"),
    (lambda: dql.scan("a").join(dql.scan("b")), "num_keys"),
    (lambda: dql.scan("x").group_by("k", num_keys=4, agg="median"), "agg"),
    (_collision, "collide"),
], ids=["stateless-only", "trailing-window", "join-keys", "agg",
        "collision"])
def test_planner_errors(make, match):
    with pytest.raises(ValueError, match=match):
        make()


def test_jnp_free_lambdas_run_on_the_query_device():
    """A plan's lambdas see torch tensors on the query's device."""
    seen = []

    def spy(v):
        seen.append({n: (type(a), a.device.type) for n, a in v.items()})
        return v
    q = (dql.scan("x").map(spy)
         .group_by("k", num_keys=4, value="v").compile(CPU))
    q.run(make_kv(np.arange(3, dtype=np.int32),
                  {"k": np.array([0, 1, 1], np.int32),
                   "v": np.ones(3, np.float32)}))
    assert seen and all(t is torch.Tensor and dev == "cpu"
                        for s in seen for t, dev in s.values())
