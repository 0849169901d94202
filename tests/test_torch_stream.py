"""The streaming layer, port vs JAX: coalescer, StreamSession, copied modules.

The same numpy inputs, made from a seed, drive ``repro.stream`` on
backend="xla" and ``repro_torch.stream`` on the CPU (the kernels' plain
versions).  The coalescer's delta rows, their order and its five counts
are exactly equal.  StreamSessions run under ``policy="paper"`` (a static
crossover, so both packages take the same decisions) and are driven with
``start(background=False)`` and one record a batch, so that the
micro-batch boundaries match: wordcount's results are bitwise equal to
each other and to ``wordcount.oracle`` after every batch, PageRank's
within 1e-5 (the two packages may add floats in another order, as
``tests/test_torch_iterative.py`` holds it).  The modules the port copies
(scheduler, metrics, sources, ``DeltaStream``) give the same decisions and
records for the same inputs.
"""
import json

import numpy as np
import pytest
import torch

from repro.api import RunConfig as JConfig, StreamConfig as JStreamConfig
from repro.apps import pagerank as jpr
from repro.apps import wordcount as jwc
from repro.data import DeltaStream as JDeltaStream
from repro.stream import (
    DeltaRecord as JRecord, FileTailSource as JTail,
    RefreshScheduler as JScheduler, StreamMetrics as JMetrics,
    StreamSession as JStreamSession, SyntheticSource as JSynthetic,
)
from repro.core.incremental import apply_delta_host as japply
from repro.core.incremental import make_delta as jmake_delta
from repro.stream.coalesce import coalesce as jcoalesce
from repro.stream.coalesce import coalesce_rows as jcoalesce_rows
from repro_torch.api import RunConfig, StreamConfig
from repro_torch.apps import pagerank as pr
from repro_torch.apps import wordcount as wc
from repro_torch.core.incremental import apply_delta_host, make_delta
from repro_torch.data import DeltaStream
from repro_torch.kernels import jitcache
import repro_torch.stream as stream_pkg
from repro_torch.stream import (
    STREAM_POLICIES, DeltaRecord, FileTailSource, RefreshScheduler,
    StreamMetrics, StreamSession, SyntheticSource, coalesce, coalesce_rows,
)

CPU = RunConfig(device="cpu")


# ---------------------------------------------------------------------------
# coalescer
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Many small torch ops: without this, 6 pytest-xdist workers on 8
    cores slow them, and the reference's tests beside them, by intra-op
    fan-out."""
    was = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(was)


def _rows(pattern, seed):
    """(record ids, values, signs) of one cancel pattern, arrival order."""
    rng = np.random.default_rng(seed)
    if pattern == "random":
        n = int(rng.integers(1, 300))
        rid = rng.integers(0, max(n // 3, 1), n)
        sign = rng.choice(np.int8([-1, 1]), n)
    elif pattern == "first-last rules":
        # -..+ keeps both, -..- keeps the first, +..+ the last, +..- none,
        # and a lone row of each sign; records interleaved in arrival
        seqs = {0: [-1, 1, -1, 1], 1: [-1, 1, -1], 2: [1, -1, 1],
                3: [1, -1], 4: [-1], 5: [1]}
        order = [r for r in range(6) for _ in seqs[r]]
        order = [order[i] for i in rng.permutation(len(order))]
        rid, sign, seen = [], [], {r: 0 for r in seqs}
        for r in order:
            rid.append(r)
            sign.append(seqs[r][seen[r]])
            seen[r] += 1
        rid, sign = np.array(rid), np.int8(sign)
    elif pattern == "everything cancels":
        rid = np.repeat(rng.permutation(40), 2)
        sign = np.tile(np.int8([1, -1]), 40)
    else:                                  # empty
        rid, sign = np.zeros(0, np.int64), np.zeros(0, np.int8)
    n = rid.shape[0]
    values = {"w": rng.integers(0, 100, (n, 3)).astype(np.int32),
              "x": rng.random(n).astype(np.float32)}
    return rid.astype(np.int32), values, sign.astype(np.int8)


def _check_result(got, want):
    assert tuple(got[1:]) == tuple(want[1:])
    assert got.n_cancelled == want.n_cancelled
    if want.delta is None:
        assert got.delta is None
        return
    d, w = got.delta, want.delta
    for a, b in ((d.record_ids, w.record_ids), (d.keys, w.keys),
                 (d.sign, w.sign), (d.valid, w.valid)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for n in w.values:
        np.testing.assert_array_equal(d.values[n].numpy(),
                                      np.asarray(w.values[n]))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("pattern", ["random", "first-last rules",
                                     "everything cancels", "empty"])
def test_coalesce_rows_matches_reference(pattern, seed):
    rid, values, sign = _rows(pattern, seed)
    _check_result(coalesce_rows(rid, values, sign, device="cpu"),
                  jcoalesce_rows(rid, values, sign, backend="xla"))


def test_coalesce_records_concatenated():
    rng = np.random.default_rng(5)
    recs = []
    for e in range(4):
        rid, values, sign = _rows("random", 10 + e)
        recs.append((rid, values, sign, e))
    got = coalesce([DeltaRecord(r, v, s, epoch=e) for r, v, s, e in recs],
                   device="cpu")
    want = jcoalesce([JRecord(r, v, s, epoch=e) for r, v, s, e in recs],
                     backend="xla")
    _check_result(got, want)
    assert coalesce([], device="cpu") == (None, 0, 0, 0, 0, 0)


@pytest.mark.parametrize("seed", [0, 1])
def test_apply_delta_host_matches_reference(seed):
    """The mirror update, vectorised in the port, against the reference's
    row-by-row loop: repeated records, both signs, invalid rows."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 50, 30).astype(np.int32)
    vals = {"w": rng.integers(0, 9, (30, 3)).astype(np.int32)}
    valid = rng.random(30) < 0.7
    n = 200
    rid = rng.integers(0, 30, n).astype(np.int32)
    dkeys = rng.integers(0, 50, n).astype(np.int32)
    dvals = {"w": rng.integers(0, 9, (n, 3)).astype(np.int32)}
    sign = rng.choice(np.int8([-1, 1]), n)
    dvalid = rng.random(n) < 0.8
    got = (keys.copy(), {"w": vals["w"].copy()}, valid.copy())
    want = (keys.copy(), {"w": vals["w"].copy()}, valid.copy())
    apply_delta_host(*got, make_delta(rid, dvals, sign, keys=dkeys,
                                      valid=dvalid))
    japply(*want, jmake_delta(rid, dvals, sign, keys=dkeys, valid=dvalid))
    for g, w in zip((got[0], got[1]["w"], got[2]),
                    (want[0], want[1]["w"], want[2])):
        np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------------------
# StreamSession, wordcount: bitwise, step by step
# ---------------------------------------------------------------------------

VOCAB, N, L = 40, 48, 6


def _wc_batches(docs, seed=3):
    """Records, one a batch: small edits, an adversarial burst (each record
    rewritten 4 times), inserts past the seed capacity (mirror growth), a
    rewrite of 60% of the corpus (past the crossover: a rerun), deletes.
    Returns [(record, corpus after it, valid after it)]."""
    rng = np.random.default_rng(seed)
    cur = np.concatenate([docs, np.full((80, L), -1, np.int32)])
    valid = np.r_[np.ones(N, bool), np.zeros(80, bool)]
    out = []

    def emit(rid, words, sign):
        out.append((np.asarray(rid, np.int32), np.asarray(words, np.int32),
                    np.int8(sign), cur.copy(), valid.copy()))

    def rewrite(rows, times=1):
        rid, words, sign = [], [], []
        for _ in range(times):
            for r in rows:
                new = rng.integers(0, VOCAB, L)
                rid += [r, r]
                words += [cur[r].copy(), new]
                sign += [-1, 1]
                cur[r] = new
        return rid, words, sign

    emit(*rewrite([2, 7, 11]))
    emit(*rewrite(rng.choice(N, 8, replace=False), times=4))
    born = np.arange(N + 40, N + 70)          # past 2x the seed capacity
    words = rng.integers(0, VOCAB, (born.size, L))
    cur[born], valid[born] = words, True
    emit(born, words, np.ones(born.size))
    emit(*rewrite(rng.choice(N, int(0.6 * N), replace=False)))
    gone = np.array([1, 5, N + 42])
    valid[gone] = False
    emit(gone, cur[gone], -np.ones(3))
    return out


def _coalesce_info(rep):
    return None if rep.coalesce is None else dict(rep.coalesce)


@pytest.mark.parametrize("path", ["mrbg", "auto"])
def test_stream_wordcount_parity(path):
    rng = np.random.default_rng(0)
    docs = rng.integers(0, VOCAB, (N, L)).astype(np.int32)
    scfg = dict(policy="paper", crossover=0.45, max_batch_records=10**6)
    spec, data = wc.make_job(docs, VOCAB)
    jspec, jdata = jwc.make_job(docs, VOCAB)
    port = StreamSession(spec, data,
                         config=RunConfig(device="cpu", onestep_path=path),
                         stream=StreamConfig(**scfg))
    ref = JStreamSession(jspec, jdata,
                         config=JConfig(backend="xla", onestep_path=path),
                         stream=JStreamConfig(**scfg))
    port.start(background=False)
    ref.start(background=False)
    gen0 = jitcache.generation()
    for e, (rid, words, sign, cur, valid) in enumerate(_wc_batches(docs)):
        port.submit_record(DeltaRecord(rid, {"w": words}, sign, epoch=e))
        ref.submit_record(JRecord(rid, {"w": words}, sign, epoch=e))
        port.drain()
        ref.drain()
        want = wc.oracle(cur, VOCAB, valid)
        np.testing.assert_array_equal(port.result["c"], want)
        np.testing.assert_array_equal(port.result["c"], ref.result["c"])
        prep, rrep = port.session.history[-1], ref.session.history[-1]
        assert _coalesce_info(prep) == _coalesce_info(rrep)
        assert (prep.mode, prep.epoch) == (rrep.mode, rrep.epoch)
        mirror = port.mirror_kv()
        m = mirror.keys.shape[0]
        assert not valid[m:].any()
        np.testing.assert_array_equal(mirror.valid.numpy(), valid[:m])
        np.testing.assert_array_equal(mirror.values["w"].numpy()[valid[:m]],
                                      cur[:m][valid[:m]])
    assert [d.action for d in port.scheduler.decisions] == \
        [d.action for d in ref.scheduler.decisions]
    assert "rerun" in port.metrics.refreshes
    assert port.grow_events == ref.grow_events >= 1
    assert port.metrics.rows_cancelled == ref.metrics.rows_cancelled > 0
    # nothing builds on the CPU: no batch is marked retraced
    assert jitcache.generation() == gen0
    assert port.metrics.retrace_batches == 0


def test_stream_background_worker_and_snapshot(tmp_path):
    rng = np.random.default_rng(1)
    docs = rng.integers(0, VOCAB, (N, L)).astype(np.int32)
    spec, data, source = wc.make_stream(docs, VOCAB, frac=0.1, seed=4,
                                        epochs=6)
    ss = StreamSession(spec, data, source=source, config=CPU,
                       stream=StreamConfig(max_batch_records=8,
                                           max_batch_delay=0.005))
    with ss:
        ss.drain(timeout=120)
    assert ss.metrics.batches >= 2 and ss.metrics.last_epoch == 5
    np.testing.assert_array_equal(ss.result["c"],
                                  wc.oracle(source.values["w"], VOCAB))
    ss.snapshot(str(tmp_path))
    meta = json.loads((tmp_path / "stream.json").read_text())
    assert meta == {"watermark": 5, "epoch": ss.session.epoch,
                    "name": "session"}
    # the deprecated shim: a per-tenant ServeTier; the session refreshes
    # under it as it did on its own
    with pytest.warns(DeprecationWarning, match="ServeTier"):
        server = stream_pkg.MultiSessionServer()
    assert not server.batch_refresh
    twin = StreamSession(*wc.make_job(docs, VOCAB), config=CPU,
                         stream=StreamConfig(max_batch_delay=0.0))
    server.add(twin)
    new = source.values["w"]
    rows = np.nonzero((new != docs).any(axis=1))[0].astype(np.int32)
    buf = np.empty((2 * rows.size, L), np.int32)
    buf[0::2], buf[1::2] = docs[rows], new[rows]
    assert server.submit("session", np.repeat(rows, 2), {"w": buf},
                         np.tile(np.int8([-1, 1]), rows.size))
    server.drain(timeout=120)
    np.testing.assert_array_equal(server["session"].result["c"],
                                  ss.result["c"])


@pytest.mark.parametrize("path", ["mrbg", "auto"])
def test_prewarm_ladder_is_a_noop_like_the_reference(path):
    rng = np.random.default_rng(2)
    docs = rng.integers(0, VOCAB, (N, L)).astype(np.int32)
    scfg = dict(prewarm=True, prewarm_rows=256)
    port = StreamSession(*wc.make_job(docs, VOCAB),
                         config=RunConfig(device="cpu", onestep_path=path),
                         stream=StreamConfig(**scfg))
    ref = JStreamSession(*jwc.make_job(docs, VOCAB),
                         config=JConfig(backend="xla", onestep_path=path),
                         stream=JStreamConfig(**scfg))
    port.start(background=False)
    ref.start(background=False)
    assert port.session.epoch == ref.session.epoch > 1
    np.testing.assert_array_equal(port.result["c"], wc.oracle(docs, VOCAB))
    assert port.session.store_bytes() == ref.session.store_bytes()


# ---------------------------------------------------------------------------
# StreamSession, PageRank: within 1e-5
# ---------------------------------------------------------------------------

def test_stream_pagerank_parity():
    nbrs = pr.random_graph(128, 4, seed=2, p_edge=0.5)
    cfg = dict(max_iters=150, tol=1e-6, value_bytes=4, cpc_threshold=1e-3)
    spec, struct, source = pr.make_stream(nbrs, frac=0.02, seed=9, epochs=3)
    jspec, jstruct, jsource = jpr.make_stream(nbrs, frac=0.02, seed=9,
                                              epochs=3)
    scfg = dict(policy="paper", max_batch_records=1)
    port = StreamSession(spec, struct, source=source,
                         config=RunConfig(device="cpu", **cfg),
                         stream=StreamConfig(**scfg))
    ref = JStreamSession(jspec, jstruct, source=jsource,
                         config=JConfig(backend="xla", **cfg),
                         stream=JStreamConfig(**scfg))
    port.start(background=False)
    ref.start(background=False)
    modes = []
    for _ in range(3):
        assert port.step() and ref.step()
        np.testing.assert_allclose(port.result["r"], ref.result["r"],
                                   rtol=0, atol=1e-5)
        modes.append(port.session.history[-1].mode)
        assert modes[-1] == ref.session.history[-1].mode
    assert "i2" in modes
    np.testing.assert_array_equal(source.values["nbrs"],
                                  jsource.values["nbrs"])
    np.testing.assert_allclose(port.result["r"],
                               pr.oracle(source.values["nbrs"]), atol=2e-2)


# ---------------------------------------------------------------------------
# copied modules
# ---------------------------------------------------------------------------

def _observations(seed=0):
    rng = np.random.default_rng(seed)
    for i in range(40):
        yield ("decide", int(rng.integers(1, 400)), int(rng.integers(1, 1000)),
               int(rng.integers(0, 5000)), int(rng.integers(1, 2000)))
        yield ("observe", ["update", "rerun"][int(rng.integers(2))],
               int(rng.integers(0, 400)), float(rng.random()),
               bool(rng.random() < 0.2))


@pytest.mark.parametrize("policy", STREAM_POLICIES)
def test_scheduler_matches_reference(policy):
    port = RefreshScheduler(StreamConfig(policy=policy, crossover=0.3))
    ref = JScheduler(JStreamConfig(policy=policy, crossover=0.3))
    port.seed(0.5)
    ref.seed(0.5)
    for ev in _observations():
        if ev[0] == "decide":
            got = port.decide(ev[1], ev[2], store_file_bytes=ev[3],
                              store_live_bytes=ev[4])
            want = ref.decide(ev[1], ev[2], store_file_bytes=ev[3],
                              store_live_bytes=ev[4])
            assert tuple(got.__dict__.values()) == \
                tuple(want.__dict__.values())
        else:
            for s in (port, ref):
                s.observe(ev[1], ev[2], ev[3], compiled=ev[4])
    assert port.action_counts == ref.action_counts
    assert port.compile_skips == ref.compile_skips


def test_stream_config_validation_matches_reference():
    assert StreamConfig() == StreamConfig(**{
        k: v for k, v in JStreamConfig().__dict__.items()})
    for bad in ({"policy": "fastest"}, {"queue_capacity": 0},
                {"max_batch_records": 0}, {"max_records": 0}):
        with pytest.raises(ValueError):
            StreamConfig(**bad)
        with pytest.raises(ValueError):
            JStreamConfig(**bad)


def test_stream_metrics_match_reference():
    port, ref = StreamMetrics(), JMetrics()
    rng = np.random.default_rng(2)
    for i in range(30):
        kw = dict(n_in=int(rng.integers(0, 99)), n_engine=int(
            rng.integers(0, 50)), action=["update", "rerun", "noop"][i % 3],
            latency_s=float(rng.random()), refresh_s=float(rng.random()),
            epoch=i, retraced=bool(i % 7 == 0), n_cancelled=i,
            n_inserts=i % 4, n_deletes=i % 5)
        port.observe_batch(**kw)
        ref.observe_batch(**kw)
    for m in (port, ref):
        m.observe_compaction(1234)
        m.observe_rejected(3)
    assert port.snapshot() == ref.snapshot()
    assert port.latency_pct(90) == ref.latency_pct(90)
    assert port.updates_per_sec() == ref.updates_per_sec()


def _same_records(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.record_ids, w.record_ids)
        np.testing.assert_array_equal(g.sign, w.sign)
        assert g.epoch == w.epoch and g.values.keys() == w.values.keys()
        for n in w.values:
            np.testing.assert_array_equal(g.values[n], w.values[n])
            assert g.values[n].dtype == w.values[n].dtype


@pytest.mark.parametrize("seed", [0, 3])
def test_delta_stream_and_synthetic_source_match_reference(seed):
    rng = np.random.default_rng(seed)
    values = {"w": rng.integers(0, 50, (60, 5)).astype(np.int32)}
    port, ref = DeltaStream(values, 0.1, seed), JDeltaStream(values, 0.1,
                                                              seed)
    for _ in range(3):
        for a, b in zip(port.delta(), ref.delta()):
            if isinstance(b, dict):
                np.testing.assert_array_equal(a["w"], b["w"])
            else:
                np.testing.assert_array_equal(a, b)
    mut = wc.doc_mutator(50)
    src = SyntheticSource(values, frac=0.2, seed=seed, epochs=5, mutator=mut)
    jsrc = JSynthetic(values, frac=0.2, seed=seed, epochs=5,
                      mutator=jwc.doc_mutator(50))
    _same_records(src.poll(30) + src.poll(10**6),
                  jsrc.poll(30) + jsrc.poll(10**6))
    assert src.exhausted and jsrc.exhausted
    assert src.watermark == jsrc.watermark == 4
    np.testing.assert_array_equal(src.values["w"], jsrc.values["w"])


@pytest.mark.parametrize("writer", ["repro", "repro_torch"])
def test_file_tail_source_across_packages(tmp_path, writer):
    rng = np.random.default_rng(4)
    path = str(tmp_path / "log.jsonl")
    recs = [(rng.integers(0, 9, 4), rng.random((4, 2)).astype(np.float32),
             rng.choice(np.int8([-1, 1]), 4), e) for e in range(5)]
    mk = (JRecord, JTail) if writer == "repro" else (DeltaRecord,
                                                      FileTailSource)
    mk[1].write(path, [mk[0](r, {"v": v}, s, epoch=e)
                       for r, v, s, e in recs])
    port = FileTailSource(path, dtypes={"v": "float32"})
    ref = JTail(path, dtypes={"v": "float32"})
    _same_records(port.poll(10**6), ref.poll(10**6))
    port.rewind(2)
    ref.rewind(2)
    got, want = port.poll(10**6), ref.poll(10**6)
    _same_records(got, want)
    assert [r.epoch for r in got] == [3, 4] and port.exhausted
