"""The slice end to end: wordcount ``Session.run`` then updates, port vs JAX.

The same corpus and deltas, from a seed, drive ``repro.api.Session`` on
backend="xla" and ``repro_torch.api.Session`` on the CPU (the kernels'
plain versions), on the MRBG path and on ``auto`` (the accumulator).
Results must be bitwise equal to each other and to ``wordcount.oracle``,
and so must the reports' counts, affected keys, store sizes and I/O.  A
carry-across test runs ``run`` in JAX, moves the preserved state over as
numpy arrays, and continues with ``update`` in both packages.
"""
import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest

from repro.api import RunConfig as JConfig, Session as JSession
from repro.api import make_delta as jmake_delta
from repro.apps import wordcount as jwc
from repro.core.mrbg_store import MRBGStore as JStore
from repro_torch.api import RunConfig, Session, make_delta
from repro_torch.apps import wordcount as wc
from repro_torch.core.mrbg_store import POLICIES, MRBGStore
from repro_torch.core.transfer import session_from_state

VOCAB, N, L = 60, 30, 8


def _corpus(seed=0):
    rng = np.random.default_rng(seed)
    docs = rng.integers(0, VOCAB, (N, L)).astype(np.int32)
    docs[rng.random(docs.shape) < 0.1] = -1
    return docs


def _deltas(docs, seed=1):
    """Edits, deletes, inserts past N and an empty delta, as
    (record ids, word rows, signs) with the corpus after each."""
    rng = np.random.default_rng(seed)
    cur = np.concatenate([docs, np.full((4, L), -1, np.int32)])
    valid = np.r_[np.ones(N, bool), np.zeros(4, bool)]
    out = []
    # 1) edit three documents: '-' old then '+' new
    rows = np.array([3, 7, 20])
    new = rng.integers(0, VOCAB, (3, L)).astype(np.int32)
    words = np.empty((6, L), np.int32)
    words[0::2], words[1::2] = cur[rows], new
    cur[rows] = new
    out.append((np.repeat(rows, 2), words, np.tile(np.int8([-1, 1]), 3)))
    out.append((cur.copy(), valid.copy()))
    # 2) delete two documents and insert two past N
    gone, born = np.array([1, 9]), np.array([N, N + 1])
    new = rng.integers(0, VOCAB, (2, L)).astype(np.int32)
    rid = np.r_[gone, born]
    words = np.concatenate([cur[gone], new])
    valid[gone], valid[born] = False, True
    cur[born] = new
    out.append((rid, words, np.int8([-1, -1, 1, 1])))
    out.append((cur.copy(), valid.copy()))
    # 3) an empty delta
    out.append((np.zeros(0, np.int32), np.zeros((0, L), np.int32),
                np.zeros(0, np.int8)))
    out.append((cur.copy(), valid.copy()))
    # 4) rewrite a document twice in one delta and delete an inserted one
    a = rng.integers(0, VOCAB, (2, L)).astype(np.int32)
    rid = np.array([5, 5, 5, 5, N])
    words = np.stack([cur[5], a[0], a[0], a[1], cur[N]])
    cur[5] = a[1]
    valid[N] = False
    out.append((rid, words, np.int8([-1, 1, -1, 1, -1])))
    out.append((cur.copy(), valid.copy()))
    return [tuple(out[i:i + 2]) for i in range(0, len(out), 2)]


def _check_reports(got, want):
    assert got.mode == want.mode and got.epoch == want.epoch
    np.testing.assert_array_equal(got.counts, want.counts)
    assert got.affected_keys == want.affected_keys
    assert got.store_bytes == want.store_bytes
    assert got.live_bytes == want.live_bytes
    assert got.store_batches == want.store_batches
    assert (got.io is None) == (want.io is None)
    if got.io is not None:
        assert dataclasses.asdict(got.io) == dataclasses.asdict(want.io)


@pytest.mark.parametrize("path", ["mrbg", "auto"])
def test_wordcount_session_parity(path):
    docs = _corpus()
    spec, data = wc.make_job(docs, VOCAB)
    port = Session(spec, RunConfig(device="cpu", onestep_path=path,
                                   value_bytes=4))
    jspec, jdata = jwc.make_job(docs, VOCAB)
    ref = JSession(jspec, JConfig(backend="xla", onestep_path=path,
                                  value_bytes=4))
    _check_reports(port.run(data), ref.run(jdata))
    np.testing.assert_array_equal(port.result["c"], ref.result["c"])
    np.testing.assert_array_equal(port.result["c"], wc.oracle(docs, VOCAB))
    for (rid, words, sign), (cur, valid) in _deltas(docs):
        got = port.update(make_delta(rid, {"w": words}, sign))
        want = ref.update(jmake_delta(rid, {"w": jnp.asarray(words)}, sign))
        _check_reports(got, want)
        assert got.mode == ("incremental" if path == "mrbg"
                            else "accumulator")
        np.testing.assert_array_equal(port.result["c"], ref.result["c"])
        np.testing.assert_array_equal(port.result["c"],
                                      wc.oracle(cur, VOCAB, valid))


def _jax_state(sess):
    """The JAX session's preserved state as numpy arrays."""
    drv = sess._driver
    view = drv.view
    state = {"view": {"values": {n: np.asarray(a)
                                 for n, a in view.values.items()},
                      "valid": np.asarray(view.valid),
                      "counts": np.asarray(view.counts)}}
    if hasattr(drv, "store"):
        st = drv.store
        state["store"] = {
            "batches": [{"k2": b.k2, "mk": b.mk, "v2": dict(b.v2),
                         "sign": b.sign, "offset": b.offset}
                        for b in st.batches],
            "idx_batch": st.idx_batch, "idx_start": st.idx_start,
            "idx_len": st.idx_len, "file_records": st.file_records,
            "live_records": st.live_records}
    else:
        state["raw_acc"] = {n: np.asarray(a)
                            for n, a in drv.job.raw_acc.items()}
    return state


@pytest.mark.parametrize("path", ["mrbg", "auto"])
def test_carry_state_across(path):
    docs = _corpus(3)
    jspec, jdata = jwc.make_job(docs, VOCAB)
    ref = JSession(jspec, JConfig(backend="xla", onestep_path=path))
    ref.run(jdata)
    port = session_from_state(wc.make_spec(VOCAB),
                              RunConfig(device="cpu", onestep_path=path),
                              _jax_state(ref))
    np.testing.assert_array_equal(port.result["c"], ref.result["c"])
    for (rid, words, sign), (cur, valid) in _deltas(docs, seed=4):
        got = port.update(make_delta(rid, {"w": words}, sign))
        want = ref.update(jmake_delta(rid, {"w": jnp.asarray(words)}, sign))
        _check_reports(got, want)
        np.testing.assert_array_equal(port.result["c"], ref.result["c"])
        np.testing.assert_array_equal(port.result["c"],
                                      wc.oracle(cur, VOCAB, valid))


@pytest.mark.parametrize("policy", POLICIES)
def test_mrbg_store_copy_matches_reference(policy):
    """The port's own copy of the store behaves byte for byte."""
    rng = np.random.default_rng(len(policy))
    kw = dict(cache_bytes=4096, fix_window_bytes=1024, gap_threshold=512)
    ours, theirs = (MRBGStore(50, 4, policy=policy, **kw),
                    JStore(50, 4, policy=policy, **kw))
    for step in range(4):
        k2 = np.sort(rng.integers(0, 50, 300)).astype(np.int32)
        mk = rng.integers(0, 1000, 300).astype(np.int32)
        v2 = {"c": rng.integers(0, 9, 300).astype(np.float32)}
        for st in (ours, theirs):
            st.append(k2, mk, v2)
            st.mark_deleted(np.array([step, 40 + step]))
        q = np.unique(rng.integers(0, 50, 20))
        got, want = ours.query(q), theirs.query(q)
        for g, w in zip(got[:2] + got[3:], want[:2] + want[3:]):
            np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(got[2]["c"], want[2]["c"])
        assert dataclasses.asdict(ours.stats) == \
            dataclasses.asdict(theirs.stats)
        assert (ours.file_bytes(), ours.live_bytes(), ours.n_batches) == \
            (theirs.file_bytes(), theirs.live_bytes(), theirs.n_batches)
    assert ours.compact() == theirs.compact()
    np.testing.assert_array_equal(ours.idx_len, theirs.idx_len)
