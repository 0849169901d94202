"""Slice 2 end to end: iterative and incremental-iterative jobs, port vs JAX.

The same numpy inputs, made from a seed, drive ``repro.api.Session`` on
backend="xla" and ``repro_torch.api.Session`` on the CPU (the kernels'
plain versions) through ``run`` and then ``update``.

Tolerances: SSSP is bitwise (min, with ``d + w`` element by element), and
so are its iteration logs and modes.  PageRank and GIM-V hold within 1e-5
absolute, Kmeans' centroids within 1e-4: XLA's ``segment_sum`` and the
port's ``index_add_`` (and Kmeans' distance sums) may add floats in
another order.  A carry-across test runs SSSP's ``run`` in JAX, moves the
``IncrIterJob`` state over as numpy arrays, and continues in both.
"""
import functools

import numpy as np
import jax.numpy as jnp
import pytest

from repro.api import RunConfig as JConfig, Session as JSession
from repro.api import make_delta as jmake_delta
from repro.apps import apriori as japriori
from repro.apps import gimv as jgimv
from repro.apps import kmeans as jkmeans
from repro.apps import pagerank as jpagerank
from repro.apps import sssp as jsssp
from repro.core import incr_iter as jincr
from repro_torch.api import RunConfig, Session, make_delta
from repro_torch.apps import apriori, gimv, kmeans, pagerank, sssp
from repro_torch.core import incr_iter
from repro_torch.core.transfer import session_from_state


@functools.lru_cache(maxsize=None)
def _jspec(make_spec, *args):
    """One reference spec per app and size for the whole file: the
    reference caches its compiled steps per spec, so sharing one spec
    compiles them once."""
    return make_spec(*args)


def _pair(spec_t, spec_j, **cfg):
    return (Session(spec_t, RunConfig(device="cpu", **cfg)),
            JSession(spec_j, JConfig(backend="xla", **cfg)))


def _update_both(port, ref, rid, values, sign):
    got = port.update(make_delta(rid, values, sign))
    want = ref.update(jmake_delta(
        rid, {n: jnp.asarray(a) for n, a in values.items()}, sign))
    return got, want


def _logs(rep):
    return [(l.iteration, l.n_input_changes, l.n_affected_dks, l.n_emitted,
             l.mrbg_on, l.io_reads, l.io_bytes) for l in rep.logs]


def _check_bitwise(got, want, port, ref):
    assert got.mode == want.mode and got.iters == want.iters
    assert got.max_change == want.max_change
    assert _logs(got) == _logs(want)
    assert got.affected_keys == want.affected_keys
    assert (got.store_bytes, got.live_bytes, got.store_batches,
            got.mrbg_on) == (want.store_bytes, want.live_bytes,
                             want.store_batches, want.mrbg_on)
    for n, a in ref.result.items():
        np.testing.assert_array_equal(port.result[n], np.asarray(a))


def _rewrite(rows, old, new, w):
    """A delta rewriting SSSP rows (vertex ids): '-' old then '+' new."""
    k = rows.size
    nb = np.empty((2 * k, old.shape[1]), np.int32)
    nb[0::2], nb[1::2] = old, new
    return (np.repeat(rows + 1, 2).astype(np.int32),
            {"nbrs": nb, "w": np.repeat(w[rows], 2, axis=0)},
            np.tile(np.int8([-1, 1]), k))


# ---------------------------------------------------------------------------
# SSSP: bitwise, logs included
# ---------------------------------------------------------------------------

V_SSSP, F_SSSP = 96, 4


def _sssp_steps(nbrs, w, seed=9):
    """(a) 30% of the slots of 10 rows deleted; (b) every in-edge of one
    reachable vertex deleted (it becomes +inf on both sides); (c) new edges
    into free slots.  Returns [(delta, graph after it)] and (b)'s vertex."""
    rng = np.random.default_rng(seed)
    cur = nbrs.copy()
    steps = []

    def step(rows, new):
        steps.append((_rewrite(rows, cur[rows], new, w), None))
        cur[rows] = new
        steps[-1] = (steps[-1][0], cur.copy())

    rows = rng.choice(V_SSSP, 10, replace=False)
    new = cur[rows].copy()
    new[rng.random(new.shape) < 0.3] = -1
    step(rows, new)
    d = sssp.oracle(cur, w, 0)
    target = int(np.nonzero((d > 0) & (d < sssp.INF / 2))[0][-1])
    rows = np.nonzero((cur == target).any(axis=1))[0]
    step(rows, np.where(cur[rows] == target, -1, cur[rows]).astype(np.int32))
    rows = rng.choice(V_SSSP, 6, replace=False)
    new = cur[rows].copy()
    free = new < 0
    new[free] = rng.integers(0, V_SSSP, int(free.sum()))
    step(rows, new)
    return steps, target


def test_sssp_parity_bitwise():
    nbrs, w = sssp.random_weighted_graph(V_SSSP, F_SSSP, seed=2)
    port, ref = _pair(sssp.make_job(nbrs, w, 0)[0],
                      _jspec(jsssp.make_spec, V_SSSP))
    _check_bitwise(port.run(sssp.make_struct(nbrs, w, 0)),
                   ref.run(jsssp.make_struct(nbrs, w, 0)), port, ref)
    np.testing.assert_allclose(
        np.minimum(port.result["d"], sssp.INF), sssp.oracle(nbrs, w, 0),
        rtol=1e-5)
    steps, target = _sssp_steps(nbrs, w)
    for (rid, values, sign), cur in steps:
        got, want = _update_both(port, ref, rid, values, sign)
        assert got.mode == "i2"
        _check_bitwise(got, want, port, ref)
        np.testing.assert_allclose(
            np.minimum(port.result["d"], sssp.INF), sssp.oracle(cur, w, 0),
            rtol=1e-5)
    # no in-edge left: +inf (the min identity), not INF, on both sides
    assert port.result["d"][target] == np.inf


def _jax_iter_state(sess):
    """The JAX IncrIterJob's preserved state as numpy arrays."""
    job = sess._driver.job
    st = job.store
    host = lambda t: {n: np.asarray(a) for n, a in t.items()}
    return {
        "state": host(job.state.values), "valid": np.asarray(job.state.valid),
        "emitted_values": host(job.emitted_values),
        "cpc_accum": job.cpc_accum, "mrbg_on": job.mrbg_on,
        "struct": {"keys": job.struct_keys, "values": job.struct_values,
                   "valid": job.struct_valid},
        "store": {
            "batches": [{"k2": b.k2, "mk": b.mk, "v2": dict(b.v2),
                         "sign": b.sign, "offset": b.offset}
                        for b in st.batches],
            "idx_batch": st.idx_batch, "idx_start": st.idx_start,
            "idx_len": st.idx_len, "file_records": st.file_records,
            "live_records": st.live_records},
    }


def test_sssp_carry_state_across():
    # the graph and steps of test_sssp_parity_bitwise: the reference
    # compiles its steps once for both tests
    nbrs, w = sssp.random_weighted_graph(V_SSSP, F_SSSP, seed=2)
    ref = JSession(_jspec(jsssp.make_spec, V_SSSP), JConfig(backend="xla"))
    ref.run(jsssp.make_struct(nbrs, w, 0))
    port = session_from_state(sssp.make_spec(V_SSSP), RunConfig(device="cpu"),
                              _jax_iter_state(ref))
    np.testing.assert_array_equal(port.result["d"], ref.result["d"])
    # through the step that empties a vertex's in-edges: +inf crosses over
    steps, target = _sssp_steps(nbrs, w)
    for delta, _ in steps[:2]:
        got, want = _update_both(port, ref, *delta)
        _check_bitwise(got, want, port, ref)
    assert port.result["d"][target] == np.inf


# ---------------------------------------------------------------------------
# PageRank, GIM-V, Kmeans: within float tolerance
# ---------------------------------------------------------------------------

def _rewire(nbrs, rows, rng):
    new = pagerank.graph_mutator(nbrs.shape[0])(rng, rows,
                                                {"nbrs": nbrs[rows]})["nbrs"]
    nb = np.empty((2 * rows.size, nbrs.shape[1]), np.int32)
    nb[0::2], nb[1::2] = nbrs[rows], new
    out = nbrs.copy()
    out[rows] = new
    return (np.repeat(rows, 2).astype(np.int32), {"nbrs": nb},
            np.tile(np.int8([-1, 1]), rows.size)), out


@pytest.mark.parametrize("cfg", [{"cpc_threshold": 0.01, "tol": 1e-6,
                                  "refresh_tol": 1e-4},
                                 {"cpc_threshold": 0.0, "tol": 1e-6},
                                 {"plain_shuffle": True, "tol": 1e-6}],
                         ids=["i2", "fallback", "plainMR"])
def test_pagerank_parity(cfg):
    v = 128
    nbrs = pagerank.random_graph(v, 4, seed=3)
    port, ref = _pair(pagerank.make_spec(v),
                      _jspec(jpagerank.make_spec, v), **cfg)
    got, want = port.run(pagerank.make_struct(nbrs)), \
        ref.run(jpagerank.make_struct(nbrs))
    assert got.mode == want.mode
    np.testing.assert_allclose(port.result["r"], ref.result["r"], atol=1e-5)
    np.testing.assert_allclose(port.result["r"], pagerank.oracle(nbrs),
                               atol=1e-4)
    rng = np.random.default_rng(4)
    delta, cur = _rewire(nbrs, rng.choice(v, 3, replace=False), rng)
    got, want = _update_both(port, ref, *delta)
    assert got.mode == want.mode
    assert got.mode == {"i2": "i2", "fallback": "iterMR-fallback",
                        "plainMR": "plainMR"}[
        "plainMR" if cfg.get("plain_shuffle") else
        ("i2" if cfg["cpc_threshold"] else "fallback")]
    np.testing.assert_allclose(port.result["r"], ref.result["r"], atol=1e-5)
    if got.mode != "i2":                  # exact refreshes: near the oracle
        np.testing.assert_allclose(port.result["r"], pagerank.oracle(cur),
                                   atol=1e-4)


def test_gimv_parity():
    nb, bs = 4, 8
    blocks = gimv.random_blocks(nb, bs, seed=4, density=0.5)
    bvec = np.random.default_rng(1).random((nb, bs)).astype(np.float32)
    port, ref = _pair(gimv.make_spec(nb, bs, bvec),
                      jgimv.make_spec(nb, bs, bvec), tol=1e-7)
    np.testing.assert_array_equal(blocks,
                                  jgimv.random_blocks(nb, bs, 4, 0.5))
    got, want = port.run(gimv.make_struct(blocks, nb)), \
        ref.run(jgimv.make_struct(blocks, nb))
    assert got.mode == want.mode == "iterative"
    np.testing.assert_allclose(port.result["v"], ref.result["v"], atol=1e-5)
    np.testing.assert_allclose(port.result["v"],
                               gimv.oracle(blocks, nb, bs, bvec), atol=1e-5)
    rids = np.arange(0, nb * nb, 5, dtype=np.int32)
    mb = np.empty((2 * rids.size, bs, bs), np.float32)
    mb[0::2], mb[1::2] = blocks[rids], blocks[rids] * 0.5
    got, want = _update_both(port, ref, np.repeat(rids, 2), {"m": mb},
                             np.tile(np.int8([-1, 1]), rids.size))
    assert got.mode == want.mode
    np.testing.assert_allclose(port.result["v"], ref.result["v"], atol=1e-5)
    blocks[rids] *= 0.5
    np.testing.assert_allclose(port.result["v"],
                               gimv.oracle(blocks, nb, bs, bvec), atol=1e-4)


def test_kmeans_parity_falls_back():
    rng = np.random.default_rng(0)
    k, dim = 3, 4
    centers = rng.normal(0, 5, (k, dim))
    pts = np.concatenate([rng.normal(c, 0.5, (100, dim)) for c in centers]
                         ).astype(np.float32)
    init = pts[rng.choice(len(pts), k, replace=False)]
    port, ref = _pair(kmeans.make_spec(k, dim, init),
                      jkmeans.make_spec(k, dim, init), tol=1e-5)
    port.run(kmeans.make_struct(pts))
    ref.run(jkmeans.make_struct(pts))
    np.testing.assert_allclose(port.result["c"], ref.result["c"], atol=1e-4)
    np.testing.assert_allclose(port.result["c"], kmeans.oracle(pts, init),
                               atol=1e-4)
    rows = rng.choice(len(pts), 30, replace=False)
    new = rng.normal(centers[1], 0.5, (30, dim)).astype(np.float32)
    buf = np.empty((60, dim), np.float32)
    buf[0::2], buf[1::2] = pts[rows], new
    got, want = _update_both(port, ref, np.repeat(rows, 2).astype(np.int32),
                             {"p": buf}, np.tile(np.int8([-1, 1]), 30))
    assert got.mode == want.mode == "iterMR-fallback"
    np.testing.assert_allclose(port.result["c"], ref.result["c"], atol=1e-4)


# ---------------------------------------------------------------------------
# the reverse index, and the last one-step app
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(4))
def test_reverse_index_and_records_of_dks(seed):
    import torch
    rng = np.random.default_rng(seed)
    n, k = 200, 23
    keys = rng.integers(0, 500, n).astype(np.int32)
    valid = rng.random(n) < 0.8
    got = incr_iter.build_reverse_index(lambda sk: torch.remainder(sk, k),
                                        keys, valid, k)
    want = jincr.build_reverse_index(lambda sk: sk % k, keys, valid, k)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype
    indptr, ids, _ = got
    for size in (0, 1, 5, k):
        dks = np.sort(rng.choice(k, size, replace=False))
        np.testing.assert_array_equal(
            incr_iter.records_of_dks(indptr, ids, dks),
            jincr.records_of_dks(indptr, ids, dks))


def test_apriori_accumulator_matches_oracle():
    rng = np.random.default_rng(6)
    tweets = rng.integers(0, 20, (60, 8)).astype(np.int32)
    tweets[rng.random(tweets.shape) < 0.2] = -1
    pairs = apriori.candidate_pairs(tweets, 20, top=10)
    np.testing.assert_array_equal(pairs,
                                  japriori.candidate_pairs(tweets, 20, 10))
    port, ref = _pair(apriori.make_spec(pairs), japriori.make_spec(pairs))
    port.run(apriori.make_job(tweets, pairs)[1])
    ref.run(japriori.make_job(tweets, pairs)[1])
    np.testing.assert_array_equal(port.result["c"],
                                  apriori.oracle(tweets, pairs))
    np.testing.assert_array_equal(apriori.oracle(tweets, pairs),
                                  japriori.oracle(tweets, pairs))
    rows = np.array([2, 7, 30])
    new = rng.integers(0, 20, (3, 8)).astype(np.int32)
    words = np.empty((6, 8), np.int32)
    words[0::2], words[1::2] = tweets[rows], new
    got, want = _update_both(port, ref, np.repeat(rows, 2), {"w": words},
                             np.tile(np.int8([-1, 1]), 3))
    assert got.mode == want.mode == "accumulator"
    tweets[rows] = new
    np.testing.assert_array_equal(port.result["c"], ref.result["c"])
    np.testing.assert_array_equal(port.result["c"],
                                  apriori.oracle(tweets, pairs))


@pytest.mark.parametrize("plain", [False, True], ids=["i2", "plainMR"])
def test_grow_records_then_update(plain):
    """Growing the record space pads the structure mirror with invalid
    rows (and rebuilds the reverse index) exactly as the reference does;
    the next refresh is unchanged."""
    nbrs, w = sssp.random_weighted_graph(V_SSSP, F_SSSP, seed=2)
    port, ref = _pair(sssp.make_spec(V_SSSP),
                      _jspec(jsssp.make_spec, V_SSSP), plain_shuffle=plain)
    port.run(sssp.make_struct(nbrs, w, 0))
    ref.run(jsssp.make_struct(nbrs, w, 0))
    for sess in (port, ref):
        sess.grow_records(V_SSSP + 1 + 40)
    if plain:
        pairs = [(port._driver._keys, ref._driver._keys),
                 (port._driver._valid, ref._driver._valid)]
    else:
        pj, rj = port._driver.job, ref._driver.job
        pairs = [(pj.struct_keys, rj.struct_keys),
                 (pj.struct_valid, rj.struct_valid),
                 (pj.rev_indptr, rj.rev_indptr), (pj.rev_ids, rj.rev_ids),
                 (pj.dks_host, rj.dks_host)]
    assert pairs[0][0].shape == (V_SSSP + 1 + 40,)
    for g, want in pairs:
        np.testing.assert_array_equal(g, want)
    delta, _ = _sssp_steps(nbrs, w)[0][0]
    got, want = _update_both(port, ref, *delta)
    assert got.mode == want.mode
    np.testing.assert_array_equal(port.result["d"], ref.result["d"])
