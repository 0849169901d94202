"""The port's hand-written CUDA kernels against their plain versions.

Every test here needs a card and skips without one; the file imports no
JAX, so the machine with the card runs it alone:
``PYTHONPATH=src python -m pytest tests/test_torch_cuda.py``.  Results
must be exactly equal: the sort is a total order, min and max are exact,
and the sums are of integer data or integer-valued floats (float atomics
add in a run-dependent order, which is exact there).  The SpMV's sums of
non-integer floats hold within 1e-5 of sum|contrib| per vertex.
"""
import numpy as np
import pytest
import torch

from repro_torch.api import RunConfig, Session, make_delta
from repro_torch.apps import apriori, gimv, kmeans, pagerank, sssp
from repro_torch.apps import wordcount as wc
from repro_torch.kernels import launch_counts, ops, ref, reset_launch_counts
from repro_torch.kernels.fused import fused_shuffle_reduce
from repro_torch.kernels.segment_reduce import segment_minmax, segment_sum
from repro_torch.kernels.sort_u32 import sort_lex
from repro_torch.kernels.spmv_ell import spmv_ell

INT32_MAX = 2**31 - 1
pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize("n", [1, 4096, 4097, 300_001])
def test_sort_lex(cuda, n):
    rng = np.random.default_rng(n)
    hi = torch.as_tensor(rng.integers(-2**31, 2**31, n).astype(np.int32),
                         device=cuda) // 1024
    lo = torch.as_tensor(rng.integers(0, 4, n).astype(np.int32), device=cuda)
    before = sort_lex.launches
    got = sort_lex(hi, lo)
    assert sort_lex.launches == before + 1
    for g, w in zip(got, ref.sort_lex_ref(hi, lo)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("d", [1, 3, 64])
def test_segment_sum(cuda, d):
    rng = np.random.default_rng(d)
    n, k = 50_000, 2**18 + 1
    seg = torch.as_tensor(rng.integers(-2, k + 2, n).astype(np.int32),
                          device=cuda)
    for dtype in (torch.int32, torch.float32):
        vals = torch.as_tensor(rng.integers(-9, 10, (n, d)),
                               device=cuda).to(dtype)
        got = segment_sum(seg, vals, k, out_dtype=dtype, counts=True)
        want = ref.segment_sum_ref(seg, vals, k, out_dtype=dtype, counts=True)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("n", [100, 4096, 20_000])
def test_fused(cuda, n):
    rng = np.random.default_rng(n)
    k2 = rng.integers(0, max(n // 16, 2), n).astype(np.int32)
    valid = rng.random(n) < 0.9
    keys = np.full(2048, INT32_MAX, np.int32)
    aff = np.unique(k2[valid])[:2048]
    keys[:aff.size] = aff
    args = [torch.as_tensor(a, device=cuda) for a in (
        np.where(valid, k2, INT32_MAX).astype(np.int32),
        rng.integers(0, 8, n).astype(np.int32),
        rng.integers(-20, 20, (n, 2)).astype(np.float32), valid,
        np.where(rng.random(n) < 0.75, 1, -1).astype(np.int8), keys)]
    got = fused_shuffle_reduce(*args, out_dtype=torch.float32)
    want = ref.fused_shuffle_reduce_ref(*args, out_dtype=torch.float32)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("kind", ["min", "max"])
@pytest.mark.parametrize("d", [1, 3, 64])
def test_segment_minmax(cuda, kind, d):
    rng = np.random.default_rng(d)
    for n, k in ((50_000, 2**18 + 1), (1000, 1), (300, 5000)):
        seg = torch.as_tensor(rng.integers(-2, k + 2, n).astype(np.int32),
                              device=cuda)
        for vals in (rng.integers(-9, 10, (n, d)).astype(np.int32),
                     rng.normal(0, 1, (n, d)).astype(np.float32)):
            v = torch.as_tensor(vals, device=cuda)
            before = segment_minmax.launches
            got = segment_minmax(kind, seg, v, k)
            assert segment_minmax.launches == before + 1
            assert torch.equal(got, ref.segment_minmax_ref(kind, seg, v, k))


def test_ops_minmax_launches_kernel(cuda):
    seg = torch.tensor([0, 1, 1, 3], dtype=torch.int32, device=cuda)
    vals = torch.tensor([2.0, -1.0, 5.0, 7.0], device=cuda)
    valid = torch.tensor([True, True, True, False], device=cuda)
    before = segment_minmax.launches
    acc, counts = ops.segment_reduce("min", seg, vals, valid, 4)
    assert segment_minmax.launches == before + 1
    assert acc.tolist() == [2.0, -1.0, float("inf"), float("inf")]
    assert counts.tolist() == [1, 2, 0, 0]


def test_spmv_ell(cuda):
    rng = np.random.default_rng(7)
    s, f, v = 20_000, 16, 30_000
    nbrs = rng.integers(0, v + 9, (s, f)).astype(np.int32)
    nbrs[rng.random((s, f)) < 0.5] = -1
    nb = torch.as_tensor(nbrs, device=cuda)
    ints = torch.as_tensor(rng.integers(-9, 10, (s, f)), device=cuda).float()
    before = spmv_ell.launches
    assert torch.equal(spmv_ell(nb, ints, v), ref.spmv_ell_ref(nb, ints, v))
    assert spmv_ell.launches == before + 1
    c = torch.as_tensor(rng.normal(0, 1, (s, f)).astype(np.float32),
                        device=cuda)
    err = (spmv_ell(nb, c, v) - ref.spmv_ell_ref(nb, c, v)).abs()
    scale = ref.spmv_ell_ref(nb, c.abs(), v).clamp_min(1)
    assert bool((err <= 1e-5 * scale).all())


def test_sssp_session_on_card_equals_cpu(cuda):
    nbrs, w = sssp.random_weighted_graph(3000, 8, seed=1)
    rng = np.random.default_rng(2)
    rows = rng.choice(3000, 30, replace=False)
    new = nbrs[rows].copy()
    new[rng.random(new.shape) < 0.3] = -1
    nb = np.empty((60, 8), np.int32)
    nb[0::2], nb[1::2] = nbrs[rows], new
    delta = (np.repeat(rows + 1, 2), {"nbrs": nb,
                                      "w": np.repeat(w[rows], 2, axis=0)},
             np.tile(np.int8([-1, 1]), 30))
    results = []
    for device in ("cuda", "cpu"):
        reset_launch_counts()
        sess = Session(sssp.make_spec(3000), RunConfig(device=device))
        sess.run(sssp.make_struct(nbrs, w, 0))
        rep = sess.update(make_delta(*delta))
        assert rep.mode == "i2"
        results.append((sess.result["d"], [
            (l.n_affected_dks, l.n_emitted) for l in rep.logs]))
        if device == "cuda":
            assert launch_counts()["segment_minmax"] > 0
    np.testing.assert_array_equal(results[0][0], results[1][0])
    assert results[0][1] == results[1][1]


@pytest.mark.parametrize("path", ["mrbg", "auto"])
def test_wordcount_session_on_card_equals_cpu(cuda, path):
    rng = np.random.default_rng(0)
    docs = rng.integers(0, 500, (3000, 16)).astype(np.int32)
    rows = rng.choice(3000, 40, replace=False)
    new = rng.integers(0, 500, (40, 16)).astype(np.int32)
    words = np.empty((80, 16), np.int32)
    words[0::2], words[1::2] = docs[rows], new
    delta = (np.repeat(rows, 2), {"w": words}, np.tile(np.int8([-1, 1]), 40))
    results = []
    for device in ("cuda", "cpu"):
        reset_launch_counts()
        sess = Session(wc.make_spec(500), RunConfig(device=device,
                                                    onestep_path=path))
        sess.run(wc.make_job(docs, 500)[1])
        sess.update(make_delta(*delta))
        results.append(sess.result["c"])
        if device == "cuda":
            assert launch_counts()["segment_sum"] > 0
    np.testing.assert_array_equal(results[0], results[1])
    docs[rows] = new
    np.testing.assert_array_equal(results[0], wc.oracle(docs, 500))


def _app_case(name, rng):
    """(spec, data, delta) of a small job of each other app, from rng."""
    if name in ("pagerank", "plainMR"):
        nbrs = pagerank.random_graph(2000, 8, seed=3)
        rows = rng.choice(2000, 20, replace=False)
        new = pagerank.graph_mutator(2000)(rng, rows, {"nbrs": nbrs[rows]})
        nb = np.empty((40, 8), np.int32)
        nb[0::2], nb[1::2] = nbrs[rows], new["nbrs"]
        return (*pagerank.make_job(nbrs), (np.repeat(rows, 2), {"nbrs": nb},
                                           np.tile(np.int8([-1, 1]), 20)))
    if name == "gimv":
        blocks = gimv.random_blocks(6, 16, seed=4, density=0.5)
        rids = np.arange(0, 36, 7, dtype=np.int32)
        mb = np.empty((2 * rids.size, 16, 16), np.float32)
        mb[0::2], mb[1::2] = blocks[rids], blocks[rids] * 0.5
        return (*gimv.make_job(blocks, 6, 16, np.ones((6, 16), np.float32)),
                (np.repeat(rids, 2), {"m": mb},
                 np.tile(np.int8([-1, 1]), rids.size)))
    if name == "kmeans":
        pts = np.concatenate([rng.normal(c, 0.5, (500, 4)) for c in
                              (-6.0, 0.0, 6.0)]).astype(np.float32)
        rows = rng.choice(1500, 40, replace=False)
        buf = np.empty((80, 4), np.float32)
        buf[0::2], buf[1::2] = pts[rows], pts[rows] + 1
        return (*kmeans.make_job(pts, pts[[0, 700, 1400]]),
                (np.repeat(rows, 2), {"p": buf},
                 np.tile(np.int8([-1, 1]), 40)))
    tweets = rng.integers(0, 30, (400, 12)).astype(np.int32)
    pairs = apriori.candidate_pairs(tweets, 30, top=20)
    rows = rng.choice(400, 10, replace=False)
    words = np.empty((20, 12), np.int32)
    words[0::2], words[1::2] = tweets[rows], tweets[rows][::-1]
    return (*apriori.make_job(tweets, pairs),
            (np.repeat(rows, 2), {"w": words}, np.tile(np.int8([-1, 1]), 10)))


@pytest.mark.parametrize("name", ["pagerank", "plainMR", "gimv", "kmeans",
                                  "apriori"])
def test_apps_on_card_match_cpu(cuda, name):
    """Each app's constants follow the device: the card path runs and
    agrees with the CPU path (float sums within 1e-4: atomics reorder
    them)."""
    results = []
    for device in ("cuda", "cpu"):
        spec, data, delta = _app_case(name, np.random.default_rng(5))
        # CPC 0 and a tight tol: no emission decision sits at a threshold
        # that reordered float sums could tip
        sess = Session(spec, RunConfig(device=device, tol=1e-7,
                                       plain_shuffle=name == "plainMR"))
        sess.run(data)
        rep = sess.update(make_delta(*delta))
        results.append((rep.mode, sess.result))
    assert results[0][0] == results[1][0]
    for n, a in results[1][1].items():
        np.testing.assert_allclose(results[0][1][n], a, atol=1e-4)
