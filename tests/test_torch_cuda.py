"""The port's hand-written CUDA kernels against their plain versions.

Every test here needs a card and skips without one; the file imports no
JAX, so the machine with the card runs it alone:
``PYTHONPATH=src python -m pytest tests/test_torch_cuda.py``.  Results
must be exactly equal: the sort is a total order, min and max are exact,
and the sums are of integer data or integer-valued floats (the segment
sum's float atomics add in a run-dependent order, which is exact there).
The SpMV's sums of non-integer floats hold within 1e-5 of sum|contrib|
per vertex.  The
flash kernel holds elementwise within rel * (|plain| + sum_j p_j |v_j|) of
its plain version: rel 2^-7 in bf16 (P and the output rounded to bf16),
2e-5 times the scores' scale in float32 (the same arithmetic in another
order; chip_smoke.FLASH_REL gives the reasons).  The LM on the card holds
within 2e-4 of the largest logit of the same weights on the CPU, in
float32.  Training, in float32: the attention's q, k, v gradients within
1e-4 of their largest value of the CPU's (the same dense formula, sums in
another order; chip_smoke.GRAD_REL), and a train step's loss and grad
norm within 1e-5, its parameters within lr / 10 (chip_smoke.STEP_TOL,
STEP_PARAM_TOL give the reasons).  The train step runs with PyTorch's
deterministic algorithms, which refuse cuBLAS without
``CUBLAS_WORKSPACE_CONFIG``: it is set here, before any test reaches
cuBLAS.
"""
import os

import numpy as np
import pytest
import torch

from repro_torch.api import RunConfig, Session, make_delta
from repro_torch.apps import apriori, gimv, kmeans, pagerank, sssp
from repro_torch.apps import wordcount as wc
from repro_torch.kernels import launch_counts, ops, ref, reset_launch_counts
import repro_torch.configs as C
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.fused import (
    RUN_TILE_ROWS, SMALL_MAX_ROWS, fused_shuffle_reduce,
)
from repro_torch.kernels.segment_reduce import (
    SLAB_WORDS, segment_minmax, segment_sum,
)
from repro_torch.kernels import sort_u32
from repro_torch.kernels.sort_u32 import sort_lex
from repro_torch.kernels.spmv_ell import spmv_ell
from repro_torch.launch.steps import (
    make_prefill_step, make_serve_step, make_train_step,
)
from repro_torch.models import blocks, lm
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.models.config import smoke_config

os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
INT32_MAX = 2**31 - 1
pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _sort_lanes(case, rng):
    """(hi, lo) int64 arrays of one sort case: a size with random keys, or
    an edge case of the one-sweep radix sort (TILE_ROWS is its tile)."""
    tile = sort_u32.TILE_ROWS
    sizes = {"tile-1": tile - 1, "tile+1": tile + 1,
             "many tiles": 97 * tile + 3}
    if case.isdigit() or case in sizes:
        n = int(case) if case.isdigit() else sizes[case]
        return (rng.integers(-2**31, 2**31, n) // 1024,
                rng.integers(0, 4, n))
    n = 100_003
    if case == "one bucket 2^24":               # every tile feeds one digit
        lo = np.full(2**24, 5)
        lo[::2**20] = 6
        return np.full(2**24, -9), lo
    if case == "descending":
        return np.arange(n, 0, -1) * 977, -np.arange(n)
    if case == "top digit only":
        return ((rng.integers(0, 256, n) << 24) | 0x5A5A5A) - 2**31, \
            np.full(n, 12345)
    assert case == "lowest digit only"
    return np.full(n, -77), rng.integers(0, 256, n) | 0x3C3C3C00


@pytest.mark.parametrize("case", ["1", "4096", "4097", "300001", "tile-1",
                                  "tile+1", "many tiles", "one bucket 2^24",
                                  "descending", "top digit only",
                                  "lowest digit only"])
def test_sort_lex(cuda, case):
    rng = np.random.default_rng(len(case))
    hi, lo = (torch.as_tensor(a.astype(np.int32), device=cuda)
              for a in _sort_lanes(case, rng))
    before = sort_lex.launches
    got = sort_lex(hi, lo)
    assert sort_lex.launches == before + 1
    for g, w in zip(got, ref.sort_lex_ref(hi, lo)):
        assert torch.equal(g, w)


def _segment_case(case, rng):
    """(seg, d, k) of one segment_sum case: random ids at K = 2^18 + 1 for
    D in (1, 3, 64), or an edge case of csrc/scatter_sum.cuh's variants
    (the block-private copy up to K (D + counts) = SLAB_WORDS words; above
    it the direct pass at D = 1 without counts, the partition otherwise)."""
    if case.isdigit():
        k = 2**18 + 1
        return rng.integers(-2, k + 2, 50_000), int(case), k
    n = 200_003
    w = SLAB_WORDS
    bounds = {"private edge": w // 2, "private edge + 1": w // 2 + 1,
              "direct edge": w, "direct edge + 1": w + 1,
              "D=3 edge": w // 4, "D=3 edge + 1": w // 4 + 1}
    if case in bounds:
        k = bounds[case]
        return rng.integers(-2, k + 2, n), 3 if "D=3" in case else 1, k
    if case == "one id 2^24":
        return np.full(2**24, 12345), 1, 2**18 + 1
    if case == "zipf":
        z = rng.zipf(1.2, 2**22) - 1
        z[z > 2**18] = -1
        return z, 1, 2**18 + 1
    if case == "sorted 2^20":
        return np.sort(rng.integers(0, 2**20, 2**22)), 1, 2**20
    if case == "half dropped 2^22":
        live = rng.random(2**24) < 0.5
        return np.where(live, rng.integers(0, 2**22, 2**24), 2**22), 1, 2**22
    if case == "misjudged bins":
        # the partition sizes bins from every 16th run of 128 rows
        run = np.arange(2**21) // 128
        return np.where(run % 16 == 0, rng.integers(0, 16384, 2**21),
                        (run % 16) * 16384 + rng.integers(0, 16384, 2**21)), \
            1, 2**18 + 1
    assert case == "D=0 counts"
    return rng.integers(-2, 70_000, n), 0, 65_536


@pytest.mark.parametrize("case", [
    "1", "3", "64", "private edge", "private edge + 1", "direct edge",
    "direct edge + 1", "D=3 edge", "D=3 edge + 1", "one id 2^24", "zipf",
    "sorted 2^20", "half dropped 2^22", "misjudged bins", "D=0 counts"])
def test_segment_sum(cuda, case):
    rng = np.random.default_rng(len(case))
    ids, d, k = _segment_case(case, rng)
    seg = torch.as_tensor(np.asarray(ids).astype(np.int32), device=cuda)
    for dtype in (torch.int32, torch.float32):
        vals = torch.as_tensor(rng.integers(-9, 10, (seg.numel(), d)),
                               dtype=torch.int32, device=cuda).to(dtype)
        before = segment_sum.launches
        got = segment_sum(seg, vals, k, out_dtype=dtype, counts=True)
        assert segment_sum.launches == before + 1
        want = ref.segment_sum_ref(seg, vals, k, out_dtype=dtype, counts=True)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert torch.equal(segment_sum(seg, vals, k, out_dtype=dtype),
                           want[0])


@pytest.mark.parametrize("n", [100, SMALL_MAX_ROWS, 20_000])
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


def _fused_rows(case, rng, d, float_vals=False):
    """Rows of one case of the large path's runs kernel (csrc/fused.cu:
    tiles of RUN_TILE_ROWS sorted rows at D = 1, a warp's 32 at D > 1)."""
    n, nkeys = {"run longer than a tile": (5 * RUN_TILE_ROWS + 7, 2),
                "one key owns every row": (2**18, 1),
                "every row a tombstone": (30_000, 300),
                "key_cap 4096": (100_000, 4000)}[case]
    k2 = np.full(n, 7) if nkeys == 1 else rng.integers(0, nkeys, n)
    valid = rng.random(n) < 0.9
    sign = np.where(rng.random(n) < 0.75, 1, -1).astype(np.int8)
    if case == "every row a tombstone":
        sign[:] = -1
    aff = np.union1d(np.unique(k2[valid]), nkeys + 3 * np.arange(90))
    keys = np.full(4096 if case == "key_cap 4096" else 1024, INT32_MAX,
                   np.int32)
    keys[:aff.size] = aff
    vals = rng.normal(0, 1, (n, d)) if float_vals \
        else rng.integers(-20, 20, (n, d))
    return [torch.as_tensor(a, device="cuda") for a in (
        np.where(valid, k2, INT32_MAX).astype(np.int32),
        rng.integers(0, 8, n).astype(np.int32), vals.astype(np.float32),
        valid, sign, keys)]


@pytest.mark.parametrize("d", [1, 8])
@pytest.mark.parametrize("case", ["run longer than a tile",
                                  "one key owns every row",
                                  "every row a tombstone", "key_cap 4096"])
def test_fused_runs(cuda, case, d):
    args = _fused_rows(case, np.random.default_rng(d), d)
    for dtype in (torch.float32, torch.int32):
        a = list(args)
        a[2] = a[2].to(dtype)
        before = fused_shuffle_reduce.launches
        got = fused_shuffle_reduce(*a, out_dtype=dtype)
        assert fused_shuffle_reduce.launches == before + 1
        for g, w in zip(got, ref.fused_shuffle_reduce_ref(*a,
                                                          out_dtype=dtype)):
            assert torch.equal(g, w)


def _one_block_rows(case, n, d, rng, float_vals=False, nkeys=None):
    """Rows of one case of the one-block path (csrc/fused.cu: one block of
    up to 1,024 threads, R rows a thread): key_cap 8 (a few of the present
    keys routed) or 4096, every row a tombstone, one key owning every row,
    40 affected keys with no rows; else key_cap the next power of two of
    the present keys."""
    if nkeys is None:
        nkeys = 1 if case == "one key owns every row" else max(n // 8, 2)
    k2 = rng.integers(0, nkeys, n)
    valid = rng.random(n) < 0.9
    sign = np.where(rng.random(n) < 0.75, 1, -1).astype(np.int8)
    if case == "every row a tombstone":
        sign[:] = -1
    aff = np.unique(k2[valid])
    if case == "affected keys with no rows":
        aff = np.union1d(aff, nkeys + 3 * np.arange(40))
    cap = {"key_cap 8": 8, "key_cap 4096": 4096}.get(
        case, 1 << max(int(np.ceil(np.log2(aff.size + 1))), 3))
    aff = np.sort(rng.choice(aff, min(cap, aff.size), replace=False))
    keys = np.full(cap, INT32_MAX, np.int32)
    keys[:aff.size] = aff
    vals = rng.normal(0, 1, (n, d)) if float_vals \
        else rng.integers(-20, 20, (n, d))
    return [torch.as_tensor(a, device="cuda") for a in (
        np.where(valid, k2, INT32_MAX).astype(np.int32),
        rng.integers(0, 8, n).astype(np.int32), vals.astype(np.float32),
        valid, sign, keys)]


@pytest.mark.parametrize("case", ["key_cap 8", "key_cap 4096",
                                  "every row a tombstone",
                                  "one key owns every row",
                                  "affected keys with no rows"])
@pytest.mark.parametrize("d", [1, 8, 512])
@pytest.mark.parametrize("n", [1, 2, 31, 32, 33, 64, 1000, SMALL_MAX_ROWS,
                               SMALL_MAX_ROWS + 1])
def test_fused_one_block(cuda, n, d, case):
    """The one-block path up to SMALL_MAX_ROWS rows, and the first size past
    it, bit for bit against the plain version on int32 and integer-valued
    float32, one launch a call on the route its n takes."""
    args = _one_block_rows(case, n, d, np.random.default_rng(n + d))
    path = "one block" if n <= SMALL_MAX_ROWS else "sort + runs"
    shape = (n, args[5].numel(), d, path)
    for dtype in (torch.int32, torch.float32):
        a = list(args)
        a[2] = a[2].to(dtype)
        before = fused_shuffle_reduce.launches
        on_shape = fused_shuffle_reduce.shapes[shape]
        got = fused_shuffle_reduce(*a, out_dtype=dtype)
        assert fused_shuffle_reduce.launches == before + 1
        assert fused_shuffle_reduce.shapes[shape] == on_shape + 1
        for g, w in zip(got, ref.fused_shuffle_reduce_ref(*a,
                                                          out_dtype=dtype)):
            assert torch.equal(g, w)


@pytest.mark.parametrize("d", [1, 8])
@pytest.mark.parametrize("rows", ["run longer than a tile", "one block"])
def test_fused_float_acc_same_every_call(cuda, rows, d):
    """Both routes add in a fixed order: non-integer float32 acc is equal
    from one call to the next, and within 1e-5 of sum|v| of the plain
    version.  The one-block case has three keys, so each run spans many
    threads and warps."""
    rng = np.random.default_rng(3)
    if rows == "one block":
        args = _one_block_rows(rows, SMALL_MAX_ROWS - 5, d, rng,
                               float_vals=True, nkeys=3)
    else:
        args = _fused_rows(rows, rng, d, float_vals=True)
    acc = fused_shuffle_reduce(*args, out_dtype=torch.float32)[5]
    assert torch.equal(acc, fused_shuffle_reduce(
        *args, out_dtype=torch.float32)[5])
    want = ref.fused_shuffle_reduce_ref(*args, out_dtype=torch.float32)[5]
    a = list(args)
    a[2] = a[2].abs()
    scale = ref.fused_shuffle_reduce_ref(*a, out_dtype=torch.float32)[5]
    assert bool(((acc - want).abs() <= 1e-5 * scale.clamp_min(1e-30)).all())


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


def _minmax_case(case, rng):
    """(seg, d, k) of one segment_minmax case at csrc/segment_minmax.cu's
    edges: N that launch blocks of 128 to 1,024 threads (the launcher's
    choice by the rows), ids random in [-2, K + 2); D = 4 (a thread a
    (row, column)); ids ascending (the refresh's runs); one id for every
    row."""
    sizes = {"blocks of 128": (200_003, 2**15, 1),
             "blocks of 256": (2**19 - 1, 2**18 + 1, 1),
             "blocks of 512": (2**20 - 1, 2**18 + 1, 1),
             "blocks of 1024": (2**21 + 3, 2**18 + 1, 1),
             "D=4": (200_003, 2**13 + 1, 4)}
    if case in sizes:
        n, k, d = sizes[case]
        return rng.integers(-2, k + 2, n), d, k
    if case == "sorted ids":
        return np.sort(rng.integers(0, 16384, 2**17)), 1, 16384
    assert case == "one id 2^22"
    return np.full(2**22, 777), 1, 2**18 + 1


@pytest.mark.parametrize("order", ["increasing", "decreasing"])
@pytest.mark.parametrize("case", ["blocks of 128", "blocks of 256",
                                  "blocks of 512", "blocks of 1024", "D=4",
                                  "sorted ids", "one id 2^22"])
def test_segment_minmax_variants(cuda, case, order):
    """Rows in increasing and decreasing order of value (every row wins in
    one of them), with both infinities and both int32 extremes."""
    rng = np.random.default_rng(len(case))
    ids, d, k = _minmax_case(case, rng)
    seg = torch.as_tensor(ids.astype(np.int32), device=cuda)
    n = seg.numel()
    u = rng.random((n, d))
    f = rng.normal(0, 100, (n, d)).astype(np.float32)
    f[u < 0.05], f[u > 0.95] = np.inf, -np.inf
    i = rng.integers(-2**31, 2**31, (n, d)).astype(np.int32)
    i[u < 0.05], i[u > 0.95] = 2**31 - 1, -2**31
    for vals in (f, i):
        vals = np.sort(vals, axis=0)
        if order == "decreasing":
            vals = vals[::-1].copy()
        v = torch.as_tensor(vals, device=cuda)
        for kind in ("min", "max"):
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


@pytest.mark.parametrize("case", ["random", "hot vertex"])
def test_spmv_ell(cuda, case):
    rng = np.random.default_rng(7)
    s, f, v = 20_000, 16, 30_000
    nbrs = rng.integers(0, v + 9, (s, f)).astype(np.int32)
    if case == "hot vertex":                 # 10% of the in-edges on one
        nbrs[rng.random((s, f)) < 0.1] = 7
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


@pytest.mark.parametrize("dtype,rel", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2**-7)])
@pytest.mark.parametrize("q_std", [1.0, 20.0])
@pytest.mark.parametrize("hd,h,kh,s", [
    pytest.param(64, 8, 8, 100, id="64-8-100"),
    # rows whose window lies wholly in a later key tile: every key of an
    # earlier tile masked for them (a finite -2e38 must give p = 1 there)
    pytest.param(64, 8, 4, 333, id="64-4-333"),
    pytest.param(128, 8, 4, 333, id="128-4-333"),
    pytest.param(256, 8, 1, 65, id="256-1-65"),
    pytest.param(256, 8, 8, 1, id="256-8-1"),
    # Qwen3-1.7B's heads around the bf16 kernel's 128-row q tile and
    # 128-key tile, and at an S that is no multiple of 64
    *(pytest.param(128, 16, 8, s, id=f"qwen3-{s}")
      for s in (1, 127, 128, 129, 200)),
    # HuBERT X-Large's heads (hd 80, KH = H: 16-column boxes) and
    # StableLM 12B's (hd 160: 32-column boxes) at an S around 64, and
    # around the wgmma kernel's 128-row q tile and 128-key tile (hd 80 also
    # over 9 tiles: its ring of 4 stages wraps twice); hd 160 at KH = H,
    # H/4 and 1
    *(pytest.param(80, 16, 16, s, id=f"hubert-{s}")
      for s in (1, 63, 64, 65, 127, 128, 129, 200, 333, 1100)),
    *(pytest.param(160, 8, 2, s, id=f"stablelm-{s}")
      for s in (1, 63, 64, 65, 127, 128, 129, 200, 333)),
    *(pytest.param(160, 8, kh, s, id=f"stablelm-kh{kh}-{s}")
      for kh in (8, 1) for s in (1, 127, 128, 129, 200, 333))])
def test_flash_attention(cuda, dtype, rel, q_std, hd, h, kh, s):
    """q at std 20 puts the scores in the softcaps' range; windows of 20
    and 50 lie under one key tile."""
    rng = np.random.default_rng(hd + s)
    q, k, v = (torch.as_tensor(rng.normal(0, sd, (2, n, s, hd)).astype(
        np.float32), device=cuda).to(dtype)
        for n, sd in ((h, q_std), (kh, 1), (kh, 1)))
    if dtype == torch.float32:
        rel *= q_std
    for opts in (dict(causal=True), dict(causal=True, window=20),
                 dict(causal=True, window=50),
                 dict(causal=True, window=20, softcap=50.0),
                 dict(causal=False),
                 dict(causal=False, window=100, softcap=30.0)):
        before = flash_attention.launches
        got = flash_attention(q, k, v, **opts)
        assert flash_attention.launches == before + 1
        want = ref.flash_attention_ref(q, k, v, **opts).float()
        a = ref.flash_attention_ref(q.float(), k.float(), v.float().abs(),
                                    **opts)
        assert got.dtype == dtype
        assert bool(((got.float() - want).abs()
                     <= rel * (want.abs() + a)).all()), opts


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hd,h,kh", [(80, 16, 16), (160, 8, 2)])
def test_flash_attention_capped_window(cuda, hd, h, kh, causal):
    """hd 80 and 160 at q std 20 with softcap 50 and a window of 40 keys
    (under one 128-key tile) over 3 tiles and a ragged last one: the
    outputs stay within the bound, and the window and the softcap each
    move most of them past it when dropped."""
    rng = np.random.default_rng(hd)
    q, k, v = (torch.as_tensor(rng.normal(0, sd, (2, n, 333, hd)).astype(
        np.float32), device=cuda).to(torch.bfloat16)
        for n, sd in ((h, 20.0), (kh, 1), (kh, 1)))
    opts = dict(causal=causal, window=40, softcap=50.0)
    got = flash_attention(q, k, v, **opts).float()
    want = ref.flash_attention_ref(q, k, v, **opts).float()
    a = ref.flash_attention_ref(q.float(), k.float(), v.float().abs(),
                                **opts)
    tol = 2**-7 * (want.abs() + a)
    assert bool(((got - want).abs() <= tol).all())
    for dropped in (dict(window=0), dict(softcap=0.0)):
        wrong = ref.flash_attention_ref(q, k, v, **{**opts, **dropped})
        assert float(((wrong.float() - want).abs() > tol).float().mean()) \
            > 0.1, dropped


@pytest.mark.parametrize("arch", ["gemma2_9b", "qwen3_1_7b"])
def test_lm_on_card_launches_flash_and_matches_cpu(cuda, arch):
    """A prefill launches the flash kernel once a layer; prefill and 40
    decode steps (Gemma 2's local window of 32 wraps) agree with the
    CPU."""
    cfg = smoke_config(C.get(arch)).replace(param_dtype="float32",
                                            compute_dtype="float32")
    model = lm.init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                           device=cuda)
    on_cpu = lm.LM(cfg, {n: p.detach().cpu()
                         for n, p in model.named_parameters()})
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (2, 40)).astype(
        np.int32)
    before = flash_attention.launches
    got = make_prefill_step(cfg, cuda)(model, {"inputs": toks})
    assert flash_attention.launches == before + cfg.n_layers
    want = make_prefill_step(cfg, "cpu")(on_cpu, {"inputs": toks})
    scale = max(1.0, float(want.abs().max()))
    assert float((got.cpu() - want).abs().max()) / scale < 2e-4
    serve, serve_cpu = make_serve_step(cfg, cuda), make_serve_step(cfg, "cpu")
    caches = lm.init_caches(cfg, 2, 40, device=cuda)
    caches_cpu = lm.init_caches(cfg, 2, 40, device="cpu")
    before = flash_attention.launches
    for t in range(40):
        got, caches = serve(model, caches, toks[:, t:t + 1])
        want, caches_cpu = serve_cpu(on_cpu, caches_cpu, toks[:, t:t + 1])
        scale = max(1.0, float(want.abs().max()))
        assert float((got.cpu() - want).abs().max()) / scale < 2e-4, t
    assert flash_attention.launches == before       # decode: plain code


@pytest.mark.parametrize("case", ["stablelm_12b@160", "hubert_xlarge@80"])
def test_new_head_dims_on_card_launch_flash_and_match_cpu(cuda, case):
    """StableLM at its hd 160 (prefill and 40 decode steps) and HuBERT at
    its hd 80 (not causal: every position's logits) at smoke width, in
    float32: one flash launch a layer, within 2e-4 of the CPU."""
    arch, hd = case.split("@")
    cfg = smoke_config(C.get(arch)).replace(
        param_dtype="float32", compute_dtype="float32", head_dim=int(hd))
    model = lm.init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                           device=cuda)
    on_cpu = lm.LM(cfg, {n: p.detach().cpu()
                         for n, p in model.named_parameters()})
    rng = np.random.default_rng(0)
    if cfg.embed_inputs:
        inputs = rng.integers(0, cfg.vocab, (2, 40)).astype(np.int32)
    else:
        inputs = rng.normal(0, 1, (2, 40, cfg.d_model)).astype(np.float32)
    before = flash_attention.launches
    with torch.inference_mode():
        got = lm.logits_fn(cfg, model, lm.forward(
            cfg, model, torch.as_tensor(inputs, device=cuda))[0])
    assert flash_attention.launches == before + cfg.n_layers
    with torch.inference_mode():
        want = lm.logits_fn(cfg, on_cpu, lm.forward(
            cfg, on_cpu, torch.as_tensor(inputs))[0])
    scale = max(1.0, float(want.abs().max()))
    assert float((got.cpu() - want).abs().max()) / scale < 2e-4
    if not cfg.causal:
        return
    serve, serve_cpu = make_serve_step(cfg, cuda), make_serve_step(cfg, "cpu")
    caches = lm.init_caches(cfg, 2, 40, device=cuda)
    caches_cpu = lm.init_caches(cfg, 2, 40, device="cpu")
    for t in range(40):
        got, caches = serve(model, caches, inputs[:, t:t + 1])
        want, caches_cpu = serve_cpu(on_cpu, caches_cpu, inputs[:, t:t + 1])
        scale = max(1.0, float(want.abs().max()))
        assert float((got.cpu() - want).abs().max()) / scale < 2e-4, t


@pytest.mark.parametrize("arch,window", [("gemma2_9b", 0), ("gemma2_9b", 32),
                                         ("qwen3_1_7b", 0)])
def test_attention_gradient_on_card_matches_cpu(cuda, arch, window):
    """blocks.attend's gradient: one flash launch a forward, none in the
    backward (the dense formula's autograd), equal to the CPU's."""
    cfg = C.get(arch).replace(param_dtype="float32", compute_dtype="float32")
    rng = np.random.default_rng(0)
    b, s, h, kh, hd = 1, 128, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    host = [torch.from_numpy(rng.normal(0, std, (b, s, n, hd)).astype(
        np.float32)) for std, n in ((8.0, h), (1.0, kh), (1.0, kh),
                                    (1.0, h))]
    grads = {}
    for dev in (cuda, torch.device("cpu")):
        q, k, v = (t.to(dev).requires_grad_() for t in host[:3])
        before = flash_attention.launches
        out = blocks.attend(cfg, q, k, v, window)
        grads[dev.type] = torch.autograd.grad(out, (q, k, v),
                                              host[3].to(dev))
        assert flash_attention.launches == before + (dev.type == "cuda")
    for got, want in zip(grads["cuda"], grads["cpu"]):
        assert float((got.cpu() - want).abs().max()) \
            <= 1e-4 * float(want.abs().max())


@pytest.mark.parametrize("arch", ["gemma2_9b", "qwen3_1_7b"])
def test_train_step_on_card_matches_cpu(cuda, arch):
    """One train step (remat full, chunked loss): 2 flash launches a layer
    (forward and recompute); loss, grad norm and parameters as the CPU's."""
    cfg = smoke_config(C.get(arch)).replace(
        param_dtype="float32", compute_dtype="float32", remat="full",
        loss_chunk=16)
    host = lm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    if arch == "gemma2_9b":
        # body matrices at 1/sqrt(input width), as chip_smoke.parity_model:
        # the reference's draw makes the smoke Gemma 2 chaotic, and two
        # devices' roundings part ways (an H100 80GB HBM3 and the CPU: grad
        # norms 3.4e-5 of themselves apart)
        with torch.no_grad():
            for n, p in host.named_parameters():
                if n.startswith("layers.") and p.ndim >= 2:
                    p /= (p.shape[0] * p.shape[1] if n.endswith(".wo")
                          else p.shape[0]) ** 0.5
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab, (2, 65)).astype(np.int32)
    batch = {"inputs": toks[:, :-1], "targets": toks[:, 1:],
             "mask": rng.random((2, 64)) < 0.9}
    opt_cfg = AdamWConfig(lr=3e-4, warmup=1, total_steps=10)
    out = {}
    for dev in (cuda, torch.device("cpu")):
        model = lm.LM(cfg, {n: p.detach().to(dev).clone()
                            for n, p in host.named_parameters()},
                      trainable=True)
        opt = adamw_init(dict(model.named_parameters()), opt_cfg)
        before = flash_attention.launches
        model, opt, m = make_train_step(cfg, opt_cfg, dev)(model, opt, batch)
        launched = flash_attention.launches - before
        assert launched == (2 * cfg.n_layers if dev.type == "cuda" else 0)
        out[dev.type] = (float(m["loss"]), float(m["grad_norm"]),
                         {n: p.detach().cpu()
                          for n, p in model.named_parameters()})
    (gl, gn, gp), (wl, wn, wp) = out["cuda"], out["cpu"]
    assert abs(gl - wl) <= 1e-5 and abs(gn - wn) <= 1e-5 * wn
    for n in wp:
        assert float((gp[n] - wp[n]).abs().max()) <= opt_cfg.lr / 10, n


# ---------------------------------------------------------------------------
# the streaming layer on the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [64, 1000, 4096, 8192])
def test_coalesce_on_card_equals_cpu_route(cuda, n):
    """The coalescer's device part and its result, bitwise against the CPU
    tensors' route; one sort and one segment sum a call."""
    from repro_torch.stream.coalesce import (
        _coalesce_kernel, coalesce_rows, pad_rows,
    )
    from repro_torch.core.kvstore import next_bucket
    rng = np.random.default_rng(n)
    rid = rng.integers(0, max(n // 3, 1), n).astype(np.int32)
    sign = rng.choice(np.int8([-1, 1]), n)
    cap = next_bucket(n, 64)
    inputs = pad_rows(rid, sign, cap, cuda)
    reset_launch_counts()
    got = _coalesce_kernel(*inputs)
    assert (launch_counts()["sort_lex"], launch_counts()["segment_sum"]) \
        == (1, 1)
    want = _coalesce_kernel(*(t.cpu() for t in inputs))
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g.cpu(), w)
    vals = {"w": rng.integers(0, 9, (n, 3)).astype(np.int32)}
    a = coalesce_rows(rid, vals, sign, device=cuda)
    b = coalesce_rows(rid, vals, sign, device="cpu")
    assert tuple(a[1:]) == tuple(b[1:])
    for x, y in ((a.delta.record_ids, b.delta.record_ids),
                 (a.delta.sign, b.delta.sign),
                 (a.delta.values["w"], b.delta.values["w"])):
        assert torch.equal(x, y)


def _stream_case(epochs=6):
    from repro_torch.stream import StreamConfig, StreamSession
    rng = np.random.default_rng(1)
    docs = rng.integers(0, 500, (3000, 16)).astype(np.int32)
    spec, data, source = wc.make_stream(docs, 500, frac=0.01, seed=2,
                                        epochs=epochs)
    ss = StreamSession(spec, data, source=source, config=RunConfig(),
                       stream=StreamConfig(max_batch_records=128))
    return ss, source


def test_stream_session_on_card_equals_oracle(cuda):
    """A background StreamSession of a few epochs on the card equals the
    oracle; every batch went through the coalescer's kernels, with a
    producer thread submitting beside the worker."""
    import threading
    from repro_torch.stream import DeltaRecord
    ss, source = _stream_case()
    reset_launch_counts()
    extra = np.arange(3000, 3010, dtype=np.int32)   # past the corpus
    words = np.random.default_rng(3).integers(0, 500, (10, 16)).astype(
        np.int32)

    def produce():
        # insert new documents, then delete them: a net no-op
        ss.submit_record(DeltaRecord(extra, {"w": words},
                                     np.ones(10, np.int8)))
        ss.submit_record(DeltaRecord(extra, {"w": words},
                                     -np.ones(10, np.int8)))
    with ss:
        t = threading.Thread(target=produce)
        t.start()
        t.join()
        ss.drain(timeout=300)
    np.testing.assert_array_equal(ss.result["c"],
                                  wc.oracle(source.values["w"], 500))
    counts = launch_counts()
    assert counts["sort_lex"] >= ss.metrics.batches >= 2
    assert counts["segment_sum"] >= ss.metrics.batches


def test_kernel_build_in_worker_marks_batch_retraced(cuda, tmp_path):
    """The worker's first batch builds the kernels into an empty build
    directory: that batch, and only it, is marked retraced."""
    from repro_torch.kernels import _build, jitcache
    ss, source = _stream_case(epochs=4)
    ss.start(background=False)
    old = _build.BUILD_DIR
    compiles = jitcache.compiles_total()
    _build.reset(tmp_path)
    try:
        with ss:
            ss.drain(timeout=600)
    finally:
        _build.reset(old)
    assert jitcache.compiles_total() == compiles + len(_build.SOURCES)
    assert ss.metrics.retrace_batches == 1 < ss.metrics.batches
    assert ss.scheduler.compile_skips == 1
    np.testing.assert_array_equal(ss.result["c"],
                                  wc.oracle(source.values["w"], 500))


@pytest.mark.parametrize("n_docs,rows", [(8, 1), (256, 64)],
                         ids=["one-block merge", "runs merge"])
def test_serve_batched_equals_solo_on_card(cuda, n_docs, rows):
    """A batched cross-tenant refresh on the card: one launch of the sort
    and of the fused merge for the group, each tenant bitwise equal to its
    solo refresh on the card and to np.bincount."""
    from repro_torch.serve import ServeTier, loadgen
    vocab, out = 512, {}
    for mode in ("batched", "solo"):
        tier = ServeTier(batch_refresh=(mode == "batched"))
        mirrors = loadgen.make_fleet(tier, 6, vocab=vocab, n_docs=n_docs,
                                     doc_len=16, seed=3)
        rng = np.random.default_rng(4)
        for _ in range(2):
            reset_launch_counts()
            for name in mirrors:
                loadgen.submit_update(tier, mirrors, name, rng, vocab,
                                      rows_per_update=rows)
            tier.drain(timeout=300)
            counts = launch_counts()
        for name, docs in mirrors.items():
            np.testing.assert_array_equal(tier[name].result["c"],
                                          wc.oracle(docs, vocab))
        out[mode] = {n: tier[n].result["c"] for n in mirrors}
        if mode == "batched":
            assert tier.stats()["batched_launches"] == 2
            # the round's one batched launch: its delta sort and its merge
            assert counts["fused_shuffle_reduce"] == 1
            assert counts["sort_lex"] >= 1
    for name, got in out["batched"].items():
        np.testing.assert_array_equal(got, out["solo"][name])


@pytest.mark.parametrize("agg", ["min", "max"])
def test_dql_min_max_query_on_card_equals_cpu(cuda, agg):
    """group_by(agg=min|max) reaches the min/max kernel on the card and
    equals the CPU's plain route exactly, run and refresh."""
    from repro_torch import dql
    from repro_torch.core.kvstore import make_kv
    rng = np.random.default_rng(5)
    n, nk = 50_000, 4096
    k = rng.integers(0, nk, n).astype(np.int32)
    v = rng.normal(size=n).astype(np.float32)
    kv = make_kv(np.arange(n, dtype=np.int32), {"k": k, "v": v})
    rows = rng.choice(n, 300, replace=False).astype(np.int32)
    kb, vb = np.repeat(k[rows], 2), np.empty(600, np.float32)
    vb[0::2], vb[1::2] = v[rows], rng.normal(size=300)
    delta = make_delta(np.repeat(rows, 2), {"k": kb, "v": vb},
                       np.tile(np.int8([-1, 1]), 300))
    res = {}
    for dev in ("cuda", "cpu"):
        q = dql.scan("x").group_by("k", num_keys=nk, value="v",
                                   agg=agg).compile(RunConfig(device=dev))
        reset_launch_counts()
        q.run(kv)
        run = q.result["v"].copy()
        q.update(delta)
        res[dev] = (run, q.result["v"], launch_counts())
    np.testing.assert_array_equal(res["cuda"][0], res["cpu"][0])
    np.testing.assert_array_equal(res["cuda"][1], res["cpu"][1])
    assert res["cuda"][2]["segment_minmax"] >= 1
    assert res["cpu"][2]["segment_minmax"] == 0


@pytest.mark.parametrize("workers", [1, 8])
def test_meshed_sessions_on_card_equal_cpu(cuda, workers):
    """8 logical shards on the card: wordcount and SSSP equal the CPU's
    meshed session bit for bit, run and update, through the sort, the
    segment sum / min-max and the fused merge; the per-shard merges on
    ``workers`` threads, and every kernel of the path launches."""
    from repro_torch.api import LocalMesh, MeshConfig
    rng = np.random.default_rng(3)
    vocab, n_docs, width = 4096, 2048, 16
    docs = rng.integers(0, vocab, (n_docs, width)).astype(np.int32)
    rows = rng.choice(n_docs, 64, replace=False)
    new = rng.integers(0, vocab, (64, width)).astype(np.int32)
    buf = np.empty((128, width), np.int32)
    buf[0::2], buf[1::2] = docs[rows], new
    wc_delta = (np.repeat(rows.astype(np.int32), 2), {"w": buf},
                np.tile(np.int8([-1, 1]), 64))
    v = 20_000
    nbrs, w = sssp.random_weighted_graph(v, 8, seed=4)
    srows = rng.choice(v, 50, replace=False)
    snew = nbrs[srows].copy()
    snew[rng.random(snew.shape) < 0.4] = -1
    nb = np.empty((100, 8), np.int32)
    nb[0::2], nb[1::2] = nbrs[srows], snew
    sssp_delta = (np.repeat(srows + 1, 2).astype(np.int32),
                  {"nbrs": nb, "w": np.repeat(w[srows], 2, axis=0)},
                  np.tile(np.int8([-1, 1]), 50))
    mc = MeshConfig(LocalMesh({"data": 8}), merge_workers=workers)
    res = {}
    for dev in ("cuda", "cpu"):
        reset_launch_counts()
        out = []
        for spec, data, delta, key in (
                (*wc.make_job(docs, vocab), wc_delta, "c"),
                (*sssp.make_job(nbrs, w, 0), sssp_delta, "d")):
            s = Session(spec, RunConfig(device=dev, mesh=mc))
            s.run(data)
            run = s.result[key].copy()
            rep = s.update(make_delta(*delta))
            assert rep.mode in ("distributed-incr", "distributed-i2")
            out.append((run, s.result[key], rep.iters))
        res[dev] = (out, launch_counts())
    for (r_gpu, u_gpu, i_gpu), (r_cpu, u_cpu, i_cpu) in zip(
            res["cuda"][0], res["cpu"][0]):
        np.testing.assert_array_equal(r_gpu, r_cpu)
        np.testing.assert_array_equal(u_gpu, u_cpu)
        assert i_gpu == i_cpu
    counts = res["cuda"][1]
    for name in ("sort_lex", "segment_sum", "segment_minmax",
                 "fused_shuffle_reduce"):
        assert counts[name] >= 1, counts
    assert not any(res["cpu"][1].values())
