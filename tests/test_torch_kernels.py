"""Port kernels' plain versions vs the JAX Pallas kernels (interpret mode).

The same numpy inputs, made from a seed, go through the Pallas kernel as
``tests/test_kernels.py`` runs it on the CPU and through the port's kernel
wrapper, which takes its plain version for CPU tensors.  Results must be
exactly equal: the sort's permutation is a total order, min and max are
exact, and the sums are of integer data or integer-valued floats.  The
SpMV's float sums of non-integer data hold within 1e-5 of sum|contrib|
per vertex (the one-hot matmul and ``index_add_`` add in other orders).
``test_torch_cuda.py`` holds the hand-written kernels against the same
plain versions on a card.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.fused import fused_shuffle_reduce as jax_fused
from repro.kernels.segment_reduce import (
    segment_minmax_mxu, segment_sum_counts_mxu,
)
from repro.kernels.sort_u32 import sort_lex_pallas
from repro.kernels.spmv_ell import spmv_ell as jax_spmv_ell
from repro_torch.kernels import ref
from repro_torch.kernels.fused import fused_shuffle_reduce
from repro_torch.kernels.segment_reduce import segment_minmax, segment_sum
from repro_torch.kernels.sort_u32 import sort_kv32, sort_lex
from repro_torch.kernels.spmv_ell import spmv_ell

INT32_MAX = 2**31 - 1


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Many small torch ops: without this, 6 pytest-xdist workers on 8
    cores slow them, and the reference's tests beside them, by intra-op
    fan-out."""
    was = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(was)


def _eq(got, want, msg=""):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                  err_msg=msg)


# ---------------------------------------------------------------------------
# sort_lex
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 63, 64, 65, 300])
def test_sort_lex_matches_pallas(n):
    rng = np.random.default_rng(n + 5)
    hi = rng.integers(0, max(n // 3, 2), n).astype(np.int32)
    lo = rng.integers(-3, 4, n).astype(np.int32)
    want = sort_lex_pallas(jnp.asarray(hi), jnp.asarray(lo), tile=64)
    oracle = jref.sort_lex_ref(jnp.asarray(hi), jnp.asarray(lo))
    got = sort_lex(torch.from_numpy(hi), torch.from_numpy(lo))
    for part, g, w, o in zip(("hi", "lo", "perm"), got, want, oracle):
        assert g.dtype == torch.int32
        _eq(g, w, part)
        _eq(g, o, part)


def test_sort_lex_extremes_and_kv32():
    hi = np.array([INT32_MAX, -2**31, 0, -1, INT32_MAX, 0, -2**31],
                  np.int32)
    lo = np.array([0, INT32_MAX, -1, 5, -2**31, -1, INT32_MAX], np.int32)
    got = sort_lex(torch.from_numpy(hi), torch.from_numpy(lo))
    want = jref.sort_lex_ref(jnp.asarray(hi), jnp.asarray(lo))
    for g, w in zip(got, want):
        _eq(g, w)
    keys, payload = sort_kv32(torch.from_numpy(hi),
                              torch.arange(hi.size, dtype=torch.int32))
    wk, wp = jref.sort_kv32_ref(jnp.asarray(hi), jnp.arange(hi.size))
    _eq(keys, wk)
    _eq(payload, wp)


# ---------------------------------------------------------------------------
# segment_sum (with and without counts)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,d,k", [(256, 8, 64), (1000, 3, 300),
                                   (64, 1, 1)])
@pytest.mark.parametrize("dtype", ["int32", "float32"])
def test_segment_sum_counts_matches_pallas(n, d, k, dtype):
    rng = np.random.default_rng(n * 7 + d)
    seg = rng.integers(-1, k + 3, n).astype(np.int32)    # ids outside [0, K)
    vals = rng.integers(-9, 10, (n, d)).astype(dtype)
    jdt = jnp.int32 if dtype == "int32" else jnp.float32
    want, wcnt = segment_sum_counts_mxu(jnp.asarray(seg), jnp.asarray(vals),
                                        k, out_dtype=jdt, rows=128, kblk=128)
    tdt = torch.int32 if dtype == "int32" else torch.float32
    got, cnt = segment_sum(torch.from_numpy(seg), torch.from_numpy(vals), k,
                           out_dtype=tdt, counts=True)
    assert got.dtype == tdt and cnt.dtype == torch.int32
    _eq(got, want)
    _eq(cnt, wcnt)
    _eq(segment_sum(torch.from_numpy(seg), torch.from_numpy(vals), k,
                    out_dtype=tdt), want)
    if dtype == "float32":
        _eq(got, jref.segment_reduce_ref(jnp.asarray(seg), jnp.asarray(vals),
                                         k))


def test_segment_sum_counts_without_columns():
    """vals [N, 0] with counts: the counts of the ids in range, as
    np.bincount gives them (the Pallas kernel raises at D = 0, so the plain
    version is the contract the card's launcher follows)."""
    rng = np.random.default_rng(11)
    seg = rng.integers(-2, 70, 5000).astype(np.int32)
    out, cnt = segment_sum(torch.from_numpy(seg), torch.zeros((5000, 0)), 64,
                           counts=True)
    assert out.shape == (64, 0) and cnt.dtype == torch.int32
    live = seg[(seg >= 0) & (seg < 64)]
    _eq(cnt, np.bincount(live, minlength=64).astype(np.int32))


def test_segment_sum_empty():
    out, cnt = segment_sum(torch.zeros(0, dtype=torch.int32),
                           torch.zeros((0, 4)), 8, counts=True)
    assert out.shape == (8, 4) and not out.any() and not cnt.any()
    out, cnt = segment_sum(torch.zeros(5, dtype=torch.int32),
                           torch.ones((5, 3)), 0, counts=True)
    assert out.shape == (0, 3) and cnt.shape == (0,)


# ---------------------------------------------------------------------------
# segment min / max
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["min", "max"])
def test_segment_minmax_plain_matches_reference(kind):
    rng = np.random.default_rng(3)
    seg = rng.integers(0, 12, 200).astype(np.int32)
    vals = rng.normal(0, 1, (200, 3)).astype(np.float32)
    got = ref.segment_minmax_ref(kind, torch.from_numpy(seg),
                                 torch.from_numpy(vals), 10)
    want = jref.segment_minmax_ref(kind, jnp.asarray(seg), jnp.asarray(vals),
                                   10)
    _eq(got, want)


# n, d, k as tests/test_kernels.py sweeps the sublane kernel; ids reach past
# K (dropped) and below it some segments stay empty (the identity)
@pytest.mark.parametrize("n,d,k", [(7, 3, 5), (513, 4, 129), (64, 1, 1)])
@pytest.mark.parametrize("kind", ["min", "max"])
@pytest.mark.parametrize("dtype", ["float32", "int32"])
def test_segment_minmax_matches_pallas(n, d, k, kind, dtype):
    rng = np.random.default_rng(n * 31 + d)
    seg = rng.integers(-1, k + 2, n).astype(np.int32)
    if dtype == "float32":
        vals = rng.normal(0, 1, (n, d)).astype(np.float32)
    else:
        vals = rng.integers(-50, 50, (n, d)).astype(np.int32)
    # the Pallas kernel takes ids in [0, K] (padding included); the port
    # drops any id outside [0, K), so hand Pallas the dropped rows as K
    jseg = np.where((seg >= 0) & (seg < k), seg, k).astype(np.int32)
    want = segment_minmax_mxu(kind, jnp.asarray(jseg), jnp.asarray(vals),
                              k + 1, rows=64, kblk=64)[:k]
    got = segment_minmax(kind, torch.from_numpy(seg),
                         torch.from_numpy(vals), k)
    assert got.dtype == torch.from_numpy(vals).dtype and got.shape == (k, d)
    _eq(got, want)
    empty = np.setdiff1d(np.arange(k), jseg)
    if empty.size and dtype == "float32":
        assert np.isinf(got.numpy()[empty]).all()


def _minmax_values(rng, n, d, dtype, order):
    """Values with both infinities (float32) or both int32 extremes, 10% at
    each end, in random or decreasing order of the rows."""
    u = rng.random((n, d))
    if dtype == "float32":
        vals = rng.normal(0, 100, (n, d)).astype(np.float32)
        vals[u < 0.1], vals[u > 0.9] = np.inf, -np.inf
    else:
        vals = rng.integers(-2**31, 2**31, (n, d)).astype(np.int32)
        vals[u < 0.1], vals[u > 0.9] = 2**31 - 1, -2**31
    if order == "decreasing":
        vals = np.sort(vals, axis=0)[::-1].copy()
    return vals


# K D on either side of SLAB_WORDS = 32768 words, the size of SSSP's
# refresh buckets (the segment sum's core switches variants there); against
# the reference's plain jax.ops.segment_min/max (a Pallas run at K = 32768
# would take minutes in interpret mode)
@pytest.mark.parametrize("k,d", [(32768, 1), (32769, 1), (8192, 4),
                                 (8193, 4)])
@pytest.mark.parametrize("kind", ["min", "max"])
@pytest.mark.parametrize("dtype", ["float32", "int32"])
@pytest.mark.parametrize("order", ["random", "decreasing"])
def test_segment_minmax_slab_bound_matches_reference(k, d, kind, dtype,
                                                     order):
    rng = np.random.default_rng(k + d)
    n = 3000
    seg = rng.integers(-1, k + 2, n).astype(np.int32)
    seg[:1000] = rng.integers(0, 5, 1000)        # a few hot segments
    vals = _minmax_values(rng, n, d, dtype, order)
    want = jref.segment_minmax_ref(kind, jnp.asarray(seg), jnp.asarray(vals),
                                   k)
    got = segment_minmax(kind, torch.from_numpy(seg), torch.from_numpy(vals),
                         k)
    assert got.shape == (k, d)
    _eq(got, want)


# ---------------------------------------------------------------------------
# ELL SpMV
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s,f,v", [(100, 4, 50), (500, 6, 700),
                                   (256, 8, 1024)])
def test_spmv_ell_matches_pallas(s, f, v):
    rng = np.random.default_rng(s)
    nbrs = rng.integers(0, v + 5, (s, f))               # some ids >= V
    nbrs[rng.random((s, f)) < 0.3] = -1
    nbrs = nbrs.astype(np.int32)
    contrib = rng.normal(0, 1, (s, f)).astype(np.float32)
    want = np.asarray(jax_spmv_ell(jnp.asarray(nbrs), jnp.asarray(contrib),
                                   v, rows=64, kblk=256))
    got = spmv_ell(torch.from_numpy(nbrs), torch.from_numpy(contrib), v)
    assert got.dtype == torch.float32 and got.shape == (v,)
    # float sums in another order: within 1e-5 of sum|contrib| per vertex
    scale = ref.spmv_ell_ref(torch.from_numpy(nbrs),
                             torch.from_numpy(np.abs(contrib)), v).numpy()
    assert (np.abs(got.numpy() - want) <= 1e-5 * np.maximum(scale, 1)).all()
    # integer-valued contributions sum exactly in any order
    ints = rng.integers(-9, 10, (s, f)).astype(np.float32)
    _eq(spmv_ell(torch.from_numpy(nbrs), torch.from_numpy(ints), v),
        jax_spmv_ell(jnp.asarray(nbrs), jnp.asarray(ints), v, rows=64,
                     kblk=256))


# ---------------------------------------------------------------------------
# fused_shuffle_reduce
# ---------------------------------------------------------------------------

def _fused_case(n, nkeys, d, seed):
    rng = np.random.default_rng(seed)
    k2 = rng.integers(0, nkeys, n).astype(np.int32)
    mk = rng.integers(0, 40, n).astype(np.int32)
    vals = rng.integers(-20, 20, (n, d)).astype(np.float32)
    valid = rng.random(n) < 0.9
    sign = np.where(rng.random(n) < 0.75, 1, -1).astype(np.int8)
    present = np.unique(k2[valid])
    aff = present[rng.random(present.size) < 0.8]      # some rows unrouted
    cap = 1 << max(int(np.ceil(np.log2(max(aff.size, 1)))), 3)
    keys = np.full(cap, INT32_MAX, np.int32)
    keys[:aff.size] = aff
    k2m = np.where(valid, k2, INT32_MAX).astype(np.int32)
    return k2m, mk, vals, valid, sign, keys


# n <= 128: the Pallas single-tile kernel; n > 128: its multi-tile path;
# n 12 and 40 at key_cap 8 and D 1 are the serving tier's tenant merges
@pytest.mark.parametrize("n,d", [(5, 1), (12, 1), (40, 1), (128, 3), (129, 1),
                                 (300, 2)])
def test_fused_matches_pallas(n, d):
    args = _fused_case(n, max(n // 4, 2), d, n + 99)
    want = jax_fused(*(jnp.asarray(a) for a in args), out_dtype=jnp.float32,
                     tile=128, kblk=64)
    got = fused_shuffle_reduce(*(torch.from_numpy(a) for a in args),
                               out_dtype=torch.float32)
    names = ("k2", "mk", "vals", "live", "perm", "acc", "counts")
    for name, g, w in zip(names, got, want):
        _eq(g, w, name)
    assert got[3].dtype == torch.bool
    if n in (12, 40):
        assert args[5].size == 8


def test_fused_last_writer_wins():
    """Duplicate (k2, mk) rows: exactly the last-arriving copy is live."""
    n, reps = 384, 3
    k2 = np.repeat(np.arange(n // reps, dtype=np.int32), reps)
    out = fused_shuffle_reduce(
        torch.from_numpy(k2), torch.zeros(n, dtype=torch.int32),
        torch.arange(n, dtype=torch.float32)[:, None],
        torch.ones(n, dtype=torch.bool), torch.ones(n, dtype=torch.int8),
        torch.arange(128, dtype=torch.int32), out_dtype=torch.float32)
    live = out[3].numpy()
    assert live.sum() == n // reps
    _eq(out[2][:, 0].numpy()[live], np.arange(reps - 1, n, reps))


# The large-path kernel's edge cases (one key's run covering every tile,
# no live row, the most affected keys at D > 1), on one shape so that the
# Pallas reference compiles once: N 300 in tiles of 128, key_cap 4096, D 8
@pytest.mark.parametrize("case", ["one key owns every row",
                                  "every row a tombstone",
                                  "key_cap 4096 at D=8"])
def test_fused_edge_cases_match_pallas(case):
    n, d, cap = 300, 8, 4096
    rng = np.random.default_rng(len(case))
    k2 = np.full(n, 7, np.int32) if case.startswith("one key") \
        else rng.integers(0, 3000, n).astype(np.int32)
    mk = rng.integers(0, 40, n).astype(np.int32)
    vals = rng.integers(-20, 20, (n, d)).astype(np.float32)
    valid = rng.random(n) < 0.9
    sign = np.where(rng.random(n) < 0.75, 1, -1).astype(np.int8)
    if case.startswith("every row"):
        sign[:] = -1
    # every present key, and keys with no rows, padded to key_cap
    aff = np.union1d(np.unique(k2[valid]), 3001 + np.arange(40))
    keys = np.full(cap, INT32_MAX, np.int32)
    keys[:aff.size] = aff
    args = (np.where(valid, k2, INT32_MAX).astype(np.int32), mk, vals, valid,
            sign, keys)
    want = jax_fused(*(jnp.asarray(a) for a in args), out_dtype=jnp.float32,
                     tile=128, kblk=512)
    got = fused_shuffle_reduce(*(torch.from_numpy(a) for a in args),
                               out_dtype=torch.float32)
    names = ("k2", "mk", "vals", "live", "perm", "acc", "counts")
    for name, g, w in zip(names, got, want):
        _eq(g, w, name)
    if case.startswith("every row"):
        assert not got[3].any() and not got[6].any()
