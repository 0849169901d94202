"""Port kernels' plain versions vs the JAX Pallas kernels (interpret mode).

The same numpy inputs, made from a seed, go through the Pallas kernel as
``tests/test_kernels.py`` runs it on the CPU and through the port's kernel
wrapper, which takes its plain version for CPU tensors.  Results must be
exactly equal: the sort's permutation is a total order, and the sums are
of integer data or integer-valued floats.  ``test_torch_cuda.py`` holds
the hand-written kernels against the same plain versions on a card.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.fused import fused_shuffle_reduce as jax_fused
from repro.kernels.segment_reduce import segment_sum_counts_mxu
from repro.kernels.sort_u32 import sort_lex_pallas
from repro_torch.kernels import ref
from repro_torch.kernels.fused import fused_shuffle_reduce
from repro_torch.kernels.segment_reduce import segment_sum
from repro_torch.kernels.sort_u32 import sort_kv32, sort_lex

INT32_MAX = 2**31 - 1


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


def test_segment_sum_empty():
    out, cnt = segment_sum(torch.zeros(0, dtype=torch.int32),
                           torch.zeros((0, 4)), 8, counts=True)
    assert out.shape == (8, 4) and not out.any() and not cnt.any()
    out, cnt = segment_sum(torch.zeros(5, dtype=torch.int32),
                           torch.ones((5, 3)), 0, counts=True)
    assert out.shape == (0, 3) and cnt.shape == (0,)


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


# n <= 128: the Pallas single-tile kernel; n > 128: its multi-tile path
@pytest.mark.parametrize("n,d", [(5, 1), (128, 3), (129, 1), (300, 2)])
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
