"""Port dispatcher, kvstore and engine vs ``repro`` on backend="xla".

The same numpy inputs, from a seed, go through ``repro.kernels.ops`` /
``repro.core`` on the xla backend (the reference's bitwise reference) and
through the port on the CPU (the kernels' plain versions).  Sorts must
give the same permutation; reductions are of integer data or
integer-valued floats, so equality is exact.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import engine as jengine
from repro.core import incremental as jinc
from repro.core import kvstore as jkv
from repro.apps import wordcount as jwc
from repro.kernels import ops as jops
from repro_torch.apps import wordcount as wc
from repro_torch.core import engine, incremental, kvstore
from repro_torch.kernels import ops

INT32_MAX = 2**31 - 1
KINDS = ("sum", "mean", "min", "max")


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


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _values(rng, n):
    return {"f": rng.integers(-8, 9, n).astype(np.float32),
            "m": rng.integers(-8, 9, (n, 3)).astype(np.float32),
            "i": rng.integers(-100, 100, n).astype(np.int32),
            "t": rng.integers(0, 5, (n, 2, 2)).astype(np.float32)}


@pytest.mark.parametrize("n", [1, 17, 300])
def test_sort_pairs(n):
    rng = np.random.default_rng(n)
    k2 = rng.integers(0, max(n // 4, 2), n).astype(np.int32)
    mk = rng.integers(0, 3, n).astype(np.int32)
    pay = {"a": rng.integers(-100, 100, n).astype(np.int32),
           "b": rng.integers(0, 9, (n, 2)).astype(np.int32)}
    for num_keys, m in ((2, mk), (1, None)):
        want = jops.sort_pairs(jnp.asarray(k2),
                               None if m is None else jnp.asarray(m),
                               {k: jnp.asarray(v) for k, v in pay.items()},
                               num_keys=num_keys, backend="xla")
        got = ops.sort_pairs(_t(k2), None if m is None else _t(m),
                             {k: _t(v) for k, v in pay.items()},
                             num_keys=num_keys)
        for name in ("k2", "mk", "perm"):
            _eq(getattr(got, name), getattr(want, name), name)
        for name in pay:
            _eq(got.payload[name], want.payload[name], name)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n", [1, 257])
def test_segment_reduce(kind, n):
    rng = np.random.default_rng(n * 3 + len(kind))
    k = int(rng.integers(1, 40))
    seg = rng.integers(0, k + 2, n).astype(np.int32)
    valid = rng.random(n) < 0.8
    vals = _values(rng, n)
    jred = {"sum": jkv.sum_reducer(), "mean": jkv.mean_reducer(),
            "min": jkv.min_reducer(), "max": jkv.max_reducer()}[kind]
    red = {"sum": kvstore.sum_reducer(), "mean": kvstore.mean_reducer(),
           "min": kvstore.min_reducer(), "max": kvstore.max_reducer()}[kind]
    wacc, wcnt = jops.segment_reduce(
        jred, jnp.asarray(seg), {k_: jnp.asarray(v) for k_, v in vals.items()},
        jnp.asarray(valid), k, backend="xla")
    gacc, gcnt = ops.segment_reduce(red, _t(seg),
                                    {k_: _t(v) for k_, v in vals.items()},
                                    _t(valid), k)
    _eq(gcnt, wcnt, "counts")
    for name in vals:
        assert gacc[name].dtype == _t(vals[name]).dtype
        _eq(gacc[name], wacc[name], f"{kind} {name}")
    # mean divides in finalize_reduce
    keys = np.arange(k, dtype=np.int32)
    _eq(kvstore.finalize_reduce(red, _t(keys), gacc, gcnt)["m"],
        jkv.finalize_reduce(jred, jnp.asarray(keys), wacc, wcnt)["m"])


def test_group_reduce_masks_out_of_range_keys():
    rng = np.random.default_rng(4)
    keys = rng.integers(-3, 12, 200).astype(np.int32)
    vals = rng.integers(-5, 5, (200, 2)).astype(np.float32)
    valid = rng.random(200) < 0.9
    want = jops.group_reduce("sum", jnp.asarray(keys), jnp.asarray(vals),
                             jnp.asarray(valid), 10, backend="xla")
    got = ops.group_reduce("sum", _t(keys), _t(vals), _t(valid), 10)
    _eq(got[0], want[0])
    _eq(got[1], want[1])


def _shuffle_case(n, nkeys, d, seed):
    rng = np.random.default_rng(seed)
    k2 = rng.integers(0, nkeys, n).astype(np.int32)
    mk = rng.integers(0, 40, n).astype(np.int32)
    vals = rng.integers(-20, 20, (n, d)).astype(np.float32)
    valid = rng.random(n) < 0.9
    sign = np.where(rng.random(n) < 0.75, 1, -1).astype(np.int8)
    present = np.unique(k2[valid])
    aff = present[rng.random(present.size) < 0.8]
    keys = np.full(64, INT32_MAX, np.int32)
    keys[:aff.size] = aff
    return k2, mk, vals, valid, sign, keys


@pytest.mark.parametrize("fused", [None, False])
@pytest.mark.parametrize("kind", ["sum", "mean"])
def test_shuffle_reduce(fused, kind):
    args = _shuffle_case(500, 50, 2, 7)
    want = jops.shuffle_reduce(kind, *(jnp.asarray(a) for a in args),
                               backend="xla")
    got = ops.shuffle_reduce(kind, *(_t(a) for a in args), fused=fused)
    for name in ("k2", "mk", "values", "live", "perm", "acc", "counts"):
        _eq(getattr(got, name), getattr(want, name), name)


def test_shuffle_reduce_fused_rules():
    args = [_t(a) for a in _shuffle_case(40, 8, 1, 2)]
    with pytest.raises(ValueError):
        ops.shuffle_reduce("min", *args, fused=True)
    # two value leaves cannot fuse: composed path, same bits
    k2, mk, vals, valid, sign, keys = args
    two = {"a": vals, "b": vals * 2}
    sr = ops.shuffle_reduce("sum", k2, mk, two, valid, sign, keys)
    one = ops.shuffle_reduce("sum", k2, mk, vals, valid, sign, keys,
                             fused=True)
    _eq(sr.acc["a"], one.acc)
    _eq(sr.acc["b"], one.acc * 2)


def test_merge_reduce_tombstones():
    rng = np.random.default_rng(11)
    pk2 = rng.integers(0, 8, 50).astype(np.int32)
    pmk = rng.integers(0, 20, 50).astype(np.int32)
    pv = {"v": rng.integers(-8, 9, 50).astype(np.float32)}
    dk2 = rng.integers(0, 8, 40).astype(np.int32)
    dmk = rng.integers(0, 20, 40).astype(np.int32)
    dv = {"v": rng.integers(-8, 9, 40).astype(np.float32)}
    dsign = np.where(rng.random(40) < 0.4, -1, 1).astype(np.int8)
    affected = np.unique(np.concatenate([pk2, dk2]))
    keys = np.full(64, INT32_MAX, np.int32)
    keys[:affected.size] = affected
    jm, jv, jc = jinc._merge_reduce(
        jkv.sum_reducer(), 64, "xla",
        jinc._combine_edges(pk2, pmk, pv, dk2, dmk, dv, dsign),
        jnp.asarray(keys))
    m, v, c = incremental._merge_reduce(
        kvstore.sum_reducer(), 64,
        incremental._combine_edges(pk2, pmk, pv, dk2, dmk, dv, dsign,
                                   device="cpu"), _t(keys))
    _eq(c, jc)
    _eq(v["v"], jv["v"])
    for name in ("k2", "mk", "valid", "sign"):
        _eq(getattr(m, name), getattr(jm, name), name)


# ---------------------------------------------------------------------------
# kvstore and engine
# ---------------------------------------------------------------------------

def test_hash32_bitwise():
    rng = np.random.default_rng(0)
    keys = np.concatenate([
        np.array([0, -1, -2**31, 2**31 - 1, 1, 65535, 65536], np.int32),
        rng.integers(-2**31, 2**31, 1000).astype(np.int32)])
    for buckets in (1, 7, 8, 1000, 2**16 + 1):
        _eq(kvstore.hash32(_t(keys), buckets),
            jkv.hash32(jnp.asarray(keys), buckets), f"buckets={buckets}")


def test_sort_edges_and_compact():
    rng = np.random.default_rng(5)
    n = 150
    args = (rng.integers(0, 8, n), rng.integers(0, 50, n),
            {"v": rng.integers(-4, 5, (n, 3)).astype(np.float32)},
            rng.random(n) < 0.7,
            np.where(rng.random(n) < 0.2, -1, 1).astype(np.int8))
    je = jkv.make_edges(*args)
    te = kvstore.make_edges(*args)
    for got, want in ((kvstore.sort_edges(te), jkv.sort_edges(je,
                                                              backend="xla")),
                      (kvstore.compact_edges(te, 256),
                       jkv.compact_edges(je, 256)),
                      (kvstore.compact_edges(te, 100),
                       jkv.compact_edges(je, 100))):
        for name in ("k2", "mk", "valid", "sign"):
            _eq(getattr(got, name), getattr(want, name), name)
        _eq(got.v2["v"], want.v2["v"])
    s = kvstore.sort_edges(te)
    host = kvstore.edges_to_host(s, sorted_valid_first=True)
    jhost = jkv.edges_to_host(jkv.sort_edges(je, backend="xla"),
                              sorted_valid_first=True)
    for name in ("k2", "mk", "sign"):
        _eq(host[name], jhost[name], name)
    assert kvstore.next_bucket(65, 64) == jkv.next_bucket(65, 64) == 128


def test_run_onestep_wordcount():
    rng = np.random.default_rng(2)
    docs = rng.integers(0, 30, (20, 6)).astype(np.int32)
    docs[rng.random(docs.shape) < 0.1] = -1
    valid = rng.random(20) < 0.9
    ids = np.arange(20, dtype=np.int32)
    want = jengine.run_onestep(jwc.make_spec(30),
                               jwc.make_input(ids, docs, valid),
                               preserve=True, backend="xla")
    got = engine.run_onestep(wc.make_spec(30), wc.make_input(ids, docs, valid),
                             preserve=True)
    _eq(got.counts, want.counts)
    _eq(got.results.values["c"], want.results.values["c"])
    _eq(got.results.valid, want.results.valid)
    for name in ("k2", "mk", "valid", "sign"):
        _eq(getattr(got.edges, name), getattr(want.edges, name), name)
    _eq(got.results.values["c"], wc.oracle(docs, 30, valid))
    _eq(wc.oracle(docs, 30, valid), jwc.oracle(docs, 30, valid))
