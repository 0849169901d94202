"""The port's hand-written CUDA kernels against their plain versions.

Every test here needs a card and skips without one; the file imports no
JAX, so the machine with the card runs it alone:
``PYTHONPATH=src python -m pytest tests/test_torch_cuda.py``.  Results
must be exactly equal: the sort is a total order, and the sums are of
integer data or integer-valued floats (float atomics add in a run-
dependent order, which is exact there).
"""
import numpy as np
import pytest
import torch

from repro_torch.api import RunConfig, Session, make_delta
from repro_torch.apps import wordcount as wc
from repro_torch.kernels import launch_counts, ops, ref, reset_launch_counts
from repro_torch.kernels.fused import fused_shuffle_reduce
from repro_torch.kernels.segment_reduce import segment_sum
from repro_torch.kernels.sort_u32 import sort_lex

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


def test_minmax_raises_not_implemented(cuda):
    seg = torch.zeros(4, dtype=torch.int32, device=cuda)
    with pytest.raises(NotImplementedError, match="slice 2"):
        ops.segment_reduce("min", seg, torch.ones(4, device=cuda),
                           torch.ones(4, dtype=torch.bool, device=cuda), 2)


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
