#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py [--docs N] [--vertices V] [--seed S]

Runs on one CUDA card, from the root of a checkout:

  1. builds the kernel libraries from ``src/repro_torch/kernels/csrc``;
  2. holds every kernel against its plain PyTorch version on the card
     (edge cases, then the main paths' shapes, with kernel, plain and
     library times and the least time the card could take);
  3. drives the one-step path — wordcount's ``Session.run`` then two
     ``update``s, on the MRBG path and on ``auto`` (the accumulator) — at
     vocab 2^18, 64 words a document, 2^20 documents, and checks every
     step against ``np.bincount`` of the updated corpus exactly;
  4. drives the iterative path — PageRank's and SSSP's ``Session.run``
     (prime-loop convergence) then one ``update`` (incremental iterative
     refresh) — on graphs of 2^22 vertices with 16 out-slots, checking
     PageRank against a float64 power iteration within bounds derived
     from ``tol`` and the CPC threshold, and SSSP against
     ``scipy.sparse.csgraph.dijkstra``.

  5. drives the LM serving path — Gemma 2 9B at full width (9,241,705,984
     parameters, bf16, random weights from ``--seed``): ``make_prefill_step``
     on 2 requests of 8192 tokens (every attention layer through the flash
     kernel: 42 launches a prefill), then 4 requests decoded through
     ``make_serve_step`` (a 16-token prompt fed one token at a time, then
     24 greedy tokens); one more prefill and 4 more decode steps run under
     ``torch.profiler`` for the device time of the flash kernel, the
     matrix products and the rest, and the device's idle share; then the
     decode-versus-prefill parity of the two paths over 64 tokens, in
     float32 at full width and 4 layers and in bf16 at full depth.

The kernels' launch counts are set to 0 before each path and read after
it.  ``--docs`` may cut the corpus to 2^18 and ``--vertices`` the graphs
to 2^20; each cut is logged as a ``CUT`` line.

Prints the card's name and power limit, then one JSON line of per-kernel
numbers, then, as the last line, ``{"ok": true, "device": {...}}``.  Any
failure raises and exits non-zero without that line.  It imports neither
JAX nor the JAX package.
"""
from __future__ import annotations

import argparse
import gc
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

VOCAB = 2**18            # wordcount shapes: never cut
DOC_LEN = 64
FULL_DOCS = 2**20        # the scale; may be cut only as far as 2^18
MIN_DOCS = 2**18
HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory (NVIDIA data sheet)
# H100 SXM float32 rate outside the tensor cores (NVIDIA data sheet): the
# rate charged for the kernels' adds and key compares
PEAK_OPS_PER_S = 67e12
# H100 SXM dense bf16 tensor-core rate (NVIDIA data sheet): the rate
# charged for attention's two matrix products
TENSOR_BF16_FLOPS_PER_S = 989e12
INT32_MAX = 2**31 - 1
# iterative shapes: graphs of 2^22 vertices (the scale; may be cut only as
# far as 2^20), 16 out-slots, each present with probability 0.5.  The
# engine's Map keys are mk = rid * 16 + slot in int32: SSSP's (2^22 + 1)
# structure rows (the virtual root is row 0) give mk < 2^26 + 32, far
# inside int32.
FULL_VERTICES = 2**22
MIN_VERTICES = 2**20
OUT_SLOTS = 16
P_EDGE = 0.5
# PageRank's CPC threshold on the refresh: low enough that the refreshed
# ranks land far closer to the new fixpoint than the run's ranks do (about
# 1/40 of that distance, against about 1/7 at a threshold of 0.01)
PR_CPC = 1e-3
# flash attention, held elementwise: |kernel - plain| <= rel * (|plain| + A)
# with A = sum_j p_j |v_j| (the plain version on |v|), the size every
# rounding of an output is proportional to.  bf16, rel 2^-7: the kernel
# rounds P to bf16 before P.V, which moves each term p_j v_j by at most
# 2^-8 of itself (at most 2^-8 A in all), and the two outputs are rounded
# to bf16 apart (at most 2^-8 |o| each; one step of bf16 is at most
# 2^-7 |o|).  float32, rel 2e-5 times the scores' scale: 2e-5 is the bound
# of the reference's own kernel test (tests/test_kernels.py) at scores of
# unit scale, and float32 rounds each score relative to its size.
FLASH_REL = {"float32": 2e-5, "bfloat16": 2**-7}
# q drawn at std 1 and at std 20 (k and v at 1): scores of std 20 reach
# the softcaps (30, 50), the softmax rests on a few keys, |o| is about 1,
# and dropping the window or the softcap moves most outputs far past the
# bound (the main shape checks that it does)
FLASH_Q_SCALES = (1.0, 20.0)
# the main path's shape: one Gemma 2 9B attention layer of a prefill of
# 2 requests x 8192 tokens
FLASH_MAIN = (2, 16, 8, 8192, 256)           # B, H, KH, S, hd
# Qwen3-1.7B's attention (hd 128, H 16, KH 8, no softcap, global) at the
# same prefill: the other head dim the serving path takes
FLASH_QWEN = (2, 16, 8, 8192, 128)
# LM serving: Gemma 2 9B at full width (arXiv:2408.00118), bf16; prefill
# of 2 requests at its context length, decode as examples/serve_lm.py
LM_ARCH = "gemma2_9b"
LM_PARAMS = 9_241_705_984
PREFILL_BATCH, PREFILL_LEN, PREFILL_CALLS = 2, 8192, 2
DECODE_BATCH, PROMPT_LEN, GEN_LEN = 4, 16, 24
# one more prefill call and this many more decode steps run under
# torch.profiler, for the device time by kind of kernel and the idle share
PROFILE_STEPS = 4
# decode-versus-prefill parity over 64 tokens.  float32 (TF32 off): the
# reference's own bound (tests/test_models.py), at 4 layers.  bf16 at full
# depth: each layer rounds the two paths' activations to 8 bits at
# different places (flash P in bf16 against softmax probabilities in bf16,
# another matmul shape); about 4 such roundings a layer add up like a
# random walk to sqrt(42 * 4) * 2^-8 = 0.05 of the logit scale, and the
# bound allows twice that.  A wrong cache slot or mask moves the logits by
# their whole scale.
PARITY_BATCH, PARITY_LEN, PARITY_F32_LAYERS = 2, 64, 4
PARITY_TOL = {"float32": 2e-4, "bfloat16": 0.1}


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int = 5) -> float:
    """Mean milliseconds of ``fn`` on the card (CUDA events, one warm-up)."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes: int, ops: float, ops_per_s: float = PEAK_OPS_PER_S) -> dict:
    """The least time for the work: the larger of bytes (each input read
    once, each output written once) over the memory rate and operations
    over the peak rate for their type, and which of the two it is."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    if t_bytes >= t_ops:
        return {"bound_ms": t_bytes, "bound_by": "bytes"}
    return {"bound_ms": t_ops, "bound_by": "operations"}


def ptxas_summary(text: str) -> list:
    """``kernel<hd>: N registers, M bytes spilled`` for every kernel in
    nvcc's -Xptxas -v report (mangled names read by their length
    prefix)."""
    out, name, spill = [], None, "?"
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            mangled, name = m.group(1), m.group(1)
            for d in re.finditer(r"\d+(?=[A-Za-z_])", mangled):
                for i in range(d.start(), d.end()):   # any suffix of digits
                    ident = mangled[d.end():d.end() + int(mangled[i:d.end()])]
                    if re.fullmatch(r"[A-Za-z_]\w*_kernel", ident):
                        rest = mangled[d.end() + len(ident):]
                        arg = re.match(r"ILi(\d+)E(?:Lb([01])E)?", rest)
                        typed = re.match(r"I([fi])(?:Lb([01])E)?E", rest)
                        name = ident + ("" if not arg else (
                            f"<{arg.group(1)}>" if arg.group(2) is None
                            else f"<{arg.group(1)}, "
                                 f"{('false', 'true')[int(arg.group(2))]}>"))
                        if typed:
                            t = {"f": "float", "i": "int"}[typed.group(1)]
                            name = ident + (
                                f"<{t}>" if typed.group(2) is None else
                                f"<{t}, "
                                f"{('false', 'true')[int(typed.group(2))]}>")
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.append(f"{name}: {m.group(1)} registers, {spill} bytes "
                       f"spilled")
            name, spill = None, "?"
    return out


def max_abs_err(got, want) -> float:
    import torch
    if got.numel() == 0:
        return 0.0
    return float((got.to(torch.float64) - want.to(torch.float64)).abs().max())


def require_equal(name, got, want) -> None:
    import torch
    if got.shape != want.shape or got.dtype != want.dtype \
            or not torch.equal(got, want):
        raise AssertionError(
            f"{name}: kernel disagrees with its plain version "
            f"(shape {tuple(got.shape)} vs {tuple(want.shape)}, "
            f"max abs err {max_abs_err(got, want) if got.shape == want.shape else 'n/a'})")


# ---------------------------------------------------------------------------
# phase 2: every kernel against its plain version
# ---------------------------------------------------------------------------

def check_sort(dev, rng) -> None:
    """The sort against its plain version, bit for bit on all three outputs:
    sizes around the kernel's tile and of many tiles, heavy duplicates
    (also 2^24 rows in one bucket: the look-back with every tile feeding
    one digit), INT32_MAX and negative keys, descending keys, and keys
    that differ only in the top or only in the lowest digit (every other
    digit constant, so the kernel skips those passes)."""
    import torch
    from repro_torch.kernels.ref import sort_lex_ref
    from repro_torch.kernels.sort_u32 import TILE_ROWS, sort_lex
    cases = []
    for n in sorted({1, 5, 4095, 4096, 4097, TILE_ROWS - 1, TILE_ROWS,
                     TILE_ROWS + 1, 2 * TILE_ROWS - 1, 2 * TILE_ROWS + 1,
                     37 * TILE_ROWS + 5, 2**20 + 3}):
        cases.append((f"n={n}", rng.integers(0, max(n // 2, 2), n),
                      rng.integers(0, 7, n)))
    n = 100_003
    cases.append(("heavy duplicates", rng.integers(0, 2, n), np.zeros(n)))
    big = 2**24
    cases.append((f"{big} equal rows (one bucket)", np.full(big, 7),
                  np.full(big, -3)))
    lo = np.full(big, 5)
    lo[::2**20] = 6
    cases.append((f"{big} rows, all but 16 in one bucket", np.full(big, -9),
                  lo))
    hi = rng.integers(0, 50, n)
    hi[rng.random(n) < 0.3] = INT32_MAX
    lo = rng.integers(0, 50, n)
    lo[rng.random(n) < 0.3] = INT32_MAX
    cases.append(("INT32_MAX keys", hi, lo))
    cases.append(("negative keys", rng.integers(-2**31, 2**31, n),
                  rng.integers(-2**31, 2**31, n)))
    cases.append(("descending keys", np.arange(n, 0, -1) * 977,
                  -np.arange(n)))
    top = rng.integers(0, 256, n) << 24
    cases.append(("only the top digit differs", (top | 0x5A5A5A) - 2**31,
                  np.full(n, 12345)))
    cases.append(("only the lowest digit differs", np.full(n, -77),
                  (rng.integers(0, 256, n) | 0x3C3C3C00)))
    for label, hi, lo in cases:
        h = torch.as_tensor(np.asarray(hi, np.int64).astype(np.int32), device=dev)
        l = torch.as_tensor(np.asarray(lo, np.int64).astype(np.int32), device=dev)
        got = sort_lex(h, l)
        want = sort_lex_ref(h, l)
        for part, g, w in zip(("hi", "lo", "perm"), got, want):
            require_equal(f"sort_lex {label} {part}", g, w)
        log(f"  sort_lex {label}: equal")


def check_segment_sum(dev, rng) -> None:
    import torch
    from repro_torch.kernels.ref import segment_sum_ref
    from repro_torch.kernels.segment_reduce import SLAB_WORDS, segment_sum
    for k in (1, 2**18 + 1):
        for d in (1, 3, 64):
            n = 20_000 if d == 64 else 200_000
            for dtype in (torch.int32, torch.float32):
                for order in ("unsorted", "sorted"):
                    seg = rng.integers(-2, k + 3, n)        # some ids out of range
                    if order == "sorted":
                        seg = np.sort(seg)
                    s = torch.as_tensor(seg.astype(np.int32), device=dev)
                    v = torch.as_tensor(rng.integers(-50, 50, (n, d)),
                                        device=dev).to(dtype)
                    got = segment_sum(s, v, k, out_dtype=dtype, counts=True)
                    want = segment_sum_ref(s, v, k, out_dtype=dtype,
                                           counts=True)
                    require_equal(f"segment_sum sums k={k} d={d} {dtype}",
                                  got[0], want[0])
                    require_equal(f"segment_sum counts k={k} d={d}",
                                  got[1], want[1])
                    require_equal(f"segment_sum no counts k={k} d={d}",
                                  segment_sum(s, v, k, out_dtype=dtype),
                                  want[0])
            log(f"  segment_sum K={k} D={d}: int32 and integer-valued "
                f"float32, sorted and unsorted ids: equal")
    # the core's variants (csrc/scatter_sum.cuh): a block-private copy of
    # the output up to K (D + counts) = SLAB_WORDS words; above, the direct
    # pass at D = 1 without counts and the partition otherwise; bins of
    # 16384 keys (D = 1, counts) reach 2048 at K = 2^25, and one more key
    # takes two slab windows a bin; D above the slab's words splits into
    # column groups; a seg view off 16-byte alignment takes the scalar
    # loads
    cases = []
    for d in (1, 3, 64):
        for cnt in (True, False):
            kb = SLAB_WORDS // (d + cnt)
            for k in (kb - 1, kb, kb + 1):
                cases.append((f"K={k} D={d} at the private variant's "
                              f"boundary", rng.integers(-2, k + 3, 100_003),
                              d, k, (cnt,)))
    for k in (2**25, 2**25 + 1):
        cases.append((f"K={k} at the slab-window boundary",
                      rng.integers(0, k + 1, 2**20), 1, k, (True,)))
    cases.append((f"D={SLAB_WORDS + 3} (two column groups)",
                  rng.integers(-1, 6, 300), SLAB_WORDS + 3, 5,
                  (True, False)))
    n = 2**24
    cases.append((f"{n} rows on one id, K=2^18+1", np.full(n, 12345), 1,
                   2**18 + 1, (True, False)))
    cases.append((f"{n} rows on one id, K=1", np.zeros(n), 1, 1,
                  (True, False)))
    z = rng.zipf(1.2, 2**22) - 1
    z[z > 2**18] = -1                        # the tail past K dropped
    cases.append(("Zipf(1.2) ids, K=2^18+1", z, 1, 2**18 + 1, (True, False)))
    cases.append(("sorted ids, K=2^20", np.sort(rng.integers(0, 2**20, 2**22)),
                  1, 2**20, (True, False)))
    # the partition sizes its bins (16384 keys at D = 1 with counts) from
    # every 16th run of 128 rows: ids whose bin follows the run make every
    # other bin overflow its room
    run = np.arange(2**21) // 128
    ids = np.where(run % 16 == 0, rng.integers(0, 16384, 2**21),
                   (run % 16) * 16384 + rng.integers(0, 16384, 2**21))
    for d in (1, 3):
        cases.append((f"ids the bin sizing misjudges (rows past their bin's "
                      f"room), D={d}", ids, d, 2**18 + 1, (True, False)))
    live = rng.random(2**24) < 0.5
    cases.append(("K=2^22, half the rows dropped",
                   np.where(live, rng.integers(0, 2**22, 2**24), 2**22), 1,
                   2**22, (True, False)))
    for label, seg, d, k, modes in cases:
        for dtype in (torch.int32, torch.float32):
            s = torch.as_tensor(np.asarray(seg).astype(np.int32), device=dev)
            v = torch.as_tensor(rng.integers(-9, 10, (s.numel(), d)),
                                dtype=torch.int32, device=dev).to(dtype)
            for cnt in modes:
                got = segment_sum(s, v, k, out_dtype=dtype, counts=cnt)
                want = segment_sum_ref(s, v, k, out_dtype=dtype, counts=cnt)
                if cnt:
                    require_equal(f"segment_sum {label} {dtype} counts",
                                  got[1], want[1])
                    got, want = got[0], want[0]
                require_equal(f"segment_sum {label} {dtype} sums", got, want)
            del s, v, got, want
        log(f"  segment_sum {label}: int32 and integer-valued float32, "
            f"counts {' and '.join('on' if c else 'off' for c in modes)}: "
            f"equal")
    s = torch.as_tensor(rng.integers(-1, 300, 50_001).astype(np.int32),
                        device=dev)[1:]
    v = torch.as_tensor(rng.integers(-9, 10, (50_001, 1)), dtype=torch.int32,
                        device=dev).to(torch.float32)[1:]
    for k in (300, 2**18 + 1):
        got = segment_sum(s, v, k, counts=True)
        want = segment_sum_ref(s, v, k, counts=True)
        require_equal(f"segment_sum unaligned views K={k} sums", got[0],
                      want[0])
        require_equal(f"segment_sum unaligned views K={k} counts", got[1],
                      want[1])
        require_equal(f"segment_sum unaligned views K={k} no counts",
                      segment_sum(s, v, k), want[0])
    log("  segment_sum views 4 bytes off 16-byte alignment (scalar loads), "
        "private, direct and partitioned: equal")
    torch.cuda.empty_cache()
    # non-integer floats: atomics add in run-dependent order; allow the
    # reordering error of float32 sums (relative to the sum of |v|)
    n, k = 500_000, 1000
    s = torch.as_tensor(rng.integers(0, k, n).astype(np.int32), device=dev)
    v = torch.as_tensor(rng.normal(0, 1, (n, 3)).astype(np.float32), device=dev)
    err = sum_rel_err("segment_sum float", segment_sum(s, v, k),
                      segment_sum_ref(s, v, k), segment_sum_ref(s, v.abs(), k))
    log(f"  segment_sum non-integer float32: relative error {err:.3g} "
        f"(tolerance 1e-5 of sum|v|: atomic order)")


def fused_case(dev, rng, n, d, dtype, nkeys):
    """Rows with duplicate (k2, mk) runs, tombstones, invalid rows and k2
    values outside the affected set."""
    import torch
    k2 = rng.integers(0, nkeys, n).astype(np.int32)
    mk = rng.integers(0, 8, n).astype(np.int32)
    vals = rng.integers(-20, 20, (n, d))
    valid = rng.random(n) < 0.9
    sign = np.where(rng.random(n) < 0.75, 1, -1).astype(np.int8)
    present = np.unique(k2[valid])
    aff = present[rng.random(present.size) < 0.8]      # some k2 not routed
    cap = 1 << max(int(np.ceil(np.log2(max(aff.size, 1)))), 3)
    keys = np.full(cap, INT32_MAX, np.int32)
    keys[:aff.size] = aff
    t = lambda a: torch.as_tensor(a, device=dev)
    k2m = np.where(valid, k2, INT32_MAX).astype(np.int32)
    return (t(k2m), t(mk), t(vals).to(dtype), t(valid), t(sign), t(keys))


def check_fused(dev, rng) -> None:
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.fused import fused_shuffle_reduce
    from repro_torch.kernels.ref import fused_shuffle_reduce_ref
    names = ("k2", "mk", "vals", "live", "perm", "acc", "counts")
    for n in (5, 1000, 4095, 4096, 4097, 9000, 70_000):
        for d in (1, 8):
            for dtype in (torch.float32, torch.int32):
                # few distinct keys: long (k2, mk) runs straddle every
                # 4096-row boundary of the sorted order
                args = fused_case(dev, rng, n, d, dtype, max(n // 64, 2))
                got = fused_shuffle_reduce(*args, out_dtype=dtype)
                want = fused_shuffle_reduce_ref(*args, out_dtype=dtype)
                for name, g, w in zip(names, got, want):
                    require_equal(f"fused n={n} d={d} {dtype} {name}", g, w)
                # the port's composed path on the card gives the same bits
                k2m, mk, vals, valid, sign, keys = args
                fz = ops.shuffle_reduce("sum", k2m, mk, vals, valid, sign,
                                        keys, fused=True)
                cp = ops.shuffle_reduce("sum", k2m, mk, vals, valid, sign,
                                        keys, fused=False)
                for name in ("k2", "mk", "values", "live", "perm", "acc",
                             "counts"):
                    require_equal(f"fused vs composed n={n} d={d} {name}",
                                  getattr(fz, name), getattr(cp, name))
        log(f"  fused_shuffle_reduce n={n} "
            f"({'one block' if n <= 4096 else 'sort + LWW kernel'}), "
            f"D in (1, 8), int32/float32: equal to plain and to composed")


def check_segment_minmax(dev, rng) -> None:
    import torch
    from repro_torch.kernels.ref import segment_minmax_ref
    from repro_torch.kernels.segment_reduce import segment_minmax
    # K = 1; K = 5000 over 300 rows (most segments empty: the identity);
    # K = 2^18 + 1 over 2e5 rows; ids from -2 to K + 2 (out of range
    # dropped); negative values; no -0.0 (see csrc/segment_minmax.cu)
    for k, n in ((1, 1000), (5000, 300), (2**18 + 1, 200_000), (7, 0)):
        for d in (1, 3, 64):
            m = n if d < 64 else min(n, 20_000)
            s = torch.as_tensor(rng.integers(-2, k + 3, m).astype(np.int32),
                                device=dev)
            for vals in (rng.integers(-2**31, 2**31, (m, d)).astype(np.int32),
                         rng.normal(0, 100, (m, d)).astype(np.float32)):
                v = torch.as_tensor(vals, device=dev)
                for kind in ("min", "max"):
                    require_equal(f"segment_minmax {kind} k={k} n={m} d={d} "
                                  f"{v.dtype}", segment_minmax(kind, s, v, k),
                                  segment_minmax_ref(kind, s, v, k))
        log(f"  segment_minmax K={k} N={n}: min and max, D in (1, 3, 64), "
            f"int32 and float32 with negatives: equal")


def check_spmv_ell(dev, rng) -> None:
    import torch
    from repro_torch.kernels.ref import spmv_ell_ref
    from repro_torch.kernels.spmv_ell import spmv_ell
    worst = 0.0
    for s_rows, f, v in ((1000, 4, 50), (2**16, 16, 2**16), (5000, 8, 1)):
        nbrs = rng.integers(0, v + 5, (s_rows, f)).astype(np.int32)  # >= V
        nbrs[rng.random((s_rows, f)) < 0.5] = -1
        nb = torch.as_tensor(nbrs, device=dev)
        ints = torch.as_tensor(rng.integers(-9, 10, (s_rows, f)),
                               device=dev).to(torch.float32)
        require_equal(f"spmv_ell S={s_rows} F={f} V={v} integer-valued",
                      spmv_ell(nb, ints, v), spmv_ell_ref(nb, ints, v))
        c = torch.as_tensor(rng.normal(0, 1, (s_rows, f)).astype(np.float32),
                            device=dev)
        worst = max(worst, sum_rel_err(f"spmv_ell S={s_rows} F={f} V={v}",
                                       spmv_ell(nb, c, v),
                                       spmv_ell_ref(nb, c, v),
                                       spmv_ell_ref(nb, c.abs(), v)))
    # one vertex takes 10% of all in-edges (a hot bin split across blocks)
    s_rows, f, v = 2**18, 16, 2**18
    nbrs = rng.integers(0, v, (s_rows, f)).astype(np.int32)
    nbrs[rng.random((s_rows, f)) < 0.1] = 7
    nbrs[rng.random((s_rows, f)) < 0.3] = -1
    nb = torch.as_tensor(nbrs, device=dev)
    ints = torch.as_tensor(rng.integers(-9, 10, (s_rows, f)),
                           device=dev).to(torch.float32)
    require_equal("spmv_ell hot vertex integer-valued",
                  spmv_ell(nb, ints, v), spmv_ell_ref(nb, ints, v))
    c = torch.as_tensor(rng.normal(0, 1, (s_rows, f)).astype(np.float32),
                        device=dev)
    worst = max(worst, sum_rel_err("spmv_ell hot vertex", spmv_ell(nb, c, v),
                                   spmv_ell_ref(nb, c, v),
                                   spmv_ell_ref(nb, c.abs(), v)))
    log(f"  spmv_ell (also one vertex with 10% of the in-edges): "
        f"integer-valued sums equal; non-integer float32 relative error "
        f"{worst:.3g} (tolerance 1e-5 of sum|contrib|: order of the adds)")


def sum_rel_err(name, got, want, scale) -> float:
    """Error of a float32 sum kernel per output relative to the sum of the
    |terms| that reach it (``scale``); fails above 1e-5, the reordering
    error of float32 sums, since atomics add in run-dependent order."""
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} vs "
                             f"{tuple(want.shape)}")
    err = float(((got - want).abs() / scale.clamp_min(1e-30)).max()) \
        if got.numel() else 0.0
    if not err <= 1e-5:
        raise AssertionError(f"{name}: relative error {err} > 1e-5")
    return err


def flash_bound(q, k, v, opt: dict, rel: float):
    """The plain version's output (float32) and the elementwise bound
    ``rel * (|plain| + A)`` the kernel is held to (see FLASH_REL)."""
    from repro_torch.kernels.ref import flash_attention_ref
    want = flash_attention_ref(q, k, v, **opt).float()
    a = flash_attention_ref(q.float(), k.float(), v.float().abs(), **opt)
    return want, a.add_(want.abs()).mul_(rel).clamp_min_(1e-30)


def flash_share(got, want, bound) -> tuple:
    """Max |got - want| and its largest share of the bound (fails above
    1)."""
    d = (got.float() - want).abs_()
    if not d.numel():
        return 0.0, 0.0
    return float(d.max()), float(d.div_(bound).max())


def check_flash_attention(dev, rng) -> None:
    """The flash kernel against its plain version: float32 and bf16, head
    dims 64, 128, 256; KH = H, H/2, 1; S of 1, 100 and 333 (no multiple of
    either dtype's tile); causal and not; windows under one tile; softcap
    on and off; q at std 1 and 20.  Then Qwen3-1.7B's heads (hd 128, H 16,
    KH 8) at S of 1, 127, 128, 129 (around the bf16 kernel's 128-row q
    tile and 128-key tile) and 200 (no multiple of 64), with windows of 20
    and 50 keys (under one key tile) besides the options above."""
    import torch
    from repro_torch.kernels.flash_attention import flash_attention
    options = (dict(causal=True), dict(causal=True, window=20),
               dict(causal=True, softcap=50.0),
               dict(causal=True, window=20, softcap=50.0),
               dict(causal=False), dict(causal=False, window=100,
                                        softcap=30.0))
    shapes = [(8, hd, kh, s, options) for hd in (64, 128, 256)
              for kh in (8, 4, 1) for s in (1, 100, 333)]
    qwen = options + (dict(causal=True, window=50),)
    shapes += [(16, 128, 8, s, qwen) for s in (1, 127, 128, 129, 200)]
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        worst, worst_share = 0.0, 0.0
        for scale in FLASH_Q_SCALES:
            rel = FLASH_REL[name] * (scale if dtype == torch.float32 else 1)
            for h, hd, kh, s, opts in shapes:
                q, k, v = (torch.as_tensor(
                    rng.normal(0, sd, (2, n, s, hd)).astype(
                        np.float32), device=dev).to(dtype)
                    for n, sd in ((h, scale), (kh, 1), (kh, 1)))
                for opt in opts:
                    got = flash_attention(q, k, v, **opt)
                    err, share = flash_share(
                        got, *flash_bound(q, k, v, opt, rel))
                    if got.dtype != dtype or not share <= 1:
                        raise AssertionError(
                            f"flash_attention {dtype} q std {scale} "
                            f"hd={hd} H={h} KH={kh} S={s} {opt}: max "
                            f"abs err {err}, {share:.3g} of the "
                            f"bound {rel} (|plain| + A)")
                    worst = max(worst, err)
                    worst_share = max(worst_share, share)
        log(f"  flash_attention {dtype}: q std 1/20, hd 64/128/256, KH 8/4/1 "
            f"of H 8, S 1/100/333, causal or not, window 20/100, softcap "
            f"0/30/50; hd 128 H 16 KH 8 at S 1/127/128/129/200, window "
            f"20/50: max abs err {worst:.3g}, at most {worst_share:.3g} of "
            f"the bound {FLASH_REL[name]:.3g}"
            f"{' x q std' if dtype == torch.float32 else ''} (|plain| + A)")


def keys_in_range(s: int, window: int) -> int:
    """Keys a causal attention of S rows attends, summed over the rows."""
    w = window if window > 0 else s
    return sum(min(i + 1, w) for i in range(s))


def time_flash_attention(dev) -> dict:
    """The flash kernel at the main path's shape, bf16: (a) a local layer
    (window 4096, softcap 50), (b) a global layer (softcap 50), each with
    its plain version; (c) softcap 0, window 0, beside
    ``scaled_dot_product_attention``, the softcap-free yardstick (no one
    PyTorch call computes softcap 50).  q is drawn at std 20, so the
    softcap and the window act; each is shown to move most outputs past
    the bound the kernel is held to (the plain version without it).  Then
    (d) Qwen3-1.7B's heads (``FLASH_QWEN``: hd 128, softcap 0) beside
    SDPA."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ref import flash_attention_ref
    b, h, kh, s, hd = FLASH_MAIN
    gen = torch.Generator(device=dev).manual_seed(1)
    q, k, v = (torch.randn((b, n, s, hd), generator=gen, device=dev).mul_(
        sd).to(torch.bfloat16)
        for n, sd in ((h, FLASH_Q_SCALES[-1]), (kh, 1), (kh, 1)))
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * 2
    res = {}
    for label, window, cap, dropped in (
            ("local", 4096, 50.0, dict(window=0)),
            ("global", 0, 50.0, dict(softcap=0.0)),
            ("softcap0", 0, 0.0, None)):
        opt = dict(window=window, softcap=cap)
        fn = lambda: flash_attention(q, k, v, **opt)
        plain = lambda: flash_attention_ref(q, k, v, **opt)
        want, tol = flash_bound(q, k, v, opt, FLASH_REL["bfloat16"])
        err, share = flash_share(fn(), want, tol)
        if not share <= 1:
            raise AssertionError(f"flash_attention main shape {label}: max "
                                 f"abs err {err}, {share:.3g} of the bound")
        if dropped:
            wrong = flash_attention_ref(q, k, v, **{**opt, **dropped})
            moved = float(((wrong.float() - want).abs_() > tol).float()
                          .mean())
            del wrong
            if not moved > 0.1:
                raise AssertionError(
                    f"flash_attention main shape {label}: dropping "
                    f"{dropped} moves only {moved:.3g} of the outputs past "
                    f"the bound; the check cannot see that option")
        del want, tol
        flops = 4 * b * h * hd * keys_in_range(s, window)
        res[label] = dict(max_abs_err=err, share_of_bound=share,
                          ms=cuda_ms(fn),
                          **bound(nbytes, flops, TENSOR_BF16_FLOPS_PER_S))
        if dropped:
            res[label]["moved_if_dropped"] = moved
        if label == "softcap0":
            res[label]["library_ms"] = cuda_ms(
                lambda: F.scaled_dot_product_attention(
                    q, k, v, is_causal=True, enable_gqa=True))
        else:
            res[label]["plain_ms"] = cuda_ms(plain)
        res[label]["tflops"] = flops / res[label]["ms"] / 1e9
        torch.cuda.empty_cache()
    # Qwen3-1.7B's shape: hd 128, softcap 0, beside SDPA
    del q, k, v
    b, h, kh, s, hd = FLASH_QWEN
    q, k, v = (torch.randn((b, n, s, hd), generator=gen, device=dev).mul_(
        sd).to(torch.bfloat16)
        for n, sd in ((h, FLASH_Q_SCALES[-1]), (kh, 1), (kh, 1)))
    fn = lambda: flash_attention(q, k, v)
    want, tol = flash_bound(q, k, v, {}, FLASH_REL["bfloat16"])
    err, share = flash_share(fn(), want, tol)
    if not share <= 1:
        raise AssertionError(f"flash_attention hd 128 shape: max abs err "
                             f"{err}, {share:.3g} of the bound")
    del want, tol
    flops = 4 * b * h * hd * keys_in_range(s, 0)
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * 2
    res["hd128"] = dict(
        max_abs_err=err, share_of_bound=share, ms=cuda_ms(fn),
        library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True)),
        **bound(nbytes, flops, TENSOR_BF16_FLOPS_PER_S))
    res["hd128"]["tflops"] = flops / res["hd128"]["ms"] / 1e9
    del q, k, v
    torch.cuda.empty_cache()
    a, g, c, d = (res[n] for n in ("local", "global", "softcap0", "hd128"))
    return dict(
        shape=("B={} H={} KH={} S={} hd={} bf16, causal, softcap 50, q std "
               "{:g}".format(*FLASH_MAIN, FLASH_Q_SCALES[-1])),
        max_abs_err=max(r["max_abs_err"] for r in res.values()),
        share_of_bound=max(r["share_of_bound"] for r in res.values()),
        moved_without_window=a["moved_if_dropped"],
        moved_without_softcap=g["moved_if_dropped"],
        ms=g["ms"], plain_ms=g["plain_ms"], bound_ms=g["bound_ms"],
        bound_by=g["bound_by"], library_ms=c["library_ms"],
        ms_local=a["ms"], plain_ms_local=a["plain_ms"],
        bound_ms_local=a["bound_ms"], ms_softcap0=c["ms"],
        bound_ms_softcap0=c["bound_ms"], ms_hd128=d["ms"],
        library_ms_hd128=d["library_ms"], bound_ms_hd128=d["bound_ms"],
        tflops={n: r["tflops"] for n, r in res.items()},
        note=("ms, plain_ms, bound_ms: a global layer (window 0, softcap "
              "50); *_local: a local layer (window 4096); library_ms: "
              "scaled_dot_product_attention(is_causal, enable_gqa) at "
              "softcap 0, beside ms_softcap0 (the kernel there): no one "
              "PyTorch call computes softcap 50; *_hd128: Qwen3-1.7B's "
              "heads (hd 128, softcap 0) at the same B and S, SDPA beside; "
              "share_of_bound: the largest |kernel - plain| / (2^-7 "
              "(|plain| + A)); moved_*: share of the outputs the plain "
              "version without that option moves past the bound"))


# ---------------------------------------------------------------------------
# phase 2b: times at the main path's shapes
# ---------------------------------------------------------------------------

def time_kernels(dev, rng, n_edges: int, vertices: int) -> dict:
    import torch
    from repro_torch.kernels.fused import fused_shuffle_reduce
    from repro_torch.kernels.ref import (
        fused_shuffle_reduce_ref, segment_minmax_ref, segment_sum_ref,
        sort_lex_ref, spmv_ell_ref,
    )
    from repro_torch.kernels.segment_reduce import segment_minmax, segment_sum
    from repro_torch.kernels.sort_u32 import sort_lex
    from repro_torch.kernels.spmv_ell import spmv_ell
    out = {}

    # shuffle sort of the initial run: k2 = word ids, mk = rid * 64 + slot
    n = n_edges
    hi = torch.randint(0, VOCAB, (n,), device=dev, dtype=torch.int32)
    lo = torch.arange(n, device=dev, dtype=torch.int32)
    got, want = sort_lex(hi, lo), sort_lex_ref(hi, lo)
    err = max(max_abs_err(g, w) for g, w in zip(got, want))
    for part, g, w in zip(("hi", "lo", "perm"), got, want):
        require_equal(f"sort_lex main-path {part}", g, w)
    del got, want
    parts = device_shares(lambda: sort_lex(hi, lo), dev)
    log(f"  sort_lex at N={n}, one call under torch.profiler: device busy "
        f"{parts['busy_ms']:.3f} ms; by kernel (ms, summed over launches: "
        f"one count, then one a pass, the constant digits' passes "
        f"returning at once) {parts['top']}")
    packed = (hi.to(torch.int64) << 32) | (lo.to(torch.int64) + 2**31)
    out["sort_lex"] = dict(
        shape=f"N={n}", max_abs_err=err,
        ms=cuda_ms(lambda: sort_lex(hi, lo)),
        plain_ms=cuda_ms(lambda: sort_lex_ref(hi, lo)),
        library_ms=cuda_ms(lambda: torch.sort(packed, stable=True)),
        # compares: a comparison sort's n log2 n
        **bound(n * (4 + 4) + n * (4 + 4 + 4), n * math.log2(n)))
    del hi, lo, packed

    # Reduce of the initial run: unsorted word ids, D = 1, K = 2^18 + 1
    k = VOCAB + 1
    seg = torch.randint(0, VOCAB, (n,), device=dev, dtype=torch.int32)
    vals = torch.ones((n, 1), device=dev, dtype=torch.float32)
    got = segment_sum(seg, vals, k, counts=True)
    want = segment_sum_ref(seg, vals, k, counts=True)
    require_equal("segment_sum main-path sums", got[0], want[0])
    require_equal("segment_sum main-path counts", got[1], want[1])
    err = max(max_abs_err(got[0], want[0]), max_abs_err(got[1], want[1]))
    seg64 = seg.to(torch.int64)

    def library():
        torch.zeros((k, 1), device=dev).index_add_(0, seg64, vals)
        torch.bincount(seg64, minlength=k)

    out["segment_sum"] = dict(
        shape=f"N={n} D=1 K={k} unsorted", max_abs_err=err,
        ms=cuda_ms(lambda: segment_sum(seg, vals, k, counts=True)),
        plain_ms=cuda_ms(lambda: segment_sum_ref(seg, vals, k, counts=True)),
        library_ms=cuda_ms(library),
        # adds: one value and one count per row
        **bound(n * 4 + n * 4 + k * 4 + k * 4, 2 * n))
    parts = device_shares(lambda: segment_sum(seg, vals, k, counts=True), dev)
    log(f"  segment_sum at N={n}, K={k}, one call under torch.profiler: "
        f"device busy {parts['busy_ms']:.3f} ms; by kernel {parts['top']}")
    del seg, vals, seg64, got, want

    # merge of update (a): 2048 affected keys x 256 preserved rows, then
    # 2048 delta rows (tombstones and inserts), padded to 2^20 rows
    key_cap, per_key, m = 2048, 256, 2**20
    keys = np.sort(rng.choice(VOCAB, key_cap, replace=False)).astype(np.int32)
    pk2 = np.repeat(keys, per_key)
    pmk = rng.integers(0, 2**26, pk2.size).astype(np.int32)
    pick = rng.choice(pk2.size, 1024, replace=False)
    dk2 = np.concatenate([pk2[pick], rng.choice(keys, 1024)])
    dmk = np.concatenate([pmk[pick], rng.integers(0, 2**26, 1024)])
    dsign = np.concatenate([-np.ones(1024), np.ones(1024)]).astype(np.int8)
    nv = pk2.size + dk2.size
    k2 = np.full(m, INT32_MAX, np.int32)
    k2[:nv] = np.concatenate([pk2, dk2])
    mk = np.full(m, INT32_MAX, np.int32)
    mk[:nv] = np.concatenate([pmk, dmk]).astype(np.int32)
    sign = np.zeros(m, np.int8)
    sign[:pk2.size] = 1
    sign[pk2.size:nv] = dsign
    valid = np.arange(m) < nv
    t = lambda a: torch.as_tensor(a, device=dev)
    args = (t(k2), t(mk), torch.ones((m, 1), device=dev), t(valid), t(sign),
            t(keys))
    got = fused_shuffle_reduce(*args, out_dtype=torch.float32)
    want = fused_shuffle_reduce_ref(*args, out_dtype=torch.float32)
    for name, g, w in zip(("k2", "mk", "vals", "live", "perm", "acc",
                           "counts"), got, want):
        require_equal(f"fused main-path {name}", g, w)
    err = max(max_abs_err(g, w) for g, w in zip(got, want))
    read = m * (4 + 4 + 4 + 1 + 1) + key_cap * 4
    written = m * (4 + 4 + 4 + 4 + 1) + key_cap * (4 + 4)
    out["fused_shuffle_reduce"] = dict(
        shape=f"N={m} D=1 key_cap={key_cap} ({nv} valid rows)",
        max_abs_err=err,
        ms=cuda_ms(lambda: fused_shuffle_reduce(*args,
                                                out_dtype=torch.float32)),
        plain_ms=cuda_ms(lambda: fused_shuffle_reduce_ref(
            *args, out_dtype=torch.float32)),
        library_ms=None,
        # compares of the sort, then one value and one count add per row
        **bound(read + written, m * math.log2(m) + 2 * nv))
    del args, got, want
    torch.cuda.empty_cache()

    # SSSP's run Reduce: (V + 1) * 16 edge rows, half of them padding
    # slots, whose id V (= num_state) the kernel drops; D = 1, K = V
    k = vertices
    n = (vertices + 1) * OUT_SLOTS
    present = torch.rand(n, device=dev) < P_EDGE
    seg = torch.where(present,
                      torch.randint(0, k, (n,), device=dev, dtype=torch.int32),
                      torch.full((n,), k, device=dev, dtype=torch.int32))
    vals = (torch.rand((n, 1), device=dev) * 30).to(torch.float32)
    got = segment_minmax("min", seg, vals, k)
    want = segment_minmax_ref("min", seg, vals, k)
    require_equal("segment_minmax main-path", got, want)
    err = max_abs_err(torch.where(torch.isinf(got), 0.0, got),
                      torch.where(torch.isinf(want), 0.0, want))
    # the library call cannot drop rows: time it on the rows in range
    # (compacted beforehand, untimed)
    live_sid = seg.to(torch.int64)[:, None][present]
    live_vals = vals[present]
    init = torch.full((k, 1), float("inf"), device=dev)
    n_live = int(present.sum())
    out["segment_minmax"] = dict(
        shape=f"N={n} D=1 K={k} ({n_live} rows in range)", max_abs_err=err,
        ms=cuda_ms(lambda: segment_minmax("min", seg, vals, k)),
        plain_ms=cuda_ms(lambda: segment_minmax_ref("min", seg, vals, k)),
        library_ms=cuda_ms(lambda: init.clone().scatter_reduce_(
            0, live_sid, live_vals, "amin")),
        # one compare per row in range
        **bound(n * 4 + n * 4 + k * 4, n_live))
    del seg, vals, got, want, init, present, live_sid, live_vals

    # PageRank's propagation at the same graph: S = V rows of 16 slots
    nbrs = torch.where(torch.rand((k, OUT_SLOTS), device=dev) < P_EDGE,
                       torch.randint(0, k, (k, OUT_SLOTS), device=dev,
                                     dtype=torch.int32),
                       torch.full((k, OUT_SLOTS), -1, device=dev,
                                  dtype=torch.int32))
    deg = (nbrs >= 0).sum(1, keepdim=True).clamp_min(1)
    contrib = (torch.rand((k, 1), device=dev) * 2 / deg).expand(
        k, OUT_SLOTS).contiguous()
    got = spmv_ell(nbrs, contrib, k)
    want = spmv_ell_ref(nbrs, contrib, k)
    err = max_abs_err(got, want)
    sum_rel_err("spmv_ell main-path", got, want,
                spmv_ell_ref(nbrs, contrib.abs(), k))
    flat = nbrs.reshape(-1).to(torch.int64)
    flat_c = contrib.reshape(-1)
    live_sid, live_c = flat[flat >= 0], flat_c[flat >= 0]
    n_live = int((nbrs >= 0).sum())
    out["spmv_ell"] = dict(
        shape=f"S={k} F={OUT_SLOTS} V={k} ({n_live} slots in range)",
        max_abs_err=err,
        ms=cuda_ms(lambda: spmv_ell(nbrs, contrib, k)),
        plain_ms=cuda_ms(lambda: spmv_ell_ref(nbrs, contrib, k)),
        # as for segment_minmax: on the slots in range
        library_ms=cuda_ms(lambda: torch.zeros(k, device=dev).index_add_(
            0, live_sid, live_c)),
        # one add per slot in range
        **bound(k * OUT_SLOTS * (4 + 4) + k * 4, n_live))
    return out


def check_iterative_shapes(dev, rng, vertices: int) -> dict:
    """The slice-1 kernels at the shapes the iterative path gives them,
    against their plain versions: PageRank's Reduce (non-integer float32,
    counts on and off), SSSP's counts-only Reduce, and PageRank's refresh
    merge at the fused path's largest key_cap.  Float sums are held within
    1e-5 of the sum of |v| per output (``sum_rel_err``), everything else
    bit for bit.  Returns segment_sum's times and bounds at the PageRank
    and SSSP shapes (``ms_pagerank``, ``library_ms_pagerank``, ...); the
    fused kernel's are logged."""
    import torch
    from repro_torch.kernels.fused import fused_shuffle_reduce
    from repro_torch.kernels.ref import fused_shuffle_reduce_ref, segment_sum_ref
    from repro_torch.kernels.segment_reduce import segment_sum
    k = vertices

    def edge_ids(n):
        # half the slots are padding, which takes the dropped id V
        present = torch.rand(n, device=dev) < P_EDGE
        return torch.where(present, torch.randint(0, k, (n,), device=dev,
                                                  dtype=torch.int32),
                           torch.full((n,), k, device=dev, dtype=torch.int32))

    # PageRank's Reduce: V * 16 edge rows of rank shares r / deg, D = 1
    n = vertices * OUT_SLOTS
    seg = edge_ids(n)
    vals = torch.rand((n, 1), device=dev) * 2 / 8
    want = segment_sum_ref(seg, vals, k, counts=True)
    scale = segment_sum_ref(seg, vals.abs(), k)
    got = segment_sum(seg, vals, k, counts=True)
    err = sum_rel_err("segment_sum PageRank sums", got[0], want[0], scale)
    require_equal("segment_sum PageRank counts", got[1], want[1])
    err = max(err, sum_rel_err("segment_sum PageRank no counts",
                               segment_sum(seg, vals, k), want[0], scale))
    seg64 = seg.to(torch.int64)
    live = seg64 < k
    lsid, lvals = seg64[live], vals[live]

    def library():
        torch.zeros((k, 1), device=dev).index_add_(0, lsid, lvals)
        torch.bincount(lsid, minlength=k)

    n_live = int(live.sum())
    times = dict(
        ms_pagerank=cuda_ms(lambda: segment_sum(seg, vals, k, counts=True)),
        plain_ms_pagerank=cuda_ms(
            lambda: segment_sum_ref(seg, vals, k, counts=True)),
        library_ms_pagerank=cuda_ms(library),
        # seg and vals read once, sums and counts written once; a value and
        # a count add a row in range
        bound_ms_pagerank=bound(n * 8 + k * 8, 2 * n_live)["bound_ms"])
    parts = device_shares(lambda: segment_sum(seg, vals, k, counts=True),
                          dev)
    log(f"  segment_sum at PageRank's Reduce [N={n} D=1 K={k}, {n_live} rows "
        f"in range, non-integer float32]: relative error {err:.3g} "
        f"(tolerance 1e-5 of sum|v|), counts equal; kernel "
        f"{times['ms_pagerank']:.3f} ms, plain "
        f"{times['plain_ms_pagerank']:.3f} ms, library on the rows in range "
        f"{times['library_ms_pagerank']:.3f} ms, bound "
        f"{times['bound_ms_pagerank']:.3f} ms; one call under torch.profiler:"
        f" device busy {parts['busy_ms']:.3f} ms, by kernel {parts['top']}")
    del seg, vals, want, scale, got, seg64, live, lsid, lvals

    # SSSP's Reduce counts: (V + 1) * 16 edge rows, int32 ones, no sums
    n = (vertices + 1) * OUT_SLOTS
    seg = edge_ids(n)
    ones = torch.ones((n, 1), device=dev, dtype=torch.int32)
    require_equal("segment_sum SSSP counts",
                  segment_sum(seg, ones, k, out_dtype=torch.int32),
                  segment_sum_ref(seg, ones, k, out_dtype=torch.int32))
    n_live = int((seg < k).sum())
    times["ms_sssp_counts"] = cuda_ms(
        lambda: segment_sum(seg, ones, k, out_dtype=torch.int32))
    times["bound_ms_sssp_counts"] = bound(n * 8 + k * 4, n_live)["bound_ms"]
    parts = device_shares(
        lambda: segment_sum(seg, ones, k, out_dtype=torch.int32), dev)
    log(f"  segment_sum at SSSP's counts [N={n} D=1 K={k} int32, {n_live} "
        f"rows in range]: equal; kernel {times['ms_sssp_counts']:.3f} ms, "
        f"bound {times['bound_ms_sssp_counts']:.3f} ms; profiled: device "
        f"busy {parts['busy_ms']:.3f} ms, by kernel {parts['top']}")
    del seg, ones
    torch.cuda.empty_cache()

    # PageRank's refresh merge with 4096 affected keys: 8 preserved rank
    # shares each, then the delta of one refresh iteration (8192 shares
    # rewritten, 1024 tombstones, 1024 new edges), padded to 2^16 rows
    key_cap, per_key, m = 4096, 8, 2**16
    keys = np.sort(rng.choice(vertices, key_cap, replace=False)).astype(np.int32)
    pk2 = np.repeat(keys, per_key)
    pmk = rng.choice(2**26, pk2.size, replace=False).astype(np.int32)
    redo = rng.choice(pk2.size, 8192 + 1024, replace=False)
    dk2 = np.concatenate([pk2[redo], rng.choice(keys, 1024)])
    dmk = np.concatenate([pmk[redo], rng.integers(0, 2**26, 1024)])
    dsign = np.concatenate([np.ones(8192), -np.ones(1024),
                            np.ones(1024)]).astype(np.int8)
    nv = pk2.size + dk2.size
    k2 = np.full(m, INT32_MAX, np.int32)
    k2[:nv] = np.concatenate([pk2, dk2])
    mk = np.full(m, INT32_MAX, np.int32)
    mk[:nv] = np.concatenate([pmk, dmk]).astype(np.int32)
    sign = np.zeros(m, np.int8)
    sign[:pk2.size] = 1
    sign[pk2.size:nv] = dsign
    t = lambda a: torch.as_tensor(a, device=dev)
    vals = (rng.random((m, 1)) * 0.25).astype(np.float32)
    args = [t(k2), t(mk), t(vals), t(np.arange(m) < nv), t(sign), t(keys)]
    got = fused_shuffle_reduce(*args, out_dtype=torch.float32)
    want = fused_shuffle_reduce_ref(*args, out_dtype=torch.float32)
    for name, g, w in zip(("k2", "mk", "vals", "live", "perm", "acc",
                           "counts"), got, want):
        if name != "acc":
            require_equal(f"fused PageRank-refresh {name}", g, w)
    abs_args = list(args)
    abs_args[2] = args[2].abs()
    err = sum_rel_err("fused PageRank-refresh acc", got[5], want[5],
                      fused_shuffle_reduce_ref(*abs_args,
                                               out_dtype=torch.float32)[5])
    log(f"  fused_shuffle_reduce at PageRank's refresh [N={m} D=1 key_cap="
        f"{key_cap}, {nv} valid rows, non-integer float32]: acc relative "
        f"error {err:.3g} (tolerance 1e-5 of sum|v|), the rest equal; kernel "
        f"{cuda_ms(lambda: fused_shuffle_reduce(*args, out_dtype=torch.float32)):.3f}"
        f" ms, plain "
        f"{cuda_ms(lambda: fused_shuffle_reduce_ref(*args, out_dtype=torch.float32)):.3f}"
        f" ms")
    return times


# ---------------------------------------------------------------------------
# phase 3: the main path
# ---------------------------------------------------------------------------

def make_deltas(rng, docs: np.ndarray):
    """Update (a): 16 documents rewritten.  Update (b): 0.1% rewritten,
    64 deleted and 64 inserted with record ids past N.  Returns the deltas
    as (record ids, word rows, signs) and the corpus after each."""
    from repro_torch.apps import wordcount as wc
    n = docs.shape[0]
    mut = wc.doc_mutator(VOCAB)
    steps = []
    cur = np.concatenate([docs, np.full((64, DOC_LEN), -1, np.int32)])
    valid = np.concatenate([np.ones(n, bool), np.zeros(64, bool)])

    def rewrite(rows):
        new = mut(rng, rows, {"w": cur[rows]})["w"]
        rid = np.repeat(rows, 2).astype(np.int32)
        words = np.empty((2 * rows.size, DOC_LEN), np.int32)
        words[0::2] = cur[rows]
        words[1::2] = new
        sign = np.tile(np.int8([-1, 1]), rows.size)
        cur[rows] = new
        return rid, words, sign

    rows = rng.choice(n, 16, replace=False)
    steps.append(("update (a): 16 docs rewritten", rewrite(rows),
                  cur.copy(), valid.copy()))

    picked = rng.choice(n, n // 1000 + 64, replace=False)
    rid, words, sign = rewrite(picked[:n // 1000])
    gone = picked[n // 1000:]
    born = np.arange(n, n + 64)
    new = mut(rng, born, {"w": cur[born]})["w"]
    rid = np.concatenate([rid, gone, born]).astype(np.int32)
    words = np.concatenate([words, cur[gone], new])
    sign = np.concatenate([sign, -np.ones(64, np.int8), np.ones(64, np.int8)])
    valid[gone] = False
    valid[born] = True
    cur[born] = new
    steps.append((f"update (b): {n // 1000} docs rewritten, 64 deleted, "
                  f"64 inserted", (rid, words, sign), cur.copy(),
                  valid.copy()))
    return steps


def drive_path(path: str, docs: np.ndarray, steps) -> dict:
    import torch
    from repro_torch.api import RunConfig, Session, make_delta
    from repro_torch.apps import wordcount as wc
    from repro_torch.kernels import launch_counts, reset_launch_counts

    def check(sess, cur, valid, label):
        want = np.bincount(cur[valid].ravel(), minlength=VOCAB)
        got = sess.result["c"]
        if got.shape != (VOCAB,) or not np.isfinite(got).all() \
                or not np.array_equal(got, want.astype(got.dtype)):
            bad = int(np.sum(got != want))
            raise AssertionError(f"{path} {label}: result differs from "
                                 f"np.bincount at {bad} keys")

    spec, data = wc.make_job(docs, VOCAB)
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    sess = Session(spec, RunConfig(onestep_path=path))
    rep = sess.run(data)
    check(sess, docs, np.ones(docs.shape[0], bool), "run")
    log(f"  [{path}] run: {time.perf_counter() - t0:.3f} s, "
        f"{docs.size} edges, mode {rep.mode}, launches {launch_counts()}")
    for label, (rid, words, sign), cur, valid in steps:
        t0 = time.perf_counter()
        rep = sess.update(make_delta(rid, {"w": words}, sign))
        dt = time.perf_counter() - t0
        check(sess, cur, valid, label)
        log(f"  [{path}] {label}: {dt:.3f} s, {int((words >= 0).sum())} "
            f"delta edges, affected keys {rep.affected_keys}, mode "
            f"{rep.mode}, launches {launch_counts()}")
    counts = launch_counts()
    log(f"  [{path}] peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del sess, data
    gc.collect()
    torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------------------
# phase 4: the iterative path (PageRank, SSSP)
# ---------------------------------------------------------------------------

def pagerank_fixpoint(nbrs: np.ndarray, r0=None, tol: float = 1e-8,
                      max_iters: int = 1000):
    """float64 power iteration of PageRank's semantics (one ``np.bincount``
    per iteration) until the largest change is below ``tol``.  Returns the
    ranks and that last change."""
    from repro_torch.apps.pagerank import DAMPING
    v, f = nbrs.shape
    ok = nbrs >= 0
    deg = np.maximum(ok.sum(axis=1), 1)
    src = np.nonzero(ok)[0]
    dst = nbrs[ok]
    share = 1.0 / deg[src]
    r = np.ones(v) if r0 is None else np.array(r0, np.float64)
    for _ in range(max_iters):
        new = DAMPING * np.bincount(dst, weights=r[src] * share,
                                    minlength=v) + (1 - DAMPING)
        change = float(np.abs(new - r).max())
        r = new
        if change < tol:
            return r, change
    raise AssertionError(f"PageRank oracle did not reach {tol} in "
                         f"{max_iters} iterations")


def pagerank_bound(v: int, held: float, oracle_change: float) -> float:
    """L1 distance allowed between the engine's ranks and the fixpoint.

    PageRank's map r -> d A r + (1 - d) contracts the L1 norm by d (A is
    column-stochastic).  If the ranks the engine's preserved edges were
    computed from differ from its final ranks by delta, the final ranks
    satisfy r = d A (r - delta) + (1 - d), so |r - r*|_1 <= d/(1-d)
    |delta|_1; ``held`` bounds |delta|_1.  The oracle is off its own
    fixpoint by at most d/(1-d) V ``oracle_change``.  float32 rounding adds
    at most (F + 2) roundings of 2^-24 of each rank per iteration, which
    the same contraction amplifies by 1/(1-d): V (F + 2) 2^-24 / (1-d) for
    ranks averaging 1.
    """
    from repro_torch.apps.pagerank import DAMPING as d
    return (d / (1 - d) * (held + v * oracle_change)
            + v * (OUT_SLOTS + 2) * 2.0**-24 / (1 - d))


def rewire_delta(rng, nbrs: np.ndarray, frac: float):
    """PageRank's update: ``frac`` of the vertices get new out-edges
    (``pagerank.graph_mutator``).  Returns the delta's arrays and the graph
    after it."""
    from repro_torch.apps import pagerank
    v = nbrs.shape[0]
    rows = np.sort(rng.choice(v, max(int(v * frac), 1), replace=False))
    new = pagerank.graph_mutator(v, P_EDGE)(rng, rows,
                                            {"nbrs": nbrs[rows]})["nbrs"]
    nb = np.empty((2 * rows.size, nbrs.shape[1]), np.int32)
    nb[0::2], nb[1::2] = nbrs[rows], new
    after = nbrs.copy()
    after[rows] = new
    return (np.repeat(rows, 2).astype(np.int32), {"nbrs": nb},
            np.tile(np.int8([-1, 1]), rows.size)), after


def drive_pagerank(dev, rng, vertices: int) -> dict:
    import torch
    from repro_torch.api import RunConfig, Session, make_delta
    from repro_torch.apps import pagerank
    from repro_torch.kernels import launch_counts, reset_launch_counts
    nbrs = pagerank.random_graph(vertices, OUT_SLOTS, seed=int(rng.integers(
        2**31)), p_edge=P_EDGE)
    spec, data = pagerank.make_job(nbrs)
    cfg = RunConfig(device=dev.type, cpc_threshold=PR_CPC)
    log(f"  [pagerank] {vertices} vertices, {int((nbrs >= 0).sum())} edges, "
        f"tol {cfg.tol}, cpc_threshold {cfg.cpc_threshold}")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    sess = Session(spec, cfg)
    rep = sess.run(data)
    t_run = time.perf_counter() - t0
    ref, ch = pagerank_fixpoint(nbrs)
    err = float(np.abs(sess.result["r"].astype(np.float64) - ref).sum())
    # the preserved edges hold the ranks of the second-to-last iteration:
    # off the final ranks by at most the last change, at every vertex
    run_change = rep.max_change[-1]
    lim = pagerank_bound(vertices, vertices * run_change, ch)
    log(f"  [pagerank] run: {t_run:.3f} s, mode {rep.mode}, {rep.iters} "
        f"iterations, last change {run_change:.3g}; L1 error "
        f"{err:.6g} <= bound {lim:.6g}; launches {launch_counts()}")
    if not (np.isfinite(sess.result["r"]).all() and err <= lim):
        raise AssertionError(f"pagerank run: L1 error {err} > {lim}")

    (rid, vals, sign), after = rewire_delta(rng, nbrs, 0.001)
    t0 = time.perf_counter()
    rep = sess.update(make_delta(rid, vals, sign))
    t_upd = time.perf_counter() - t0
    ref2, ch2 = pagerank_fixpoint(after, r0=ref)
    err = float(np.abs(sess.result["r"].astype(np.float64) - ref2).sum())
    # what a refresh that left the run's ranks in place would score
    stale = float(np.abs(ref - ref2).sum())
    if rep.mode == "i2":
        # a vertex the refresh never touched still holds the run's last
        # change; a touched one at most the CPC threshold it held back,
        # plus the change of an emission the refresh stopped before
        # propagating (< refresh tol: the loop ended before max_iters).
        # Bounded per vertex, so by no count the engine reports.
        if rep.iters >= cfg.refresh_iters_:
            raise AssertionError("pagerank refresh hit max_iters")
        held = vertices * max(run_change,
                              cfg.cpc_threshold + cfg.refresh_tol_)
    else:
        held = vertices * cfg.refresh_tol_
    lim = pagerank_bound(vertices, held, ch2)
    log(f"  [pagerank] update ({rid.size // 2} vertices rewired): "
        f"{t_upd:.3f} s, mode {rep.mode}, {rep.iters} iterations, "
        f"L1 error {err:.6g} <= bound {lim:.6g} and < stale error "
        f"{stale:.6g} / 10")
    for l in rep.logs:
        log(f"    {l}")
    if not (np.isfinite(sess.result["r"]).all() and err <= lim):
        raise AssertionError(f"pagerank update: L1 error {err} > {lim}")
    if not err < stale / 10:
        raise AssertionError(f"pagerank update: L1 error {err} is not "
                             f"below a tenth of the stale ranks' {stale}")
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30 if dev.type == "cuda" \
        else float("nan")
    log(f"  [pagerank] launches {counts}; peak device memory {peak:.2f} GiB")
    for name in ("sort_lex", "segment_sum"):
        if dev.type == "cuda" and counts[name] == 0:
            raise AssertionError(f"pagerank path launched no {name}")
    del sess, data
    release(dev)
    return counts


def dijkstra(nbrs: np.ndarray, w: np.ndarray, src: int) -> np.ndarray:
    """scipy's Dijkstra on the same directed graph (parallel edges keep
    their lightest weight; the sparse matrix would sum them)."""
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import dijkstra as sp_dijkstra
    v = nbrs.shape[0]
    i, f = np.nonzero(nbrs >= 0)
    key = i.astype(np.int64) * v + nbrs[i, f]
    ww = w[i, f].astype(np.float64)
    order = np.lexsort((ww, key))
    key, ww = key[order], ww[order]
    first = np.r_[True, key[1:] != key[:-1]]
    g = csr_matrix((ww[first], (key[first] // v, key[first] % v)),
                   shape=(v, v))
    return sp_dijkstra(g, directed=True, indices=src)


def check_sssp(label: str, d: np.ndarray, want: np.ndarray) -> None:
    """float32 path sums within 1e-5 relative where Dijkstra reaches; at
    least INF / 2 (unreachable) exactly where it gives inf."""
    from repro_torch.apps.sssp import INF
    reach = np.isfinite(want)
    got = d.astype(np.float64)
    bad_far = int(np.sum(~reach & (got < INF / 2)))
    rel = np.abs(got[reach] - want[reach]) / np.maximum(want[reach], 1e-30)
    worst = float(rel.max()) if rel.size else 0.0
    log(f"  [sssp] {label}: {int(reach.sum())} reachable, max relative "
        f"error {worst:.3g} (tolerance 1e-5), {bad_far} unreachable "
        f"vertices below INF/2")
    if bad_far or worst > 1e-5 or not np.all(got[reach] < INF / 2):
        raise AssertionError(f"sssp {label}: disagrees with dijkstra")


def drive_sssp(dev, rng, vertices: int) -> dict:
    import torch
    from repro_torch.api import RunConfig, Session, make_delta
    from repro_torch.apps import sssp
    from repro_torch.kernels import launch_counts, reset_launch_counts
    nbrs, w = sssp.random_weighted_graph(vertices, OUT_SLOTS,
                                         seed=int(rng.integers(2**31)),
                                         p_edge=P_EDGE)
    spec, data = sssp.make_job(nbrs, w, src=0)
    log(f"  [sssp] {vertices} vertices, {int((nbrs >= 0).sum())} edges, "
        f"source 0")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    sess = Session(spec, RunConfig(device=dev.type))
    rep = sess.run(data)
    t_run = time.perf_counter() - t0
    log(f"  [sssp] run: {t_run:.3f} s, mode {rep.mode}, {rep.iters} "
        f"iterations; launches {launch_counts()}")
    check_sssp("run", sess.result["d"], dijkstra(nbrs, w, 0))

    # the update of benchmarks/fig8_overall.py: 30% of the slots of 0.1%
    # of the rows deleted
    rows = np.sort(rng.choice(vertices, max(vertices // 1000, 1),
                              replace=False))
    new = nbrs[rows].copy()
    new[rng.random(new.shape) < 0.3] = -1
    nb = np.empty((2 * rows.size, OUT_SLOTS), np.int32)
    nb[0::2], nb[1::2] = nbrs[rows], new
    t0 = time.perf_counter()
    rep = sess.update(make_delta(
        np.repeat(rows + 1, 2).astype(np.int32),
        {"nbrs": nb, "w": np.repeat(w[rows], 2, axis=0)},
        np.tile(np.int8([-1, 1]), rows.size)))
    t_upd = time.perf_counter() - t0
    nbrs[rows] = new
    log(f"  [sssp] update ({rows.size} rows, 30% of slots deleted): "
        f"{t_upd:.3f} s, mode {rep.mode}, {rep.iters} iterations")
    for l in rep.logs:
        log(f"    {l}")
    if rep.mode != "i2":
        raise AssertionError(f"sssp update ran in mode {rep.mode}, not i2")
    check_sssp("update", sess.result["d"], dijkstra(nbrs, w, 0))
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30 if dev.type == "cuda" \
        else float("nan")
    log(f"  [sssp] launches {counts}; peak device memory {peak:.2f} GiB")
    if dev.type == "cuda" and counts["segment_minmax"] == 0:
        raise AssertionError("sssp path launched no segment_minmax")
    del sess, data
    release(dev)
    return counts


# ---------------------------------------------------------------------------
# phase 5: LM serving (Gemma 2 9B at full width)
# ---------------------------------------------------------------------------

def parity_model(cfg, gen, dev):
    """Random weights at 1/sqrt(input width) for the parity checks.  The
    reference's draw (``init_params``) scales body matrices by
    1/sqrt(cycles), its stacked axis read as fan-in; at full width that
    saturates the attention softcap and makes the random network chaotic,
    so that any two orders of rounding part ways (see PERF.md).  Embedding
    and norms as the reference."""
    from repro_torch.models import lm
    from repro_torch.models.common import tree_init
    plan = {}
    for name, spec in lm.plan_model(cfg).items():
        if spec.fan_in:
            width = spec.shape[0] * spec.shape[1] if name.endswith(".wo") \
                else spec.shape[0]
            spec = spec._replace(fan_in=width)
        plan[name] = spec
    return lm.LM(cfg, tree_init(plan, gen, cfg.dtype("param"), dev))


def decode_vs_prefill(cfg, model, toks, dev) -> float:
    """Largest gap between the per-step decode logits (the cache path, plain
    decode attention) and the teacher-forced logits of one cache-less
    forward over the same tokens (the flash kernel), over the largest
    |logit|; the forward's logits get the logit softcap here, which
    ``serve_step`` applies and the prefill step does not."""
    import torch
    from repro_torch.launch.steps import make_serve_step
    from repro_torch.models import lm
    from repro_torch.models.common import softcap
    b, s = toks.shape
    with torch.inference_mode():
        hidden, _ = lm.forward(cfg, model, toks)
        full = softcap(lm.logits_fn(cfg, model, hidden).float(),
                       cfg.logit_softcap)
    serve = make_serve_step(cfg, dev)
    caches = lm.init_caches(cfg, b, s, device=dev)
    scale = max(1.0, float(full.abs().max()))
    worst = 0.0
    for t in range(s):
        logits, caches = serve(model, caches, toks[:, t:t + 1])
        if not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"{cfg.name}: decode step {t} not finite")
        worst = max(worst, float((logits - full[:, t]).abs().max()) / scale)
    return worst


MATMUL_KERNELS = re.compile(r"gemm|gemv|xmma|nvjet|cutlass|cublas|splitk",
                            re.IGNORECASE)


def device_shares(fn, dev) -> dict:
    """Runs ``fn`` once under ``torch.profiler`` and splits the device time
    of its kernels into the flash kernel, matrix products (cuBLAS's and
    CUTLASS's kernels) and the rest (elementwise passes, reductions,
    copies).  ``busy_ms`` is the union of the kernels' intervals, ``wall_ms``
    the host clock of the profiled call (which the profiler slows);
    ``top`` the five kernels that took the most device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    sync(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        sync(dev)
        wall = time.perf_counter() - t0
    ms = {"flash": 0.0, "matmul": 0.0, "other": 0.0}
    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        lo, hi = e.time_range.start, e.time_range.end
        spans.append((lo, hi))
        kind = "flash" if "flash" in e.name else \
            "matmul" if MATMUL_KERNELS.search(e.name) else "other"
        ms[kind] += (hi - lo) / 1e3
        by_name[e.name] = by_name.get(e.name, 0.0) + (hi - lo) / 1e3
    busy, end = 0.0, -math.inf
    for lo, hi in sorted(spans):
        busy += max(0.0, hi - max(lo, end))
        end = max(end, hi)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    return dict(kernels=len(spans), busy_ms=busy / 1e3, wall_ms=wall * 1e3,
                top=[(n[:60], round(t, 3)) for n, t in top], **ms)


def log_shares(label: str, p: dict, wall_ms: float) -> None:
    """One line of a profile: device time by kind as shares of the busy
    time, and the device's idle share of the unprofiled host-clock time
    ``wall_ms`` of the same work (and of the profiled one)."""
    if not p["kernels"]:
        log(f"  [lm] profile, {label}: the profiler saw no device kernels; "
            f"shares not measured")
        return
    busy = p["busy_ms"]
    log(f"  [lm] profile, {label}: {p['kernels']} kernels, device busy "
        f"{p['busy_ms']:.3f} ms: flash {p['flash']:.3f} ms "
        f"({p['flash'] / busy:.1%}), matmul {p['matmul']:.3f} ms "
        f"({p['matmul'] / busy:.1%}), other {p['other']:.3f} ms "
        f"({p['other'] / busy:.1%}); device idle {1 - p['busy_ms'] / wall_ms:.1%}"
        f" of the unprofiled {wall_ms:.3f} ms ({1 - p['busy_ms'] / p['wall_ms']:.1%}"
        f" of the profiled {p['wall_ms']:.3f} ms); top {p['top']}")


def drive_lm(dev, seed: int) -> dict:
    import torch
    import repro_torch.configs as C
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models import lm
    cfg = C.get(LM_ARCH)
    gen = torch.Generator(device=dev).manual_seed(seed)
    t0 = time.perf_counter()
    model = lm.init_params(cfg, gen, device=dev)
    sync(dev)
    n_params = lm.count_params(model)
    log(f"  [lm] {cfg.name}: {n_params} parameters ({cfg.n_layers} layers "
        f"{cfg.layer_kinds[:2]} x {cfg.cycles}, d {cfg.d_model}, heads "
        f"{cfg.n_heads}/{cfg.n_kv_heads} x {cfg.head_dim}, d_ff {cfg.d_ff}, "
        f"vocab {cfg.vocab}), {cfg.param_dtype}, drawn in "
        f"{time.perf_counter() - t0:.3f} s; {memory_gib(dev):.2f} GiB")
    if n_params != LM_PARAMS:
        raise AssertionError(f"{cfg.name}: {n_params} parameters, not the "
                             f"published {LM_PARAMS}")

    # the main path: prefill, then decode
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    prefill = make_prefill_step(cfg, dev)
    toks = torch.randint(0, cfg.vocab, (PREFILL_BATCH, PREFILL_LEN),
                         generator=gen, device=dev, dtype=torch.int32)
    secs = []
    for _ in range(PREFILL_CALLS):
        t0 = time.perf_counter()
        logits = prefill(model, {"inputs": toks})
        sync(dev)
        secs.append(time.perf_counter() - t0)
        if tuple(logits.shape) != (PREFILL_BATCH, 1, cfg.vocab) \
                or not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"prefill logits {tuple(logits.shape)}: "
                                 f"not [{PREFILL_BATCH}, 1, {cfg.vocab}] "
                                 f"finite values")
    peak = memory_gib(dev, peak=True)
    tokens = PREFILL_BATCH * PREFILL_LEN
    prof = device_shares(lambda: prefill(model, {"inputs": toks}), dev)
    n_flash = launch_counts()["flash_attention"]
    log(f"  [lm] prefill {PREFILL_BATCH} x {PREFILL_LEN} tokens: "
        + ", ".join(f"{t:.3f} s ({tokens / t:.0f} tokens/s)" for t in secs)
        + f"; flash launches {n_flash} (one more call profiled); peak "
        f"device memory {peak:.2f} GiB")
    log_shares("one prefill", prof, secs[-1] * 1e3)
    if dev.type == "cuda" and n_flash != cfg.n_layers * (PREFILL_CALLS + 1):
        raise AssertionError(f"prefill launched the flash kernel {n_flash} "
                             f"times, not {cfg.n_layers} x "
                             f"{PREFILL_CALLS + 1}")
    del logits
    release(dev)

    serve = make_serve_step(cfg, dev)
    caches = lm.init_caches(cfg, DECODE_BATCH,
                            PROMPT_LEN + GEN_LEN + PROFILE_STEPS, device=dev)
    prompts = torch.randint(0, cfg.vocab, (DECODE_BATCH, PROMPT_LEN),
                            generator=gen, device=dev, dtype=torch.int32)
    t0 = time.perf_counter()
    for t in range(PROMPT_LEN):
        logits, caches = serve(model, caches, prompts[:, t:t + 1])
    sync(dev)
    t_prompt = time.perf_counter() - t0
    step_secs, out = [], []
    tok = logits.argmax(-1, keepdim=True).to(torch.int32)
    for _ in range(GEN_LEN):
        out.append(tok)
        t0 = time.perf_counter()
        logits, caches = serve(model, caches, tok)
        tok = logits.argmax(-1, keepdim=True).to(torch.int32)
        sync(dev)
        step_secs.append(time.perf_counter() - t0)
        if not bool(torch.isfinite(logits).all()):
            raise AssertionError("decode logits not finite")
    gen_toks = torch.cat(out, dim=1).cpu().numpy()
    steps = np.array(step_secs)
    log(f"  [lm] decode {DECODE_BATCH} requests: prompt of {PROMPT_LEN} "
        f"tokens stepped in {t_prompt:.3f} s, {GEN_LEN} greedy steps: "
        f"median {np.median(steps) * 1e3:.2f} ms a step (min "
        f"{steps.min() * 1e3:.2f}, max {steps.max() * 1e3:.2f}), "
        f"{DECODE_BATCH / np.median(steps):.1f} tokens/s; cache at "
        f"position {int(caches['pos'])}; first request's tokens "
        f"{gen_toks[0, :8].tolist()}...")
    if int(caches["pos"]) != PROMPT_LEN + GEN_LEN or gen_toks.shape != (
            DECODE_BATCH, GEN_LEN) or gen_toks.min() < 0 \
            or gen_toks.max() >= cfg.vocab:
        raise AssertionError("decode produced no valid tokens")

    def decode_steps():
        nonlocal caches, tok
        for _ in range(PROFILE_STEPS):
            logits, caches = serve(model, caches, tok)
            tok = logits.argmax(-1, keepdim=True).to(torch.int32)
    log_shares(f"{PROFILE_STEPS} decode steps",
               device_shares(decode_steps, dev),
               np.median(steps) * 1e3 * PROFILE_STEPS)
    counts = launch_counts()
    log(f"  [lm] launches {counts}")
    del model, caches, logits
    release(dev)

    # the two paths against each other, on weights at 1/sqrt(input width)
    ptoks = torch.randint(0, cfg.vocab, (PARITY_BATCH, PARITY_LEN),
                          generator=gen, device=dev, dtype=torch.int32)
    cfg32 = cfg.replace(n_layers=PARITY_F32_LAYERS, param_dtype="float32",
                        compute_dtype="float32")
    for pcfg, tol, label in (
            (cfg32, PARITY_TOL["float32"],
             f"float32, {PARITY_F32_LAYERS} layers at full width"),
            (cfg, PARITY_TOL["bfloat16"], f"bf16, {cfg.n_layers} layers")):
        model = parity_model(pcfg, gen, dev)
        err = decode_vs_prefill(pcfg, model, ptoks, dev)
        log(f"  [lm] decode vs prefill over {PARITY_BATCH} x {PARITY_LEN} "
            f"tokens, {label}: max |gap| / max |logit| {err:.3g} "
            f"(bound {tol})")
        if not err <= tol:
            raise AssertionError(f"decode vs prefill ({label}): {err} > "
                                 f"{tol}")
        del model
        release(dev)
    return counts


def sync(dev) -> None:
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def memory_gib(dev, peak: bool = False) -> float:
    """Device memory allocated now (or at its peak), in GiB; nan off the
    card."""
    import torch
    if dev.type != "cuda":
        return float("nan")
    return (torch.cuda.max_memory_allocated(dev) if peak
            else torch.cuda.memory_allocated(dev)) / 2**30


def release(dev) -> None:
    import torch
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--docs", type=int, default=FULL_DOCS,
                    help="documents in the corpus (the scale; >= 2^18)")
    ap.add_argument("--vertices", type=int, default=FULL_VERTICES,
                    help="vertices of the iterative graphs (the scale; "
                         ">= 2^20)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the data and of phase 5's random weights")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this test "
              "runs on a CUDA card", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {__file__}; run it "
              "from a checkout of the repository", file=sys.stderr)
        return 2
    if args.docs < MIN_DOCS:
        raise SystemExit(f"--docs {args.docs} is below the floor 2^18")
    if args.vertices < MIN_VERTICES:
        raise SystemExit(f"--vertices {args.vertices} is below the floor "
                         f"2^20")
    sys.path.insert(0, str(SRC))
    from repro_torch.kernels import _build, launch_counts

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(args.seed)
    t_all = time.perf_counter()

    log("phase 1: build")
    secs = _build.build_all()
    log(f"  built {', '.join(_build.SOURCES)} in {secs:.2f} s "
        f"into {_build.BUILD_DIR}")
    for lib in sorted(_build.BUILD_DIR.glob(f"*-{_build._digest()}.log")):
        log(f"  {lib.name}: " + "; ".join(ptxas_summary(lib.read_text())))

    log("phase 2: kernels against their plain versions")
    check_sort(dev, rng)
    check_segment_sum(dev, rng)
    check_fused(dev, rng)
    check_segment_minmax(dev, rng)
    check_spmv_ell(dev, rng)
    check_flash_attention(dev, rng)
    timed = time_kernels(dev, rng, args.docs * DOC_LEN, args.vertices)
    torch.cuda.empty_cache()
    timed["flash_attention"] = time_flash_attention(dev)
    for name, t in timed.items():
        lib = "n/a" if t["library_ms"] is None \
            else f"{t['library_ms']:.3f} ms"
        log(f"  {name} [{t['shape']}]: kernel {t['ms']:.3f} ms, plain "
            f"{t['plain_ms']:.3f} ms, library {lib}, "
            f"bound {t['bound_ms']:.3f} ms ({t['bound_by']})")
    t = timed["flash_attention"]
    log(f"  flash_attention local layer (window 4096): kernel "
        f"{t['ms_local']:.3f} ms, plain {t['plain_ms_local']:.3f} ms, bound "
        f"{t['bound_ms_local']:.3f} ms; softcap 0: kernel "
        f"{t['ms_softcap0']:.3f} ms, scaled_dot_product_attention "
        f"{t['library_ms']:.3f} ms, bound {t['bound_ms_softcap0']:.3f} ms"
        f"; hd 128 (Qwen3-1.7B heads, softcap 0): kernel "
        f"{t['ms_hd128']:.3f} ms, scaled_dot_product_attention "
        f"{t['library_ms_hd128']:.3f} ms, bound {t['bound_ms_hd128']:.3f} ms"
        f"; TFLOP/s {', '.join(f'{n} {v:.1f}' for n, v in t['tflops'].items())}"
        f"; q std {FLASH_Q_SCALES[-1]:g}: at most {t['share_of_bound']:.3g} "
        f"of the bound; without the window {t['moved_without_window']:.3g}, "
        f"without the softcap {t['moved_without_softcap']:.3g} of the "
        f"outputs move past it")
    timed["segment_sum"].update(
        check_iterative_shapes(dev, rng, args.vertices))
    torch.cuda.empty_cache()

    log("phase 3: main path (wordcount, one-step incremental)")
    if args.docs != FULL_DOCS:
        log(f"  CUT: {args.docs} documents instead of {FULL_DOCS}")
    log(f"  vocab {VOCAB}, {DOC_LEN} words a document, {args.docs} "
        f"documents, {args.docs * DOC_LEN} intermediate edges")
    docs = rng.integers(0, VOCAB, (args.docs, DOC_LEN)).astype(np.int32)
    steps = make_deltas(rng, docs)
    mrbg = drive_path("mrbg", docs, steps)
    acc = drive_path("auto", docs, steps)
    for name in ("sort_lex", "segment_sum", "fused_shuffle_reduce"):
        if mrbg[name] == 0:
            raise AssertionError(f"mrbg path launched no {name}")
    if acc["segment_sum"] == 0:
        raise AssertionError("accumulator path launched no segment_sum")

    log("phase 4: iterative path (PageRank, SSSP: run, then incremental "
        "iterative update)")
    if args.vertices != FULL_VERTICES:
        log(f"  CUT: {args.vertices} vertices instead of {FULL_VERTICES}")
    pr = drive_pagerank(dev, rng, args.vertices)
    sp = drive_sssp(dev, rng, args.vertices)

    log("phase 5: LM serving (Gemma 2 9B at full width: prefill, decode, "
        "decode-versus-prefill parity)")
    lmc = drive_lm(dev, args.seed)
    paths = (mrbg, acc, pr, sp, lmc)

    sources = {
        "sort_lex": ("src/repro_torch/kernels/csrc/sort.cu",
                     "src/repro/kernels/sort_u32.py:250"),
        "segment_sum": ("src/repro_torch/kernels/csrc/segment_sum.cu",
                        "src/repro/kernels/segment_reduce.py:211"),
        "fused_shuffle_reduce": ("src/repro_torch/kernels/csrc/fused.cu",
                                 "src/repro/kernels/fused.py:149"),
        "segment_minmax": ("src/repro_torch/kernels/csrc/segment_minmax.cu",
                           "src/repro/kernels/segment_reduce.py:255"),
        "spmv_ell": ("src/repro_torch/kernels/csrc/spmv_ell.cu",
                     "src/repro/kernels/spmv_ell.py:51"),
        "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:82"),
    }
    kernels = []
    for name, (source, replaces) in sources.items():
        t = timed[name]
        entry = {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": sum(p[name] for p in paths),
            "max_abs_err": t["max_abs_err"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"]}
        if name == "segment_sum":
            entry.update({n: t[n] for n in (
                "shape", "ms_pagerank", "plain_ms_pagerank",
                "library_ms_pagerank", "bound_ms_pagerank", "ms_sssp_counts",
                "bound_ms_sssp_counts")})
            entry["note"] = (
                "ms, plain_ms, library_ms, bound_ms: wordcount's Reduce; "
                "*_pagerank: PageRank's Reduce (N 2^26, K 2^22, half the "
                "rows dropped, counts on; library: index_add_ + bincount on "
                "the rows in range); *_sssp_counts: SSSP's counts (int32 "
                "ones, counts off)")
        if name == "spmv_ell":
            entry["note"] = ("no engine path calls it (nor the JAX "
                             "package's); held against its plain version "
                             "at PageRank's shapes")
        if name == "flash_attention":
            entry.update({n: t[n] for n in (
                "shape", "share_of_bound", "moved_without_window",
                "moved_without_softcap", "ms_local", "plain_ms_local",
                "bound_ms_local", "ms_softcap0", "bound_ms_softcap0",
                "ms_hd128", "library_ms_hd128", "bound_ms_hd128", "tflops",
                "note")})
        kernels.append(entry)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log(f"  total {time.perf_counter() - t_all:.1f} s; launches mrbg {mrbg}, "
        f"auto {acc}, pagerank {pr}, sssp {sp}, lm {lmc}")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
