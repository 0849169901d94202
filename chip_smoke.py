#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py [--docs N] [--seed S]

Runs on one CUDA card, from the root of a checkout:

  1. builds the kernel libraries from ``src/repro_torch/kernels/csrc``;
  2. holds every kernel against its plain PyTorch version on the card
     (edge cases, then the main path's shapes, with kernel, plain and
     library times and the least time the card could take);
  3. drives the main path — wordcount's ``Session.run`` then two
     ``update``s, on the MRBG path and on ``auto`` (the accumulator) — at
     vocab 2^18, 64 words a document, 2^20 documents, and checks every
     step against ``np.bincount`` of the updated corpus exactly, with the
     kernels' launch counts read around each path.

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
INT32_MAX = 2**31 - 1


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


def bound(nbytes: int, ops: float) -> dict:
    """The least time for the work: the larger of bytes (each input read
    once, each output written once) over the memory rate and operations
    over the peak rate, and which of the two it is."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S * 1e3
    if t_bytes >= t_ops:
        return {"bound_ms": t_bytes, "bound_by": "bytes"}
    return {"bound_ms": t_ops, "bound_by": "operations"}


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
    import torch
    from repro_torch.kernels.ref import sort_lex_ref
    from repro_torch.kernels.sort_u32 import sort_lex
    cases = []
    for n in (1, 5, 4095, 4096, 4097, 2**20 + 3):
        cases.append((f"n={n}", rng.integers(0, max(n // 2, 2), n),
                      rng.integers(0, 7, n)))
    n = 100_003
    cases.append(("heavy duplicates", rng.integers(0, 2, n), np.zeros(n)))
    hi = rng.integers(0, 50, n)
    hi[rng.random(n) < 0.3] = INT32_MAX
    lo = rng.integers(0, 50, n)
    lo[rng.random(n) < 0.3] = INT32_MAX
    cases.append(("INT32_MAX keys", hi, lo))
    cases.append(("negative keys", rng.integers(-2**31, 2**31, n),
                  rng.integers(-2**31, 2**31, n)))
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
    from repro_torch.kernels.segment_reduce import segment_sum
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
    # non-integer floats: atomics add in run-dependent order; allow the
    # reordering error of float32 sums (relative to the sum of |v|)
    n, k = 500_000, 1000
    s = torch.as_tensor(rng.integers(0, k, n).astype(np.int32), device=dev)
    v = torch.as_tensor(rng.normal(0, 1, (n, 3)).astype(np.float32), device=dev)
    got = segment_sum(s, v, k)
    want = segment_sum_ref(s, v, k)
    scale = segment_sum_ref(s, v.abs(), k)
    err = float(((got - want).abs() / scale.clamp_min(1e-30)).max())
    if err > 1e-5:
        raise AssertionError(f"segment_sum float: relative error {err} > 1e-5")
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


# ---------------------------------------------------------------------------
# phase 2b: times at the main path's shapes
# ---------------------------------------------------------------------------

def time_kernels(dev, rng, n_edges: int) -> dict:
    import torch
    from repro_torch.kernels.fused import fused_shuffle_reduce
    from repro_torch.kernels.ref import (
        fused_shuffle_reduce_ref, segment_sum_ref, sort_lex_ref,
    )
    from repro_torch.kernels.segment_reduce import segment_sum
    from repro_torch.kernels.sort_u32 import sort_lex
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
    return out


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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--docs", type=int, default=FULL_DOCS,
                    help="documents in the corpus (the scale; >= 2^18)")
    ap.add_argument("--seed", type=int, default=0)
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
    for lib in sorted(_build.BUILD_DIR.glob("*.log")):
        regs = [l.strip() for l in lib.read_text().splitlines()
                if "registers" in l or "spill" in l]
        log(f"  {lib.name}: " + " | ".join(regs[:6]))

    log("phase 2: kernels against their plain versions")
    check_sort(dev, rng)
    check_segment_sum(dev, rng)
    check_fused(dev, rng)
    timed = time_kernels(dev, rng, args.docs * DOC_LEN)
    for name, t in timed.items():
        log(f"  {name} [{t['shape']}]: kernel {t['ms']:.3f} ms, plain "
            f"{t['plain_ms']:.3f} ms, library "
            f"{'n/a' if t['library_ms'] is None else f'{t['library_ms']:.3f} ms'}, "
            f"bound {t['bound_ms']:.3f} ms ({t['bound_by']})")
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

    sources = {
        "sort_lex": ("src/repro_torch/kernels/csrc/sort.cu",
                     "src/repro/kernels/sort_u32.py:250"),
        "segment_sum": ("src/repro_torch/kernels/csrc/segment_sum.cu",
                        "src/repro/kernels/segment_reduce.py:211"),
        "fused_shuffle_reduce": ("src/repro_torch/kernels/csrc/fused.cu",
                                 "src/repro/kernels/fused.py:149"),
    }
    kernels = []
    for name, (source, replaces) in sources.items():
        t = timed[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": mrbg[name] + acc[name],
            "max_abs_err": t["max_abs_err"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"]})
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log(f"  total {time.perf_counter() - t_all:.1f} s; launches mrbg {mrbg}, "
        f"auto {acc}")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
