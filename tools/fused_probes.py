#!/usr/bin/env python3
"""Ablations of the fused merge's one-block kernel: which part of its work
bounds it at a row count.

    python3 tools/fused_probes.py [VARIANT ...]

For each variant (all of them by default) this copies the checkout's
``src`` into the git-ignored ``build/fused-probes/<variant>/src``, applies
the variant's edits to the copy's ``csrc/fused.cu``, builds only that
source, and times the copy's one-block route (``fused._fused_cuda(...,
one_block=True)``) in a process of its own at ``chip_smoke``'s
``ONE_BLOCK_SHAPES`` (the same rows as phase 2, from ``merge_rows``):
device microseconds a call (20 calls under torch.profiler, the union of
their kernels' intervals over 20) and events ms (mean of 20 calls after a
warm-up).  The variants:

  base       the kernel as it is;
  empty      returns at once: the launch alone;
  loads      returns after the loads and the reductions, before any
             radix pass;
  nosort     no radix pass (the rows stay in their input order);
  ballot     each pass ranks a warp's rows with 8 ballots a row instead
             of __match_any_sync;
  sortonly   returns after the sort: the loads, the reductions and the
             passes;
  nopassb    returns before the carry scan: the loads, the sort, the
             sorted rows out and each thread's share of the runs; no slot
             stores, no zero fill;
  rows2, rows8
             2 or 8 rows a thread once a warp is full, instead of 4.

Only base, ballot and the rows variants compute the function, and they
are held against the plain version (acc within 1e-5 of the sum of |v|,
the rest bit for bit); the others' outputs are wrong and only their
times mean anything.  Prints the card's name and power limit and one
JSON line a variant; needs one CUDA card.
"""
from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
OUT = ROOT / "build" / "fused-probes"
CU = Path("repro_torch/kernels/csrc/fused.cu")

_VARY = "  const uint32_t vary[2] = {"
_TOP = "  const uint32_t top[2] = {tl, th};"
_MATCH = ("        const unsigned peers = __match_any_sync(repro::FULL_MASK, "
          "dg);")
_SORTED = ("  // the sorted rows out, a thread a row in turn (coalesced stores): "
           "the")
_CARRY = "    run_carry<T>(run, runc, any, sum, cnt);        // two barriers"
_ROWS = "constexpr int ONE_ROWS = 4;"
_TOP_OF_KERNEL = "  __shared__ uint32_t red[6][32], wtot[32];"

# variant -> (old, new) edits of fused.cu, each old text unique
VARIANTS = {
    "base": [],
    "empty": [(_TOP_OF_KERNEL, _TOP_OF_KERNEL + "\n  if (n > 0) return;")],
    "loads": [(_VARY, "  uint32_t vary[2] = {"),
              (_TOP, "  vary[0] = vary[1] = 0;\n" + _TOP),
              (_SORTED, "  if (n > 0) return;\n" + _SORTED)],
    "nosort": [(_VARY, "  uint32_t vary[2] = {"),
               (_TOP, "  vary[0] = vary[1] = 0;\n" + _TOP)],
    "ballot": [(_MATCH, "        unsigned peers = repro::FULL_MASK;\n"
                        "        for (int b = 0; b < 8; ++b) {\n"
                        "          const unsigned bit = (dg >> b) & 1;\n"
                        "          const unsigned v = __ballot_sync("
                        "repro::FULL_MASK, bit);\n"
                        "          peers &= bit ? v : ~v;\n"
                        "        }")],
    "sortonly": [(_SORTED, "  if (n > 0) return;\n" + _SORTED)],
    "nopassb": [(_CARRY, "    if (n > 0) return;\n" + _CARRY)],
    "rows2": [(_ROWS, "constexpr int ONE_ROWS = 2;")],
    "rows8": [(_ROWS, "constexpr int ONE_ROWS = 8;")],
}
CHECKED = ("base", "ballot", "rows2", "rows8")


def prepare(name: str) -> Path:
    """The variant's copy of ``src`` with its edits applied."""
    src = OUT / name / "src"
    shutil.rmtree(src, ignore_errors=True)
    shutil.copytree(ROOT / "src", src, ignore=shutil.ignore_patterns(
        "build", "__pycache__"))
    path = src / CU
    text = path.read_text()
    for old, new in VARIANTS[name]:
        if text.count(old) != 1:
            raise SystemExit(f"{name}: the text to edit is not unique in "
                             f"{CU}: {old!r}")
        text = text.replace(old, new)
    path.write_text(text)
    return src


def time_variant(src: str, name: str) -> None:
    """Build the copy's fused kernel under ``src`` and time its one-block
    route at ONE_BLOCK_SHAPES."""
    sys.path.insert(0, str(Path(src).resolve()))
    sys.path.insert(1, str(ROOT))
    import numpy as np
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels.fused import _fused_cuda
    from repro_torch.kernels.ref import fused_shuffle_reduce_ref
    _build.SOURCES = ("fused",)
    _build.build_all()
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    res = {"variant": name}
    for (label, m, cap, nkeys, universe, per_key, redo, tomb, new,
         mk_range) in cs.ONE_BLOCK_SHAPES:
        args, _ = cs.merge_rows(rng, dev, m, universe or cs.FULL_VERTICES,
                                nkeys, per_key, redo, tomb, new,
                                mk_range=mk_range, key_pad=cap)
        fn = lambda: _fused_cuda(*args, out_dtype=torch.float32,
                                 one_block=True)
        got = fn()
        if name in CHECKED:
            want = fused_shuffle_reduce_ref(*args, out_dtype=torch.float32)
            for part, g, w in zip(("k2", "mk", "vals", "live", "perm",
                                   "acc", "counts"), got, want):
                if part != "acc":
                    cs.require_equal(f"{name} {label} {part}", g, w)
            cs.sum_rel_err(f"{name} {label} acc", got[5], want[5], want[5])
        p = cs.device_shares(lambda: [fn() for _ in range(20)], dev, top=1)
        res[f"us {label}"] = round(p["busy_ms"] / 20 * 1e3, 3)
        res[f"events ms {label}"] = round(cs.cuda_ms(fn, reps=20), 5)
    print(json.dumps(res), flush=True)


def main(argv) -> int:
    if argv[:1] == ["--time"]:
        time_variant(*argv[1:3])
        return 0
    import torch
    if not torch.cuda.is_available():
        print("fused_probes: needs a CUDA card", file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip(), flush=True)
    rc = 0
    for name in argv or list(VARIANTS):
        src = prepare(name)
        try:
            done = subprocess.run([sys.executable, __file__, "--time",
                                   str(src), name], timeout=600,
                                  check=False)
            rc = rc or done.returncode
        except subprocess.TimeoutExpired:
            print(f"{name}: timed out", flush=True)
            rc = 1
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
