#!/usr/bin/env python3
"""Decode-versus-prefill parity of a recurrent arch at a reduced width, on
the CPU: a rehearsal of ``chip_smoke.py`` phase 12's bf16 check and its
bound before a card run.

    PYTHONPATH=src python3 tools/cpu_parity.py [--arch ARCH] [--d-model D]
        [--vocab V] [--seeds N] [--dtype bfloat16|float32]

Builds the arch's config at full depth with ``d_model`` (and RG-LRU's
width) cut to ``D``, RecurrentGemma's d_ff to 3 D, draws
``chip_smoke.parity_model`` weights from each seed, and prints
``chip_smoke.decode_vs_prefill`` over 2 x 64 tokens beside
``chip_smoke.parity_bound``.  On CPU tensors the flash wrapper takes its
plain version and bf16 products sum on the CPU, so the gap shows the
size of the check, not the card's number.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default="recurrentgemma_2b",
                    choices=("recurrentgemma_2b", "xlstm_125m"))
    ap.add_argument("--d-model", type=int, default=512)
    ap.add_argument("--vocab", type=int, default=8192)
    ap.add_argument("--seeds", type=int, default=2)
    ap.add_argument("--dtype", default="bfloat16",
                    choices=("bfloat16", "float32"))
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    import chip_smoke as cs
    import repro_torch.configs as C
    from repro_torch.models.config import RGLRUConfig

    d = args.d_model
    cfg = C.get(args.arch).replace(d_model=d, vocab=args.vocab,
                                   param_dtype=args.dtype,
                                   compute_dtype=args.dtype)
    if cfg.rglru is not None:
        cfg = cfg.replace(d_ff=3 * d, rglru=RGLRUConfig(d, 4, d))
    dev = torch.device("cpu")
    tol = cs.parity_bound(cfg.n_layers, cfg.layer_kinds.count("rec"))
    for seed in range(args.seeds):
        gen = torch.Generator().manual_seed(seed)
        model = cs.parity_model(cfg, gen, dev)
        toks = torch.randint(0, cfg.vocab, (2, 64), generator=gen,
                             dtype=torch.int32)
        t0 = time.perf_counter()
        err = cs.decode_vs_prefill(cfg, model, toks, dev)
        print(f"{cfg.name} d {d}, {cfg.n_layers} layers, {args.dtype}, seed "
              f"{seed}: max |gap| / max |logit| {err:.4g} (phase 12's bf16 "
              f"bound at this depth {tol:.4g}); {time.perf_counter() - t0:.1f}"
              f" s on the CPU", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
