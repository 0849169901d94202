#!/usr/bin/env python3
"""Probes behind the training checks' bounds and sizes, on the CPU.

    PYTHONPATH=src python3 tools/train_probes.py spread [ARCH ...]
    PYTHONPATH=src python3 tools/train_probes.py peak
    PYTHONPATH=src python3 tools/train_probes.py adamw

``spread``: ``chip_smoke.py`` phase 16 (b)'s three float32 train steps of
each arch (default: DeepSeek-V3 and Llama 4 Scout at ``--preset 100m``
cut to ``STEP_LAYERS``, the RecurrentGemma and xLSTM smoke configs), run
twice on the CPU with 1 and 7 BLAS threads, the only difference being
the order of the sums: the largest parameter gap between the two runs,
and the same gap over the elements ``chip_smoke.UndecidedProbe`` leaves
decided.  It shows what a device's summation order alone does to Adam's
steps (``chip_smoke.STEP_ZERO_LEAF``'s note).

``peak``: the dry-run on ``meta`` (``launch.dryrun.dryrun``) of phase 16
(c)'s Llama 4 Scout step (1 layer, B 2 x S 4096, remat full, loss_chunk
512) with AdamW's slices at 2^28, 2^29, 2^30 elements and whole: the
predicted peak of each.

``adamw``: one AdamW update of DeepSeek-V3's whole parameter tree on
``meta`` under the dry-run's counters (``FlopCounterMode`` and
``Traffic``), at each slice size: the seconds a dry-run of its train
step spends there.

Prints one line a case; imports neither JAX nor the JAX package.
"""
from __future__ import annotations

import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

SLICES = (2**28, 2**29, 2**30, 2**62)


def spread(archs) -> None:
    import numpy as np
    import torch
    import chip_smoke as cs
    import repro_torch.configs as C
    from repro_torch.launch import steps
    from repro_torch.launch.train import preset_config
    from repro_torch.models import blocks, lm
    from repro_torch.optim import AdamWConfig, adamw_init
    cpu = torch.device("cpu")
    b, s = cs.STEP_SHAPE
    for arch, preset in cs.MOE_REC_STEPS:
        if archs and arch not in archs:
            continue
        cfg = preset_config(C.get(arch), preset)
        if preset == "100m":
            cfg = cfg.replace(n_layers=cs.STEP_LAYERS)
        cfg = cfg.replace(param_dtype="float32", compute_dtype="float32",
                          remat="full", loss_chunk=cs.STEP_CHUNK)
        host = cs.parity_model(cfg, torch.Generator().manual_seed(0), cpu)
        rng = np.random.default_rng(0)
        batches = []
        for _ in range(cs.STEP_COUNT):
            toks = rng.integers(0, cfg.vocab, (b, s + 1)).astype(np.int32)
            batches.append({"inputs": toks[:, :-1], "targets": toks[:, 1:],
                            "mask": rng.random((b, s)) < 0.9})
        chunk = blocks.MLSTM_CHUNK
        blocks.MLSTM_CHUNK = cs.STEP_MLSTM_CHUNK
        runs = []
        try:
            for threads in (1, 7):
                torch.set_num_threads(threads)
                model = lm.LM(cfg, {n: p.detach().clone() for n, p in
                                    host.named_parameters()}, trainable=True)
                opt_cfg = AdamWConfig(**cs.STEP_OPT)
                opt = adamw_init(dict(model.named_parameters()), opt_cfg)
                step = steps.make_train_step(cfg, opt_cfg, cpu)
                with cs.UndecidedProbe() as und:
                    for batch in batches:
                        model, opt, _ = step(model, opt, batch)
                runs.append(({n: p.detach().clone() for n, p in
                              model.named_parameters()}, und.mask))
        finally:
            blocks.MLSTM_CHUNK = chunk
        (a, mask), (c, _) = runs
        gaps = {n: (a[n] - c[n]).abs() for n in a}
        whole = max(float(d.max()) for d in gaps.values())
        decided = max((float(d[~mask[n]].max()) for n, d in gaps.items()
                       if (~mask[n]).any()), default=0.0)
        print(f"{cfg.name} {preset}: parameters after {cs.STEP_COUNT} steps,"
              f" 1 against 7 BLAS threads: max gap {whole:.3g}, over the "
              f"decided elements {decided:.3g} (lr / 10 = "
              f"{cs.STEP_PARAM_TOL:.3g})", flush=True)


def peak() -> None:
    import repro_torch.configs as C
    from repro_torch.launch import dryrun
    from repro_torch.models.config import ShapeCell
    from repro_torch.optim import adamw
    cfg = C.get("llama4_scout_17b_a16e").replace(n_layers=1, remat="full",
                                                 loss_chunk=512)
    for elems in SLICES:
        adamw.ADAMW_SLICE_ELEMS = elems
        mem = dryrun.dryrun(cfg, ShapeCell("train_2x4096", 4096, 2,
                                           "train"))["full"]["memory"]
        print(f"llama4 scout, 1 layer, B 2 x S 4096, slices of {elems}: "
              f"predicted peak {sum(mem.values()) / 2**30:.2f} GiB",
              flush=True)


def adamw_cost() -> None:
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    import repro_torch.configs as C
    from repro_torch.launch.dryrun import Traffic
    from repro_torch.models import lm
    from repro_torch.optim import adamw
    cfg = C.get("deepseek_v3_671b")
    params = dict(lm.init_params(cfg, torch.Generator(), "meta",
                                 trainable=True).named_parameters())
    grads = {n: torch.empty_like(p) for n, p in params.items()}
    opt = adamw.adamw_init(params, adamw.AdamWConfig())
    for elems in SLICES:
        adamw.ADAMW_SLICE_ELEMS = elems
        parts = sum(len(adamw.leaf_slices(p.shape)) for p in params.values())
        t0 = time.perf_counter()
        with torch.no_grad(), FlopCounterMode(display=False), \
                Traffic((params, opt, grads)):
            adamw.adamw_update(grads, opt, params, adamw.AdamWConfig())
        print(f"deepseek-v3 AdamW on meta under the dry-run's counters, "
              f"slices of {elems}: {parts} parts, "
              f"{time.perf_counter() - t0:.2f} s", flush=True)


def main(argv) -> int:
    if not argv or argv[0] not in ("spread", "peak", "adamw"):
        print(__doc__)
        return 2
    if argv[0] == "spread":
        spread(set(argv[1:]))
    elif argv[0] == "peak":
        peak()
    else:
        adamw_cost()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
