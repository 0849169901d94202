"""End-to-end training driver with checkpoint/restart, failure injection,
and straggler watchdog.

Counterpart of ``repro.launch.train``, with its arguments, prints and
resume logic; the model and the steps run on ``cuda`` unless ``device``
says ``cpu``:

  python -m repro_torch.launch.train --arch qwen3-1.7b --preset 100m \\
      --steps 300 --ckpt-every 50 --out build/train/run1
  # kill it anywhere; re-running the same command resumes from the last
  # checkpoint and reproduces the exact same loss trajectory (deterministic
  # data pipeline, saved optimizer state, deterministic train step).

Checkpoints are the reference's format (``repro_torch.ckpt``), so a run
started by ``repro.launch.train`` resumes here and the other way round.
An arch whose inputs come embedded (HuBERT) trains on the reference's
frontend stub: each token id of the synthetic corpus becomes a row of a
fixed random table (:func:`frontend_stub`), and its batches mask 30% of
the targets (masked-frame prediction).
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.ckpt import CheckpointManager
from repro_torch.data import LMDataConfig, lm_batch_at_step
from repro_torch.launch.steps import make_train_step
from repro_torch.models import lm
from repro_torch.models.common import resolve_device
from repro_torch.models.config import (
    MLAConfig, ModelConfig, RGLRUConfig, smoke_config,
)
from repro_torch.models.transfer import (
    opt_state_from_numpy, params_from_numpy, to_reference_tree,
)
from repro_torch.optim import AdamWConfig, adamw_init


def preset_config(cfg: ModelConfig, preset: str) -> ModelConfig:
    """``full`` (the architecture), ``smoke`` (``smoke_config``) or ``100m``
    (a ~100M-parameter member of the same family: 103M for the dense
    ones; RG-LRU at width 512, 8 experts of 768, MLA at (96, 64))."""
    if preset == "full":
        return cfg
    if preset == "smoke":
        return smoke_config(cfg)
    if preset == "100m":
        kw = dict(n_layers=max(4, min(cfg.n_layers, 12)), d_model=768,
                  n_heads=12, n_kv_heads=min(cfg.n_kv_heads, 4), d_ff=2048,
                  head_dim=64, vocab=32768, remat="none", local_window=256)
        if cfg.moe is not None:
            kw["moe"] = dataclasses.replace(
                cfg.moe, num_experts=8, top_k=min(cfg.moe.top_k, 2),
                d_ff_expert=768, d_ff_shared=768 if cfg.moe.num_shared else 0,
                ep_axes=("model",))
        if cfg.mla is not None:
            kw["mla"] = MLAConfig(q_lora_rank=128, kv_lora_rank=64,
                                  qk_nope_head_dim=64, qk_rope_head_dim=32,
                                  v_head_dim=64)
        if cfg.rglru is not None:
            kw["rglru"] = RGLRUConfig(d_rnn=512, conv_width=4,
                                      block_width=512)
        return cfg.replace(**kw)
    raise ValueError(preset)


STUB_ROWS = 256


def frontend_stub(cfg: ModelConfig) -> np.ndarray:
    """The reference trainer's stand-in for a conv or VQ frontend: a
    float32 table [256, d] drawn from ``np.random.default_rng(1234)``;
    token t's embedding is row ``t % 256``."""
    rng = np.random.default_rng(1234)
    return rng.normal(0, 1, (STUB_ROWS, cfg.d_model)).astype(np.float32)


class StragglerWatchdog:
    """Flags steps slower than ``ratio`` x the EWMA step time (recorded and
    surfaced, as the reference does)."""

    def __init__(self, ratio: float = 2.0, alpha: float = 0.2):
        self.ratio = ratio
        self.alpha = alpha
        self.ewma: Optional[float] = None
        self.events = []

    def observe(self, step: int, dt: float) -> bool:
        if self.ewma is None:
            self.ewma = dt
            return False
        slow = dt > self.ratio * self.ewma
        if slow:
            self.events.append((step, dt, self.ewma))
        self.ewma = (1 - self.alpha) * self.ewma + self.alpha * dt
        return slow


def _state_tree(cfg: ModelConfig, params: lm.LM, opt):
    """The checkpoint's tree, in the reference's layout."""
    return {"params": to_reference_tree(cfg, dict(params.named_parameters())),
            "opt": {"m": to_reference_tree(cfg, opt["m"]),
                    "v": to_reference_tree(cfg, opt["v"]),
                    "step": opt["step"].cpu()}}


def train(cfg: ModelConfig, *, steps: int, global_batch: int, seq_len: int,
          out: str, ckpt_every: int = 50, fail_at: Optional[int] = None,
          lr: float = 3e-4, log_every: int = 10, seed: int = 0,
          device="cuda"):
    """Train ``steps`` steps on the synthetic corpus from ``seed``, resuming
    from the newest checkpoint under ``out``; returns the losses of the
    steps this call ran.  ``fail_at`` raises before that step.  On CUDA the
    process must have set ``CUBLAS_WORKSPACE_CONFIG`` before its first
    cuBLAS call (:func:`main` does), or the deterministic step raises."""
    dev = resolve_device(device)
    opt_cfg = AdamWConfig(lr=lr, total_steps=steps,
                          warmup=min(100, steps // 10 + 1))
    data_cfg = LMDataConfig(vocab=cfg.vocab, seq_len=seq_len,
                            global_batch=global_batch, seed=seed,
                            mask_prob=0.3 if cfg.family == "encoder" else 0.0)
    step_fn = make_train_step(cfg, opt_cfg, dev)
    mgr = CheckpointManager(out, keep=3, every=ckpt_every)
    watchdog = StragglerWatchdog()
    table = None if cfg.embed_inputs else frontend_stub(cfg)

    start = 0
    s, tree, meta = mgr.resume(dev)
    if s is not None:
        params = params_from_numpy(cfg, tree["params"], dev, trainable=True)
        opt = opt_state_from_numpy(cfg, tree["opt"], dev,
                                   opt_cfg.opt_dtype)
        start = s
        print(f"[train] resumed from step {s}")
    else:
        gen = torch.Generator(device=dev).manual_seed(seed)
        params = lm.init_params(cfg, gen, dev, trainable=True)
        opt = adamw_init(dict(params.named_parameters()), opt_cfg)

    losses = []
    for step in range(start, steps):
        if fail_at is not None and step == fail_at:
            raise RuntimeError(f"injected failure at step {step}")
        batch = lm_batch_at_step(data_cfg, step)
        if table is not None:
            batch["inputs"] = table[batch["inputs"] % STUB_ROWS]
        t0 = time.perf_counter()
        params, opt, metrics = step_fn(params, opt, batch)
        loss = float(metrics["loss"])
        dt = time.perf_counter() - t0
        watchdog.observe(step, dt)
        losses.append(loss)
        if step % log_every == 0:
            print(f"[train] step {step:5d} loss {loss:.4f} "
                  f"({dt*1e3:.0f} ms)", flush=True)
        mgr.maybe_save(step + 1, lambda: _state_tree(cfg, params, opt),
                       {"loss": loss})
    print(f"[train] done: loss {losses[0]:.4f} -> {losses[-1]:.4f}; "
          f"straggler events: {len(watchdog.events)}")
    return losses


def main(argv=None):
    # cuBLAS reads it once, at its first use in the process; the
    # deterministic train step refuses a product without it
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--preset", default="100m",
                    choices=["smoke", "100m", "full"])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--fail-at", type=int, default=None)
    ap.add_argument("--out", default="build/train")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import repro_torch.configs as C
    cfg = preset_config(C.get(args.arch), args.preset)
    return train(cfg, steps=args.steps, global_batch=args.global_batch,
                 seq_len=args.seq_len, out=args.out,
                 ckpt_every=args.ckpt_every, fail_at=args.fail_at,
                 lr=args.lr, device=args.device)


if __name__ == "__main__":
    main()
