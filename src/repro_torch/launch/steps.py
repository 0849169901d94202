"""Train, eval and serving steps of the LM.

Counterpart of ``repro.launch.steps``'s ``make_train_step``,
``make_eval_step``, ``make_prefill_step`` and ``make_serve_step``.  A step
is made for a device (``cuda`` unless the caller asks for ``cpu``; without
a card ``cuda`` raises), takes the port's model
(``repro_torch.models.lm.LM``) on that device, and moves its batch there.
Eval, prefill and decode run under ``torch.inference_mode()``.  A train
step is the loss, ``backward()``, then AdamW, which updates the model's
parameters and the moments in place; it runs with PyTorch's deterministic
algorithms, so that a run resumed from a checkpoint repeats the
uninterrupted one bit for bit (on CUDA the embedding gather's backward, a
scatter-add, is otherwise nondeterministic).  An op without a
deterministic version raises; so does every cuBLAS product on CUDA unless
``CUBLAS_WORKSPACE_CONFIG`` (``:4096:8``) was set before the process first
used cuBLAS, as ``repro_torch.launch.train.main`` sets it.

A batch's ``inputs`` are token ids [B, S], or embeddings [B, S, d] when
``cfg.embed_inputs`` is False (HuBERT behind its frontend stub), as the
reference's ``batch_specs`` gives them; another rank raises.  The input
specs themselves are not ported (the reference's dry-run needs them,
ROADMAP.md Queue 1 item 16b.5).
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, Optional

import torch

from repro_torch.models import lm
from repro_torch.models.common import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.optim import AdamWConfig, adamw_update


def _on(params: lm.LM, dev: torch.device, what: str) -> None:
    if params.device.type != dev.type:
        raise ValueError(f"{what} was made for {dev}, but the model lies on "
                         f"{params.device}")


def _inputs(cfg: ModelConfig, inputs, dev: torch.device) -> torch.Tensor:
    """A batch's inputs on ``dev``: ids [B, S], or [B, S, d] embeddings
    when the config takes them embedded."""
    x = torch.as_tensor(inputs, device=dev)
    if cfg.embed_inputs:
        ok, what = x.ndim == 2, "token ids [B, S]"
    else:
        ok = x.ndim == 3 and x.shape[-1] == cfg.d_model
        what = f"embeddings [B, S, {cfg.d_model}]"
    if not ok:
        raise ValueError(f"{cfg.name} takes {what} as inputs, got "
                         f"{tuple(x.shape)}")
    return x


def make_serve_step(cfg: ModelConfig, device="cuda"):
    """serve_step(params, caches, tokens [B, 1]) -> (logits [B, V] float32
    with the logit softcap, caches updated in place)."""
    dev = resolve_device(device)

    def serve_step(params: lm.LM, caches: Dict[str, Any], tokens):
        _on(params, dev, "serve_step")
        tokens = torch.as_tensor(tokens, device=dev)
        with torch.inference_mode():
            return lm.serve_step(cfg, params, caches, tokens)
    return serve_step


def make_prefill_step(cfg: ModelConfig, device="cuda"):
    """prefill_step(params, {"inputs": [B, S] ids or [B, S, d]
    embeddings}) -> last-token logits [B, 1, V] in the compute dtype,
    without the logit softcap (as the reference).  Every attention layer
    runs the flash kernel."""
    dev = resolve_device(device)

    def prefill_step(params: lm.LM, batch: Dict[str, Any]):
        _on(params, dev, "prefill_step")
        inputs = _inputs(cfg, batch["inputs"], dev)
        with torch.inference_mode():
            hidden, _ = lm.forward(cfg, params, inputs)
            return lm.logits_fn(cfg, params, hidden[:, -1:, :])
    return prefill_step


def _batch_on(cfg: ModelConfig, batch: Dict[str, Any], dev: torch.device):
    return {k: _inputs(cfg, v, dev) if k == "inputs"
            else torch.as_tensor(v, device=dev) for k, v in batch.items()}


@contextlib.contextmanager
def deterministic():
    """PyTorch's deterministic algorithms for the block (restored after);
    an op that has none raises."""
    was = (torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was[0], warn_only=was[1])


def make_train_step(cfg: ModelConfig, opt_cfg: Optional[AdamWConfig] = None,
                    device="cuda"):
    """train_step(params, opt_state, batch) -> (params, opt_state,
    {"loss", "grad_norm", "lr"}): ``params`` an ``LM`` built with
    ``trainable=True``, updated in place with its moments (the returned
    ``params`` is the same model); the metrics are float32 scalars on the
    device."""
    opt_cfg = opt_cfg or AdamWConfig()
    dev = resolve_device(device)

    def train_step(params: lm.LM, opt_state, batch: Dict[str, Any]):
        _on(params, dev, "train_step")
        named = dict(params.named_parameters())
        frozen = [n for n, p in named.items() if not p.requires_grad]
        if frozen:
            raise ValueError(f"train_step needs a model built with "
                             f"trainable=True; {frozen[:4]} take no "
                             f"gradients")
        with deterministic():
            loss = lm.lm_loss(cfg, params, _batch_on(cfg, batch, dev))
            loss.backward()
            grads = {n: torch.zeros_like(p) if p.grad is None else p.grad
                     for n, p in named.items()}
            for p in named.values():
                p.grad = None
            _, opt_state, info = adamw_update(grads, opt_state, named,
                                              opt_cfg)
        return params, opt_state, {"loss": loss.detach(), **info}
    return train_step


def make_eval_step(cfg: ModelConfig, device="cuda"):
    """eval_step(params, batch) -> the loss, a float32 scalar."""
    dev = resolve_device(device)

    def eval_step(params: lm.LM, batch: Dict[str, Any]):
        _on(params, dev, "eval_step")
        with torch.inference_mode():
            return lm.lm_loss(cfg, params, _batch_on(cfg, batch, dev))
    return eval_step
