"""Serving steps: prefill and decode, each one call under
``torch.inference_mode()``.

Counterpart of ``repro.launch.steps.make_prefill_step`` and
``make_serve_step``.  A step is made for a device (``cuda`` unless the
caller asks for ``cpu``; without a card ``cuda`` raises), takes the
port's model (``repro_torch.models.lm.LM``) on that device, and moves its
token ids there.  Train and eval steps and the input specs are not
ported.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.models import lm
from repro_torch.models.common import resolve_device
from repro_torch.models.config import ModelConfig


def _on(params: lm.LM, dev: torch.device, what: str) -> None:
    if params.device.type != dev.type:
        raise ValueError(f"{what} was made for {dev}, but the model lies on "
                         f"{params.device}")


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
    """prefill_step(params, {"inputs": [B, S]}) -> last-token logits
    [B, 1, V] in the compute dtype, without the logit softcap (as the
    reference).  Every attention layer runs the flash kernel."""
    dev = resolve_device(device)

    def prefill_step(params: lm.LM, batch: Dict[str, Any]):
        _on(params, dev, "prefill_step")
        inputs = torch.as_tensor(batch["inputs"], device=dev)
        with torch.inference_mode():
            hidden, _ = lm.forward(cfg, params, inputs)
            return lm.logits_fn(cfg, params, hidden[:, -1:, :])
    return prefill_step
