"""LM assembly: embedding, the layer stack, final norm, logits, decode.

Counterpart of ``repro.models.lm`` for serving.  The reference scans
stacked super-blocks (``jax.lax.scan``); here the stack is an
``nn.ModuleList`` of ``cfg.n_layers`` blocks (prefix, ``cycles`` times the
pattern, remainder), and a parameter's name is ``layers.<i>.<path>``.

Everything runs on ``cuda`` unless the caller passes ``device="cpu"``.
Caches are tensors updated in place by each decode step (the reference
returns new ones); :func:`serve_step` returns the same dict it was given.

Not ported: ``lm_loss``, multi-token prediction, ``_remat`` and the
sharding helpers (``param_specs``, ``param_shardings``, ``cache_specs``).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn

from repro_torch.models import blocks as B
from repro_torch.models.common import (
    ParamSpec, resolve_device, rms_norm, softcap, tree_init,
)
from repro_torch.models.config import ModelConfig

KINDS = ("attn_dense", "attn_local")


# ---------------------------------------------------------------------------
# Parameter plan
# ---------------------------------------------------------------------------

def _check_kind(kind: str) -> None:
    if kind not in KINDS:
        raise NotImplementedError(
            f"block kind {kind!r} is not ported yet (ROADMAP.md Queue 1 "
            f"item 16b); the port runs {KINDS}")


def plan_block(cfg: ModelConfig, kind: str) -> Dict[str, ParamSpec]:
    _check_kind(kind)
    plan = {f"attn.{n}": s for n, s in B.plan_attention(cfg).items()}
    plan.update({f"ffn.{n}": s for n, s in
                 B.plan_ffn(cfg, kind=cfg.ffn_kind).items()})
    return plan


def plan_model(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    """Every parameter, by name.  Body layers carry the reference's fan-in
    for its stacked leaves (the cycle count), so that :func:`init_params`
    draws from the reference's distribution."""
    if not cfg.embed_inputs:
        raise NotImplementedError("frontend-embedded inputs come with their "
                                  "archs (ROADMAP.md Queue 1 item 16b)")
    d = cfg.d_model
    plan: Dict[str, ParamSpec] = {
        "embed": ParamSpec((cfg.vocab, d)),
        "final_norm": ParamSpec((d,), "zeros"),
    }
    if not cfg.tie_embeddings:
        plan["head"] = ParamSpec((d, cfg.vocab))
    n_pre, n_body = len(cfg.prefix_blocks), cfg.cycles * len(cfg.block_pattern)
    for i, kind in enumerate(cfg.layer_kinds):
        body = n_pre <= i < n_pre + n_body
        for name, s in plan_block(cfg, kind).items():
            if body and s.init == "normal":
                s = s._replace(fan_in=cfg.cycles)
            plan[f"layers.{i}.{name}"] = s
    return plan


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------

def _sub(tensors: Dict[str, torch.Tensor], prefix: str):
    return {n[len(prefix):]: t for n, t in tensors.items()
            if n.startswith(prefix)}


class Block(nn.Module):
    """One layer's parameters: ``attn`` then ``ffn``, and its ``kind``
    (``attn_local`` attends within the local window)."""

    def __init__(self, kind: str, tensors: Dict[str, torch.Tensor]):
        super().__init__()
        _check_kind(kind)
        self.kind = kind
        self.attn = B.Params(_sub(tensors, "attn."))
        self.ffn = B.Params(_sub(tensors, "ffn."))


class LM(nn.Module):
    """The model: ``embed``, ``layers``, ``final_norm`` (and ``head`` when
    embeddings are not tied), built from tensors named as
    :func:`plan_model` names them; any leaf missing, left over or of
    another shape raises."""

    def __init__(self, cfg: ModelConfig, tensors: Dict[str, torch.Tensor]):
        super().__init__()
        plan = plan_model(cfg)
        missing = sorted(plan.keys() - tensors.keys())
        extra = sorted(tensors.keys() - plan.keys())
        if missing or extra:
            raise ValueError(f"parameters missing {missing[:8]} "
                             f"({len(missing)}), left over {extra[:8]} "
                             f"({len(extra)})")
        bad = [n for n, s in plan.items()
               if tuple(tensors[n].shape) != tuple(s.shape)]
        if bad:
            raise ValueError(f"parameters of the wrong shape: {bad[:8]}")
        self.cfg = cfg
        for name in ("embed", "final_norm", "head"):
            if name in tensors:
                self.register_parameter(
                    name, nn.Parameter(tensors[name], requires_grad=False))
        self.layers = nn.ModuleList(
            Block(kind, _sub(tensors, f"layers.{i}."))
            for i, kind in enumerate(cfg.layer_kinds))

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def forward(self, inputs, pos=None, caches=None):
        return forward(self.cfg, self, inputs, pos, caches)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def apply_block(cfg: ModelConfig, kind: str, p, x, pos, cache):
    _check_kind(kind)
    win = cfg.local_window if kind == "attn_local" else 0
    x, c = B.apply_attention(cfg, p.attn, x, pos,
                             cache["attn"] if cache else None, window=win)
    x = B.apply_ffn(cfg, p.ffn, x, kind=cfg.ffn_kind)
    return x, ({"attn": c} if cache else None)


def forward(cfg: ModelConfig, params: LM, inputs: torch.Tensor,
            pos: Optional[torch.Tensor] = None,
            caches: Optional[Dict[str, Any]] = None):
    """inputs: token ids [B, S].  Returns (hidden [B, S, d], caches).

    Without caches this is a prefill: positions are 0..S-1 (``pos`` None,
    or exactly that) and every attention layer runs the flash kernel.  With
    caches, one decode step at ``caches["pos"]`` (or ``pos``); the caches
    are updated in place and ``caches["pos"]`` advances by one.
    """
    b, s = inputs.shape[:2]
    x = params.embed[inputs.long()].to(cfg.dtype("compute"))
    x = x * torch.sqrt(torch.tensor(float(cfg.d_model))).to(x.dtype)
    if caches is None:
        B.prefill_positions(pos, b, s, x.device)
        pos = None                         # checked once, not per layer
    elif pos is None:
        pos = caches["pos"].expand(b, s)
    for i, layer in enumerate(params.layers):
        c = caches["layers"][i] if caches is not None else None
        x, _ = apply_block(cfg, layer.kind, layer, x, pos, c)
    if caches is not None:
        caches["pos"].add_(1)
    return rms_norm(x, params.final_norm, cfg.norm_eps), caches


def logits_fn(cfg: ModelConfig, params: LM, hidden: torch.Tensor):
    if cfg.tie_embeddings:
        return hidden @ params.embed.to(hidden.dtype).t()
    return hidden @ params.head.to(hidden.dtype)


def serve_step(cfg: ModelConfig, params: LM, caches: Dict[str, Any],
               tokens: torch.Tensor):
    """One decode step: tokens [B, 1] -> (logits [B, vocab] float32 with the
    logit softcap, caches updated in place)."""
    hidden, caches = forward(cfg, params, tokens, None, caches)
    logits = logits_fn(cfg, params, hidden[:, -1:, :])
    logits = softcap(logits.float(), cfg.logit_softcap)
    return logits[:, 0], caches


# ---------------------------------------------------------------------------
# Materialization
# ---------------------------------------------------------------------------

def init_params(cfg: ModelConfig, generator: torch.Generator,
                device="cuda") -> LM:
    """Random weights with the reference's distribution, drawn from
    ``generator`` (on its own device; pass one on the target device to
    draw there).  ``device="meta"`` gives the shapes without drawing."""
    dev = resolve_device(device)
    return LM(cfg, tree_init(plan_model(cfg), generator, cfg.dtype("param"),
                             dev))


def init_caches(cfg: ModelConfig, batch: int, max_len: int,
                device="cuda") -> Dict[str, Any]:
    """Zero caches in the compute dtype: ``pos`` (an int32 scalar) and one
    ``{"attn": {"k", "v"}}`` per layer (local layers hold a rotating
    buffer of min(window, max_len) slots)."""
    dev = resolve_device(device)
    layers = []
    for kind in cfg.layer_kinds:
        _check_kind(kind)
        window = cfg.local_window if kind == "attn_local" else 0
        layers.append({"attn": B.init_attn_cache(
            cfg, batch, max_len, window, device=dev,
            dtype=cfg.dtype("compute"))})
    return {"pos": torch.zeros((), dtype=torch.int32, device=dev),
            "layers": layers}


def count_params(params: nn.Module) -> int:
    return sum(p.numel() for p in params.parameters())
