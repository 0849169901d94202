"""LM assembly: embedding, the layer stack, final norm, logits, the loss
and decode.

Counterpart of ``repro.models.lm``.  The reference scans stacked
super-blocks (``jax.lax.scan``); here the stack is an ``nn.ModuleList`` of
``cfg.n_layers`` blocks (prefix, ``cycles`` times the pattern, remainder),
and a parameter's name is ``layers.<i>.<path>``.  With ``cfg.mtp`` the
model also holds ``mtp_proj``, ``mtp_block.<path>`` and ``mtp_norm``.
Inputs are token ids [B, S], or, with ``cfg.embed_inputs`` False (an
encoder behind a frontend stub, HuBERT), embeddings [B, S, d]: the model
then has no ``embed`` and always a ``head``.  A model that is not causal
has no decode: :func:`init_caches` and :func:`serve_step` refuse it, as
the reference's ``shape_cells`` gives an encoder no decode cell.

Everything runs on ``cuda`` unless the caller passes ``device="cpu"``.
Caches are tensors updated in place by each decode step (the reference
returns new ones); :func:`serve_step` returns the same dict it was given.
Training: :func:`lm_loss` (chunked cross-entropy, multi-token prediction)
on a model built with ``trainable=True``; ``cfg.remat`` checkpoints each
layer (the reference checkpoints each scanned super-block, which holds
the same layers).

Not ported: the sharding helpers (``param_specs``, ``param_shardings``,
``cache_specs``).
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Optional

import torch
from torch import nn
from torch.utils.checkpoint import (
    checkpoint, create_selective_checkpoint_contexts,
)

from repro_torch.models import blocks as B
from repro_torch.models.common import (
    ParamSpec, cross_entropy, masked_nll, resolve_device, rms_norm, softcap,
    tree_init,
)
from repro_torch.models.config import ModelConfig

# each block kind and the parts of its layer, in order: attention or a
# recurrence, then the FFN or the MoE where the kind has one (mLSTM and
# sLSTM carry their own projections in ``cell``).  ``attn`` is MLA in an
# ``mla_dense`` layer (its FFN at ``d_ff_dense``) and in an ``attn_moe``
# layer of a config with ``mla``, else GQA.
PARTS = {"attn_dense": ("attn", "ffn"), "attn_local": ("attn", "ffn"),
         "mla_dense": ("attn", "ffn"), "attn_moe": ("attn", "moe"),
         "rec": ("rec", "ffn"), "mlstm": ("cell",), "slstm": ("cell",)}
KINDS = tuple(PARTS)
# the ops whose outputs remat="dots" keeps (jax's checkpoint_dots: every
# matrix product); the rest of a layer is recomputed in the backward
_DOTS = [torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default]


# ---------------------------------------------------------------------------
# Parameter plan
# ---------------------------------------------------------------------------

def _check_kind(kind: str) -> None:
    if kind not in KINDS:
        raise ValueError(f"unknown block kind {kind!r}; the port runs "
                         f"{KINDS}")


def is_mla(cfg: ModelConfig, kind: str) -> bool:
    """Whether a layer of ``kind`` attends with MLA (else GQA)."""
    return kind == "mla_dense" or (kind == "attn_moe" and
                                   cfg.mla is not None)


def is_expert_leaf(name: str) -> bool:
    """Whether a parameter is stacked on the experts (``moe.w_in``,
    ``moe.w_out``): what an expert-parallel rank holds a slice of."""
    return ".moe.w_" in name


def _check_decoder(cfg: ModelConfig) -> None:
    if not cfg.causal:
        raise ValueError(
            f"{cfg.name} is not causal (an encoder): it has no decode, as "
            f"repro_torch.configs.shape_cells gives it no decode cell; run "
            f"it through forward, the prefill or the train step")


def plan_block(cfg: ModelConfig, kind: str) -> Dict[str, ParamSpec]:
    _check_kind(kind)
    d_ff = cfg.d_ff_dense if kind == "mla_dense" else None
    plans = {"attn": B.plan_mla if is_mla(cfg, kind) else B.plan_attention,
             "rec": B.plan_rglru, "moe": B.plan_moe,
             "cell": B.plan_mlstm if kind == "mlstm" else B.plan_slstm,
             "ffn": lambda c: B.plan_ffn(c, d_ff, kind=c.ffn_kind)}
    return {f"{part}.{n}": s for part in PARTS[kind]
            for n, s in plans[part](cfg).items()}


def plan_model(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    """Every parameter, by name.  Body layers carry the reference's fan-in
    for its stacked leaves (the cycle count), so that :func:`init_params`
    draws from the reference's distribution."""
    d = cfg.d_model
    plan: Dict[str, ParamSpec] = {}
    if cfg.embed_inputs:
        plan["embed"] = ParamSpec((cfg.vocab, d))
    plan["final_norm"] = ParamSpec((d,), "zeros")
    if not cfg.tie_embeddings or not cfg.embed_inputs:
        plan["head"] = ParamSpec((d, cfg.vocab))
    n_pre, n_body = len(cfg.prefix_blocks), cfg.cycles * len(cfg.block_pattern)
    for i, kind in enumerate(cfg.layer_kinds):
        body = n_pre <= i < n_pre + n_body
        for name, s in plan_block(cfg, kind).items():
            if body and s.init == "normal":
                s = s._replace(fan_in=cfg.cycles)
            plan[f"layers.{i}.{name}"] = s
    if cfg.mtp:
        plan["mtp_proj"] = ParamSpec((2 * d, d))
        plan.update((f"mtp_block.{n}", s)
                    for n, s in plan_block(cfg, "attn_dense").items())
        plan["mtp_norm"] = ParamSpec((d,), "zeros")
    return plan


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------

def _sub(tensors: Dict[str, torch.Tensor], prefix: str):
    return {n[len(prefix):]: t for n, t in tensors.items()
            if n.startswith(prefix)}


class Block(nn.Module):
    """One layer's parameters, one submodule for each of its kind's
    ``PARTS`` (``attn`` and ``ffn`` or ``moe``, ``rec`` and ``ffn``, or
    ``cell``), and its ``kind`` (``attn_local`` attends within the local
    window)."""

    def __init__(self, kind: str, tensors: Dict[str, torch.Tensor],
                 trainable: bool = False):
        super().__init__()
        _check_kind(kind)
        self.kind = kind
        for part in PARTS[kind]:
            setattr(self, part, B.Params(_sub(tensors, f"{part}."),
                                         trainable))


class LM(nn.Module):
    """The model: ``embed`` (unless the inputs come embedded), ``layers``,
    ``final_norm`` (and ``head`` when embeddings are not tied or the
    inputs come embedded; ``mtp_proj``, ``mtp_block``, ``mtp_norm`` with
    ``cfg.mtp``), built from tensors named as :func:`plan_model`
    names them; any leaf missing, left over or of another shape raises.
    The parameters take gradients only when ``trainable``.  ``ep_size`` >
    1: the MoE layers hold ``num_experts / ep_size`` experts, a rank's
    slice for the ``a2a`` path (``transfer.params_from_numpy(...,
    ep=...)``)."""

    def __init__(self, cfg: ModelConfig, tensors: Dict[str, torch.Tensor],
                 trainable: bool = False, ep_size: int = 1):
        super().__init__()
        plan = plan_model(cfg)
        if ep_size > 1:
            if cfg.moe is None or cfg.moe.num_experts % ep_size:
                raise ValueError(f"ep_size {ep_size} must divide the "
                                 f"experts of {cfg.name}")
            plan = {n: (s._replace(shape=(s.shape[0] // ep_size,)
                                   + tuple(s.shape[1:]))
                        if is_expert_leaf(n) else s)
                    for n, s in plan.items()}
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
        for name in ("embed", "final_norm", "head", "mtp_proj", "mtp_norm"):
            if name in tensors:
                self.register_parameter(
                    name, nn.Parameter(tensors[name], requires_grad=trainable))
        self.layers = nn.ModuleList(
            Block(kind, _sub(tensors, f"layers.{i}."), trainable)
            for i, kind in enumerate(cfg.layer_kinds))
        if cfg.mtp:
            self.mtp_block = Block("attn_dense", _sub(tensors, "mtp_block."),
                                   trainable)

    @property
    def device(self) -> torch.device:
        return self.final_norm.device

    def forward(self, inputs, pos=None, caches=None):
        return forward(self.cfg, self, inputs, pos, caches)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def apply_block(cfg: ModelConfig, kind: str, p, x, pos, cache):
    _check_kind(kind)
    if kind in ("mlstm", "slstm"):
        apply = B.apply_mlstm if kind == "mlstm" else B.apply_slstm
        x, c = apply(cfg, p.cell, x, cache["cell"] if cache else None)
        return x, ({"cell": c} if cache else None)
    if kind == "rec":
        part = "rec"
        x, c = B.apply_rglru(cfg, p.rec, x, cache["rec"] if cache else None)
    else:
        part = "attn"
        c = cache["attn"] if cache else None
        if is_mla(cfg, kind):
            x, c = B.apply_mla(cfg, p.attn, x, pos, c)
        else:
            win = cfg.local_window if kind == "attn_local" else 0
            x, c = B.apply_attention(cfg, p.attn, x, pos, c, window=win)
    if kind == "attn_moe":
        x = B.apply_moe(cfg, p.moe, x)
    else:
        x = B.apply_ffn(cfg, p.ffn, x, kind=cfg.ffn_kind)
    return x, ({part: c} if cache else None)


def _layer(cfg: ModelConfig, layer: Block, x: torch.Tensor) -> torch.Tensor:
    return apply_block(cfg, layer.kind, layer, x, None, None)[0]


def _remat(cfg: ModelConfig, fn):
    """``fn`` under ``cfg.remat``: ``none`` keeps every activation for the
    backward; ``full`` keeps only the input and recomputes ``fn`` in the
    backward; ``dots`` keeps the matrix products' outputs too and
    recomputes the rest (``jax.checkpoint_policies.checkpoint_dots``)."""
    if cfg.remat == "none":
        return fn
    kw = {}
    if cfg.remat == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _DOTS)
    return functools.partial(checkpoint, fn, use_reentrant=False, **kw)


def forward(cfg: ModelConfig, params: LM, inputs: torch.Tensor,
            pos: Optional[torch.Tensor] = None,
            caches: Optional[Dict[str, Any]] = None):
    """inputs: token ids [B, S], or embeddings [B, S, d] when
    ``cfg.embed_inputs`` is False (cast to the compute dtype, without the
    sqrt(d) scale of embedded tokens).  Returns (hidden [B, S, d],
    caches).

    Without caches this is a prefill or a training pass: positions are
    0..S-1 (``pos`` None, or exactly that), every attention layer runs the
    flash kernel, and, where autograd records, each layer runs under
    ``cfg.remat``.  With caches, one decode step at ``caches["pos"]`` (or
    ``pos``); the caches are updated in place and ``caches["pos"]``
    advances by one.
    """
    b, s = inputs.shape[:2]
    if cfg.embed_inputs:
        x = params.embed[inputs.long()].to(cfg.dtype("compute"))
        x = x * torch.sqrt(torch.tensor(float(cfg.d_model))).to(x.dtype)
    else:
        x = inputs.to(cfg.dtype("compute"))
    if caches is None:
        B.prefill_positions(pos, b, s, x.device)
        pos = None                         # checked once, not per layer
        run = _remat(cfg, _layer) if torch.is_grad_enabled() else _layer
        for layer in params.layers:
            x = run(cfg, layer, x)
    else:
        if pos is None:
            pos = caches["pos"].expand(b, s)
        for layer, c in zip(params.layers, caches["layers"]):
            x, _ = apply_block(cfg, layer.kind, layer, x, pos, c)
        caches["pos"].add_(1)
    return rms_norm(x, params.final_norm, cfg.norm_eps), caches


def logits_fn(cfg: ModelConfig, params: LM, hidden: torch.Tensor):
    if cfg.tie_embeddings and cfg.embed_inputs:
        return hidden @ params.embed.to(hidden.dtype).t()
    return hidden @ params.head.to(hidden.dtype)


def _chunk_nll(cfg: ModelConfig, params: LM, h: torch.Tensor,
               t: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Summed NLL of one chunk from its logits in the compute dtype."""
    return masked_nll(logits_fn(cfg, params, h), t, m, cfg.logit_softcap)


def lm_loss(cfg: ModelConfig, params: LM, batch: Dict[str, torch.Tensor]):
    """The training loss of ``batch`` ({"inputs", "targets", "mask"} [B, S],
    optional "pos", which must be None or 0..S-1): the token-mean
    cross-entropy, float32.

    When ``cfg.loss_chunk`` divides S and is smaller, the cross-entropy
    goes ``loss_chunk`` positions at a time and the [B, S, V] logits are
    never materialised: each chunk's logits are recomputed in the backward
    (a checkpoint around the chunk).  With ``cfg.mtp``, one more
    ``attn_dense`` block predicts token t+2 from [h_t ; emb(tok_{t+1})]
    and adds 0.3 times its cross-entropy (DeepSeek-V3); inputs that come
    embedded have no embedding table to read, and skip it, as the
    reference does.
    """
    inputs, targets, mask = batch["inputs"], batch["targets"], batch["mask"]
    hidden, _ = forward(cfg, params, inputs, batch.get("pos"))
    s, chunk = hidden.shape[1], cfg.loss_chunk
    if chunk and s % chunk == 0 and s > chunk:
        nll = functools.partial(checkpoint, _chunk_nll, use_reentrant=False) \
            if torch.is_grad_enabled() else _chunk_nll
        tot = cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
        for c in range(0, s, chunk):
            m = mask[:, c:c + chunk].float()
            tot = tot + nll(cfg, params, hidden[:, c:c + chunk],
                            targets[:, c:c + chunk], m)
            cnt = cnt + m.sum()
        loss = tot / torch.clamp(cnt, min=1.0)
    else:
        loss = cross_entropy(logits_fn(cfg, params, hidden), targets, mask,
                             cfg.logit_softcap)

    if cfg.mtp and cfg.embed_inputs:
        nxt = params.embed[targets.long()].to(hidden.dtype)
        h2 = torch.cat([hidden, nxt], dim=-1) @ params.mtp_proj.to(
            hidden.dtype)
        h2, _ = apply_block(cfg, "attn_dense", params.mtp_block, h2, None,
                            None)
        h2 = rms_norm(h2, params.mtp_norm, cfg.norm_eps)
        t2 = torch.cat([targets[:, 1:], targets[:, -1:]], dim=1)
        m2 = torch.cat([mask[:, :-1], torch.zeros_like(mask[:, :1])],
                       dim=1).float()
        loss = loss + 0.3 * cross_entropy(logits_fn(cfg, params, h2), t2, m2,
                                          cfg.logit_softcap)
    return loss


def serve_step(cfg: ModelConfig, params: LM, caches: Dict[str, Any],
               tokens: torch.Tensor):
    """One decode step: tokens [B, 1] -> (logits [B, vocab] float32 with the
    logit softcap, caches updated in place).  A config that is not causal
    raises."""
    _check_decoder(cfg)
    hidden, caches = forward(cfg, params, tokens, None, caches)
    logits = logits_fn(cfg, params, hidden[:, -1:, :])
    logits = softcap(logits.float(), cfg.logit_softcap)
    return logits[:, 0], caches


# ---------------------------------------------------------------------------
# Materialization
# ---------------------------------------------------------------------------

def init_params(cfg: ModelConfig, generator: torch.Generator,
                device="cuda", trainable: bool = False) -> LM:
    """Random weights with the reference's distribution, drawn from
    ``generator`` (on its own device; pass one on the target device to
    draw there).  ``device="meta"`` gives the shapes without drawing."""
    dev = resolve_device(device)
    return LM(cfg, tree_init(plan_model(cfg), generator, cfg.dtype("param"),
                             dev), trainable)


def init_caches(cfg: ModelConfig, batch: int, max_len: int,
                device="cuda") -> Dict[str, Any]:
    """Zero caches: ``pos`` (an int32 scalar) and one per layer, keyed by
    the part that reads it: ``{"attn": {"k", "v"}}`` in the compute dtype
    (local layers hold a rotating buffer of min(window, max_len) slots),
    or, for an MLA layer, ``{"attn": {"latent", "k_rope"}}`` in the compute
    dtype,
    ``{"rec": {"h", "conv"}}`` in the compute dtype, and ``{"cell":
    ...}``, mLSTM's ``C``, ``n``, ``m`` and sLSTM's ``c``, ``n``, ``h``,
    ``m`` in float32, the dtype of the reference's carries after its
    first step.  A config that is not causal raises: it has no decode."""
    _check_decoder(cfg)
    dev = resolve_device(device)
    dtype = cfg.dtype("compute")
    layers = []
    for kind in cfg.layer_kinds:
        _check_kind(kind)
        if kind == "rec":
            layers.append({"rec": B.init_rglru_cache(cfg, batch, device=dev,
                                                     dtype=dtype)})
        elif kind in ("mlstm", "slstm"):
            init = B.init_mlstm_cache if kind == "mlstm" \
                else B.init_slstm_cache
            layers.append({"cell": init(cfg, batch, device=dev)})
        elif is_mla(cfg, kind):
            layers.append({"attn": B.init_mla_cache(
                cfg, batch, max_len, device=dev, dtype=dtype)})
        else:
            window = cfg.local_window if kind == "attn_local" else 0
            layers.append({"attn": B.init_attn_cache(
                cfg, batch, max_len, window, device=dev, dtype=dtype)})
    return {"pos": torch.zeros((), dtype=torch.int32, device=dev),
            "layers": layers}


def count_params(params: nn.Module) -> int:
    return sum(p.numel() for p in params.parameters())
