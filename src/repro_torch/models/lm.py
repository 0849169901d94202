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

Under a mesh (``mesh=`` of :func:`init_params`, :func:`init_caches`,
``LM``'s ``layout``): the model holds one rank's shards of every leaf, as
the reference's ``param_shardings`` lays them out (``models.shard``), and
runs under the ambient mesh (``models.meshctx``): the embedding is
vocab-parallel (ids outside the rank's rows masked, the rows reduced over
``"model"``, Gemma's sqrt(d) scale after), each layer reduces its partial
sums (an MoE layer gathers the batch's rows first: its routing is over
the global batch), :func:`logits_fn` gives the rank's vocab slice, and
:func:`gather_logits` (:func:`serve_step`, :func:`prefill`) gathers it
over ``"model"`` and the batch over ``"data"``, so that every rank returns
the whole [B, V].  Token ids come whole to every rank;
:func:`serve_step` and :func:`prefill` run the rank's rows of them.
Caches hold the rank's rows, the kv heads it reads and its RG-LRU
columns; MLA's latent and the xLSTM cells' states are whole; ``pos`` stays
replicated.  :func:`lm_loss` under a layout is vocab-parallel on the
rank's rows, and its backward goes through each collective's adjoint
(``models.collectives``); the gradients it leaves are partial over the
batch's axes (``launch.steps.make_train_step`` sums them).
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
from repro_torch.models.collectives import reduce_out, split_in
from repro_torch.models.common import (
    ParamSpec, masked_nll, resolve_device, rms_norm, softcap, tree_init,
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
        plan["embed"] = ParamSpec((cfg.vocab, d), ("vocab", "d_model"))
    plan["final_norm"] = ParamSpec((d,), ("d_model",), "zeros")
    if not cfg.tie_embeddings or not cfg.embed_inputs:
        plan["head"] = ParamSpec((d, cfg.vocab), ("d_model", "vocab"))
    n_pre, n_body = len(cfg.prefix_blocks), cfg.cycles * len(cfg.block_pattern)
    for i, kind in enumerate(cfg.layer_kinds):
        body = n_pre <= i < n_pre + n_body
        for name, s in plan_block(cfg, kind).items():
            if body and s.init == "normal":
                s = s._replace(fan_in=cfg.cycles)
            plan[f"layers.{i}.{name}"] = s
    if cfg.mtp:
        plan["mtp_proj"] = ParamSpec((2 * d, d), ("d_model", None))
        plan.update((f"mtp_block.{n}", s)
                    for n, s in plan_block(cfg, "attn_dense").items())
        plan["mtp_norm"] = ParamSpec((d,), ("d_model",), "zeros")
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
                 trainable: bool = False, parts=None):
        super().__init__()
        _check_kind(kind)
        self.kind = kind
        for part in PARTS[kind]:
            setattr(self, part, B.Params(_sub(tensors, f"{part}."),
                                         trainable, (parts or {}).get(part)))


def _parts(cfg: ModelConfig, layout, kind: str):
    """A layer of ``kind``'s ``shard.Part`` by part under ``layout``."""
    if layout is None:
        return None
    parts = {}
    for part in PARTS[kind]:
        if part == "attn":
            parts[part] = layout.mla_heads() if is_mla(cfg, kind) \
                else layout.attn_heads()
        elif part == "ffn":
            parts[part] = layout.ffn(cfg.d_ff_dense if kind == "mla_dense"
                                     else cfg.d_ff)
        elif part == "cell":
            parts[part] = layout.mlstm() if kind == "mlstm" \
                else layout.slstm()
        else:
            parts[part] = getattr(layout, part)()      # moe, rec
    return parts


class LM(nn.Module):
    """The model: ``embed`` (unless the inputs come embedded), ``layers``,
    ``final_norm`` (and ``head`` when embeddings are not tied or the
    inputs come embedded; ``mtp_proj``, ``mtp_block``, ``mtp_norm`` with
    ``cfg.mtp``), built from tensors named as :func:`plan_model`
    names them; any leaf missing, left over or of another shape raises.
    The parameters take gradients only when ``trainable``.  ``ep_size`` >
    1: the MoE layers hold ``num_experts / ep_size`` experts, a rank's
    slice for the ``a2a`` path (``transfer.params_from_numpy(...,
    ep=...)``).  ``layout`` (a ``models.shard.Layout``): the tensors are
    that rank's shards, at the shapes of ``layout.plan()``; a config with
    a block kind the mesh does not split raises."""

    def __init__(self, cfg: ModelConfig, tensors: Dict[str, torch.Tensor],
                 trainable: bool = False, ep_size: int = 1, layout=None):
        super().__init__()
        plan = plan_model(cfg)
        if layout is not None:
            from repro_torch.models.shard import check_supported
            check_supported(cfg)
            if ep_size > 1:
                raise ValueError("a layout and ep_size do not combine")
            plan = layout.plan()
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
        self.layout = layout
        self.vocab_part = None if layout is None else layout.vocab()
        for name in ("embed", "final_norm", "head", "mtp_proj", "mtp_norm"):
            if name in tensors:
                self.register_parameter(
                    name, nn.Parameter(tensors[name], requires_grad=trainable))
        self.layers = nn.ModuleList(
            Block(kind, _sub(tensors, f"layers.{i}."), trainable,
                  _parts(cfg, layout, kind))
            for i, kind in enumerate(cfg.layer_kinds))
        if cfg.mtp:
            self.mtp_block = Block("attn_dense", _sub(tensors, "mtp_block."),
                                   trainable, _parts(cfg, layout,
                                                     "attn_dense"))

    @property
    def device(self) -> torch.device:
        return self.final_norm.device

    def forward(self, inputs, pos=None, caches=None):
        return forward(self.cfg, self, inputs, pos, caches)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def apply_block(cfg: ModelConfig, kind: str, p, x, pos, cache, rows=()):
    """One layer on ``x``; ``rows``: the mesh axes a rank's batch is split
    over (the MoE gathers its rows over them, ``blocks.apply_moe``)."""
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
        x = B.apply_moe(cfg, p.moe, x, rows)
    else:
        x = B.apply_ffn(cfg, p.ffn, x, kind=cfg.ffn_kind)
    return x, ({part: c} if cache else None)


def _layer(cfg: ModelConfig, layer: Block, x: torch.Tensor,
           rows=()) -> torch.Tensor:
    return apply_block(cfg, layer.kind, layer, x, None, None, rows)[0]


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


def embed(cfg: ModelConfig, params: LM, ids: torch.Tensor) -> torch.Tensor:
    """The rows of ``embed`` for token ``ids``, in the parameters' dtype;
    under a layout vocab-parallel: the rank's rows, the others' ids masked
    to zero, reduced over the vocabulary's axes."""
    vocab = getattr(params, "vocab_part", None)
    if vocab is None or not vocab.reduce:
        return params.embed[ids.long()]
    ids = ids.long() - vocab.lo
    inside = ((ids >= 0) & (ids < vocab.n))[..., None]
    emb = params.embed[ids.clamp(0, vocab.n - 1)]
    return reduce_out(B.part_mesh(vocab), torch.where(inside, emb, 0),
                      vocab.reduce)


def forward(cfg: ModelConfig, params: LM, inputs: torch.Tensor,
            pos: Optional[torch.Tensor] = None,
            caches: Optional[Dict[str, Any]] = None, rows=()):
    """inputs: token ids [B, S], or embeddings [B, S, d] when
    ``cfg.embed_inputs`` is False (cast to the compute dtype, without the
    sqrt(d) scale of embedded tokens).  Returns (hidden [B, S, d],
    caches).

    Without caches this is a prefill or a training pass: positions are
    0..S-1 (``pos`` None, or exactly that), every attention layer runs the
    flash kernel, and, where autograd records, each layer runs under
    ``cfg.remat``.  With caches, one decode step at ``caches["pos"]`` (or
    ``pos``); the caches are updated in place and ``caches["pos"]``
    advances by one.  ``rows``: under a layout, the mesh axes the batch
    was split over to give the rank ``inputs`` (``layout.rows``).
    """
    b, s = inputs.shape[:2]
    if cfg.embed_inputs:
        x = embed(cfg, params, inputs).to(cfg.dtype("compute"))
        x = x * torch.sqrt(torch.tensor(float(cfg.d_model))).to(x.dtype)
    else:
        x = inputs.to(cfg.dtype("compute"))
    if caches is None:
        B.prefill_positions(pos, b, s, x.device)
        pos = None                         # checked once, not per layer
        run = _remat(cfg, _layer) if torch.is_grad_enabled() else _layer
        for layer in params.layers:
            x = run(cfg, layer, x, rows)
    else:
        if pos is None:
            pos = caches["pos"].expand(b, s)
        for layer, c in zip(params.layers, caches["layers"]):
            x, _ = apply_block(cfg, layer.kind, layer, x, pos, c, rows)
        caches["pos"].add_(1)
    return rms_norm(x, params.final_norm, cfg.norm_eps), caches


def logits_fn(cfg: ModelConfig, params: LM, hidden: torch.Tensor):
    """hidden [..., d] -> logits [..., V] in its dtype; a rank's vocab
    slice [..., V / parts] under a mesh (:func:`gather_logits`)."""
    if cfg.tie_embeddings and cfg.embed_inputs:
        return hidden @ params.embed.to(hidden.dtype).t()
    return hidden @ params.head.to(hidden.dtype)


def gather_logits(cfg: ModelConfig, params: LM, logits: torch.Tensor,
                  batch_axes=()) -> torch.Tensor:
    """A rank's logits [b, ..., V / parts] of its rows as every rank's whole
    [B, ..., V]: gathered over the vocabulary's mesh axes (the slices in
    their order), then over ``batch_axes`` (the rows in their order).  A
    model without a layout returns ``logits``."""
    vocab = getattr(params, "vocab_part", None)
    if vocab is None:
        return logits
    mesh = B.part_mesh(vocab)
    if vocab.reduce:
        parts = mesh.all_gather(logits, vocab.reduce)
        logits = parts.movedim(0, -2).reshape(*logits.shape[:-1], -1)
    if batch_axes:
        logits = mesh.all_gather(logits, batch_axes).flatten(0, 1)
    return logits


def _vocab_nll(cfg: ModelConfig, params: LM, h: torch.Tensor,
               t: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Summed NLL of the rank's rows ``h`` [b, c, d] (targets ``t``, mask
    ``m``), float32 after the logit softcap, from the rank's vocab slice
    of the logits: the logsumexp's max over the slices (no gradient goes
    through it), its sum of exponentials and the gold logit (from the rank
    that holds the target; the others add 0) reduced over the vocabulary's
    axes in one sum.  Without a layout, or with the vocabulary whole on
    the rank, the plain ``masked_nll``."""
    vocab = getattr(params, "vocab_part", None)
    if vocab is None or not vocab.reduce:
        return masked_nll(logits_fn(cfg, params, h), t, m, cfg.logit_softcap)
    mesh = B.part_mesh(vocab)
    lg = softcap(logits_fn(cfg, params, split_in(mesh, h, vocab.reduce))
                 .float(), cfg.logit_softcap)
    top = mesh.all_gather(lg.detach().amax(-1), vocab.reduce).amax(0)
    ids = t.long() - vocab.lo
    inside = (ids >= 0) & (ids < vocab.n)
    gold = torch.gather(lg, -1, ids.clamp(0, vocab.n - 1)[..., None])[..., 0]
    sums = reduce_out(mesh, torch.stack(
        [torch.exp(lg - top[..., None]).sum(-1),
         torch.where(inside, gold, 0)]), vocab.reduce)
    return ((top + torch.log(sums[0]) - sums[1]) * m.float()).sum()


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

    Under a layout (a model cut for a rank, run under its mesh) the batch
    comes whole to every rank, which runs its rows of it: the loss is
    vocab-parallel (:func:`_vocab_nll`), each rank sums its rows' NLL and
    divides by the whole batch's token count (the whole mask is on every
    rank), and the returned loss is those shares summed over the batch's
    axes, whose gradient reaches each rank's share unchanged
    (``collectives.reduce_out``).  The gradients a rank's backward leaves
    are partial over the batch's axes (``models.shard`` says which leaves
    to sum over which axes).
    """
    total = batch["mask"].float().sum()
    pos = batch.get("pos")
    (inputs, targets, mask), axes = _own_rows(params, (
        batch["inputs"], batch["targets"], batch["mask"]))
    if pos is not None:
        pos, _ = _own_rows(params, pos)
    hidden, _ = forward(cfg, params, inputs, pos, rows=axes)
    s, chunk = hidden.shape[1], cfg.loss_chunk
    if chunk and s % chunk == 0 and s > chunk:
        nll = functools.partial(checkpoint, _vocab_nll, use_reentrant=False) \
            if torch.is_grad_enabled() else _vocab_nll
        tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
        for c in range(0, s, chunk):
            tot = tot + nll(cfg, params, hidden[:, c:c + chunk],
                            targets[:, c:c + chunk], mask[:, c:c + chunk])
        loss = tot / torch.clamp(total, min=1.0)
    else:
        loss = _vocab_nll(cfg, params, hidden, targets, mask) / \
            torch.clamp(total, min=1.0)

    if cfg.mtp and cfg.embed_inputs:
        nxt = embed(cfg, params, targets).to(hidden.dtype)
        h2 = torch.cat([hidden, nxt], dim=-1) @ params.mtp_proj.to(
            hidden.dtype)
        h2, _ = apply_block(cfg, "attn_dense", params.mtp_block, h2, None,
                            None, axes)
        h2 = rms_norm(h2, params.mtp_norm, cfg.norm_eps)
        t2 = torch.cat([targets[:, 1:], targets[:, -1:]], dim=1)
        m2 = torch.cat([mask[:, :-1], torch.zeros_like(mask[:, :1])],
                       dim=1).float()
        total2 = batch["mask"][:, :-1].float().sum()
        loss = loss + 0.3 * _vocab_nll(cfg, params, h2, t2, m2) / \
            torch.clamp(total2, min=1.0)
    if axes:
        loss = reduce_out(B.part_mesh(params.vocab_part), loss, axes)
    return loss


def _own_rows(params: LM, x):
    """The rows of a whole batch ``x`` (a tensor, or a tuple of them) that
    the model's rank runs, and the mesh axes the batch is split over: all
    of ``x`` and none without a layout."""
    if getattr(params, "layout", None) is None:
        return x, ()
    first = x[0] if isinstance(x, tuple) else x
    rows, axes = params.layout.rows(first.shape[0])
    if isinstance(x, tuple):
        return tuple(t[rows] for t in x), axes
    return x[rows], axes


def prefill(cfg: ModelConfig, params: LM, inputs: torch.Tensor,
            every: bool = False):
    """inputs [B, S] ids or [B, S, d] embeddings -> last-token logits [B,
    1, V] (``every``: every position's, [B, S, V]) in the compute dtype,
    without the logit softcap (as the reference).  Under a layout the
    rank runs its rows, and every rank returns the whole logits."""
    inputs, axes = _own_rows(params, inputs)
    hidden, _ = forward(cfg, params, inputs, rows=axes)
    if not every:
        hidden = hidden[:, -1:, :]
    return gather_logits(cfg, params, logits_fn(cfg, params, hidden), axes)


def serve_step(cfg: ModelConfig, params: LM, caches: Dict[str, Any],
               tokens: torch.Tensor):
    """One decode step: tokens [B, 1] -> (logits [B, vocab] float32 with the
    logit softcap, caches updated in place).  A config that is not causal
    raises."""
    _check_decoder(cfg)
    tokens, axes = _own_rows(params, tokens)
    hidden, caches = forward(cfg, params, tokens, None, caches, axes)
    logits = logits_fn(cfg, params, hidden[:, -1:, :]).float()
    logits = softcap(gather_logits(cfg, params, logits, axes),
                     cfg.logit_softcap)
    return logits[:, 0], caches


# ---------------------------------------------------------------------------
# Materialization
# ---------------------------------------------------------------------------

def init_params(cfg: ModelConfig, generator: torch.Generator,
                device="cuda", trainable: bool = False, mesh=None) -> LM:
    """Random weights with the reference's distribution, drawn from
    ``generator`` (on its own device; pass one on the target device to
    draw there).  ``device="meta"`` gives the shapes without drawing.
    ``mesh``: the model of ``mesh``'s own rank, each leaf drawn whole (the
    same values at any mesh) and cut to the rank's shard."""
    dev = resolve_device(device)
    if mesh is None:
        return LM(cfg, tree_init(plan_model(cfg), generator,
                                 cfg.dtype("param"), dev), trainable)
    from repro_torch.models.shard import Layout
    layout = Layout.of(cfg, mesh)
    tensors = {}
    for name, spec in plan_model(cfg).items():
        if dev.type == "meta":
            spec = spec._replace(shape=layout.local_shape(spec))
        whole = tree_init({name: spec}, generator, cfg.dtype("param"),
                          dev)[name]
        tensors[name] = whole if dev.type == "meta" else \
            layout.take(name, spec, whole).clone()
        del whole
    return LM(cfg, tensors, trainable, layout=layout)


def init_caches(cfg: ModelConfig, batch: int, max_len: int,
                device="cuda", mesh=None) -> Dict[str, Any]:
    """Zero caches: ``pos`` (an int32 scalar) and one per layer, keyed by
    the part that reads it: ``{"attn": {"k", "v"}}`` in the compute dtype
    (local layers hold a rotating buffer of min(window, max_len) slots),
    or, for an MLA layer, ``{"attn": {"latent", "k_rope"}}`` in the compute
    dtype,
    ``{"rec": {"h", "conv"}}`` in the compute dtype, and ``{"cell":
    ...}``, mLSTM's ``C``, ``n``, ``m`` and sLSTM's ``c``, ``n``, ``h``,
    ``m`` in float32, the dtype of the reference's carries after its
    first step.  A config that is not causal raises: it has no decode.
    ``mesh``: the caches of ``mesh``'s own rank, its rows of the batch, the
    kv heads its q heads read and its RG-LRU columns (``models.shard``);
    MLA's latent and the xLSTM cells' states whole."""
    _check_decoder(cfg)
    dev = resolve_device(device)
    dtype = cfg.dtype("compute")
    kv_heads = width = None
    if mesh is not None:
        from repro_torch.models.shard import Layout, check_supported
        check_supported(cfg)
        layout = Layout.of(cfg, mesh)
        rows = layout.rows(batch)[0]
        batch = rows.stop - rows.start
        if any("attn" in PARTS[k] and not is_mla(cfg, k)
               for k in cfg.layer_kinds):
            heads = layout.attn_heads().kv
            kv_heads = heads.stop - heads.start
        if "rec" in cfg.layer_kinds:
            width = layout.rec().n
    layers = []
    for kind in cfg.layer_kinds:
        _check_kind(kind)
        if kind == "rec":
            layers.append({"rec": B.init_rglru_cache(cfg, batch, device=dev,
                                                     dtype=dtype,
                                                     width=width)})
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
                cfg, batch, max_len, window, device=dev, dtype=dtype,
                kv_heads=kv_heads)})
    return {"pos": torch.zeros((), dtype=torch.int32, device=dev),
            "layers": layers}


def count_params(params: nn.Module) -> int:
    return sum(p.numel() for p in params.parameters())
