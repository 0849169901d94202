"""Blocks of the port: GQA attention, MLA, the dense FFN, MoE, and the
recurrent blocks (RG-LRU, mLSTM, sLSTM).

Counterpart of ``repro.models.blocks``.
Every kind provides ``plan_<kind>(cfg)`` (a flat dict of ``ParamSpec``)
and ``apply_<kind>(cfg, p, x, ...)`` on a :class:`Params` module holding
those parameters.  Layout as the reference: activations [B, S, ...], q/k/v
[B, S, heads, hd], ``wq`` [d, H, hd], ``wo`` [H, hd, d].

``cache=None`` is a prefill or a training pass over the whole sequence:
queries and keys sit at positions 0..S-1 and attention runs the flash
kernel (:func:`attend`); its gradient is that of the dense formula
:func:`_attend`, recomputed from the saved q, k and v, which is what
``jax.grad`` differentiates in the reference's train step.  A cache dict
is a one-token decode step at the cache's position, attending over the
cache with :func:`_attend`, as the reference does with XLA.  The cache is
updated in place.

``cfg.causal`` False (an encoder, HuBERT) masks nothing but the window:
the flash kernel and :func:`_attend` take it alike.  The FFN kinds are
SwiGLU, GeGLU and GELU (tanh approximation, as ``jax.nn.gelu``'s
default).

The recurrent blocks (RecurrentGemma's RG-LRU with its causal conv,
xLSTM's mLSTM and sLSTM) carry a state from token to token.  Without a
cache, RG-LRU's linear recurrence runs as a scan of ceil(log2 S)
elementwise passes (:func:`linear_scan`, the reference's
``associative_scan``), and mLSTM and sLSTM step through the tokens one
at a time in Python, as the reference's ``lax.scan`` does (in training,
mLSTM's in checkpointed chunks of ``MLSTM_CHUNK`` tokens); no kernel of
the reference maps to them.  With a cache, each takes one step and
writes its state in place: RG-LRU's ``h`` and ``conv`` in the cache's
dtype (the compute dtype: ``h`` is rounded to it every step, as in the
reference), the xLSTM cells' states in float32.

MLA (DeepSeek-V3's multi-head latent attention) without a cache expands
its latent to per-head keys (q.k head dim nope + rope = 192) and values
(128) and runs the flash kernel at that pair of dims, one launch a layer.
With a cache it decodes *absorbed*, as the reference: the cache holds only
the normed latent [B, T, kv_lora_rank] and the roped ``k_rope`` [B, T,
rope] in the compute dtype, and the scores are taken in latent space in
float32.

MoE takes the reference's two paths, chosen as its ``apply_moe``
chooses.  ``gather`` (:func:`apply_moe_gather`, the default ``moe_impl``):
a float32 softmax router, top-k (ties to the lower expert id, as
``jax.lax.top_k``), gates renormalised, each (token, k) slot placed in its
expert's buffer of ``moe_capacity`` slots in token-major order, slots past
it dropped, two batched products over all experts, the weighted gather
back, and the shared expert.  ``a2a`` (:func:`apply_moe_a2a`, with
``moe_impl="a2a"`` and an ambient ``RankMesh`` that has every ``ep_axes``
axis, ``repro_torch.models.meshctx``): each rank routes its own block of
tokens, buckets the (token, k) slots by the rank that holds their expert,
exchanges them (and back) over the EP axes with ``all_to_all_single``, and
runs only its ``num_experts / P`` experts.  The routing
(:func:`moe_route`) is looked up by name at every call, so that a probe
can wrap it to record the chosen experts without a cost to the serving
path.

Every block also runs on one rank's shards of its leaves
(:class:`Params` ``part``, cut by ``models.shard``): on the rank's heads,
experts or ``d_ff`` columns, each partial sum reduced through the
ambient mesh's ``psum``; each ``apply_*`` says how
(:func:`apply_moe_part` for the MoE).  In training each collective goes
through ``models.collectives``, whose backward is its adjoint: a
reduction's is the identity, and what every rank holds alike (the normed
input, MLA's latent, RG-LRU's reduced gates and ``lam``, mLSTM's normed
cell output, a replicated ``wk`` / ``wv`` and qk-norm's scales) sums its
gradient over the axes its split work runs on.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.collectives import (
    exchange, gather_alike, gather_rows, reduce_out, reduce_own_rows,
    split_in,
)
from repro_torch.models.common import (
    ParamSpec, apply_rope, rms_norm, rope_table, softcap, swiglu,
)
from repro_torch.models.config import ModelConfig

NEG = -2.0e38


# the largest float32 score block of the attention backward's recompute,
# in bytes: a layer's kv heads go through it in groups whose [B, group, rep,
# S, S] scores stay under this (a whole layer's take 1.07 GB a sequence at
# S 4096, H 16)
ATTN_BWD_SCORE_BYTES = 2**30
# the profiler range around that recompute (``chip_smoke.py`` reads it)
ATTN_BWD_RANGE = "attention_backward_recompute"
# tokens of the mLSTM loop recomputed together in a training pass: autograd
# of a token saves its [B, H, dh, dh] float32 state C about three times
# (4.7 MB each at xLSTM 125M's B 2, H 4, dh 384: some 58 GB for one layer
# at S 4096), so with grad on the loop runs in chunks of this many tokens,
# each under a checkpoint that keeps only the state at its start
MLSTM_CHUNK = 64


class Params(nn.Module):
    """A block's parameters, one ``nn.Parameter`` per plan leaf; they take
    gradients only when ``trainable`` (serving builds them without).
    ``part`` (a ``models.shard.Part``): the tensors are one rank's shards
    of the leaves, and the block runs under the ambient mesh they were cut
    for."""

    def __init__(self, tensors: Dict[str, torch.Tensor],
                 trainable: bool = False, part=None):
        super().__init__()
        self.part = part
        for name, t in tensors.items():
            self.register_parameter(name,
                                    nn.Parameter(t, requires_grad=trainable))


def part_mesh(part):
    """The ambient mesh (``models.meshctx``) for a rank's shards cut as
    ``part`` says; another mesh, or none, raises."""
    from repro_torch.models.meshctx import get_mesh
    from repro_torch.models.shard import where_of
    mesh = get_mesh()
    if mesh is None or where_of(mesh) != part.where:
        raise ValueError(f"these parameters are a rank's shards for the mesh "
                         f"and coordinates {part.where}; run them under that "
                         f"mesh (models.meshctx), not {mesh!r}")
    return mesh


# ---------------------------------------------------------------------------
# Attention (GQA, local windows, softcap, qk-norm)
# ---------------------------------------------------------------------------

def plan_attention(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d, h, k, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {
        "norm": ParamSpec((d,), ("d_model",), "zeros"),
        "wq": ParamSpec((d, h, hd), ("d_model", "heads", None)),
        "wk": ParamSpec((d, k, hd), ("d_model", "kv_heads", None)),
        "wv": ParamSpec((d, k, hd), ("d_model", "kv_heads", None)),
        "wo": ParamSpec((h, hd, d), ("heads", None, "d_model")),
    }
    if cfg.qk_norm:
        p["q_scale"] = ParamSpec((hd,), (None,), "zeros")
        p["k_scale"] = ParamSpec((hd,), (None,), "zeros")
    if cfg.post_norms:
        p["post_norm"] = ParamSpec((d,), ("d_model",), "zeros")
    return p


def _attend(cfg: ModelConfig, q, k, v, q_pos, k_pos, window: int = 0):
    """Dense attention at explicit positions (the decode path): q [B,S,H,hd],
    k/v [B,T,K,hd], q_pos [B,S], k_pos [B,T] (-1: an empty cache slot)."""
    b, s, h, hd = q.shape
    t, kh = k.shape[1], k.shape[2]
    rep = h // kh
    qf = q.reshape(b, s, kh, rep, hd).float()
    scores = torch.einsum("bskrd,btkd->bkrst", qf, k.float()) / (hd ** 0.5)
    scores = softcap(scores, cfg.attn_softcap).reshape(b, h, s, t)
    if cfg.causal:
        mask = k_pos[:, None, :] <= q_pos[:, :, None]
    else:
        mask = torch.ones((b, s, t), dtype=torch.bool, device=q.device)
    if window > 0:
        mask = mask & ((q_pos[:, :, None] - k_pos[:, None, :]) < window)
    mask = mask & (k_pos >= 0)[:, None, :]
    scores = scores.masked_fill(~mask[:, None], NEG)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkrst,btkd->bskrd", probs.reshape(b, kh, rep, s, t),
                       v)
    return out.reshape(b, s, h, v.shape[-1])


class FlashAttend(torch.autograd.Function):
    """Attention of a whole sequence whose forward is the flash kernel (its
    plain version for CPU tensors) and whose gradient is the autograd of
    the dense formula :func:`_attend` at positions 0..S-1, re-run on the
    saved q, k and v (the reference has no backward kernel; ``jax.grad``
    differentiates ``_attend``).  The recompute takes the kv heads in
    groups (``ATTN_BWD_SCORE_BYTES``); heads are independent, so the
    gradient is the whole formula's.  Under ``inference_mode`` nothing is
    saved or recorded."""

    @staticmethod
    def forward(ctx, q, k, v, cfg: ModelConfig, window: int):
        ctx.cfg, ctx.window = cfg, window
        ctx.save_for_backward(q, k, v)
        out = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), causal=cfg.causal,
                              window=window, softcap=cfg.attn_softcap)
        return out.transpose(1, 2)

    @staticmethod
    def backward(ctx, dout):
        q, k, v = ctx.saved_tensors
        b, s, h, _ = q.shape
        kh = k.shape[2]
        rep = h // kh
        group = max(1, min(kh, ATTN_BWD_SCORE_BYTES // (b * rep * s * s * 4)))
        pos = torch.arange(s, dtype=torch.int32, device=q.device).expand(b, s)
        grads = []
        with torch.profiler.record_function(ATTN_BWD_RANGE), \
                torch.enable_grad():
            for j in range(0, kh, group):
                heads = slice(j * rep, (j + group) * rep)
                qkv = [t.detach().requires_grad_() for t in (
                    q[:, :, heads], k[:, :, j:j + group], v[:, :, j:j + group])]
                out = _attend(ctx.cfg, *qkv, pos, pos, ctx.window)
                grads.append(torch.autograd.grad(out, qkv, dout[:, :, heads]))
        dq, dk, dv = (torch.cat(g, dim=2) for g in zip(*grads))
        return dq, dk, dv, None, None


def attend(cfg: ModelConfig, q, k, v, window: int = 0):
    """Attention of a whole sequence, queries and keys at 0..S-1:
    q [B,S,H,hd], k/v [B,S,K,hd] -> [B,S,H,hd], through the flash kernel
    (its plain version for CPU tensors) whatever ``cfg.attn_impl`` says,
    differentiable by :class:`FlashAttend`."""
    if q.shape[1] != k.shape[1]:
        raise ValueError(f"attend takes queries and keys of one sequence, "
                         f"got {q.shape[1]} and {k.shape[1]} positions")
    return FlashAttend.apply(q, k, v, cfg, window)


def prefill_positions(pos: Optional[torch.Tensor], b: int, s: int,
                      device) -> torch.Tensor:
    """The positions of a cache-less pass, [B, S] int32 = 0..S-1.  The flash
    kernel places queries and keys there; explicit ``pos`` must say the
    same or the call is refused."""
    ar = torch.arange(s, dtype=torch.int32, device=device).expand(b, s)
    if pos is not None and (tuple(pos.shape) != (b, s) or not torch.equal(
            pos.to(device=device, dtype=torch.int32), ar)):
        raise ValueError("without a cache, attention runs the flash kernel, "
                         "whose queries and keys sit at positions 0..S-1; "
                         "pass pos=None (other positions are not supported)")
    return ar


def apply_attention(cfg: ModelConfig, p, x, pos=None, cache=None, *,
                    window: int = 0):
    """GQA attention on ``x`` [B, S, d]; ``window > 0`` = sliding window.

    Without a cache ``pos`` must be None (or 0..S-1).  With one, ``x`` is
    one token, ``pos`` [B, 1] its position, and ``cache`` ({"k", "v"}
    [B, T, K, hd]) gets its keys and values in place: slot ``pos`` (clamped
    to T - 1, as the reference's dynamic_update_slice) or, for a local
    layer, slot ``pos mod T`` of a rotating buffer of T = min(window,
    max_len) slots.  Returns (x + attention, cache).

    A rank's shards (``p.part``, ``models.shard``) hold its q heads and
    either its kv heads or all of them, of which it uses those its q heads
    read (the cache holds only those); the output projection's partial
    sum is reduced over the part's mesh axes (``mesh.psum``).
    """
    b, s, d = x.shape
    h, kh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    wk, wv = p.wk, p.wv
    xn = rms_norm(x, p.norm, cfg.norm_eps)
    q_scale, k_scale = (getattr(p, "q_scale", None),
                        getattr(p, "k_scale", None))
    if p.part is not None:
        h = p.part.q.stop - p.part.q.start
        kh = p.part.kv.stop - p.part.kv.start
        if p.part.reduce:
            # what every rank holds alike enters its heads' work
            mesh = part_mesh(p.part)
            xn = split_in(mesh, xn, p.part.reduce)
            if cfg.qk_norm:
                q_scale, k_scale = (split_in(mesh, t, p.part.reduce)
                                    for t in (q_scale, k_scale))
            if wk.shape[1] == cfg.n_kv_heads:
                wk, wv = (split_in(mesh, t, p.part.reduce) for t in (wk, wv))
        if wk.shape[1] == cfg.n_kv_heads:     # replicated: the heads read
            wk, wv = wk[:, p.part.kv], wv[:, p.part.kv]
    q = (xn @ p.wq.to(xn.dtype).reshape(d, h * hd)).view(b, s, h, hd)
    k = (xn @ wk.to(xn.dtype).reshape(d, kh * hd)).view(b, s, kh, hd)
    v = (xn @ wv.to(xn.dtype).reshape(d, kh * hd)).view(b, s, kh, hd)
    if cfg.qk_norm:
        q = rms_norm(q, q_scale, cfg.norm_eps)
        k = rms_norm(k, k_scale, cfg.norm_eps)
    if cache is None:
        pos = prefill_positions(pos, b, s, x.device)
    sin, cos = rope_table(pos, hd, cfg.rope_theta)
    q = apply_rope(q, sin, cos)
    k = apply_rope(k, sin, cos)

    if cache is None:
        out = attend(cfg, q, k, v, window)
    else:
        if s != 1:
            raise ValueError(f"a cached step takes one token, got {s}")
        ck, cv = cache["k"], cache["v"]
        cpos = pos.reshape(-1)[0]
        tmax = ck.shape[1]
        slot = torch.remainder(cpos, tmax) if window > 0 \
            else cpos.clamp(max=tmax - 1)
        slot = slot.reshape(1).long()
        ck.index_copy_(1, slot, k.to(ck.dtype))
        cv.index_copy_(1, slot, v.to(cv.dtype))
        idx = torch.arange(tmax, device=x.device)
        if window > 0:    # rotating window buffer: slot idx holds position
            age = torch.remainder(cpos - idx, tmax)   # cpos - age, if written
            k_pos = torch.where(age <= cpos, cpos - age, -1)
        else:
            k_pos = torch.where(idx <= cpos, idx, -1)
        out = _attend(cfg, q, ck.to(q.dtype), cv.to(q.dtype),
                      cpos.reshape(1, 1).expand(b, 1),
                      k_pos[None].expand(b, tmax), window)
    y = out.reshape(b, s, h * hd) @ p.wo.to(out.dtype).reshape(h * hd, d)
    if p.part is not None and p.part.reduce:
        y = reduce_out(part_mesh(p.part), y, p.part.reduce)
    if cfg.post_norms:
        y = rms_norm(y, p.post_norm, cfg.norm_eps)
    return x + y, cache


def init_attn_cache(cfg: ModelConfig, batch: int, max_len: int,
                    window: int = 0, *, device, dtype,
                    kv_heads: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """Zero keys and values [batch, T, kv_heads, hd] (T = min(window,
    max_len) for a local layer); a rank passes its rows and the number of
    kv heads it reads."""
    t = min(window, max_len) if window > 0 else max_len
    shape = (batch, t, kv_heads or cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


# ----------------------------- MLA (DeepSeek-V3) ---------------------------

def plan_mla(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    m = cfg.mla
    d, h = cfg.d_model, cfg.n_heads
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
    return {
        "norm": ParamSpec((d,), ("d_model",), "zeros"),
        "wq_a": ParamSpec((d, m.q_lora_rank), ("d_model", None)),
        "q_norm": ParamSpec((m.q_lora_rank,), (None,), "zeros"),
        "wq_b": ParamSpec((m.q_lora_rank, h, qk), (None, "heads", None)),
        "wkv_a": ParamSpec((d, m.kv_lora_rank + m.qk_rope_head_dim),
                           ("d_model", None)),
        "kv_norm": ParamSpec((m.kv_lora_rank,), (None,), "zeros"),
        "wk_b": ParamSpec((m.kv_lora_rank, h, m.qk_nope_head_dim),
                          (None, "heads", None)),
        "wv_b": ParamSpec((m.kv_lora_rank, h, m.v_head_dim),
                          (None, "heads", None)),
        "wo": ParamSpec((h, m.v_head_dim, d), ("heads", None, "d_model")),
    }


def _heads(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a [B, S, R] times w [R, H, k] -> [B, S, H, k] (one product)."""
    r, h, k = w.shape
    return (a @ w.to(a.dtype).reshape(r, h * k)).view(*a.shape[:2], h, k)


def apply_mla(cfg: ModelConfig, p, x, pos=None, cache=None):
    """MLA on ``x`` [B, S, d]: low-rank q (``wq_a``, norm, ``wq_b``) of
    ``nope + rope`` columns a head, a shared latent and rope key
    (``wkv_a``), rotary embeddings on the rope columns.  Without a cache
    (``pos`` None or 0..S-1) the latent expands to keys and values and the
    flash kernel attends at q.k head dim nope + rope and v head dim
    ``v_head_dim``.  With one (``{"latent" [B, T, R], "k_rope" [B, T,
    rope]}``), ``x`` is one token at ``pos`` [B, 1]: its latent and rope
    key go into slot ``pos`` (clamped to T - 1, as the reference's
    dynamic_update_slice) in place, and attention is absorbed: q_nope goes
    into latent space through ``wk_b``, the scores over the cache are
    float32, scaled by 1/sqrt(nope + rope), and the context leaves it
    through ``wv_b``.  Returns (x + attention, cache).

    A rank's shards (``p.part``) hold its heads of ``wq_b``, ``wk_b``,
    ``wv_b`` and ``wo`` and the whole latent path: it computes the whole
    latent (its cache holds it whole) and attends with its own heads; the
    output projection's partial sum is reduced over the part's axes."""
    m = cfg.mla
    b, s, d = x.shape
    h = p.wq_b.shape[1]
    nope, rope_d, vd = m.qk_nope_head_dim, m.qk_rope_head_dim, m.v_head_dim
    r = m.kv_lora_rank
    xn = rms_norm(x, p.norm, cfg.norm_eps)
    cq = rms_norm(xn @ p.wq_a.to(xn.dtype), p.q_norm, cfg.norm_eps)
    ckv = xn @ p.wkv_a.to(xn.dtype)
    latent = rms_norm(ckv[..., :r], p.kv_norm, cfg.norm_eps)
    k_rope = ckv[..., r:][:, :, None, :]                 # [B, S, 1, rope]
    if p.part is not None and p.part.reduce:
        # the replicated latent enters the rank's heads
        mesh = part_mesh(p.part)
        cq, latent, k_rope = (split_in(mesh, t, p.part.reduce)
                              for t in (cq, latent, k_rope))
    q = _heads(cq, p.wq_b)
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    if cache is None:
        pos = prefill_positions(pos, b, s, x.device)
    sin, cos = rope_table(pos, rope_d, cfg.rope_theta)
    q_rope = apply_rope(q_rope, sin, cos)
    k_rope = apply_rope(k_rope, sin, cos)

    if cache is None:
        k_nope = _heads(latent, p.wk_b)
        v = _heads(latent, p.wv_b)
        k = torch.cat([k_nope, k_rope.expand(b, s, h, rope_d)], dim=-1)
        out = attend(cfg, torch.cat([q_nope, q_rope], dim=-1), k, v)
    else:
        if s != 1:
            raise ValueError(f"a cached step takes one token, got {s}")
        clat, crope = cache["latent"], cache["k_rope"]
        cpos = pos.reshape(-1)[0]
        tmax = clat.shape[1]
        slot = cpos.clamp(max=tmax - 1).reshape(1).long()
        clat.index_copy_(1, slot, latent.to(clat.dtype))
        crope.index_copy_(1, slot, k_rope[:, :, 0, :].to(crope.dtype))
        q_lat = torch.einsum("bshk,rhk->bshr", q_nope,
                             p.wk_b.to(q_nope.dtype))
        lat32 = clat.float()
        scores = (torch.einsum("bshr,btr->bhst", q_lat.float(), lat32)
                  + torch.einsum("bshk,btk->bhst", q_rope.float(),
                                 crope.float())) / ((nope + rope_d) ** 0.5)
        visible = torch.arange(tmax, device=x.device) <= cpos
        probs = torch.softmax(scores.masked_fill(~visible, NEG), dim=-1)
        ctx = torch.einsum("bhst,btr->bshr", probs, lat32).to(x.dtype)
        out = torch.einsum("bshr,rhv->bshv", ctx, p.wv_b.to(x.dtype))
    y = out.reshape(b, s, h * vd) @ p.wo.to(out.dtype).reshape(h * vd, d)
    if p.part is not None and p.part.reduce:
        y = reduce_out(part_mesh(p.part), y, p.part.reduce)
    return x + y, cache


def init_mla_cache(cfg: ModelConfig, batch: int, max_len: int, *, device,
                   dtype) -> Dict[str, torch.Tensor]:
    m = cfg.mla
    return {"latent": torch.zeros((batch, max_len, m.kv_lora_rank),
                                  dtype=dtype, device=device),
            "k_rope": torch.zeros((batch, max_len, m.qk_rope_head_dim),
                                  dtype=dtype, device=device)}


# ---------------------------------------------------------------------------
# FFN: dense (swiglu / geglu / gelu) and MoE
# ---------------------------------------------------------------------------

def plan_ffn(cfg: ModelConfig, d_ff: Optional[int] = None,
             kind: str = "swiglu") -> Dict[str, ParamSpec]:
    d = cfg.d_model
    ff = d_ff or cfg.d_ff
    p = {"norm": ParamSpec((d,), ("d_model",), "zeros"),
         "w_in": ParamSpec((d, ff if kind == "gelu" else 2 * ff),
                           ("d_model", "d_ff")),
         "w_out": ParamSpec((ff, d), ("d_ff", "d_model"))}
    if cfg.post_norms:
        p["post_norm"] = ParamSpec((d,), ("d_model",), "zeros")
    return p


def apply_ffn(cfg: ModelConfig, p, x, kind: str = "swiglu"):
    """The dense FFN; a rank's shards (``p.part``) hold its ``d_ff``
    columns (``w_in`` as ``[gate_r | up_r]``) and reduce the partial sum
    over the part's mesh axes."""
    xn = rms_norm(x, p.norm, cfg.norm_eps)
    split = p.part is not None and p.part.reduce
    if split:
        xn = split_in(part_mesh(p.part), xn, p.part.reduce)
    h = xn @ p.w_in.to(xn.dtype)
    h = F.gelu(h, approximate="tanh") if kind == "gelu" else swiglu(h, kind)
    y = h @ p.w_out.to(h.dtype)
    if split:
        y = reduce_out(part_mesh(p.part), y, p.part.reduce)
    if cfg.post_norms:
        y = rms_norm(y, p.post_norm, cfg.norm_eps)
    return x + y


def plan_moe(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    mo = cfg.moe
    d = cfg.d_model
    p = {"norm": ParamSpec((d,), ("d_model",), "zeros"),
         "router": ParamSpec((d, mo.num_experts), ("d_model", None)),
         "w_in": ParamSpec((mo.num_experts, d, 2 * mo.d_ff_expert),
                           ("expert", "d_model", None)),
         "w_out": ParamSpec((mo.num_experts, mo.d_ff_expert, d),
                            ("expert", None, "d_model"))}
    if mo.num_shared:
        ffs = mo.d_ff_shared or mo.d_ff_expert
        p["shared_in"] = ParamSpec((d, 2 * ffs * mo.num_shared),
                                   ("d_model", "d_ff"))
        p["shared_out"] = ParamSpec((ffs * mo.num_shared, d),
                                    ("d_ff", "d_model"))
    return p


def moe_route(cfg: ModelConfig, router: torch.Tensor, tokens: torch.Tensor):
    """The router on ``tokens`` [N, d]: softmax of the float32 logits, the
    top ``top_k`` experts a token (equal probabilities to the lower expert
    id, as ``jax.lax.top_k``: a stable sort), the gates renormalised to sum
    to 1 (over at least 1e-9).  Returns (gate [N, K] float32, eid [N, K]
    int64)."""
    probs = torch.softmax(tokens.float() @ router.float(), dim=-1)
    top, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    k = cfg.moe.top_k
    gate, eid = top[:, :k], order[:, :k]
    return gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9), eid


def moe_capacity(cfg: ModelConfig, n: int) -> int:
    """Slots an expert holds for ``n`` tokens: n top_k capacity_factor /
    num_experts, at least 1, and at least min(n, 32), the reference's
    floor that keeps small (decode) batches from dropping a slot."""
    mo = cfg.moe
    cap = int(max(1, (n * mo.top_k * mo.capacity_factor) // mo.num_experts))
    return max(cap, min(n, 32))


def moe_slots(eid: torch.Tensor, num_experts: int) -> torch.Tensor:
    """Each (token, k) slot's position in its expert's buffer: how many
    slots before it, in token-major order, chose the same expert (a cumsum
    over the one-hot choices).  eid [N, K] -> [N, K] int64."""
    n, k = eid.shape
    flat = eid.reshape(-1, 1)
    onehot = torch.zeros((n * k, num_experts), dtype=torch.int32,
                         device=eid.device).scatter_(1, flat, 1)
    pos = torch.cumsum(onehot, dim=0, dtype=torch.int32) - 1
    return pos.gather(1, flat).view(n, k).long()


def apply_moe(cfg: ModelConfig, p, x, rows=()):
    """The MoE FFN on ``x`` [B, S, d]: on a rank's shards (``p.part``)
    :func:`apply_moe_part`, the batch split over ``rows``; else
    :func:`apply_moe_a2a` when ``cfg.moe_impl`` is ``"a2a"`` and the
    ambient mesh has every ``ep_axes`` axis, else :func:`apply_moe_gather`
    (the reference's choice).  Returns x + y."""
    if p.part is not None:
        return apply_moe_part(cfg, p, x, rows)
    if cfg.moe_impl == "a2a":
        from repro_torch.models.meshctx import get_mesh
        mesh = get_mesh()
        if mesh is not None and all(a in mesh.shape
                                    for a in cfg.moe.ep_axes):
            return apply_moe_a2a(cfg, p, x, mesh)
    if p.w_in.shape[0] != cfg.moe.num_experts:
        raise ValueError(
            f"the layer holds {p.w_in.shape[0]} of {cfg.moe.num_experts} "
            f"experts (an expert-parallel slice): it runs only through "
            f"moe_impl='a2a' under a mesh that has {cfg.moe.ep_axes}")
    return apply_moe_gather(cfg, p, x)


def apply_moe_gather(cfg: ModelConfig, p, x):
    """The MoE FFN on ``x`` [B, S, d], the reference's ``gather``
    implementation (see the module note).  Returns x + y."""
    mo = cfg.moe
    b, s, d = x.shape
    xn = rms_norm(x, p.norm, cfg.norm_eps)
    tokens = xn.reshape(b * s, d)
    y = gather_experts(cfg, p, tokens)
    if mo.num_shared:
        hs = swiglu(tokens @ p.shared_in.to(tokens.dtype))
        y = y + hs @ p.shared_out.to(hs.dtype)
    return x + y.view(b, s, d)


def gather_experts(cfg: ModelConfig, p, tokens, lo: int = 0, on=None,
                   router=None):
    """The routed experts' output [N, d] on ``tokens`` [N, d] through the
    ``gather`` dispatch: every token routed (:func:`moe_route`), the
    capacity (:func:`moe_capacity`) and slot positions (:func:`moe_slots`)
    over all N, the kept slots of experts ``lo`` to ``lo + n`` (``p.w_in``
    holds those n) scattered into an [n + 1, cap, d] buffer, both products
    batched by expert, and each slot's output gathered back and weighed by
    its gate.  ``on`` [N] bool: only those tokens' slots are dispatched
    (the others add 0).  ``router``: in place of ``p.router``."""
    mo = cfg.moe
    n_tok, d = tokens.shape
    ne, kk = p.w_in.shape[0], mo.top_k
    gate, eid = moe_route(cfg, p.router if router is None else router,
                          tokens)
    cap = moe_capacity(cfg, n_tok)
    pos_k = moe_slots(eid, mo.num_experts)
    keep = (pos_k < cap) & (eid >= lo) & (eid < lo + ne)
    if on is not None:
        keep = keep & on[:, None]
    # dispatch: the other slots go to row n, which no expert reads
    flat_e = torch.where(keep, eid - lo, ne).reshape(-1)
    flat_pos = torch.where(keep, pos_k, 0).reshape(-1)
    disp = tokens.new_zeros((ne + 1, cap, d))
    disp[flat_e, flat_pos] = tokens.repeat_interleave(kk, dim=0)
    hmid = swiglu(torch.bmm(disp[:ne], p.w_in.to(disp.dtype)))
    eout = torch.bmm(hmid, p.w_out.to(hmid.dtype))
    # combine: the other slots read expert lo's slot 0 and weigh it by 0
    gath = eout[flat_e % ne, flat_pos]
    gath = gath * (gate.reshape(-1, 1) * keep.reshape(-1, 1)).to(gath.dtype)
    return gath.view(n_tok, kk, d).sum(dim=1)


def a2a_slots(cfg: ModelConfig, eid: torch.Tensor, p_ep: int):
    """The a2a path's bucketing of the (token, k) slots of ``eid`` [n, K]
    by destination rank ``eid // (E / p_ep)``, as the reference's
    ``local_moe``: ``order`` (a stable sort of the destinations), the
    sorted destinations, each sorted slot's rank within its destination
    (position minus ``searchsorted(..., "left")``), ``ok`` (rank below the
    per-destination capacity) and the capacity, ``int(n K cf) // p_ep +
    1`` floored at ``min(n K, 32)``."""
    mo = cfg.moe
    n, kk = eid.shape
    cap = int(n * kk * mo.capacity_factor) // p_ep + 1
    cap = max(cap, min(n * kk, 32))
    dest = (eid // (mo.num_experts // p_ep)).reshape(-1)
    order = torch.sort(dest, stable=True).indices
    sdest = dest[order]
    rank = torch.arange(n * kk, device=eid.device) - torch.searchsorted(
        sdest, sdest, side="left")
    return order, sdest, rank, rank < cap, cap


def _block_of(n: int, parts: int, i: int, what: str) -> slice:
    if n % parts:
        raise ValueError(f"the a2a path splits {what} {n} over {parts} "
                         f"ranks: it must divide")
    return slice(i * (n // parts), (i + 1) * (n // parts))


def a2a_block(cfg: ModelConfig, mesh, b: int, s: int, rank=None):
    """The (batch, sequence) slices of a [b, s, ...] activation that a rank
    (this one by default) works on in the a2a path: the reference's
    ``in_specs``, batch split over the ``cfg.sharding.batch`` axes the
    mesh has, sequence over ``"model"``."""
    batch_axes = tuple(a for a in cfg.sharding.batch if a in mesh.shape)
    nb = 1
    for a in batch_axes:
        nb *= mesh.shape[a]
    seq = ("model",) if "model" in mesh.shape else ()
    ns = mesh.shape["model"] if seq else 1
    return (_block_of(b, nb, mesh.index(batch_axes, rank), "the batch"),
            _block_of(s, ns, mesh.index(seq, rank), "the sequence"))


def a2a_fits(cfg: ModelConfig, mesh, b: int, s: int) -> bool:
    """Whether the a2a path's blocks (:func:`a2a_block`) split a [b, s, ...]
    activation over ``mesh``: the batch over the batch's axes the mesh
    has, the sequence over ``"model"``."""
    nb = 1
    for a in cfg.sharding.batch:
        nb *= mesh.shape.get(a, 1)
    return b % nb == 0 and s % mesh.shape.get("model", 1) == 0


def a2a_experts(cfg: ModelConfig, p, xn, mesh, router=None):
    """The routed experts' output y [B, S, d] of the normed ``xn`` [B, S,
    d], the whole of it on every rank, through the expert-parallel
    exchange over ``mesh`` (:func:`apply_moe_a2a`, which adds the shared
    expert); ``router`` in place of ``p.router``.  In training the
    exchanges' adjoints are the reverse exchanges, and the gradient of y
    comes whole to every rank (:func:`apply_moe_part`)."""
    mo = cfg.moe
    b, s, d = xn.shape
    ep_axes = tuple(a for a in mo.ep_axes if a in mesh.shape)
    p_ep = 1
    for a in ep_axes:
        p_ep *= mesh.shape[a]
    e_loc = mo.num_experts // p_ep
    if p.w_in.shape[0] != e_loc:
        raise ValueError(f"{p_ep} EP ranks hold {e_loc} experts each; the "
                         f"layer holds {p.w_in.shape[0]}")
    bsl, ssl = a2a_block(cfg, mesh, b, s)
    toks = xn[bsl, ssl].reshape(-1, d)
    n, kk = toks.shape[0], mo.top_k
    gate, eid = moe_route(cfg, p.router if router is None else router, toks)
    order, sdest, rank, ok, cap = a2a_slots(cfg, eid, p_ep)
    row = torch.where(ok, sdest, 0)
    col = torch.where(ok, rank, 0)
    send = toks.new_zeros((p_ep, cap, d))
    send_eid = torch.full((p_ep, cap), -1, dtype=torch.int32,
                          device=toks.device)
    send[row[ok], col[ok]] = toks[order[ok] // kk]
    send_eid[row[ok], col[ok]] = eid.reshape(-1)[order[ok]].to(torch.int32)
    if not bool(ok.all()):
        send[0, 0] = 0
        send_eid[0, 0] = -1

    rt = exchange(mesh, send, ep_axes)                   # [p_ep * cap, d]
    local_e = mesh.all_to_all(send_eid, ep_axes) - mesh.index(ep_axes) * e_loc
    out = torch.zeros_like(rt)
    for le in range(e_loc):
        sel = (local_e == le)[:, None]
        h = swiglu(torch.where(sel, rt, 0) @ p.w_in[le].to(rt.dtype))
        out = out + torch.where(sel, h @ p.w_out[le].to(h.dtype), 0)
    back = exchange(mesh, out.view(p_ep, cap, d), ep_axes)

    last = p_ep * cap - 1
    slot_of = torch.full((n * kk,), last, dtype=torch.int64,
                         device=toks.device)
    slot_of[order] = torch.where(ok, sdest * cap + rank, last)
    ok_slot = torch.zeros(n * kk, dtype=torch.bool, device=toks.device)
    ok_slot[order] = ok
    gathered = back[slot_of]
    w = (gate.reshape(-1) * ok_slot).to(gathered.dtype)
    y_loc = (gathered * w[:, None]).view(n, kk, d).sum(dim=1)
    y = torch.empty_like(xn)
    blocks = gather_alike(mesh, y_loc.view(xn[bsl, ssl].shape))
    for r in range(mesh.world):
        y[a2a_block(cfg, mesh, b, s, r)] = blocks[r]
    return y


def apply_moe_a2a(cfg: ModelConfig, p, x, mesh):
    """The expert-parallel MoE on ``x`` [B, S, d] over ``mesh`` (a
    ``RankMesh``), op for op the reference's ``apply_moe_a2a``.

    Every rank takes the whole ``x`` and returns the whole ``x + y``, as
    the reference's function does at its global view.  Inside
    (:func:`a2a_experts`), a rank works on the token block the reference's
    ``in_specs`` give it (batch split over the ``cfg.sharding.batch`` axes
    the mesh has, sequence over ``"model"``): the float32 router and top-k
    (:func:`moe_route`), gates renormalised, the slots bucketed by
    destination rank (:func:`a2a_slots`) into a ``[P_ep, cap, d]`` send
    buffer with their expert ids (-1 in empty slots), two exchanges out
    over the EP axes and one back (``RankMesh.all_to_all``, a group for
    each coordinate off them), each of the rank's ``E / P_ep`` experts'
    SwiGLU products on the capacity buffer masked to its slots, the
    combine by slot and gate, and the blocks of y brought together with
    ``all_gather``; then the shared expert on every token.  ``p.w_in`` /
    ``p.w_out`` hold only this rank's experts (``params_from_numpy(...,
    ep=...)``).

    As in the reference's scatter (XLA applies a scatter's updates in
    order), the slots that do not fit write an empty slot to destination
    0's slot 0 after its token did: with any slot dropped, that token's
    slot goes empty too.
    """
    mo = cfg.moe
    b, s, d = x.shape
    xn = rms_norm(x, p.norm, cfg.norm_eps)
    y = a2a_experts(cfg, p, xn, mesh)
    if mo.num_shared:
        flat = xn.reshape(b * s, d)
        hs = swiglu(flat @ p.shared_in.to(flat.dtype))
        y = y + (hs @ p.shared_out.to(hs.dtype)).view(b, s, d)
    return x + y


def apply_moe_part(cfg: ModelConfig, p, x, rows=()):
    """The MoE on a rank's shards (``p.part``: its experts ``lo`` to ``lo +
    n`` of the split over ``part.experts``, the shared expert's ``d_ff``
    split over ``part.shared``) of ``x`` [b, S, d], the rank's rows of a
    batch split over the mesh axes ``rows``.  Returns x + y, y the whole
    layer's at those rows.

    The normed rows of every rank of ``rows`` are gathered first (the
    global batch, in its order), so that the routing, the capacity
    (:func:`moe_capacity`) and the slot positions (:func:`moe_slots`) are
    the reference's, over all its tokens.  Under ``moe_impl="a2a"``, where
    the gathered batch splits into the a2a path's blocks
    (:func:`a2a_fits`; a decode step's one token does not split over
    ``"model"``), the routed output comes whole to every rank from
    :func:`a2a_experts`, and the shared expert's partial on the rank's
    rows, reduced over its axes, is added to it.  Else (``gather``) each
    rank runs :func:`gather_experts` on the kept slots of its own experts;
    the shared expert's partial on its own rows is added, and one
    reduction runs over the axes of the rows, the experts and the shared
    expert, of which the rank keeps its rows.  So that this reduction
    counts each (row, expert) once, a rank dispatches a row's slots only
    where it owns the row along the batch's axes that do not split the
    experts, and adds anything only at coordinate 0 of an axis of the
    reduction that splits neither it nor the rows.

    In training (``models.collectives``): the gathered batch's gradient
    is summed over every axis that split the work on it and the rank
    keeps its block (the shared expert reads the rank's block of the
    gathered batch, so its gradient goes the same way); the reduced
    output's gradient is every block's, gathered over ``rows``; the
    router, which every rank holds alike and applies to its share of the
    slots, sums its gradient over the axes that split that share but not
    the rows (``models.shard`` sums it over the rows' axes after)."""
    part = p.part
    mesh = part_mesh(part)
    mo = cfg.moe
    b, s, d = x.shape
    rows = tuple(rows)
    own = mesh.index(rows) if rows else 0
    xn = rms_norm(x, p.norm, cfg.norm_eps)

    def shared(xb):
        flat = xb[own].reshape(b * s, d)
        hs = swiglu(flat @ p.shared_in.to(flat.dtype))
        return (hs @ p.shared_out.to(hs.dtype)).view(b, s, d)

    ep = tuple(a for a in mo.ep_axes if a in mesh.shape)
    n_rows = math.prod(mesh.shape[a] for a in rows)
    if cfg.moe_impl == "a2a" and len(ep) == len(mo.ep_axes) and \
            a2a_fits(cfg, mesh, n_rows * b, s):
        if part.experts != tuple(a for a in ep if mesh.shape[a] > 1) or \
                part.lo != mesh.index(ep) * part.n:
            raise ValueError(
                f"the a2a path exchanges over {mo.ep_axes}, but the rank "
                f"holds experts {part.lo} to {part.lo + part.n} split over "
                f"{part.experts} (ShardingRules.expert "
                f"{cfg.sharding.expert})")
        # every rank works on its block of the gathered batch
        split = tuple(a for a in mesh.shape if mesh.shape[a] > 1)
        xb = gather_rows(mesh, xn, rows, split, own)
        router = split_in(mesh, p.router,
                          tuple(a for a in split if a not in rows))
        y = a2a_experts(cfg, p, xb.flatten(0, 1), mesh, router)
        y = reduce_own_rows(mesh, y.view(n_rows, b, s, d), (), rows, own)
        if mo.num_shared:
            y = y + reduce_out(mesh, shared(xb), part.shared)
        return x + y

    coords = mesh.coords
    axes = tuple(a for a in mesh.shape
                 if a in rows + part.experts + part.shared)

    def adds(split) -> bool:
        return all(coords[a] == 0 for a in axes
                   if a not in rows and a not in split)

    from repro_torch.core.distributed import coords_of
    xb = gather_rows(mesh, xn, rows, axes, own)
    router = split_in(mesh, p.router,
                      tuple(a for a in part.experts if a not in rows))
    sizes = {a: mesh.shape[a] for a in rows}
    on = [all(c[a] == coords[a] for a in rows if a not in part.experts)
          and adds(part.experts)
          for c in (coords_of(sizes, j) for j in range(n_rows))]
    row_on = torch.tensor(on, device=x.device).repeat_interleave(b * s)
    y = gather_experts(cfg, p, xb.reshape(-1, d), part.lo, row_on, router)
    y = y.view(n_rows, b, s, d)
    if mo.num_shared and adds(part.shared):
        y = torch.cat([y[:own], (y[own] + shared(xb))[None], y[own + 1:]])
    return x + reduce_own_rows(mesh, y, axes, rows, own)


# ---------------------------------------------------------------------------
# RG-LRU recurrent block (RecurrentGemma / Griffin)
# ---------------------------------------------------------------------------

def plan_rglru(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d = cfg.d_model
    r = cfg.rglru.d_rnn
    cw = cfg.rglru.conv_width
    return {
        "norm": ParamSpec((d,), ("d_model",), "zeros"),
        "w_x": ParamSpec((d, r), ("d_model", "d_ff")),
        "w_gate": ParamSpec((d, r), ("d_model", "d_ff")),
        "conv_w": ParamSpec((cw, r), (None, "d_ff")),
        "conv_b": ParamSpec((r,), ("d_ff",), "zeros"),
        "w_a": ParamSpec((r, r), ("d_ff", None)),
        "w_i": ParamSpec((r, r), ("d_ff", None)),
        "lam": ParamSpec((r,), (None,), "ones"),
        "w_out": ParamSpec((r, d), ("d_ff", "d_model")),
    }


def causal_conv(u, w, b, state=None):
    """Depthwise causal conv: u [B, S, R], w [CW, R], b [R]; ``state``
    [B, CW-1, R] holds the inputs before u (zeros when None).  Returns
    (out [B, S, R], the last CW-1 inputs)."""
    cw = w.shape[0]
    if state is None:
        pad = u.new_zeros((u.shape[0], cw - 1) + tuple(u.shape[2:]))
    else:
        pad = state.to(u.dtype)
    full = torch.cat([pad, u], dim=1)
    s = u.shape[1]
    out = sum(full[:, i:i + s] * w[i] for i in range(cw))
    return out + b, full[:, full.shape[1] - (cw - 1):]


def linear_scan(a, b):
    """h_t = a_t h_{t-1} + b_t along axis 1 from h_{-1} = 0: a log-depth
    scan, ceil(log2 S) passes of (a, b) <- (a a_shift, b + a b_shift),
    each element combined with the one ``shift`` steps before it."""
    s, shift = a.shape[1], 1
    while shift < s:
        b = torch.cat([b[:, :shift],
                       b[:, shift:] + a[:, shift:] * b[:, :-shift]], dim=1)
        a = torch.cat([a[:, :shift], a[:, shift:] * a[:, :-shift]], dim=1)
        shift *= 2
    return b


def apply_rglru(cfg: ModelConfig, p, x, cache=None):
    """The RG-LRU block on ``x`` [B, S, d]: norm, a GELU gate, the causal
    conv, the gated linear recurrence in float32, the output projection.
    With ``cache`` ({"h" [B, R], "conv" [B, CW-1, R]}) ``x`` is one token
    and the cache takes the new state in place.  Returns (x + y,
    cache).

    A rank's shards (``p.part``) hold its ``d_ff`` columns ``lo`` to ``lo
    + n`` of ``w_x``, ``w_gate`` and the conv and those rows of ``w_a``,
    ``w_i`` and ``w_out``: both gates' pre-activations [B, S, 2R] are one
    float32 partial sum, reduced over the part's axes, of which the rank
    takes its columns; the recurrence and the cache run on those columns
    (``h`` [B, n], ``conv`` [B, CW-1, n]); the output projection's partial
    sum is reduced again."""
    c = 8.0
    part = p.part
    xn = rms_norm(x, p.norm, cfg.norm_eps)
    if part is not None and part.reduce:
        xn = split_in(part_mesh(part), xn, part.reduce)
    u = xn @ p.w_x.to(xn.dtype)
    g = F.gelu(xn @ p.w_gate.to(xn.dtype), approximate="tanh")
    u, new_conv = causal_conv(u, p.conv_w.to(u.dtype), p.conv_b.to(u.dtype),
                              cache["conv"] if cache is not None else None)
    uf = u.float()
    lam = p.lam
    if part is not None and part.reduce:
        # the reduced gates, like lam, every rank holds alike; each takes
        # its columns
        mesh = part_mesh(part)
        gates = split_in(mesh, reduce_out(mesh, torch.cat(
            [uf @ p.w_a.float(), uf @ p.w_i.float()], dim=-1), part.reduce),
            part.reduce)
        r_all = cfg.rglru.d_rnn
        cols = slice(part.lo, part.lo + part.n)
        r = torch.sigmoid(gates[..., :r_all][..., cols])
        i = torch.sigmoid(gates[..., r_all:][..., cols])
        lam = split_in(mesh, lam, part.reduce)[cols]
    else:
        r = torch.sigmoid(uf @ p.w_a.float())
        i = torch.sigmoid(uf @ p.w_i.float())
    log_a = -c * r * F.softplus(lam.float())
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-9))
    bterm = beta * (i * uf)
    if cache is None:
        h = linear_scan(a, bterm)
    else:
        if x.shape[1] != 1:
            raise ValueError(f"a cached step takes one token, got "
                             f"{x.shape[1]}")
        h = a[:, 0] * cache["h"].float() + bterm[:, 0]
        cache["h"].copy_(h)
        cache["conv"].copy_(new_conv)
        h = h[:, None]
    y = (h.to(x.dtype) * g) @ p.w_out.to(x.dtype)
    if part is not None and part.reduce:
        y = reduce_out(part_mesh(part), y, part.reduce)
    return x + y, cache


def init_rglru_cache(cfg: ModelConfig, batch: int, *, device, dtype,
                     width: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """Zero ``h`` [batch, R] and ``conv`` [batch, CW-1, R]; a rank passes
    the number of ``d_ff`` columns it holds as ``width``."""
    r, cw = width or cfg.rglru.d_rnn, cfg.rglru.conv_width
    return {"h": torch.zeros((batch, r), dtype=dtype, device=device),
            "conv": torch.zeros((batch, cw - 1, r), dtype=dtype,
                                device=device)}


# ---------------------------------------------------------------------------
# xLSTM: mLSTM (matrix memory) and sLSTM (scalar memory) blocks
# ---------------------------------------------------------------------------

def plan_mlstm(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d, h = cfg.d_model, cfg.n_heads
    m = 2 * d                       # projection factor 2
    return {
        "norm": ParamSpec((d,), ("d_model",), "zeros"),
        "w_up": ParamSpec((d, 2 * m), ("d_model", "d_ff")),
        "wq": ParamSpec((m, m), ("d_ff", None)),
        "wk": ParamSpec((m, m), ("d_ff", None)),
        "wv": ParamSpec((m, m), ("d_ff", None)),
        "w_if": ParamSpec((m, 2 * h), ("d_ff", None)),
        "gn": ParamSpec((m,), (None,), "zeros"),
        "w_down": ParamSpec((m, d), ("d_ff", "d_model")),
    }


def mlstm_step(C, n, m, q, k, v, i_t, f_t):
    """One token of the matrix memory, float32: C [B, H, dh, dh], n
    [B, H, dh], m [B, H] (the stabiliser); q/k/v [B, H, dh], i_t/f_t
    [B, H] (f_t a log-sigmoid).  Returns (C, n, m, h [B, H, dh])."""
    fm = f_t + m
    mnew = torch.maximum(fm, i_t)
    fp = torch.exp(fm - mnew)[..., None]
    ip = torch.exp(i_t - mnew)[..., None]
    C = fp[..., None] * C + ip[..., None] * (v[..., :, None] * k[..., None, :])
    n = fp * n + ip * k
    denom = torch.clamp((n * q).sum(-1).abs(), min=1.0)[..., None]
    h = (C * q[..., None, :]).sum(-1) / denom
    return C, n, mnew, h


def mlstm_loop(C, n, m, q, k, v, i_t, f_t):
    """:func:`mlstm_step` over the tokens of q/k/v [B, T, H, dh] and
    i_t/f_t [B, T, H] from the state (C, n, m).  Returns (C, n, m, h [B,
    T, H, dh])."""
    hs = []
    # one token at a time through unbind (not q[:, t]): its backward
    # stacks the tokens' gradients once, where indexing's scatters each
    # into a zero tensor of the whole sequence (O(S^2) bytes)
    for step in zip(*(t.unbind(1) for t in (q, k, v, i_t, f_t))):
        C, n, m, ht = mlstm_step(C, n, m, *step)
        hs.append(ht)
    return C, n, m, torch.stack(hs, dim=1)


def apply_mlstm(cfg: ModelConfig, p, x, cache=None):
    """The mLSTM block on ``x`` [B, S, d]: up-projection to 2 x 2d, q/k/v
    of head dim 2d / H, exponential input and sigmoid forget gates, the
    matrix memory stepped token by token in float32, a norm over the
    whole width 2d, the SiLU gate, the down-projection.  With ``cache``
    ({"C", "n", "m"}, float32) ``x`` is one token and the cache takes the
    new state in place.

    Without a cache and with grad on (training), a sequence longer than
    ``MLSTM_CHUNK`` goes through :func:`mlstm_loop` a chunk of that many
    tokens at a time, each chunk under ``torch.utils.checkpoint`` with the
    state carried across: the backward keeps the states at the chunks'
    starts and recomputes one chunk's tokens at a time.  The values and
    gradients are the whole loop's.

    A rank's shards (``p.part``) hold ``w_up`` as ``[z_r | gate_r]`` (its
    ``d_ff`` columns ``lo`` to ``lo + n`` of each half) and those rows of
    ``wq``, ``wk``, ``wv``, ``w_if`` and ``w_down``: the partials of q, k,
    v (in the compute dtype) and of the gates (float32) are one float32
    reduction over the part's axes; the cell, its state and the norm run
    whole on every rank, and the rank's columns of the normed output go
    through its gate and ``w_down``, whose partial sum is reduced
    again."""
    b, s, d = x.shape
    h_ = cfg.n_heads
    m = 2 * d
    dh = m // h_
    part = p.part if p.part is not None and p.part.reduce else None
    xn = rms_norm(x, p.norm, cfg.norm_eps)
    if part is not None:
        mesh = part_mesh(part)
        xn = split_in(mesh, xn, part.reduce)
    z, gate = (xn @ p.w_up.to(xn.dtype)).chunk(2, dim=-1)
    # the reference divides in the compute dtype by sqrt(dh) rounded to it
    k_scale = float(torch.tensor(dh ** 0.5, dtype=torch.float64).to(z.dtype))
    q, k, v = (z @ w.to(z.dtype) for w in (p.wq, p.wk, p.wv))
    gf = z.float() @ p.w_if.float()
    if part is not None:
        qkvg = reduce_out(mesh, torch.cat(
            [q.float(), k.float(), v.float(), gf], dim=-1), part.reduce)
        q, k, v = (t.to(z.dtype) for t in qkvg[..., :3 * m].split(m, dim=-1))
        gf = qkvg[..., 3 * m:]
    q = q.view(b, s, h_, dh).float()
    k = (k.view(b, s, h_, dh) / k_scale).float()
    v = v.view(b, s, h_, dh).float()
    i_t = gf[..., :h_]
    f_t = F.logsigmoid(gf[..., h_:])
    if cache is None:
        C = x.new_zeros((b, h_, dh, dh), dtype=torch.float32)
        n = x.new_zeros((b, h_, dh), dtype=torch.float32)
        mstab = x.new_zeros((b, h_), dtype=torch.float32)
        seq = (q, k, v, i_t, f_t)
        if torch.is_grad_enabled() and s > MLSTM_CHUNK:
            hs = []
            for chunk in zip(*(t.split(MLSTM_CHUNK, dim=1) for t in seq)):
                C, n, mstab, ht = checkpoint(mlstm_loop, C, n, mstab, *chunk,
                                             use_reentrant=False)
                hs.append(ht)
            hs = torch.cat(hs, dim=1)                   # [B, S, H, dh]
        else:
            C, n, mstab, hs = mlstm_loop(C, n, mstab, *seq)
    else:
        if s != 1:
            raise ValueError(f"a cached step takes one token, got {s}")
        C, n, mstab, ht = mlstm_step(cache["C"].float(), cache["n"].float(),
                                     cache["m"].float(), q[:, 0], k[:, 0],
                                     v[:, 0], i_t[:, 0], f_t[:, 0])
        for name, t in (("C", C), ("n", n), ("m", mstab)):
            cache[name].copy_(t)
        hs = ht[:, None]
    hs = rms_norm(hs.reshape(b, s, m).to(x.dtype), p.gn, cfg.norm_eps)
    if part is not None:
        # the whole cell's normed output enters the rank's columns
        hs = split_in(mesh, hs, part.reduce)[..., part.lo:part.lo + part.n]
    y = (hs * F.silu(gate)) @ p.w_down.to(x.dtype)
    if part is not None:
        y = reduce_out(mesh, y, part.reduce)
    return x + y, cache


def init_mlstm_cache(cfg: ModelConfig, batch: int, *, device
                     ) -> Dict[str, torch.Tensor]:
    h_ = cfg.n_heads
    dh = 2 * cfg.d_model // h_
    f32 = dict(dtype=torch.float32, device=device)
    return {"C": torch.zeros((batch, h_, dh, dh), **f32),
            "n": torch.zeros((batch, h_, dh), **f32),
            "m": torch.zeros((batch, h_), **f32)}


def plan_slstm(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d, h = cfg.d_model, cfg.n_heads
    dh = d // h
    ff = max(int(4 * d / 3) // 2 * 2, 8)
    return {
        "norm": ParamSpec((d,), ("d_model",), "zeros"),
        "w_gates": ParamSpec((d, 4 * d), ("d_model", None)),
        "r_gates": ParamSpec((4, h, dh, dh), (None, None, None, None)),
        "gn": ParamSpec((d,), (None,), "zeros"),
        "norm2": ParamSpec((d,), ("d_model",), "zeros"),
        "up": ParamSpec((d, 2 * ff), ("d_model", "d_ff")),
        "down": ParamSpec((ff, d), ("d_ff", "d_model")),
    }


def slstm_step(r, c, n, h, m, wx_t):
    """One token of the scalar memory, float32: r [4, H, dh, dh] (the
    recurrent weights of the z, i, f, o gates), states c/n/h/m [B, H, dh],
    wx_t [B, 4, H, dh].  Returns (c, n, h, m)."""
    pre = wx_t + torch.einsum("ghij,bhj->bghi", r, h)
    z = torch.tanh(pre[:, 0])
    i_t = pre[:, 1]
    f_t = F.logsigmoid(pre[:, 2])
    o = torch.sigmoid(pre[:, 3])
    fm = f_t + m
    mnew = torch.maximum(fm, i_t)
    ip = torch.exp(i_t - mnew)
    fp = torch.exp(fm - mnew)
    c = fp * c + ip * z
    n = torch.clamp(fp * n + ip, min=1e-6)
    return c, n, o * c / n, mnew


def apply_slstm(cfg: ModelConfig, p, x, cache=None):
    """The sLSTM block on ``x`` [B, S, d]: gate pre-activations in
    float32, the scalar memory stepped token by token with its per-head
    recurrent product, a norm, the residual, then a SwiGLU FFN of width
    4d/3.  With ``cache`` ({"c", "n", "h", "m"}, float32) ``x`` is one
    token and the cache takes the new state in place.  Its states are
    [B, H, dh], a token's saved tensors the size of its gate inputs, so
    a training pass runs the loop whole (no chunks, unlike
    :func:`apply_mlstm`).  A rank's shards (``p.part``) hold the cell's
    weights whole and the FFN's ``d_ff`` columns (``up`` as ``[gate_r |
    up_r]``): the cell runs whole on every rank, and the FFN's partial sum
    is reduced over the part's axes."""
    b, s, d = x.shape
    h_ = cfg.n_heads
    dh = d // h_
    xn = rms_norm(x, p.norm, cfg.norm_eps)
    wx = (xn.float() @ p.w_gates.float()).view(b, s, 4, h_, dh)
    r = p.r_gates.float()
    if cache is None:
        c = n = h = m = x.new_zeros((b, h_, dh), dtype=torch.float32)
        hs = []
        for wx_t in wx.unbind(1):        # unbind: see mlstm_loop
            c, n, h, m = slstm_step(r, c, n, h, m, wx_t)
            hs.append(h)
        hs = torch.stack(hs, dim=1)
    else:
        if s != 1:
            raise ValueError(f"a cached step takes one token, got {s}")
        state = slstm_step(r, *(cache[k].float() for k in "cnhm"), wx[:, 0])
        for name, t in zip("cnhm", state):
            cache[name].copy_(t)
        hs = state[2][:, None]
    hs = rms_norm(hs.reshape(b, s, d).to(x.dtype), p.gn, cfg.norm_eps)
    y = x + hs
    yn = rms_norm(y, p.norm2, cfg.norm_eps)
    split = p.part is not None and p.part.reduce
    if split:
        yn = split_in(part_mesh(p.part), yn, p.part.reduce)
    out = swiglu(yn @ p.up.to(y.dtype)) @ p.down.to(y.dtype)
    if split:
        out = reduce_out(part_mesh(p.part), out, p.part.reduce)
    return y + out, cache


def init_slstm_cache(cfg: ModelConfig, batch: int, *, device
                     ) -> Dict[str, torch.Tensor]:
    shape = (batch, cfg.n_heads, cfg.d_model // cfg.n_heads)
    return {k: torch.zeros(shape, dtype=torch.float32, device=device)
            for k in "cnhm"}
