"""Transformer blocks of the port: GQA attention and the dense FFN.

Counterpart of ``repro.models.blocks`` for the kinds the port runs so far.
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

Not ported yet: RG-LRU, mLSTM and sLSTM (ROADMAP.md Queue 1 item 16b.3),
MLA and MoE (16b.4).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels.flash_attention import flash_attention
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


class Params(nn.Module):
    """A block's parameters, one ``nn.Parameter`` per plan leaf; they take
    gradients only when ``trainable`` (serving builds them without)."""

    def __init__(self, tensors: Dict[str, torch.Tensor],
                 trainable: bool = False):
        super().__init__()
        for name, t in tensors.items():
            self.register_parameter(name,
                                    nn.Parameter(t, requires_grad=trainable))


# ---------------------------------------------------------------------------
# Attention (GQA, local windows, softcap, qk-norm)
# ---------------------------------------------------------------------------

def plan_attention(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d, h, k, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {
        "norm": ParamSpec((d,), "zeros"),
        "wq": ParamSpec((d, h, hd)),
        "wk": ParamSpec((d, k, hd)),
        "wv": ParamSpec((d, k, hd)),
        "wo": ParamSpec((h, hd, d)),
    }
    if cfg.qk_norm:
        p["q_scale"] = ParamSpec((hd,), "zeros")
        p["k_scale"] = ParamSpec((hd,), "zeros")
    if cfg.post_norms:
        p["post_norm"] = ParamSpec((d,), "zeros")
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
    """
    b, s, d = x.shape
    h, kh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    xn = rms_norm(x, p.norm, cfg.norm_eps)
    q = (xn @ p.wq.to(xn.dtype).reshape(d, h * hd)).view(b, s, h, hd)
    k = (xn @ p.wk.to(xn.dtype).reshape(d, kh * hd)).view(b, s, kh, hd)
    v = (xn @ p.wv.to(xn.dtype).reshape(d, kh * hd)).view(b, s, kh, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p.q_scale, cfg.norm_eps)
        k = rms_norm(k, p.k_scale, cfg.norm_eps)
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
    if cfg.post_norms:
        y = rms_norm(y, p.post_norm, cfg.norm_eps)
    return x + y, cache


def init_attn_cache(cfg: ModelConfig, batch: int, max_len: int,
                    window: int = 0, *, device, dtype) -> Dict[str, torch.Tensor]:
    t = min(window, max_len) if window > 0 else max_len
    shape = (batch, t, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


# ---------------------------------------------------------------------------
# FFN: dense (swiglu / geglu / gelu)
# ---------------------------------------------------------------------------

def plan_ffn(cfg: ModelConfig, d_ff: Optional[int] = None,
             kind: str = "swiglu") -> Dict[str, ParamSpec]:
    d = cfg.d_model
    ff = d_ff or cfg.d_ff
    p = {"norm": ParamSpec((d,), "zeros"),
         "w_in": ParamSpec((d, ff if kind == "gelu" else 2 * ff)),
         "w_out": ParamSpec((ff, d))}
    if cfg.post_norms:
        p["post_norm"] = ParamSpec((d,), "zeros")
    return p


def apply_ffn(cfg: ModelConfig, p, x, kind: str = "swiglu"):
    xn = rms_norm(x, p.norm, cfg.norm_eps)
    h = xn @ p.w_in.to(xn.dtype)
    h = F.gelu(h, approximate="tanh") if kind == "gelu" else swiglu(h, kind)
    y = h @ p.w_out.to(h.dtype)
    if cfg.post_norms:
        y = rms_norm(y, p.post_norm, cfg.norm_eps)
    return x + y
