"""Plain PyTorch versions of the port's kernels, one per kernel.

Each function states one kernel's contract (masking included) with
straight-line tensor code.  The kernel wrappers take these for tensors on
the CPU, and the chip smoke test holds each CUDA kernel against its plain
version on the same inputs.  Counterpart of ``repro.kernels.ref``; nothing
here builds or launches a kernel, so these run on any device.
"""
from __future__ import annotations

import torch

_INT32_MAX = 2**31 - 1


# -- sort -------------------------------------------------------------------

def sort_lex_ref(hi: torch.Tensor, lo: torch.Tensor):
    """Stable lexicographic (hi, lo) sort; returns (hi, lo, perm int32).

    Two stable passes, least significant lane first, so ties keep input
    order: the total order (hi, lo, row index).
    """
    perm = torch.sort(lo, stable=True).indices
    perm = perm[torch.sort(hi[perm], stable=True).indices]
    return hi[perm], lo[perm], perm.to(torch.int32)


# -- segment sum ------------------------------------------------------------

def segment_sum_ref(seg: torch.Tensor, vals: torch.Tensor, num_segments: int,
                    *, out_dtype=torch.float32, counts: bool = False):
    """Per-segment sums [K, D] of ``vals`` [N, D] in ``out_dtype``, ids
    outside [0, K) dropped; with ``counts`` also the row counts [K] int32."""
    k = max(int(num_segments), 0)
    d = vals.shape[1]
    sid = seg.to(torch.int64)
    sid = torch.where((sid >= 0) & (sid < k), sid, k)
    out = torch.zeros((k + 1, d), dtype=out_dtype, device=vals.device)
    out.index_add_(0, sid, vals.to(out_dtype))
    if not counts:
        return out[:k]
    cnt = torch.zeros(k + 1, dtype=torch.int32, device=vals.device)
    cnt.index_add_(0, sid, torch.ones_like(sid, dtype=torch.int32))
    return out[:k], cnt[:k]


def segment_minmax_ref(kind: str, seg: torch.Tensor, vals: torch.Tensor,
                       num_segments: int) -> torch.Tensor:
    """Per-segment min or max [K, D]; ids outside [0, K) dropped; segments
    with no rows hold the identity (+-inf for floats, the iinfo extreme for
    ints).  The plain version of ``segment_minmax_mxu``."""
    k = max(int(num_segments), 0)
    d = vals.shape[1]
    if vals.dtype.is_floating_point:
        ident = float("inf") if kind == "min" else float("-inf")
    else:
        info = torch.iinfo(vals.dtype)
        ident = info.max if kind == "min" else info.min
    sid = seg.to(torch.int64)
    sid = torch.where((sid >= 0) & (sid < k), sid, k)
    out = torch.full((k + 1, d), ident, dtype=vals.dtype, device=vals.device)
    out.scatter_reduce_(0, sid[:, None].expand(-1, d), vals,
                        "amin" if kind == "min" else "amax")
    return out[:k]


# -- fused shuffle + merge + reduce -----------------------------------------

def fused_shuffle_reduce_ref(k2, mk, vals, valid, sign, affected_keys, *,
                             out_dtype):
    """Sort by (k2, mk), last writer wins, sum live rows per affected key.

    ``k2`` of invalid rows already holds int32 max; ``affected_keys`` is
    sorted, unique among real entries and padded with int32 max.  Returns
    ``(k2_s, mk_s, vals_s, live, perm, acc [key_cap, D], counts [key_cap])``.
    """
    n = k2.shape[0]
    key_cap = affected_keys.shape[0]
    k2_s, mk_s, perm = sort_lex_ref(k2, mk)
    p = perm.to(torch.int64)
    vals_s = vals[p]
    nxt = torch.arange(1, n + 1, device=k2.device).clamp_max(max(n - 1, 0))
    is_last = (k2_s[nxt] != k2_s) | (mk_s[nxt] != mk_s)
    if n:
        is_last[-1] = True
    live = valid[p].to(torch.bool) & is_last & (sign[p] > 0)
    slot = torch.searchsorted(affected_keys, k2_s).clamp_max(key_cap - 1)
    routed = live & (affected_keys[slot] == k2_s)
    acc, counts = segment_sum_ref(torch.where(routed, slot, key_cap), vals_s,
                                  key_cap, out_dtype=out_dtype, counts=True)
    return k2_s, mk_s, vals_s, live, perm, acc, counts


# -- ELL SpMV ---------------------------------------------------------------

def spmv_ell_ref(nbrs: torch.Tensor, contrib: torch.Tensor,
                 num_vertices: int) -> torch.Tensor:
    """y [V] float32 with y[j] = sum of ``contrib`` [S, F] over the slots
    whose ``nbrs`` [S, F] entry is j; -1 padding and ids >= V dropped."""
    v = max(int(num_vertices), 0)
    flat = nbrs.reshape(-1).to(torch.int64)
    sid = torch.where((flat >= 0) & (flat < v), flat, v)
    y = torch.zeros(v + 1, dtype=torch.float32, device=contrib.device)
    y.index_add_(0, sid, contrib.reshape(-1).to(torch.float32))
    return y[:v]


# -- attention --------------------------------------------------------------

_NEG = -2.0e38


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 0,
                        softcap: float = 0.0) -> torch.Tensor:
    """Dense masked softmax attention in float32, the flash kernel's
    contract: q [B, H, S, hd], k [B, KH, S, hd], v [B, KH, S, vd] (GQA,
    H % KH == 0; vd any, MLA's differs from hd) at positions 0..S-1;
    scale 1/sqrt(hd), tanh softcap before the mask, masked scores at
    -2e38; the output [B, H, S, vd] in q's dtype.  Counterpart of
    ``repro.kernels.ref.mha_ref``.  It holds the [B, H, S, S] scores (twice
    while they are scaled: the product's output stays unchanged, as a
    checkpoint that keeps matrix products, ``remat="dots"``, requires)."""
    b, h, sq, hd = q.shape
    kh, sk = k.shape[1], k.shape[2]
    rep = h // kh
    kx = k.float().repeat_interleave(rep, dim=1)
    vx = v.float().repeat_interleave(rep, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kx) / (hd ** 0.5)
    if softcap > 0:
        s.div_(softcap).tanh_().mul_(softcap)
    qp = torch.arange(sq, device=q.device)[:, None]
    kp = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kp <= qp
    if window > 0:
        mask &= (qp - kp) < window
    s.masked_fill_(~mask, _NEG)
    p = torch.softmax(s, dim=-1)
    del s
    return torch.einsum("bhqk,bhkd->bhqd", p, vx).to(q.dtype)
