"""Flash attention (forward) — every cache-less attention layer of the
LM's prefill as one kernel.

Counterpart of ``repro.kernels.flash_attention.flash_attention``, with its
contract and layout: q [B, H, S, hd], k/v [B, KH, S, hd] (GQA, H % KH ==
0), queries and keys at positions 0..S-1; causal mask, sliding window
(``window > 0``: key within ``window`` of the query), tanh softcap; scale
1/sqrt(hd); bf16 or float32 in, q's dtype out.  V may have a head dim of
its own, vd: v [B, KH, S, vd] gives [B, H, S, vd], the scale still
1/sqrt(hd) (DeepSeek-V3's MLA: q.k over 192, v 128, and at its 100m
preset 96 and 64; the reference's dense attention takes any vd, its
Pallas kernel one hd for all three).

On the H100 ``csrc/flash_attention.cu`` replaces the Pallas kernel (its
``pl.pallas_call`` walks the KV blocks of one q block with a fori_loop):
a block walks the KV tiles of one (q tile, head, batch) with the
streaming softmax in registers.  At the serving shape it is bounded by
tensor-core operations, not bytes.  Which kernel serves which (dtype,
hd):

- bf16 at hd 64, 80, 128, 160 and 256 (Gemma 2, Qwen3, Mistral NeMo,
  Chameleon; HuBERT X-Large at 80, StableLM 12B at 160) runs the Hopper
  design: a producer warpgroup keeps Q and a ring of K and V tiles (2
  stages, 4 at hd 80) coming by TMA (mbarriers; its registers cut by
  ``setmaxnreg``), and two consumer warpgroups of 64 q rows each
  multiply with ``wgmma`` (S = Q.K^T from shared memory, O += P.V with P
  in registers; S of one tile and P.V of the one before issued
  together), the softcap's tanh from one exponential and one
  reciprocal.  A tile is a row of TMA boxes
  in the swizzle of their width: 64 columns at the multiples of 64, 32 at
  hd 160 and 16 at hd 80.  Shared memory: 224 KB at hd 256 (80-key
  tiles), 200 KB at 160, 180 KB at 80, 160 KB at 128 and 80 KB at 64
  (128-key tiles).
- bf16 at hd 16 and 32 (the smoke configs' heads) runs a smaller
  ``mma.sync`` kernel with synchronous loads.
- float32 at every dim runs plain FMAs (TF32 would break its contract)
  and serves the checks and float32 models.
- (hd, vd) = (192, 128), MLA's, runs the wgmma kernel in bf16 (Q and K
  three 64-column boxes, V two; 208 KB of shared memory) and the FMA
  kernel in float32 (``SPLIT_DIMS``); (96, 64), the 100m preset's MLA,
  likewise with 32-column boxes (Q and K three, V two; 104 KB).

The scale is 1/sqrt of the true hd.  The source note gives the bounds
and what the design leaves.

The wrapper is the custom op ``repro_torch::flash_attention``.  CUDA
tensors launch the kernel or raise, also at a pair of head dims that no
kernel serves (:func:`kernel_for`); CPU tensors take the plain version
:func:`ref.flash_attention_ref`, at any head dims, and only they;
``meta`` tensors give the output's shape and refuse the pairs the card
refuses.  ``torch.utils.flop_counter.FlopCounterMode`` counts a call by
its formula, 2 B H (hd + vd) times the keys the rows attend
(:func:`attended_keys`), on every device alike, and never the plain
version's own products.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import _build, count_launch
from repro_torch.kernels.ref import flash_attention_ref

# head dims the kernels serve with v's equal to q.k's, and the pairs
# (q.k hd, v hd) with a v head dim of its own (DeepSeek-V3's MLA at full
# width and at ``launch.train``'s 100m preset)
HEAD_DIMS = (16, 32, 64, 80, 128, 160, 256)
SPLIT_DIMS = ((192, 128), (96, 64))
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def kernel_for(hd: int, vd: int, dtype: torch.dtype) -> Optional[str]:
    """The CUDA kernel that serves q.k head dim ``hd``, v head dim ``vd``
    and ``dtype``: "wgmma" (bf16, both dims 64 or more), "mma" (bf16 at
    16 and 32), "f32" (float32), or None where none does."""
    if dtype not in _DTYPE_CODES or not (
            (hd == vd and hd in HEAD_DIMS) or (hd, vd) in SPLIT_DIMS):
        return None
    if dtype == torch.float32:
        return "f32"
    return "wgmma" if min(hd, vd) >= 64 else "mma"


def attended_keys(s: int, causal: bool, window: int) -> int:
    """Keys the S rows of one head attend, summed over the rows: the
    causal triangle cut to ``window`` keys a row, or, not causal, every
    key but those more than ``window`` behind the row."""
    if not causal:
        if window <= 0 or window >= s:
            return s * s
        return s * s - (s - window) * (s - window + 1) // 2
    w = s if window <= 0 else min(window, s)
    return w * (w + 1) // 2 + (s - w) * w


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0) -> torch.Tensor:
    """q [B, H, S, hd]; k [B, KH, S, hd], v [B, KH, S, vd] (H % KH == 0)
    -> [B, H, S, vd], through the custom op ``repro_torch::flash_attention``
    (:func:`_flash_op`): the kernel for CUDA tensors, the plain version
    for CPU tensors, shapes only for ``meta`` tensors.  A CUDA or ``meta``
    tensor at a pair of head dims that no kernel serves raises here, so
    that a dry-run on ``meta`` refuses what the card refuses."""
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4 \
            or k.shape[:3] != v.shape[:3]:
        raise ValueError(f"flash_attention takes q [B, H, S, hd], k [B, KH, "
                         f"S, hd] and v [B, KH, S, vd], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, h, s, hd = q.shape
    kh, vd = k.shape[1], v.shape[3]
    if k.shape[0] != b or k.shape[2] != s or k.shape[3] != hd:
        raise ValueError(f"flash_attention needs k [{b}, KH, {s}, {hd}] "
                         f"(queries and keys at the same positions), got "
                         f"{tuple(k.shape)}")
    if kh < 1 or h % kh:
        raise ValueError(f"flash_attention needs H % KH == 0, got H {h}, "
                         f"KH {kh}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes bf16 or float32 q, k, v of "
                        f"one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention inputs lie on different devices")
    if q.device.type != "cpu" and kernel_for(hd, vd, q.dtype) is None:
        raise ValueError(f"flash_attention has no kernel for head dims "
                         f"(q.k {hd}, v {vd}): it takes {HEAD_DIMS} for "
                         f"both and the pairs {SPLIT_DIMS}")
    if q.device.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"flash_attention runs on cuda, cpu or meta, not "
                         f"{q.device}")
    return _flash_op(q, k, v, bool(causal), max(int(window), 0),
                     float(softcap))


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=(),
                         device_types="cpu")
def _flash_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool, window: int, softcap: float) -> torch.Tensor:
    """The op behind :func:`flash_attention`, which checks its arguments;
    its CPU implementation is the plain version."""
    return flash_attention_ref(q, k, v, causal=causal, window=window,
                               softcap=softcap)


@_flash_op.register_kernel("cuda")
def _flash_cuda(q, k, v, causal, window, softcap):
    b, h, s, hd = q.shape
    kh, vd = k.shape[1], v.shape[3]
    q, k, v = (_aligned(t) for t in (q, k, v))
    out = q.new_empty((b, h, s, vd))
    if out.numel():
        lib = _build.library("flash_attention")
        rc = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h,
            kh, s, hd, vd, _DTYPE_CODES[q.dtype], int(causal), window,
            softcap, _build.stream_ptr(q.device))
        _build.check(lib, rc, "flash_attention")
        count_launch(flash_attention)
    return out


@_flash_op.register_fake
def _flash_fake(q, k, v, causal, window, softcap):
    return q.new_empty(q.shape[:3] + v.shape[3:])


@register_flop_formula(torch.ops.repro_torch.flash_attention)
def _flash_flops(q_shape, k_shape, v_shape, causal, window, softcap, *,
                 out_shape=None, **kw) -> int:
    """The two products' multiply-adds over the keys each row attends:
    2 B H (hd + vd) keys."""
    b, h, s, hd = q_shape
    return 2 * b * h * (hd + v_shape[3]) * attended_keys(s, causal, window)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """Contiguous, on a 16-byte boundary (TMA and the 16-byte loads of the
    other kernels need it)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


flash_attention.launches = 0
