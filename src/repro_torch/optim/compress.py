"""Compressed data-parallel gradient all-reduce with error feedback.

Counterpart of ``repro.optim.compress``: each gradient leaf is quantized
to int8 with a per-leaf scale (max-abs / 127), the int8 payload is
reduced (4x fewer bytes on the wire than float32), and the quantization
residual stays in an error-feedback buffer added back before the next
step (EF-SGD, Karimireddy et al., 2019).

The reference runs :func:`compressed_psum` inside ``shard_map`` over a
mesh axis.  The port takes either mesh of ``repro_torch.core.distributed``:

  * no mesh (a ``LocalMesh``, P logical shards of one device): the P
    replicas' values are stacked on a leading ``[P, ...]`` axis and the
    all-reduce is a sum over that axis;
  * ``mesh=RankMesh(...)``, one process a replica: each rank passes its
    own leaf; the ranks' int8 payloads and scales are gathered
    (``all_gather``: the int8 bytes are what crosses the wire) and every
    rank sums their dequantized values in rank order.  That is the
    stacked form's sum, in its order, so both give the same bits on every
    rank (an ``all_reduce`` of the float32 values would add in the
    backend's order, which differs from rank to rank and run to run).
"""
from __future__ import annotations

import math
from typing import Any, Tuple

import torch

from repro_torch.tree import tree_flatten, tree_map


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(q int8, scale float32 scalar) with x ~= q * scale, |q| <= 127;
    rounding half to even, as ``jnp.round``."""
    scale = torch.clamp(x.abs().max(), min=1e-30) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compressed_psum(x: torch.Tensor, err: torch.Tensor, mesh=None):
    """Error-feedback int8 mean of ``x`` [P, ...] over its leading axis.

    Replica ``r`` quantizes ``x[r] + err[r]`` with its own scale; the mean
    of the P dequantized tensors comes back on every replica.  Returns
    (the mean float32 [P, ...], the new error buffers [P, ...] in
    ``err``'s dtype).  With ``mesh`` (a ``RankMesh``), ``x`` and ``err``
    are this rank's own leaf and buffer, the P replicas are the ranks, and
    the mean and new buffer come back in the leaf's shape."""
    if mesh is not None:
        return _ranked_psum(x, err, mesh)
    if x.shape != err.shape or x.ndim < 1:
        raise ValueError(f"compressed_psum takes x and err of one shape "
                         f"[P, ...], got {tuple(x.shape)} and "
                         f"{tuple(err.shape)}")
    n = x.shape[0]
    xe = x.to(torch.float32) + err.to(torch.float32)
    parts, new_err = [], torch.empty_like(xe)
    for r in range(n):
        q, scale = quantize_int8(xe[r])
        deq = dequantize_int8(q, scale)
        new_err[r] = xe[r] - deq
        parts.append(deq)
    total = parts[0]
    for part in parts[1:]:
        total = total + part
    return (total / n).expand_as(xe), new_err.to(err.dtype)


def _ranked_psum(x: torch.Tensor, err: torch.Tensor, mesh):
    if x.shape != err.shape:
        raise ValueError(f"compressed_psum takes x and err of one shape, "
                         f"got {tuple(x.shape)} and {tuple(err.shape)}")
    xe = x.to(torch.float32) + err.to(torch.float32)
    q, scale = quantize_int8(xe)
    new_err = xe - dequantize_int8(q, scale)
    qs, scales = mesh.all_gather(q), mesh.all_gather(scale)
    total = dequantize_int8(qs[0], scales[0])
    for r in range(1, mesh.world):
        total = total + dequantize_int8(qs[r], scales[r])
    return total / mesh.world, new_err.to(err.dtype)


def init_error_buffers(grads: Any, dtype=torch.bfloat16):
    return tree_map(lambda g: torch.zeros(g.shape, dtype=dtype,
                                          device=g.device), grads)


def compressed_tree_psum(grads: Any, err_tree: Any):
    """:func:`compressed_psum` leaf by leaf over a tree of [P, ...]
    gradients; each mean comes back in its leaf's dtype."""
    flat_g, unflatten = tree_flatten(grads)
    flat_e, _ = tree_flatten(err_tree)
    if len(flat_g) != len(flat_e):
        raise ValueError(f"{len(flat_g)} gradient leaves but "
                         f"{len(flat_e)} error buffers")
    out_g, out_e = [], []
    for g, e in zip(flat_g, flat_e):
        rg, re = compressed_psum(g, e)
        out_g.append(rg.to(g.dtype))
        out_e.append(re)
    return unflatten(out_g), unflatten(out_e)


def wire_bytes(grads: Any) -> Tuple[int, int]:
    """(uncompressed float32 bytes, int8 bytes) per all-reduce round."""
    flat, _ = tree_flatten(grads)
    n = sum(math.prod(g.shape) for g in flat)
    return 4 * n, 1 * n + 4 * len(flat)
