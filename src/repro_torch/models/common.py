"""Shared model machinery: parameter plans, initialisation, norms, rotary
embeddings, activation helpers.

Counterpart of ``repro.models.common``.  A plan is a flat dict from a
parameter's name (``layers.3.attn.wq``) to its ``ParamSpec``;
:func:`tree_init` draws tensors from it with the reference's
distribution, and the modules of ``blocks`` and ``lm`` take the tensors
as their parameters.

Every leaf carries the reference's logical axes (``ParamSpec.axes``:
``"d_model"``, ``"heads"``, ``"kv_heads"``, ``"d_ff"``, ``"vocab"``,
``"expert"``, ``"batch"``, ``"kv_seq"`` or None a dim).
:func:`shard_spec` maps them through ``ShardingRules`` onto a mesh's axes
as the reference's ``valid_pspec`` does, and :func:`shard_slice` says
which part of the leaf a rank at given coordinates holds
(``repro_torch.models.shard`` cuts a model with them).  ``constrain`` has
no counterpart: a rank's tensors are its shards, and the collectives are
explicit (``RankMesh.psum``, ``RankMesh.all_gather``).
"""
from __future__ import annotations

import math
from typing import Dict, Mapping, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

DEVICES = ("cuda", "cpu", "meta")


class ParamSpec(NamedTuple):
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]    # the reference's logical axis a dim
    init: str = "normal"               # normal | zeros | ones
    # fan-in of the 1/sqrt(fan_in) scale; 0 means the reference's rule on
    # this shape.  Body leaves carry the cycle count: the reference stacks
    # them on a leading cycles axis, which its rule then reads as fan-in.
    fan_in: int = 0


def _mesh_axes(rules, logical: Optional[str]):
    """The mesh axes (a name, a tuple of names or None) ``rules`` gives a
    logical axis."""
    if logical is None:
        return None
    return getattr(rules, logical, None)


def _divisible_entry(entry, dim: int, sizes: Mapping[str, int]):
    """Mesh axes dropped from the end of ``entry`` until their sizes'
    product divides ``dim`` (an axis the mesh lacks counts 1), as the
    reference's ``_divisible_entry``: kv_heads 8 takes no 16-way split and
    falls back to replicated.  One name stays a name, several a tuple."""
    if entry is None:
        return None
    names = list(entry) if isinstance(entry, (tuple, list)) else [entry]
    while names:
        if dim % math.prod(sizes.get(n, 1) for n in names) == 0:
            break
        names.pop()
    if not names:
        return None
    return tuple(names) if len(names) > 1 else names[0]


def shard_spec(rules, axes: Tuple[Optional[str], ...],
               shape: Tuple[int, ...], mesh_shape: Mapping[str, int]
               ) -> Tuple:
    """The reference's ``valid_pspec(rules, axes, shape, mesh)`` on a mesh
    given as ``{axis: size}``: one entry a dim, None (replicated), a mesh
    axis, or a tuple of them (the first slowest)."""
    if len(axes) != len(shape):
        raise ValueError(f"axes {axes} do not match shape {shape}")
    return tuple(_divisible_entry(_mesh_axes(rules, a), d, mesh_shape)
                 for a, d in zip(axes, shape))


def entry_names(entry) -> Tuple[str, ...]:
    """A spec entry's mesh axes as a tuple (none for None)."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def entry_part(entry, mesh_shape: Mapping[str, int],
               coords: Mapping[str, int]) -> Tuple[int, int]:
    """(index, parts) of a spec entry at ``coords``: the entry's axes
    flattened, the first slowest, an axis the mesh lacks of size 1 at 0."""
    index, parts = 0, 1
    for n in entry_names(entry):
        size = mesh_shape.get(n, 1)
        index = index * size + (coords.get(n, 0) if n in mesh_shape else 0)
        parts *= size
    return index, parts


def shard_slice(spec: Tuple, shape: Tuple[int, ...],
                mesh_shape: Mapping[str, int], coords: Mapping[str, int]
                ) -> Tuple[slice, ...]:
    """The index range of every dim that the rank at ``coords`` (row order,
    as ``RankMesh.coords_of`` numbers ranks) holds under ``spec``
    (:func:`shard_spec`): dim / parts elements from index * dim / parts,
    as GSPMD tiles a ``NamedSharding``."""
    out = []
    for entry, dim in zip(spec, shape):
        index, parts = entry_part(entry, mesh_shape, coords)
        if dim % parts:
            raise ValueError(f"entry {entry} splits {dim} into {parts}")
        n = dim // parts
        out.append(slice(index * n, (index + 1) * n))
    return tuple(out)


def resolve_device(device) -> torch.device:
    """``cuda`` (the entry points' default), ``cpu`` or ``meta`` (shapes
    only); raises when CUDA is asked for and there is no card."""
    try:
        dev = torch.device(device)
    except RuntimeError:
        dev = None
    if dev is None or dev.type not in DEVICES:
        raise ValueError(f"device must be one of {DEVICES}, got {device!r}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} asked for, but torch.cuda.is_available() "
            f"is False: the LM stack runs on a CUDA card unless the caller "
            f"passes device='cpu'")
    return dev


def tree_init(plan: Dict[str, ParamSpec], generator: torch.Generator,
              dtype: torch.dtype, device) -> Dict[str, torch.Tensor]:
    """Draw every leaf of ``plan``: zeros or ones as named, else
    normal / sqrt(fan_in) in float32 rounded to ``dtype``, as the
    reference's ``tree_init``.  Draws come from ``generator`` on its own
    device, leaf by leaf in plan order; on ``meta`` nothing is drawn."""
    dev = torch.device(device)
    out = {}
    for name, s in plan.items():
        if s.init == "zeros":
            out[name] = torch.zeros(s.shape, dtype=dtype, device=dev)
        elif s.init == "ones":
            out[name] = torch.ones(s.shape, dtype=dtype, device=dev)
        elif dev.type == "meta":
            out[name] = torch.empty(s.shape, dtype=dtype, device=dev)
        else:
            fan_in = s.fan_in or (s.shape[0] if len(s.shape) > 1
                                  else max(s.shape[0], 1))
            w = torch.randn(s.shape, generator=generator,
                            device=generator.device, dtype=torch.float32)
            out[name] = w.mul_(1.0 / math.sqrt(max(fan_in, 1))).to(
                device=dev, dtype=dtype)
    return out


# ---------------------------------------------------------------------------
# numerics
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6):
    """RMSNorm in float32 with the reference's ``1 + scale`` gain."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + scale.float())).to(x.dtype)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    if cap <= 0.0:
        return x
    return torch.tanh(x / cap) * cap


def rope_table(positions: torch.Tensor, dim: int, theta: float):
    """positions [*, T] -> (sin, cos) each [*, T, dim/2] in float32."""
    half = dim // 2
    exps = torch.arange(half, dtype=torch.float32,
                        device=positions.device) / half
    freqs = 1.0 / (theta ** exps)
    ang = positions.float()[..., None] * freqs
    return torch.sin(ang), torch.cos(ang)


def apply_rope(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor):
    """x [..., T, H, D]; sin/cos [..., T, D/2] (broadcast over heads);
    split halves, float32 inside."""
    half = x.shape[-1] // 2
    s = sin[..., None, :]
    c = cos[..., None, :]
    x1f = x[..., :half].float()
    x2f = x[..., half:].float()
    return torch.cat([x1f * c - x2f * s, x2f * c + x1f * s],
                     dim=-1).to(x.dtype)


def swiglu(x: torch.Tensor, kind: str = "swiglu") -> torch.Tensor:
    """x [..., 2*ff] fused gate+up -> [..., ff]; GeGLU takes the tanh
    approximation of GELU, as the reference."""
    gate, up = x.chunk(2, dim=-1)
    if kind == "geglu":
        return F.gelu(gate, approximate="tanh") * up
    return F.silu(gate) * up


def masked_nll(logits: torch.Tensor, targets: torch.Tensor,
               mask: torch.Tensor, logit_cap: float = 0.0) -> torch.Tensor:
    """Summed negative log-likelihood in float32 after the logit softcap:
    logits [..., V], targets int [...], mask [...] (weights, 0 or 1)."""
    logits = softcap(logits.float(), logit_cap)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    return ((logz - gold) * mask.float()).sum()

