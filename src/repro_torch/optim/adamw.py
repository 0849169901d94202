"""AdamW with gradient clipping and the warm-up + cosine schedule.

Counterpart of ``repro.optim.adamw``, with the reference's formula (not
``torch.optim.AdamW``, which decays the weights by ``p *= 1 - lr * wd``
and has no schedule): the update in float32, weight decay added to the
step before ``lr`` multiplies it, bias correction with the step as a
float32, the clip by the global norm, the cast back to each leaf's dtype.

Parameters, gradients and moments are dicts keyed by the port's parameter
names (``layers.3.attn.wq``); the state is ``{"m", "v", "step"}`` with
``step`` an int32 scalar tensor.  :func:`adamw_update` writes the new
parameters and moments in place, leaf by leaf (the reference returns new
trees), so a step holds one leaf's float32 temporaries, not a second copy
of the state; a leaf of more than ``ADAMW_SLICE_ELEMS`` elements goes in
slices of its leading axis, so that they stay near that size.

Under a mesh (a model cut for a rank, ``models.shard``) the parameters,
gradients and moments are the rank's shards: :func:`global_norm` sums
each leaf's squares over the mesh axes it is split over (``norm_axes``),
so that every rank clips by the same norm, bit for bit, and the update is
elementwise on the shards.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

# the elements of a leaf above which its update goes in slices of the
# leading axis: the update's float32 temporaries (the gradient, both
# moments, the step, the parameter) are each the size of what is updated
# at once, 5.4 GB for Llama 4 Scout's expert leaf w_in [16, 5120, 16384]
# whole, 2.1 GB at this size (a train step of its one-layer cut peaks at
# 61.7 GiB on ``meta``, 82.7 whole; 57.7 at 2^28, which doubles the
# slices and the ops a dry-run of DeepSeek-V3 counts: tools/
# train_probes.py).  The arithmetic is elementwise, so a slice's result
# is bitwise the whole leaf's.
ADAMW_SLICE_ELEMS = 2**29


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup: int = 100
    total_steps: int = 10000
    opt_dtype: torch.dtype = torch.float32


def cosine_schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """The learning rate at ``step`` (an int or an integer tensor), float32:
    a linear warm-up to ``lr`` over ``warmup`` steps, then half a cosine
    down to 0 at ``total_steps``."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup) / max(cfg.total_steps - cfg.warmup, 1),
                    0.0, 1.0)
    return cfg.lr * warm * (0.5 * (1.0 + torch.cos(math.pi * t)))


def global_norm(tree: Dict[str, torch.Tensor], mesh=None,
                norm_axes: Optional[Dict[str, Tuple[str, ...]]] = None
                ) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32.  ``mesh``:
    the leaves are a rank's shards, and the squares of the leaves split
    over the same axes (``norm_axes[name]``, none for a replicated leaf)
    are added on the rank, then summed over those axes with
    ``mesh.psum`` (float32, in rank order); the groups are added in the
    order of their axes, so that every rank gets the same bits."""
    sums = [leaf.float().square().sum() for leaf in tree.values()]
    if mesh is None:
        return torch.sqrt(sum(sums[1:], sums[0]))
    groups: Dict[Tuple[str, ...], list] = {}
    for name, sq in zip(tree, sums):
        groups.setdefault(tuple(norm_axes.get(name, ())), []).append(sq)
    total = None
    for axes in sorted(groups):
        part = torch.stack(groups[axes]).sum()
        if axes:
            part = mesh.psum(part, axes)
        total = part if total is None else total + part
    return torch.sqrt(total)


def leaf_slices(shape) -> list:
    """The index of each part a leaf of ``shape`` is updated in: the whole
    (``...``) up to ``ADAMW_SLICE_ELEMS`` elements, else runs of rows of
    the leading axis with at most that many elements (one row at least)."""
    numel = math.prod(shape)
    if numel <= ADAMW_SLICE_ELEMS or len(shape) == 0:
        return [...]
    rows = max(1, ADAMW_SLICE_ELEMS // (numel // shape[0]))
    return [slice(i, i + rows) for i in range(0, shape[0], rows)]


def adamw_init(params: Dict[str, torch.Tensor], cfg: AdamWConfig):
    """Zero moments in ``cfg.opt_dtype`` beside each parameter, step 0."""
    dev = next(iter(params.values())).device if params else None
    return {
        "m": {n: torch.zeros(p.shape, dtype=cfg.opt_dtype, device=p.device)
              for n, p in params.items()},
        "v": {n: torch.zeros(p.shape, dtype=cfg.opt_dtype, device=p.device)
              for n, p in params.items()},
        "step": torch.zeros((), dtype=torch.int32, device=dev),
    }


@torch.no_grad()
def adamw_update(grads: Dict[str, torch.Tensor], opt_state,
                 params: Dict[str, torch.Tensor], cfg: AdamWConfig,
                 mesh=None, norm_axes=None):
    """One AdamW step: ``params`` and the moments of ``opt_state`` are
    updated in place.  Returns ``(params, opt_state, {"grad_norm", "lr"})``
    with ``opt_state["step"]`` a new tensor one higher.  ``mesh`` and
    ``norm_axes``: the leaves are a rank's shards (:func:`global_norm`)."""
    step = opt_state["step"] + 1
    gnorm = global_norm(grads, mesh, norm_axes)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0) if cfg.clip_norm > 0 else 1.0
    lr = cosine_schedule(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    stepf = step.to(torch.float32)
    corr1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                       device=stepf.device), stepf)
    corr2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                       device=stepf.device), stepf)
    for name, leaf in params.items():
        for part in leaf_slices(leaf.shape):
            p = leaf[part]
            m, v = opt_state["m"][name][part], opt_state["v"][name][part]
            g = grads[name][part].float() * scale
            m2 = b1 * m.float() + (1 - b1) * g
            v2 = b2 * v.float() + (1 - b2) * g.square()
            delta = (m2 / corr1) / ((v2 / corr2).sqrt() + cfg.eps) \
                + cfg.weight_decay * p.float()
            p.copy_(p.float() - lr * delta)
            m.copy_(m2)
            v.copy_(v2)
    return params, {"m": opt_state["m"], "v": opt_state["v"],
                    "step": step}, {"grad_norm": gnorm, "lr": lr}
