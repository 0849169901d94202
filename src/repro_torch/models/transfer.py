"""Carry an LM's weights across from the JAX package's parameter tree.

The reference's ``lm.init_params`` returns a tree ``{"embed", "final_norm",
["head"], "prefix": [block, ...], "body": {"b<i>_<kind>": block}, "rem":
[block, ...]}`` whose ``body`` leaves are stacked on a leading ``cycles``
axis; a block is ``{"attn": {...}, "ffn": {...}}``.  Handed over as numpy
arrays (``jax.tree.map(np.asarray, params)``), :func:`params_from_numpy`
unstacks the body into the port's layers and copies every leaf bit for
bit (bfloat16 through its 16-bit pattern).  A leaf missing, left over, of
another shape or of another dtype than ``cfg.param_dtype`` raises.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch

from repro_torch.models.common import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.lm import LM


def _leaves(node: Any, path: str = "") -> Iterator[Tuple[str, Any]]:
    if isinstance(node, dict):
        for name, sub in node.items():
            yield from _leaves(sub, f"{path}.{name}" if path else name)
    else:
        yield path, node


def _tensor(a: Any, dtype: torch.dtype, name: str) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a.copy())
    if t.dtype != dtype:
        raise TypeError(f"{name}: {t.dtype}, but the config's param_dtype "
                        f"is {dtype}")
    return t


def params_from_numpy(cfg: ModelConfig, tree: Dict[str, Any],
                      device="cuda") -> LM:
    """The port's model holding the reference tree's weights."""
    dev = resolve_device(device)
    top = dict(tree)
    flat: Dict[str, Any] = {}
    for name in ("embed", "final_norm", "head"):
        if name in top:
            flat[name] = top.pop(name)
    n_pre, width = len(cfg.prefix_blocks), len(cfg.block_pattern)
    for i, blk in enumerate(top.pop("prefix", [])):
        flat.update((f"layers.{i}.{p}", a) for p, a in _leaves(blk))
    keys = {f"b{i}_{kind}": i for i, kind in enumerate(cfg.block_pattern)}
    for key, blk in top.pop("body", {}).items():
        if key not in keys:
            raise ValueError(f"body block {key!r} left over: the pattern "
                             f"{cfg.block_pattern} has {sorted(keys)}")
        for p, a in _leaves(blk):
            if np.shape(a)[:1] != (cfg.cycles,):
                raise ValueError(f"body.{key}.{p}: leading axis "
                                 f"{np.shape(a)[:1]}, not ({cfg.cycles},)")
            for c in range(cfg.cycles):
                flat[f"layers.{n_pre + c * width + keys[key]}.{p}"] = a[c]
    base = n_pre + cfg.cycles * width
    for j, blk in enumerate(top.pop("rem", [])):
        flat.update((f"layers.{base + j}.{p}", a) for p, a in _leaves(blk))
    if top:
        raise ValueError(f"leaves left over: {sorted(top)}")
    dtype = cfg.dtype("param")
    return LM(cfg, {n: _tensor(a, dtype, n).to(dev) for n, a in flat.items()})
