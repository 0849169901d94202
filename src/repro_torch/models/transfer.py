"""Carry an LM's weights and optimizer state across from and to the JAX
package's parameter tree.

The reference's ``lm.init_params`` returns a tree ``{"embed", "final_norm",
["head"], "prefix": [block, ...], "body": {"b<i>_<kind>": block}, "rem":
[block, ...], ["mtp_proj", "mtp_block", "mtp_norm"]}`` whose ``body``
leaves are stacked on a leading ``cycles`` axis; a block is ``{"attn":
{...}, "ffn": {...}}``, ``{"rec": {...}, "ffn": {...}}`` (RG-LRU) or
``{"cell": {...}}`` (mLSTM, sLSTM), and ``rem`` holds the blocks after the
last whole cycle (RecurrentGemma's two).  :func:`from_reference_tree` unstacks the body into
the port's flat names (``layers.<i>.<path>``, ``mtp_block.<path>``) and
:func:`to_reference_tree` stacks them back.  On top of them:

- :func:`params_from_numpy` / :func:`params_to_numpy`: the model, every
  leaf copied bit for bit (with ``ep=(index, size)``, only the experts of
  EP rank ``index`` of ``size``, for the MoE's ``a2a`` path; with
  ``mesh=``, only the mesh's own rank's shard of each leaf, as
  ``models.shard`` lays it out).  bfloat16 goes through its 16-bit pattern:
  in, an array of ``ml_dtypes.bfloat16`` (``jax.tree.map(np.asarray,
  params)``), a uint16 array of the patterns, or a torch tensor; out, the
  uint16 patterns.  A leaf missing, left over, of another shape or of
  another dtype than ``cfg.param_dtype`` raises.
- :func:`opt_state_from_numpy` / :func:`opt_state_to_numpy`: an AdamW
  state ``{"m", "v", "step"}``, the moments in the reference's tree (of
  the optimizer's ``opt_dtype``) and ``step`` an int32 scalar.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch

from repro_torch.models.common import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.lm import LM, is_expert_leaf
from repro_torch.tree import tree_map

_TOP = ("embed", "final_norm", "head", "mtp_proj", "mtp_norm")


def _leaves(node: Any, path: str = "") -> Iterator[Tuple[str, Any]]:
    if isinstance(node, dict):
        for name, sub in node.items():
            yield from _leaves(sub, f"{path}.{name}" if path else name)
    else:
        yield path, node


def _nest(flat: Dict[str, Any]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for path, leaf in flat.items():
        *heads, last = path.split(".")
        node = out
        for h in heads:
            node = node.setdefault(h, {})
        node[last] = leaf
    return out


def from_reference_tree(cfg: ModelConfig, tree: Dict[str, Any]
                        ) -> Dict[str, Any]:
    """The reference tree's leaves under the port's flat names (body
    leaves indexed by cycle, not copied)."""
    top = dict(tree)
    flat: Dict[str, Any] = {n: top.pop(n) for n in _TOP if n in top}
    if "mtp_block" in top:
        flat.update((f"mtp_block.{p}", a)
                    for p, a in _leaves(top.pop("mtp_block")))
    n_pre, width = len(cfg.prefix_blocks), len(cfg.block_pattern)
    for i, blk in enumerate(top.pop("prefix", [])):
        flat.update((f"layers.{i}.{p}", a) for p, a in _leaves(blk))
    keys = {f"b{i}_{kind}": i for i, kind in enumerate(cfg.block_pattern)}
    for key, blk in top.pop("body", {}).items():
        if key not in keys:
            raise ValueError(f"body block {key!r} left over: the pattern "
                             f"{cfg.block_pattern} has {sorted(keys)}")
        for p, a in _leaves(blk):
            if tuple(a.shape[:1]) != (cfg.cycles,):
                raise ValueError(f"body.{key}.{p}: leading axis "
                                 f"{tuple(a.shape[:1])}, not ({cfg.cycles},)")
            for c in range(cfg.cycles):
                flat[f"layers.{n_pre + c * width + keys[key]}.{p}"] = a[c]
    base = n_pre + cfg.cycles * width
    for j, blk in enumerate(top.pop("rem", [])):
        flat.update((f"layers.{base + j}.{p}", a) for p, a in _leaves(blk))
    if top:
        raise ValueError(f"leaves left over: {sorted(top)}")
    return flat


def to_reference_tree(cfg: ModelConfig, flat: Dict[str, torch.Tensor]
                      ) -> Dict[str, Any]:
    """The port's flat tensors (parameters, gradients or moments) in the
    reference's tree, on the CPU: body leaves stacked on ``cycles``."""
    flat = {n: t.detach().cpu() for n, t in flat.items()}
    tree: Dict[str, Any] = {n: flat.pop(n) for n in _TOP if n in flat}
    if cfg.mtp:
        tree["mtp_block"] = _nest({n[len("mtp_block."):]: flat.pop(n)
                                   for n in list(flat)
                                   if n.startswith("mtp_block.")})
    n_pre, width = len(cfg.prefix_blocks), len(cfg.block_pattern)
    kinds = cfg.layer_kinds

    def block(i):
        pre = f"layers.{i}."
        return _nest({n[len(pre):]: flat.pop(n) for n in list(flat)
                      if n.startswith(pre)})

    tree["prefix"] = [block(i) for i in range(n_pre)]
    if cfg.cycles > 0:
        body = {}
        for k, kind in enumerate(cfg.block_pattern):
            cyc = [dict(_leaves(block(n_pre + c * width + k)))
                   for c in range(cfg.cycles)]
            body[f"b{k}_{kind}"] = _nest({p: torch.stack([b[p] for b in cyc])
                                          for p in cyc[0]})
        tree["body"] = body
    base = n_pre + cfg.cycles * width
    tree["rem"] = [block(i) for i in range(base, len(kinds))]
    if flat:
        raise ValueError(f"leaves left over: {sorted(flat)[:8]}")
    return tree


def tensor_of(a: Any, dtype: torch.dtype, name: str) -> torch.Tensor:
    """A host tensor of ``dtype`` holding ``a`` bit for bit (a numpy array,
    bfloat16 as ``ml_dtypes.bfloat16`` or its uint16 patterns, or a
    tensor); another dtype raises."""
    if isinstance(a, torch.Tensor):
        t = a.clone()
    else:
        a = np.asarray(a)
        if a.dtype.name == "bfloat16" or (a.dtype == np.uint16
                                          and dtype == torch.bfloat16):
            t = torch.from_numpy(a.view(np.uint16).copy()).view(
                torch.bfloat16)
        else:
            t = torch.from_numpy(a.copy())
    if t.dtype != dtype:
        raise TypeError(f"{name}: {t.dtype}, where {dtype} was expected")
    return t


def numpy_of(t: torch.Tensor) -> np.ndarray:
    """A host copy; bfloat16 as its uint16 patterns."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.uint16).numpy().copy()
    return t.numpy().copy()


def params_from_numpy(cfg: ModelConfig, tree: Dict[str, Any],
                      device="cuda", trainable: bool = False,
                      ep=None, mesh=None) -> LM:
    """The port's model holding the reference tree's weights.  ``ep``
    ``(index, size)``: each MoE layer keeps experts ``index * E / size``
    up to ``(index + 1) * E / size`` (rank ``index`` of the ``size`` EP
    ranks), so that no rank copies the others'.  ``mesh`` (a ``RankMesh``
    or anything with its ``shape`` and ``coords``): each leaf keeps the
    mesh's own rank's shard (``models.shard.Layout.take``; the fused FFN
    input as ``[gate_r | up_r]``)."""
    dev = resolve_device(device)
    dtype = cfg.dtype("param")
    flat = from_reference_tree(cfg, tree)
    if mesh is not None:
        if ep is not None:
            raise ValueError("params_from_numpy takes ep= or mesh=, not both")
        from repro_torch.models.lm import plan_model
        from repro_torch.models.shard import Layout
        layout = Layout.of(cfg, mesh)
        plan = plan_model(cfg)
        return LM(cfg, {n: tensor_of(layout.take(n, plan[n], a)
                                     if n in plan else a, dtype, n).to(dev)
                        for n, a in flat.items()}, trainable, layout=layout)
    size = 1
    if ep is not None:
        index, size = ep
        e_loc = cfg.moe.num_experts // size
        flat = {n: a[index * e_loc:(index + 1) * e_loc]
                if is_expert_leaf(n) else a for n, a in flat.items()}
    return LM(cfg, {n: tensor_of(a, dtype, n).to(dev)
                    for n, a in flat.items()}, trainable, ep_size=size)


def params_to_numpy(cfg: ModelConfig, model: LM) -> Dict[str, Any]:
    """The model's weights in the reference's tree, as numpy arrays."""
    return tree_map(numpy_of,
                    to_reference_tree(cfg, dict(model.named_parameters())))


def opt_state_from_numpy(cfg: ModelConfig, tree: Dict[str, Any],
                         device="cuda", dtype: torch.dtype = torch.float32
                         ) -> Dict[str, Any]:
    """A reference AdamW state as the port's ``{"m", "v", "step"}`` keyed
    by parameter name.  The moments must be of ``dtype``, the optimizer's
    ``AdamWConfig.opt_dtype`` (the reference's resume takes the dtype of
    its live state, not ``cfg.opt_dtype``); another dtype raises."""
    dev = resolve_device(device)
    state = {w: {n: tensor_of(a, dtype, f"{w}.{n}").to(dev) for n, a in
                 from_reference_tree(cfg, tree[w]).items()}
             for w in ("m", "v")}
    state["step"] = tensor_of(tree["step"], torch.int32, "step").to(dev)
    return state


def opt_state_to_numpy(cfg: ModelConfig, state: Dict[str, Any]):
    return tree_map(numpy_of, {"m": to_reference_tree(cfg, state["m"]),
                               "v": to_reference_tree(cfg, state["v"]),
                               "step": state["step"]})
