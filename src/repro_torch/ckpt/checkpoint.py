"""Checkpointing: atomic, manifest-driven, keep-k rolling.

Counterpart of ``repro.ckpt.checkpoint``, writing its on-disk format, so
that a checkpoint of either package restores in the other:

  <root>/step_00000010.tmp/  -> written, fsynced, then renamed to
  <root>/step_00000010/
      manifest.json         step, leaf keys, dtypes, user metadata
      arrays.npz            flattened leaves keyed by path

A tree is nested dicts and lists of tensors or numpy arrays.  Leaves are
visited as ``jax.tree`` visits them (dict keys sorted, lists in order), and
a leaf's key is its path joined by ``/`` (``params/body/b0_attn_dense/
attn/wq``); bfloat16 is stored as its uint16 patterns with ``bfloat16``
in the manifest, as the reference does.  :func:`restore_pytree` takes a
target device in place of the reference's shardings and rebuilds the tree
from the keys (an all-digit key is a list index).
"""
from __future__ import annotations

import json
import os
import shutil
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch


def _flatten(tree, path: str, out: Dict[str, np.ndarray],
             dtypes: Dict[str, str]) -> None:
    if isinstance(tree, dict):
        for k in sorted(tree):
            _flatten(tree[k], f"{path}/{k}" if path else str(k), out, dtypes)
        return
    if isinstance(tree, (list, tuple)):
        for i, sub in enumerate(tree):
            _flatten(sub, f"{path}/{i}" if path else str(i), out, dtypes)
        return
    if isinstance(tree, torch.Tensor):
        t = tree.detach().cpu()
        if t.dtype == torch.bfloat16:    # npz has no bf16: store raw bits
            dtypes[path] = "bfloat16"
            out[path] = t.view(torch.uint16).numpy()
            return
        a = t.numpy()
    else:
        a = np.asarray(tree)
    dtypes[path] = str(a.dtype)
    out[path] = a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def save_pytree(root: str, step: int, tree, metadata: Optional[Dict] = None,
                keep: int = 3) -> Path:
    root_p = Path(root)
    root_p.mkdir(parents=True, exist_ok=True)
    final = root_p / f"step_{step:08d}"
    tmp = root_p / f"step_{step:08d}.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    flat: Dict[str, np.ndarray] = {}
    dtypes: Dict[str, str] = {}
    _flatten(tree, "", flat, dtypes)
    np.savez(tmp / "arrays.npz", **flat)
    manifest = {
        "step": step,
        "keys": list(flat.keys()),
        "dtypes": dtypes,
        "metadata": metadata or {},
    }
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    # fsync before the atomic publish
    fd = os.open(tmp / "manifest.json", os.O_RDONLY)
    os.fsync(fd)
    os.close(fd)
    if final.exists():
        shutil.rmtree(final)
    os.rename(tmp, final)
    _gc(root_p, keep)
    return final


def _gc(root: Path, keep: int):
    steps = sorted(p for p in root.glob("step_????????") if p.is_dir())
    for p in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(p, ignore_errors=True)


def latest_step(root: str) -> Optional[int]:
    root_p = Path(root)
    if not root_p.exists():
        return None
    steps = sorted(root_p.glob("step_????????"))
    if not steps:
        return None
    return int(steps[-1].name.split("_")[1])


def _insert(tree: Dict[str, Any], parts, leaf) -> None:
    node = tree
    for p in parts[:-1]:
        node = node.setdefault(p, {})
    node[parts[-1]] = leaf


def _lists(node):
    """Dicts whose keys are all digits become lists, in index order."""
    if not isinstance(node, dict):
        return node
    node = {k: _lists(v) for k, v in node.items()}
    if node and all(k.isdigit() for k in node):
        return [node[k] for k in sorted(node, key=int)]
    return node


def restore_pytree(root: str, step: int, device=None
                   ) -> Tuple[Dict[str, Any], Dict]:
    """(tree of tensors on ``device`` (the CPU when None), metadata)."""
    d = Path(root) / f"step_{step:08d}"
    manifest = json.loads((d / "manifest.json").read_text())
    tree: Dict[str, Any] = {}
    with np.load(d / "arrays.npz") as arrays:
        for k in manifest["keys"]:
            t = torch.from_numpy(np.array(arrays[k]))
            if manifest.get("dtypes", {}).get(k) == "bfloat16":
                t = t.view(torch.bfloat16)
            _insert(tree, k.split("/"),
                    t if device is None else t.to(device))
    return _lists(tree), manifest["metadata"]


class CheckpointManager:
    """Keep-k rolling checkpoints with resume support."""

    def __init__(self, root: str, keep: int = 3, every: int = 50):
        self.root = root
        self.keep = keep
        self.every = every

    def maybe_save(self, step: int, tree, metadata=None) -> bool:
        """Saves at every ``every``-th step.  ``tree`` may be a callable
        that builds it, called only when a save is due (the trainer's
        host copy of its state)."""
        if step % self.every != 0:
            return False
        save_pytree(self.root, step, tree() if callable(tree) else tree,
                    metadata, self.keep)
        return True

    def resume(self, device=None):
        """(step, tree, metadata) of the newest checkpoint, or Nones."""
        s = latest_step(self.root)
        if s is None:
            return None, None, None
        tree, meta = restore_pytree(self.root, s, device)
        return s, tree, meta
