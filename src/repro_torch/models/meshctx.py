"""The ambient mesh of the MoE's expert-parallel path.

Counterpart of ``repro.models.meshctx``: the caller sets the mesh before
it runs the model, and ``blocks.apply_moe`` reads it to choose the
``a2a`` path (``ModelConfig`` is a frozen, hashable dataclass and cannot
carry the mesh itself).  The port's mesh is a
``repro_torch.core.distributed.RankMesh``: one process a rank, each
holding its ``num_experts / P`` experts.
"""
from __future__ import annotations

from typing import Any, Optional

_MESH: Optional[Any] = None


def set_mesh(mesh) -> None:
    global _MESH
    _MESH = mesh


def get_mesh():
    return _MESH
