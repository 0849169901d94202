"""A model cut for one rank of a mesh, by the reference's ``ShardingRules``.

The reference lays its LM out over a device mesh with GSPMD: every leaf's
logical axes (``ParamSpec.axes``) go through ``cfg.sharding`` to mesh axes
(``valid_pspec``; heads, kv heads, d_ff and vocab over ``"model"``, the
batch over ``("pod", "data")``), and XLA inserts the collectives.  The
port runs one process a rank (``RankMesh``) and writes the collectives
out.  :class:`Layout` says, for a rank at given coordinates, which part
of each leaf it holds (:func:`repro_torch.models.common.shard_spec` and
``shard_slice``, the reference's tiling), with one named difference:

- **the fused FFN input** ``ffn.w_in`` [d, 2 ff] of a GLU kind (SwiGLU,
  GeGLU), laid out ``[gate | up]`` and split on ``d_ff``.  GSPMD gives
  device r the columns ``r 2ff / m`` to ``(r + 1) 2ff / m``: a quarter of
  ``[gate | up]`` at m 4, not a half of each.  A rank here holds
  ``[gate_r | up_r]`` (columns ``r ff / m`` to ``(r + 1) ff / m`` of each
  half), so that the activation runs on its own columns.  It holds as
  many bytes as the device; the columns differ.

Where ``_divisible_entry`` falls back to replication (kv_heads 8 on a
16-way ``"model"``), the rank holds the whole leaf, as the reference's
layout says, and computes only the kv heads its own q heads read; its
attention cache holds just those heads (:meth:`Layout.attn_heads`).

Under a mesh the blocks run on the rank's shards (:class:`Part` on each
``blocks.Params``): attention on its heads, the FFN on its ``d_ff``
columns, each ending in a partial sum reduced over ``"model"``
(``mesh.psum``); the embedding is vocab-parallel (ids outside the rank's
rows masked, then reduced), and the logits are the rank's vocab slice,
gathered with the batch (``lm.gather_logits``).  Only the dense attention
kinds (``attn_dense``, ``attn_local``) and the FFN kinds are split; MLA,
the MoE's experts, RG-LRU, mLSTM and sLSTM under a mesh raise
(:func:`check_supported`), as does training under a mesh.
"""
from __future__ import annotations

import math
from typing import Dict, Mapping, NamedTuple, Optional, Tuple

from repro_torch.models.common import (
    ParamSpec, entry_names, entry_part, shard_slice, shard_spec,
)
from repro_torch.models.config import ModelConfig

# the block kinds a mesh splits; the others raise under a mesh
SHARDED_KINDS = ("attn_dense", "attn_local")
KINDS_ITEM = ("the MLA, MoE, RG-LRU, mLSTM and sLSTM layers under a "
              "\"model\" split are ROADMAP.md item 31")
TRAIN_ITEM = ("training under a mesh (the vocab-parallel loss, the "
              "gradients reduced over \"data\") is ROADMAP.md item 32")


def check_supported(cfg: ModelConfig, kind: str = "prefill") -> None:
    """Raise unless a step of ``kind`` (``prefill``, ``decode``, ``train``)
    of ``cfg`` runs under a mesh: serving the dense attention kinds."""
    if kind == "train":
        raise NotImplementedError(f"{cfg.name}: {TRAIN_ITEM}")
    split = [a for a in ("seq", "d_model", "kv_seq")
             if getattr(cfg.sharding, a) is not None]
    if split:
        raise NotImplementedError(
            f"{cfg.name}: ShardingRules split {split}; the port splits "
            f"heads, kv heads, d_ff, the vocabulary and the batch only")
    other = sorted(set(cfg.layer_kinds) - set(SHARDED_KINDS))
    if other or cfg.mtp:
        raise NotImplementedError(
            f"{cfg.name} has {other or ['mtp']} layers: {KINDS_ITEM}; the "
            f"port splits only {SHARDED_KINDS} and the FFN over a mesh")


def is_fused_glu(cfg: ModelConfig, name: str) -> bool:
    """Whether ``name`` is a fused ``[gate | up]`` FFN input (the one leaf
    whose rank columns differ from GSPMD's)."""
    return name.endswith("ffn.w_in") and cfg.ffn_kind != "gelu"


def fix_rules_for_mesh(cfg: ModelConfig, mesh_shape: Mapping[str, int]
                       ) -> ModelConfig:
    """The reference dry-run's batch rule (``_fix_rules_for_mesh``): a
    mesh without a ``"pod"`` axis splits the batch over the others."""
    import dataclasses
    if "pod" in mesh_shape:
        return cfg
    rules = cfg.sharding
    return cfg.replace(sharding=dataclasses.replace(
        rules, batch=tuple(a for a in rules.batch if a != "pod")))


class Part(NamedTuple):
    """What a rank holds of one part of a layer (``attn``, ``ffn``) or of
    the vocabulary: ``reduce``, the mesh axes over which its output is a
    partial sum (or, for the vocabulary, split); ``q`` / ``kv``, the
    global q heads it holds and the kv heads they read (attention);
    ``lo`` / ``n``, its rows of the vocabulary; ``where``, the mesh's
    shape and the rank's coordinates it was cut for."""
    reduce: Tuple[str, ...]
    where: Tuple
    q: Optional[slice] = None
    kv: Optional[slice] = None
    lo: int = 0
    n: int = 0


def where_of(mesh) -> Tuple:
    """A mesh's shape and its rank's coordinates, as ``Part.where``."""
    return (tuple((a, int(n)) for a, n in mesh.shape.items()),
            tuple((a, int(mesh.coords[a])) for a in mesh.shape))


def _live(entry, mesh_shape: Mapping[str, int]) -> Tuple[str, ...]:
    """A spec entry's axes that the mesh has with more than one rank."""
    return tuple(n for n in entry_names(entry) if mesh_shape.get(n, 1) > 1)


class Layout:
    """The rank at ``coords`` of a mesh of ``mesh_shape``, for ``cfg``."""

    def __init__(self, cfg: ModelConfig, mesh_shape: Mapping[str, int],
                 coords: Mapping[str, int]):
        self.cfg = cfg
        self.shape = {a: int(n) for a, n in mesh_shape.items()}
        self.coords = {a: int(coords[a]) for a in self.shape}
        self.where = (tuple(self.shape.items()), tuple(self.coords.items()))

    @classmethod
    def of(cls, cfg: ModelConfig, mesh) -> "Layout":
        """The layout of ``mesh``'s own rank (a ``RankMesh`` or a
        ``launch.mesh.MetaMesh``)."""
        return cls(cfg, mesh.shape, mesh.coords)

    def matches(self, mesh) -> bool:
        return mesh is not None and where_of(mesh) == self.where

    # -- leaves --------------------------------------------------------------
    def spec(self, s: ParamSpec) -> Tuple:
        return shard_spec(self.cfg.sharding, s.axes, s.shape, self.shape)

    def slices(self, s: ParamSpec) -> Tuple[slice, ...]:
        return shard_slice(self.spec(s), s.shape, self.shape, self.coords)

    def local_shape(self, s: ParamSpec) -> Tuple[int, ...]:
        return tuple(sl.stop - sl.start for sl in self.slices(s))

    def plan(self) -> Dict[str, ParamSpec]:
        """``lm.plan_model`` with every leaf at the rank's shape."""
        from repro_torch.models import lm
        return {n: s._replace(shape=self.local_shape(s))
                for n, s in lm.plan_model(self.cfg).items()}

    def take(self, name: str, s: ParamSpec, a):
        """The rank's part of the whole leaf ``a`` (a tensor or an array) of
        plan entry ``(name, s)``; a fused GLU input as ``[gate_r | up_r]``
        (module docstring)."""
        sl = self.slices(s)
        if not is_fused_glu(self.cfg, name) or sl[1] == slice(0, s.shape[1]):
            return a[sl]
        index, parts = entry_part(self.spec(s)[1], self.shape, self.coords)
        ff = s.shape[1] // 2
        if ff % parts:
            raise ValueError(f"{name}: d_ff {ff} does not split into "
                             f"{parts} parts of each of gate and up")
        n = ff // parts
        gate = a[sl[0], index * n:(index + 1) * n]
        up = a[sl[0], ff + index * n:ff + (index + 1) * n]
        if hasattr(gate, "new_empty"):
            import torch
            return torch.cat([gate, up], dim=1)
        import numpy as np
        return np.concatenate([gate, up], axis=1)

    # -- what the blocks read ------------------------------------------------
    def attn_heads(self) -> Part:
        """The q heads the rank holds (the ``heads`` entry of ``wq``), the kv
        heads they read, and the axes ``wo``'s partial sum is reduced over.
        Where ``kv_heads`` is split the rank holds exactly those kv heads;
        where it falls back to replicated, the rank holds every kv head and
        reads only ``q // rep`` of its own q heads.  A split whose q heads do
        not read their kv heads in equal groups raises."""
        cfg, mesh_shape, coords = self.cfg, self.shape, self.coords
        h, kh, hd, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_model
        rules = cfg.sharding
        q_entry = shard_spec(rules, ("d_model", "heads", None), (d, h, hd),
                             mesh_shape)[1]
        k_entry = shard_spec(rules, ("d_model", "kv_heads", None), (d, kh, hd),
                             mesh_shape)[1]
        q = shard_slice((q_entry,), (h,), mesh_shape, coords)[0]
        rep = h // kh
        kv = slice(q.start // rep, (q.stop - 1) // rep + 1)
        if entry_names(k_entry):
            held = shard_slice((k_entry,), (kh,), mesh_shape, coords)[0]
            if held != kv:
                raise NotImplementedError(
                    f"{cfg.name}: q heads {q} read kv heads {kv}, but the "
                    f"rank holds kv heads {held} under {mesh_shape}")
        h_loc, k_loc = q.stop - q.start, kv.stop - kv.start
        group = h_loc // k_loc
        if h_loc % k_loc or any((q.start + i) // rep - kv.start != i // group
                                for i in range(h_loc)):
            raise NotImplementedError(
                f"{cfg.name}: q heads {q} do not read kv heads {kv} in equal "
                f"groups under {mesh_shape}")
        return Part(_live(q_entry, mesh_shape), self.where, q=q, kv=kv)

    def ffn(self, d_ff: int) -> Part:
        """The axes the rank's FFN output is summed over (the ``d_ff`` entry
        of ``w_out``)."""
        cfg = self.cfg
        entry = shard_spec(cfg.sharding, ("d_ff", "d_model"),
                           (d_ff, cfg.d_model), self.shape)[0]
        return Part(_live(entry, self.shape), self.where)

    def vocab(self) -> Part:
        """The rank's rows of the vocabulary (of ``embed`` [V, d] and of
        ``head`` [d, V], split alike) and the axes they are split over."""
        cfg = self.cfg
        entry = shard_spec(cfg.sharding, ("vocab",), (cfg.vocab,),
                           self.shape)[0]
        sl = shard_slice((entry,), (cfg.vocab,), self.shape, self.coords)[0]
        return Part(_live(entry, self.shape), self.where, lo=sl.start,
                    n=sl.stop - sl.start)

    def rows(self, batch: int) -> Tuple[slice, Tuple[str, ...]]:
        """The rank's rows of a batch of ``batch`` and the mesh axes the
        batch is split over (``("batch", ...)`` under the rules)."""
        entry = shard_spec(self.cfg.sharding, ("batch",), (batch,),
                           self.shape)[0]
        sl = shard_slice((entry,), (batch,), self.shape, self.coords)[0]
        return sl, _live(entry, self.shape)

    def param_bytes(self) -> int:
        """Bytes of the rank's parameters in ``cfg.param_dtype``."""
        import torch
        item = torch.empty((), dtype=self.cfg.dtype("param")).element_size()
        return sum(math.prod(s.shape) for s in self.plan().values()) * item
