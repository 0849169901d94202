"""A model cut for one rank of a mesh, by the reference's ``ShardingRules``.

The reference lays its LM out over a device mesh with GSPMD: every leaf's
logical axes (``ParamSpec.axes``) go through ``cfg.sharding`` to mesh axes
(``valid_pspec``; heads, kv heads, d_ff, experts and vocab over
``"model"``, DeepSeek-V3's experts over ``("data", "model")``, the batch
over ``("pod", "data")``), and XLA inserts the collectives.  The port
runs one process a rank (``RankMesh``) and writes the collectives out.
:class:`Layout` says, for a rank at given coordinates, which part of each
leaf it holds (:func:`repro_torch.models.common.shard_spec` and
``shard_slice``, the reference's tiling), with one named difference:

- **the fused inputs** (:data:`FUSED_LEAVES`): the GLU FFN's ``ffn.w_in``
  [d, 2 ff] (SwiGLU, GeGLU; ``[gate | up]``), mLSTM's ``cell.w_up`` [d,
  2 m] (``[z | gate]``), sLSTM's ``cell.up`` [d, 2 ff] and the MoE's
  ``moe.shared_in`` [d, 2 ffs]: two halves laid side by side and split on
  ``d_ff``.  GSPMD gives device r the columns ``r 2ff / m`` to ``(r + 1)
  2ff / m``: a quarter of ``[a | b]`` at m 4, not a half of each.  A rank
  here holds ``[a_r | b_r]`` (columns ``r ff / m`` to ``(r + 1) ff / m``
  of each half), so that what pairs the halves runs on its own columns.
  It holds as many bytes as the device; the columns differ.

Where ``_divisible_entry`` falls back to replication (kv_heads 8 on a
16-way ``"model"``; RecurrentGemma's 10 heads on 4), the rank holds the
whole leaf, as the reference's layout says; attention then computes only
the kv heads its own q heads read (all of them, with no reduction, when
the q heads are replicated too), and its cache holds just those heads
(:meth:`Layout.attn_heads`).

Under a mesh the blocks run on the rank's shards (:class:`Part` on each
``blocks.Params``), each ending in a partial sum reduced through
``mesh.psum`` (gathered and added in float32 in rank order):

- attention and MLA on the rank's heads (MLA's latent, its norms,
  ``wq_a`` and ``wkv_a`` replicated: each rank computes the whole latent,
  and its cache holds it whole), one reduction after ``wo``;
- the FFN and sLSTM's post-FFN on the rank's ``d_ff`` columns, one
  reduction;
- the MoE: the router replicated, the experts split on ``expert``, the
  shared expert on ``d_ff``.  Under ``moe_impl="gather"`` every rank
  routes every token of the global batch (its rows gathered over the
  batch's axes first: capacity and slot positions are the reference's,
  over all tokens), runs its own experts' slots, and adds the shared
  expert's partial on its own rows; one reduction.  Under ``"a2a"``,
  where the sequence splits over ``"model"``, the layer takes the
  existing expert-parallel exchange (``blocks.apply_moe_a2a``), the
  shared expert's partial reduced after it;
- RG-LRU on the rank's ``d_ff`` columns (the input and gate projections,
  the conv, the recurrence and its cache); ``w_a`` / ``w_i`` split by
  rows, so both gates' pre-activations are one float32 reduction, of
  which the rank takes its columns; a second reduction after ``w_out``.
  The cache holds the rank's columns (the reference's layout replicates
  it);
- mLSTM: ``w_up`` as ``[z_r | gate_r]``, q, k, v and the gates from
  ``wq`` / ``wk`` / ``wv`` / ``w_if`` split by rows: one reduction of
  their partials; the cell runs whole on every rank (its state and cache
  whole, as the reference's layout has them), then the rank's columns of
  the normed output go through ``w_down``, one more reduction;
- sLSTM's cell whole on every rank (its weights replicated).

The embedding is vocab-parallel (ids outside the rank's rows masked, then
reduced), and the logits are the rank's vocab slice, gathered with the
batch (``lm.gather_logits``).  DeepSeek-V3's MTP leaves are laid out and
held; no serving step runs them.

Training (``lm.lm_loss`` under the mesh, ``launch.steps.make_train_step``
with ``mesh=``): the loss is vocab-parallel on the rank's rows, and the
backward goes through every collective by its adjoint
(``models.collectives``).  A replicated leaf that enters a rank's split
work (the kv heads a rank's q heads read, qk-norm's scales, RG-LRU's
``lam``, the MoE's router) sums its gradient over the axes of that split
inside the backward; after it, a leaf's gradient is partial only over the
batch's axes that it is not split over (:meth:`Layout.grad_axes`):
DeepSeek-V3's experts, split over ``("data", "model")``, see every row
through the MoE's gathered batch and take no sum.  The global norm sums
each leaf's squares over the axes it is split over
(:meth:`Layout.split_axes`), a replicated leaf counted once; the moments
lie on the rank's shards.
"""
from __future__ import annotations

import math
from typing import Dict, Mapping, NamedTuple, Optional, Tuple

from repro_torch.models.common import (
    ParamSpec, entry_names, entry_part, shard_slice, shard_spec,
)
from repro_torch.models.config import ModelConfig

# the leaves laid out as two halves side by side and split on d_ff, by
# (part, leaf): a rank holds [a_r | b_r] (module docstring)
FUSED_LEAVES = (("ffn", "w_in"), ("cell", "w_up"), ("cell", "up"),
                ("moe", "shared_in"))


def check_supported(cfg: ModelConfig) -> None:
    """Raise unless the steps of ``cfg`` (prefill, decode, train) run under
    a mesh: with rules that split neither the sequence nor ``d_model``."""
    split = [a for a in ("seq", "d_model", "kv_seq")
             if getattr(cfg.sharding, a) is not None]
    if split:
        raise NotImplementedError(
            f"{cfg.name}: ShardingRules split {split}; the port splits "
            f"heads, kv heads, experts, d_ff, the vocabulary and the batch "
            f"only")


def is_fused_glu(cfg: ModelConfig, name: str) -> bool:
    """Whether ``name`` is one of :data:`FUSED_LEAVES` (the FFN's input only
    of a GLU kind): the leaves whose rank columns differ from GSPMD's."""
    key = tuple(name.split(".")[-2:])
    return key in FUSED_LEAVES and not (key == ("ffn", "w_in")
                                        and cfg.ffn_kind == "gelu")


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
    """What a rank holds of one part of a layer (``attn``, ``ffn``,
    ``moe``, ``rec``, ``cell``) or of the vocabulary: ``reduce``, the mesh
    axes over which its output is a partial sum (or, for the vocabulary,
    split); ``q`` / ``kv``, the global q heads it holds and the kv heads
    they read (attention; MLA has no ``kv``); ``lo`` / ``n``, its rows of
    the vocabulary, its experts (MoE), or its ``d_ff`` columns (RG-LRU,
    mLSTM); ``experts`` / ``shared``, the mesh axes the MoE's experts and
    its shared expert's ``d_ff`` are split over; ``where``, the mesh's
    shape and the rank's coordinates it was cut for."""
    reduce: Tuple[str, ...]
    where: Tuple
    q: Optional[slice] = None
    kv: Optional[slice] = None
    lo: int = 0
    n: int = 0
    experts: Tuple[str, ...] = ()
    shared: Tuple[str, ...] = ()


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
        plan entry ``(name, s)``; a fused input as ``[a_r | b_r]`` (module
        docstring)."""
        sl = self.slices(s)
        if not is_fused_glu(self.cfg, name) or sl[1] == slice(0, s.shape[1]):
            return a[sl]
        index, parts = entry_part(self.spec(s)[1], self.shape, self.coords)
        ff = s.shape[1] // 2
        if ff % parts:
            raise ValueError(f"{name}: d_ff {ff} does not split into "
                             f"{parts} parts of each of its halves")
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

    def _split(self, plan, axis: str, leaves, what: str) -> Tuple:
        """(the mesh axes, the slice) of the rank's part of the logical
        ``axis`` of the first of ``leaves`` (names of a block's ``plan``);
        every other leaf must split its ``axis`` over the same mesh axes,
        or the layer's parts would not line up."""
        entries = [self.spec(plan[n])[plan[n].axes.index(axis)]
                   for n in leaves]
        live = [_live(e, self.shape) for e in entries]
        if len(set(live)) > 1:
            raise NotImplementedError(
                f"{self.cfg.name}: {what}'s leaves {list(leaves)} split "
                f"{axis} over {live} under {self.shape}")
        first = plan[leaves[0]]
        dim = first.shape[first.axes.index(axis)]
        return live[0], shard_slice((entries[0],), (dim,), self.shape,
                                    self.coords)[0]

    def mla_heads(self) -> Part:
        """MLA's q heads the rank holds (the ``heads`` entry of ``wq_b``,
        ``wk_b``, ``wv_b`` and ``wo``) and the axes ``wo``'s partial sum is
        reduced over; the latent is replicated."""
        from repro_torch.models.blocks import plan_mla
        live, q = self._split(plan_mla(self.cfg), "heads",
                              ("wq_b", "wk_b", "wv_b", "wo"), "MLA")
        return Part(live, self.where, q=q)

    def moe(self) -> Part:
        """The MoE's experts the rank holds (``lo`` / ``n``, the ``expert``
        entry of ``w_in`` and ``w_out``), the axes they split over, and
        those of the shared expert's ``d_ff``."""
        from repro_torch.models.blocks import plan_moe
        plan = plan_moe(self.cfg)
        experts, ex = self._split(plan, "expert", ("w_in", "w_out"), "MoE")
        shared = ()
        if "shared_out" in plan:
            shared, _ = self._split(plan, "d_ff", ("shared_out", "shared_in"),
                                    "the shared expert")
        reduce = tuple(a for a in self.shape if a in experts + shared)
        return Part(reduce, self.where, lo=ex.start, n=ex.stop - ex.start,
                    experts=experts, shared=shared)

    def rec(self) -> Part:
        """RG-LRU's ``d_ff`` columns the rank holds (``w_x``, ``w_gate``,
        the conv; the rows of ``w_a``, ``w_i`` and ``w_out``) and the axes
        its gates' and its output's partial sums are reduced over."""
        from repro_torch.models.blocks import plan_rglru
        live, cols = self._split(
            plan_rglru(self.cfg), "d_ff",
            ("w_a", "w_i", "w_x", "w_gate", "conv_w", "conv_b", "w_out"),
            "RG-LRU")
        return Part(live, self.where, lo=cols.start,
                    n=cols.stop - cols.start)

    def mlstm(self) -> Part:
        """mLSTM's ``d_ff`` columns the rank holds (of each half of
        ``w_up``; the rows of ``wq``, ``wk``, ``wv``, ``w_if`` and
        ``w_down``) and the axes their partial sums are reduced over."""
        from repro_torch.models.blocks import plan_mlstm
        live, cols = self._split(
            plan_mlstm(self.cfg), "d_ff",
            ("wq", "wk", "wv", "w_if", "w_down", "w_up"), "mLSTM")
        return Part(live, self.where, lo=cols.start,
                    n=cols.stop - cols.start)

    def slstm(self) -> Part:
        """sLSTM's post-FFN: the axes its output's partial sum is reduced
        over (the cell is replicated)."""
        from repro_torch.models.blocks import plan_slstm
        live, _ = self._split(plan_slstm(self.cfg), "d_ff", ("down", "up"),
                              "sLSTM's FFN")
        return Part(live, self.where)

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

    def split_axes(self, s: ParamSpec) -> Tuple[str, ...]:
        """The mesh axes (of more than one rank) that a leaf of plan entry
        ``s`` (``lm.plan_model``'s, at the whole shape) is split over, in
        the mesh's order."""
        names = {n for e in self.spec(s) for n in _live(e, self.shape)}
        return tuple(a for a in self.shape if a in names)

    def grad_axes(self, s: ParamSpec, rows: Tuple[str, ...]
                  ) -> Tuple[str, ...]:
        """The axes a leaf's gradient is summed over after the backward:
        of ``rows``, the axes a batch splits over (:meth:`rows`), those
        the leaf is not split over (module docstring)."""
        split = self.split_axes(s)
        return tuple(a for a in rows if a not in split)

    def param_bytes(self) -> int:
        """Bytes of the rank's parameters in ``cfg.param_dtype``."""
        import torch
        item = torch.empty((), dtype=self.cfg.dtype("param")).element_size()
        return sum(math.prod(s.shape) for s in self.plan().values()) * item
