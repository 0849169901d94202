"""The port's layout of the LM over a mesh against the reference's GSPMD
layout, what a rank of each block kind holds, and the dry-run of one
rank of the reference's meshes on ``meta``.

Layout, pure and fast: for all ten archs' full configs, every leaf's
``shard_spec`` equals ``repro.models.common.valid_pspec`` at the 16 x 16,
2 x 16 x 16 and host-8 (2 x 4) meshes.  ``valid_pspec`` reads only a
mesh's ``axis_names`` and ``devices.shape``, so it is given a stand-in
with ``devices = np.empty(shape)`` and no devices are made.  The port's
body leaves are unstacked (``layers.<i>``): their axes are the
reference's minus its leading ``cycles`` axis.  Each leaf's bytes on a
rank equal the reference's shard's; the one named difference is the
fused inputs (``ffn.w_in`` of a GLU kind, mLSTM's ``w_up``, sLSTM's
``up``, the MoE's ``shared_in``), whose rank holds ``[a_r | b_r]`` where
GSPMD gives a device the contiguous columns ``r 2ff / m`` on (as many of
them).

The dry-run: Qwen3-1.7B's prefill_32k at ``pod16x16`` on ``meta``, one
rank: ``devices`` 256, ``argument_size`` the layout's parameter bytes
plus the batch's, ``coll`` the closed form of ``launch.dryrun``'s
docstring, and ``roofline.analyze`` reads a collective term over
``LINK_BW``.  A train cell of Qwen3-1.7B at full width cut to 2 layers
at that mesh: its parameter and moment bytes the layout's, its
gradients' reduction one all-reduce of the bytes of the leaves summed
over ``"data"``, its forward's collectives in closed form; the train
cells of the four archs below likewise.  The serving cells of
DeepSeek-V3, Llama 4 Scout, RecurrentGemma 2B and xLSTM 125M at both
meshes, at one cycle's depth (and one cell of each at its full depth):
rank 0's parameter bytes equal the reference's shards' and
``Layout.param_bytes``, its arguments those and its inputs', and its
collective bytes by kind each block kind's closed form (the MoE's rows
gathered over the batch's axes among them).
"""
import math

import numpy as np
import pytest

import repro.configs as JC
from repro.models import lm as jlm
from repro.models.common import ParamSpec as JParamSpec, valid_pspec

import repro_torch.configs as TC
from repro_torch.launch import dryrun, mesh, roofline
from repro_torch.launch.steps import batch_specs
from repro_torch.models import lm as tlm
from repro_torch.models.config import SHAPES, ShapeCell
from repro_torch.models.shard import (
    Layout, check_supported, fix_rules_for_mesh, is_fused_glu,
)

MESHES = {"pod16x16": mesh.PRODUCTION, "pod2x16x16": mesh.MULTI_POD,
          "host8": mesh.host_mesh_shape(8)}
DENSE = ("gemma2_9b", "qwen3_1_7b", "mistral_nemo_12b", "stablelm_12b",
         "chameleon_34b", "hubert_xlarge")


class _Mesh:
    """What ``valid_pspec`` reads of a ``jax.sharding.Mesh``."""

    def __init__(self, shape):
        self.axis_names = tuple(shape)
        self.devices = np.empty(tuple(shape.values()))


def _ref_specs(jcfg, mesh_shape):
    """The reference's pspec of every leaf, under the port's flat names
    (body leaves unstacked: the leading cycles entry dropped)."""
    fake = _Mesh(mesh_shape)
    plan = jlm.plan_model(jcfg)
    out = {}

    def walk(node, path, body):
        if isinstance(node, JParamSpec):
            p = tuple(valid_pspec(jcfg.sharding, node.axes, node.shape, fake))
            out[path] = (p[1:], node.shape[1:]) if body else (p, node.shape)
        elif isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{path}.{k}" if path else k, body)
        else:
            for i, v in enumerate(node):
                walk(v, f"{path}.{i}", body)

    for key in ("embed", "final_norm", "head", "mtp_proj", "mtp_norm"):
        if key in plan:
            walk(plan[key], key, False)
    if "mtp_block" in plan:
        walk(plan["mtp_block"], "mtp_block", False)
    n_pre, width = len(jcfg.prefix_blocks), len(jcfg.block_pattern)
    for i, blk in enumerate(plan["prefix"]):
        walk(blk, f"layers.{i}", False)
    for k, kind in enumerate(jcfg.block_pattern):
        if jcfg.cycles:
            for c in range(jcfg.cycles):
                walk(plan["body"][f"b{k}_{kind}"],
                     f"layers.{n_pre + c * width + k}", True)
    base = n_pre + jcfg.cycles * width
    for j, blk in enumerate(plan["rem"]):
        walk(blk, f"layers.{base + j}", False)
    return out


def _parts(entry, mesh_shape):
    names = () if entry is None else (
        entry if isinstance(entry, tuple) else (entry,))
    return math.prod(mesh_shape.get(n, 1) for n in names)


@pytest.mark.parametrize("where", sorted(MESHES))
@pytest.mark.parametrize("arch", TC.ARCHS)
def test_layout_equals_valid_pspec(arch, where):
    """Every leaf's spec equals the reference's; its bytes on ranks 0 and
    the last equal the device's shard's, and ``w_in`` of a GLU FFN holds
    ``[gate_r | up_r]`` (as many columns as GSPMD's, other ones)."""
    shape = MESHES[where]
    tcfg, jcfg = TC.get(arch), JC.get(arch)
    ref = _ref_specs(jcfg, shape)
    plan = tlm.plan_model(tcfg)
    assert sorted(plan) == sorted(ref)
    world = math.prod(shape.values())
    from repro_torch.core.distributed import coords_of
    for rank in (0, world - 1):
        layout = Layout(tcfg, shape, coords_of(shape, rank))
        fused = 0
        for name, s in plan.items():
            spec, jshape = ref[name]
            assert tuple(s.shape) == tuple(jshape), name
            assert layout.spec(s) == spec, (name, layout.spec(s), spec)
            want = [d // _parts(e, shape) for e, d in zip(spec, s.shape)]
            assert list(layout.local_shape(s)) == want, name
            if not is_fused_glu(tcfg, name) or _parts(spec[1], shape) == 1:
                continue
            fused += 1
            cols = layout.take(name, s, np.arange(s.shape[1])[None])[0]
            sl = layout.slices(s)[1]
            assert cols.size == sl.stop - sl.start == want[1]
            ff, n = s.shape[1] // 2, want[1] // 2
            lo = cols[0]
            assert (cols[:n] == np.arange(lo, lo + n)).all()
            assert (cols[n:] == cols[:n] + ff).all()
            assert not (cols == np.arange(sl.start, sl.stop)).all()
        split = any(_parts(ref[n][0][1], shape) > 1 for n in plan
                    if is_fused_glu(tcfg, n))
        assert (fused > 0) == split


def test_kv_heads_fall_back_and_read_their_own():
    """kv_heads 8 on a 16-way ``"model"``: the whole leaf on every rank,
    and each rank reads the one kv head of its q head; at 4 ranks the kv
    heads split two a rank."""
    cfg = TC.get("gemma2_9b")
    from repro_torch.core.distributed import coords_of
    for r in range(16):
        part = Layout(cfg, mesh.PRODUCTION,
                      coords_of(mesh.PRODUCTION, r)).attn_heads()
        assert part.q == slice(r, r + 1)
        assert part.kv == slice(r // 2, r // 2 + 1)
        assert part.reduce == ("model",)
    wk = tlm.plan_model(cfg)["layers.0.attn.wk"]
    assert Layout(cfg, mesh.PRODUCTION, coords_of(mesh.PRODUCTION, 5)
                  ).local_shape(wk) == wk.shape
    part = Layout(cfg, {"model": 4}, {"model": 3}).attn_heads()
    assert (part.q, part.kv) == (slice(12, 16), slice(6, 8))


def test_dryrun_one_rank_of_pod16x16():
    """Qwen3-1.7B prefill_32k on rank 0 of 16 x 16: devices, the
    parameter and batch bytes, the closed-form collectives, the
    roofline's collective term; ``--all`` at a mesh counts all 31 cells,
    the train cells among them."""
    arch = "qwen3_1_7b"
    cfg, cell = TC.get(arch), SHAPES["prefill_32k"]
    rec = dryrun.dryrun(cfg, cell, arch=arch, mesh="pod16x16")
    assert (rec["mesh"], rec["devices"]) == ("pod16x16", 256)
    full = rec["full"]
    fixed = fix_rules_for_mesh(cfg, mesh.PRODUCTION)
    layout = Layout(fixed, mesh.PRODUCTION, {"data": 0, "model": 0})
    batch = dryrun.storage_bytes(batch_specs(cfg, cell))
    assert full["memory"]["argument_size"] == layout.param_bytes() + batch
    ref = _ref_specs(JC.get(arch), mesh.PRODUCTION)
    assert layout.param_bytes() == 2 * sum(
        math.prod(d // _parts(e, mesh.PRODUCTION) for e, d in zip(*r))
        for r in ref.values())
    b_r, s, d = cell.global_batch // 16, cell.seq_len, cfg.d_model
    v, b = cfg.vocab, 2
    assert full["coll"] == {
        "all-reduce": (2 * cfg.n_layers + 1) * b_r * s * d * b,
        "all-gather": b_r * v * b + cell.global_batch * v * b}
    a = roofline.analyze(rec)
    assert a["t_collective_s"] == sum(full["coll"].values()) / mesh.LINK_BW
    assert a["t_collective_s"] > 0 and a["t_memory_s"] > 0
    assert dryrun.mesh_cells() == TC.all_cells()
    assert len(dryrun.mesh_cells()) == 31
    assert sum(SHAPES[c].kind == "train" for _, c in dryrun.mesh_cells()) \
        == len(TC.ARCHS)


def test_dryrun_train_cell_at_pod16x16():
    """Rank 0 of 16 x 16 training Qwen3-1.7B at full width cut to 2
    layers, B 32 x S 64 (2 rows a rank), on ``meta``: its parameter and
    moment bytes are ``Layout.param_bytes()`` and two float32 copies of
    its shards, its arguments those, AdamW's step and the batch; the
    gradients' reduction is one all-reduce of the bytes of the rank's
    shards of the leaves summed over ``"data"`` (every leaf: none is
    split over it), the norm's one float32 scalar over ``"model"``; the
    forward's collectives in closed form (the embedding and each layer's
    two reductions; the loss's sum of exponentials and gold logit, its
    max over the vocabulary's 16 slices, the reported loss over
    ``"data"``); the backward's at least the forward's again (remat
    full)."""
    from repro_torch.models.config import ShapeCell
    arch = "qwen3_1_7b"
    cfg = TC.get(arch).replace(n_layers=2)
    cell = ShapeCell("train_cut", 64, 32, "train")
    rec = dryrun.dryrun(cfg, cell, arch=arch, mesh="pod16x16")
    full = rec["full"]
    fixed = fix_rules_for_mesh(cfg, mesh.PRODUCTION)
    layout = Layout(fixed, mesh.PRODUCTION, {"data": 0, "model": 0})
    plan = tlm.plan_model(fixed)
    local = layout.plan()
    elems = sum(math.prod(s.shape) for s in local.values())
    assert full["state_bytes"] == {"params": layout.param_bytes(),
                                   "moments": 2 * 4 * elems}
    batch = dryrun.storage_bytes(batch_specs(cfg, cell))
    assert full["memory"]["argument_size"] == layout.param_bytes() + \
        2 * 4 * elems + 4 + batch
    rows, axes = layout.rows(cell.global_batch)
    assert axes == ("data",)
    summed = [n for n, s in plan.items() if layout.grad_axes(s, axes)]
    assert summed == list(plan)
    phases = full["coll_phases"]
    assert phases["grads"] == {
        "all-reduce": 2 * sum(math.prod(local[n].shape) for n in summed),
        "all-gather": 0}
    assert phases["update"] == {"all-reduce": 4, "all-gather": 0}
    b_r, s, d = rows.stop - rows.start, cell.seq_len, cfg.d_model
    assert phases["forward"] == {
        "all-reduce": (2 * cfg.n_layers + 1) * b_r * s * d * 2
        + 2 * b_r * s * 4 + 4,
        "all-gather": 16 * b_r * s * 4}
    assert phases["backward"]["all-reduce"] > \
        phases["forward"]["all-reduce"]
    assert sum(sum(p.values()) for p in phases.values()) == \
        sum(full["coll"].values())
    a = roofline.analyze(rec)
    assert a["t_collective_s"] == sum(full["coll"].values()) / mesh.LINK_BW


def test_a_cut_model_refuses_what_it_cannot_run():
    """A smoke Gemma 2 cut for rank 1 of ``{"data": 2, "model": 2}``: the
    steps without that mesh, the forward outside it and the loss outside
    it raise; a config whose rules split ``d_model`` raises under a
    mesh."""
    import dataclasses
    import torch
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models.config import smoke_config
    cfg = smoke_config(TC.get("gemma2_9b")).replace(param_dtype="float32",
                                                   compute_dtype="float32")
    where = mesh.MetaMesh({"data": 2, "model": 2}, rank=1)
    model = tlm.init_params(cfg, torch.Generator(), "cpu", mesh=where)
    assert model.layout.coords == {"data": 0, "model": 1}
    assert tuple(model.embed.shape) == (cfg.vocab // 2, cfg.d_model)
    toks = np.zeros((2, 4), np.int32)
    with pytest.raises(ValueError, match="made without a mesh"):
        make_prefill_step(cfg, "cpu")(model, {"inputs": toks})
    with pytest.raises(ValueError, match="shards for the mesh"):
        tlm.forward(cfg, model, torch.from_numpy(toks))
    with pytest.raises(ValueError, match="shards for the mesh"):
        tlm.lm_loss(cfg, model, {"inputs": torch.from_numpy(toks),
                                 "targets": torch.from_numpy(toks),
                                 "mask": torch.ones((2, 4), dtype=bool)})
    with pytest.raises(ValueError, match="not cut for that rank"):
        make_prefill_step(cfg, "cpu", mesh.MetaMesh({"data": 2, "model": 2}))(
            model, {"inputs": toks})
    split = cfg.replace(sharding=dataclasses.replace(cfg.sharding,
                                                     d_model="model"))
    with pytest.raises(NotImplementedError, match="d_model"):
        check_supported(split)


NEW = ("deepseek_v3_671b", "llama4_scout_17b_a16e", "recurrentgemma_2b",
       "xlstm_125m")


@pytest.mark.parametrize("arch", TC.ARCHS)
def test_check_supported_serves_every_arch(arch):
    """Serving and training pass for all ten archs, and rules that split
    the sequence, ``d_model`` or the cache's sequence raise."""
    import dataclasses
    cfg = TC.get(arch)
    check_supported(cfg)
    for axis in ("seq", "d_model", "kv_seq"):
        split = cfg.replace(sharding=dataclasses.replace(cfg.sharding,
                                                         **{axis: "model"}))
        with pytest.raises(NotImplementedError, match=axis):
            check_supported(split)


@pytest.mark.parametrize("arch", NEW)
def test_parts_at_pod16x16(arch):
    """What ranks 0, 17 and 255 of 16 x 16 hold of each block kind:
    DeepSeek-V3's MLA 8 of 128 heads and 1 of 256 experts over ("data",
    "model"); Llama 4 Scout's 40 q and 8 kv heads replicated (no
    reduction), 1 of 16 experts over "model"; RecurrentGemma's 10 heads
    replicated, 160 of 2,560 RG-LRU columns; xLSTM's mLSTM 96 of 1,536
    columns, sLSTM's FFN split; every fused input split."""
    from repro_torch.core.distributed import coords_of
    cfg = fix_rules_for_mesh(TC.get(arch), mesh.PRODUCTION)
    for r in (0, 17, 255):
        c = coords_of(mesh.PRODUCTION, r)
        layout = Layout(cfg, mesh.PRODUCTION, c)
        m = c["model"]
        if arch == "deepseek_v3_671b":
            part = layout.mla_heads()
            assert (part.q, part.kv, part.reduce) == (
                slice(8 * m, 8 * m + 8), None, ("model",))
            moe = layout.moe()
            assert (moe.lo, moe.n) == (16 * c["data"] + m, 1)
            assert (moe.experts, moe.shared, moe.reduce) == (
                ("data", "model"), ("model",), ("data", "model"))
        if arch == "llama4_scout_17b_a16e":
            part = layout.attn_heads()
            assert (part.q, part.kv, part.reduce) == (slice(0, 40),
                                                      slice(0, 8), ())
            moe = layout.moe()
            assert (moe.lo, moe.n, moe.experts, moe.reduce) == (
                m, 1, ("model",), ("model",))
        if arch == "recurrentgemma_2b":
            part = layout.attn_heads()
            assert (part.q, part.kv, part.reduce) == (slice(0, 10),
                                                      slice(0, 1), ())
            rec = layout.rec()
            assert (rec.lo, rec.n, rec.reduce) == (160 * m, 160, ("model",))
        if arch == "xlstm_125m":
            cell = layout.mlstm()
            assert (cell.lo, cell.n, cell.reduce) == (96 * m, 96, ("model",))
            assert layout.slstm().reduce == ("model",)
        plan = tlm.plan_model(cfg)
        for name, s in plan.items():
            if is_fused_glu(cfg, name):
                assert layout.local_shape(s)[1] == s.shape[1] // 16, name
        assert sum(is_fused_glu(cfg, n) for n in plan) > 0


def _coll_want(arch, cfg, cell, shape, rows):
    """Rank 0's collective bytes by kind at ``cell`` on a mesh of ``shape``
    in closed form, ``rows`` its rows of the batch (b_r): the embedding's
    reduction, each block kind's (attention and MLA one where their heads
    split, none where they are replicated; the FFN one; RG-LRU its gates'
    float32 [b_r, S, 2 R] and its output; mLSTM its q, k, v and gates'
    float32 [b_r, S, 3 m + 2 H] and its output; the MoE its rows gathered
    over the batch's axes and one reduction of the whole batch's output),
    then the logits' vocab slices and rows."""
    b_r = rows.stop - rows.start
    big_b, s = cell.global_batch, cell.seq_len if cell.kind == "prefill" \
        else 1
    d, v, b = cfg.d_model, cfg.vocab, 2
    b_l = 2 if cell.kind == "prefill" else 4
    tok, glob = b_r * s * d * b, big_b * s * d * b
    kinds = cfg.layer_kinds
    n = {k: kinds.count(k) for k in set(kinds)}
    gather = b_r * v * b_l + (big_b * v * b_l if b_r < big_b else 0)
    if arch == "deepseek_v3_671b":
        moe = n["attn_moe"]
        return {"all-reduce": (1 + cfg.n_layers + n["mla_dense"]) * tok
                + moe * glob, "all-gather": moe * glob + gather}
    if arch == "llama4_scout_17b_a16e":
        moe = n["attn_moe"]
        return {"all-reduce": tok + moe * glob,
                "all-gather": moe * glob + gather}
    if arch == "recurrentgemma_2b":
        r = cfg.rglru.d_rnn
        return {"all-reduce": (1 + cfg.n_layers + n["rec"]) * tok
                + n["rec"] * b_r * s * 2 * r * 4, "all-gather": gather}
    m, h = 2 * d, cfg.n_heads
    return {"all-reduce": (1 + cfg.n_layers) * tok
            + n["mlstm"] * b_r * s * (3 * m + 2 * h) * 4,
            "all-gather": gather}


def _check_serving_cell(arch, shape, where, cut):
    """Rank 0 of ``arch``'s serving cell ``shape`` at mesh ``where`` on
    ``meta`` (``cut``: at one cycle's depth, the prefix and one pass of
    ``block_pattern`` but at least 2 layers, the depth of the reference's
    ``smoke_config``): its parameter
    bytes equal the reference's device shards' and ``Layout.param_bytes``,
    its arguments those and its inputs' (the batch, or the caches and the
    tokens), its collective bytes each kind's closed form."""
    from repro_torch.launch.steps import decode_specs
    shape_of = mesh.MESHES[where]
    tcfg, jcfg = TC.get(arch), JC.get(arch)
    if cut:
        n = max(len(tcfg.block_pattern) + len(tcfg.prefix_blocks), 2)
        tcfg, jcfg = tcfg.replace(n_layers=n), jcfg.replace(n_layers=n)
    cfg, cell = fix_rules_for_mesh(tcfg, shape_of), SHAPES[shape]
    rec = dryrun.dryrun(tcfg, cell, arch=arch, mesh=where)
    assert (rec["mesh"], rec["devices"]) == (where,
                                             math.prod(shape_of.values()))
    full = rec["full"]
    layout = Layout(cfg, shape_of, {a: 0 for a in shape_of})
    ref = _ref_specs(jcfg, shape_of)
    assert layout.param_bytes() == 2 * sum(
        math.prod(d // _parts(e, shape_of) for e, d in zip(*r))
        for r in ref.values())
    inputs = batch_specs(cfg, cell) if cell.kind == "prefill" else \
        decode_specs(cfg, cell, mesh=mesh.MetaMesh(shape_of))
    assert full["memory"]["argument_size"] == layout.param_bytes() + \
        dryrun.storage_bytes(inputs)
    want = _coll_want(arch, cfg, cell, shape_of,
                      layout.rows(cell.global_batch)[0])
    assert {k: int(v) for k, v in full["coll"].items()} == want


def _check_train_cell(arch, where):
    """Rank 0 of ``arch``'s train_4k at mesh ``where`` on ``meta``, at one
    cycle's depth (as :func:`_check_serving_cell`): its parameter and
    moment bytes the layout's, its arguments those, AdamW's step and the
    batch; the gradients' reduction one all-reduce of the bytes of the
    rank's shards of the leaves summed over the batch's axes
    (``Layout.grad_axes``: DeepSeek-V3's experts, split over ``("data",
    "model")``, only over ``"pod"``); the norm's one float32 scalar a set
    of split axes; the forward's collectives the prefill's closed form
    (:func:`_coll_want`) at the cell's length without the logits'
    gathers, plus the vocab-parallel loss's (its sums [2, b_r, S] float32
    reduced, its max [b_r, S] float32 gathered over the 16 slices; again
    for DeepSeek-V3's MTP, with its block's two reductions and its
    embedding's) and the reported loss's float32 scalar over the batch's
    axes."""
    shape_of = mesh.MESHES[where]
    tcfg = TC.get(arch)
    n = max(len(tcfg.block_pattern) + len(tcfg.prefix_blocks), 2)
    tcfg = tcfg.replace(n_layers=n)
    cfg, cell = fix_rules_for_mesh(tcfg, shape_of), SHAPES["train_4k"]
    rec = dryrun.dryrun(tcfg, cell, arch=arch, mesh=where)
    full = rec["full"]
    layout = Layout(cfg, shape_of, {a: 0 for a in shape_of})
    plan, local = tlm.plan_model(cfg), layout.plan()
    elems = sum(math.prod(s.shape) for s in local.values())
    assert full["state_bytes"] == {"params": layout.param_bytes(),
                                   "moments": 2 * 4 * elems}
    assert full["memory"]["argument_size"] == layout.param_bytes() + \
        2 * 4 * elems + 4 + dryrun.storage_bytes(batch_specs(cfg, cell))
    rows, axes = layout.rows(cell.global_batch)
    summed = [n for n, s in plan.items() if layout.grad_axes(s, axes)]
    # DeepSeek-V3's experts see every row of the pod: summed over "pod"
    # only, where the mesh has it
    experts = {n: layout.grad_axes(plan[n], axes) for n in plan
               if tlm.is_expert_leaf(n)}
    assert set(experts.values()) <= {tuple(
        a for a in axes if a not in cfg.sharding.expert)}
    phases = full["coll_phases"]
    assert {k: int(v) for k, v in phases["grads"].items()} == {
        "all-reduce": 2 * sum(math.prod(local[n].shape) for n in summed),
        "all-gather": 0}
    groups = {layout.split_axes(s) for s in plan.values()} - {()}
    assert phases["update"] == {"all-reduce": 4 * len(groups),
                                "all-gather": 0}
    prefill = ShapeCell("prefill", cell.seq_len, cell.global_batch,
                        "prefill")
    want = _coll_want(arch, cfg, prefill, shape_of, rows)
    b_r, s, d = rows.stop - rows.start, cell.seq_len, cfg.d_model
    v = cfg.vocab
    want["all-gather"] -= b_r * v * 2 + cell.global_batch * v * 2
    heads = 1 + cfg.mtp
    want["all-reduce"] += heads * 2 * b_r * s * 4 + 4 + \
        cfg.mtp * 3 * b_r * s * d * 2
    want["all-gather"] += heads * shape_of["model"] * b_r * s * 4
    assert {k: int(x) for k, x in phases["forward"].items()} == want
    assert sum(sum(p.values()) for p in phases.values()) == \
        pytest.approx(sum(full["coll"].values()), rel=1e-12)


@pytest.mark.parametrize("where", ["pod16x16", "pod2x16x16"])
@pytest.mark.parametrize("arch", NEW)
def test_dryrun_train_cells_of_the_new_archs(arch, where):
    """The train_4k cell of DeepSeek-V3, Llama 4 Scout, RecurrentGemma 2B
    and xLSTM 125M at both meshes: :func:`_check_train_cell`."""
    _check_train_cell(arch, where)


@pytest.mark.parametrize("where", ["pod16x16", "pod2x16x16"])
@pytest.mark.parametrize("arch,shape", [
    c for c in dryrun.mesh_cells()
    if c[0] in NEW and SHAPES[c[1]].kind != "train"])
def test_dryrun_serving_cells_of_the_new_archs(arch, shape, where):
    """Every serving cell of DeepSeek-V3, Llama 4 Scout, RecurrentGemma 2B
    and xLSTM 125M at both meshes, at one cycle's depth (the closed forms
    count the layers of each kind): :func:`_check_serving_cell`."""
    _check_serving_cell(arch, shape, where, cut=True)


# one serving cell of each new arch traced at its full depth (a prefill
# and the decode's caches among them)
FULL_DEPTH = {"deepseek_v3_671b": "prefill_32k",
              "llama4_scout_17b_a16e": "decode_32k",
              "recurrentgemma_2b": "long_500k", "xlstm_125m": "decode_32k"}


@pytest.mark.parametrize("arch", NEW)
def test_dryrun_serving_cell_at_full_depth(arch):
    """:func:`_check_serving_cell` at pod16x16 on the whole config (61,
    48, 26 and 12 layers)."""
    _check_serving_cell(arch, FULL_DEPTH[arch], "pod16x16", cut=False)

