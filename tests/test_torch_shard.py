"""The port's layout of the LM over a mesh against the reference's GSPMD
layout, and the dry-run of one rank of the reference's meshes on
``meta``.

Layout, pure and fast: for all ten archs' full configs, every leaf's
``shard_spec`` equals ``repro.models.common.valid_pspec`` at the 16 x 16,
2 x 16 x 16 and host-8 (2 x 4) meshes.  ``valid_pspec`` reads only a
mesh's ``axis_names`` and ``devices.shape``, so it is given a stand-in
with ``devices = np.empty(shape)`` and no devices are made.  The port's
body leaves are unstacked (``layers.<i>``): their axes are the
reference's minus its leading ``cycles`` axis.  Each leaf's bytes on a
rank equal the reference's shard's; the one named difference is the
fused FFN input ``ffn.w_in`` of a GLU kind, whose rank holds ``[gate_r |
up_r]`` where GSPMD gives a device the contiguous columns ``r 2ff / m``
on (as many of them).

The dry-run: Qwen3-1.7B's prefill_32k at ``pod16x16`` on ``meta``, one
rank: ``devices`` 256, ``argument_size`` the layout's parameter bytes
plus the batch's, ``coll`` the closed form of ``launch.dryrun``'s
docstring, and ``roofline.analyze`` reads a collective term over
``LINK_BW``; a train cell and an MoE arch at that mesh raise.
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
from repro_torch.models.config import SHAPES
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
    roofline's collective term; a train cell and an MoE arch raise."""
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
    with pytest.raises(NotImplementedError, match="item 32"):
        dryrun.dryrun(cfg, SHAPES["train_4k"], mesh="pod16x16")
    with pytest.raises(NotImplementedError, match="item 31"):
        dryrun.dryrun(TC.get("llama4_scout_17b_a16e"), SHAPES["decode_32k"],
                      mesh="pod16x16")
    for a in ("recurrentgemma_2b", "xlstm_125m", "deepseek_v3_671b"):
        with pytest.raises(NotImplementedError, match="item 31"):
            check_supported(TC.get(a), "decode")
    for a in DENSE:
        check_supported(TC.get(a), "prefill")


def test_a_cut_model_refuses_what_it_cannot_run():
    """A smoke Gemma 2 cut for rank 1 of ``{"data": 2, "model": 2}``: the
    steps without that mesh, the forward outside it and the loss raise;
    a config whose rules split ``d_model`` raises under a mesh."""
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
    with pytest.raises(NotImplementedError, match="item 32"):
        tlm.lm_loss(cfg, model, {"inputs": toks, "targets": toks,
                                 "mask": np.ones((2, 4), bool)})
    with pytest.raises(ValueError, match="not cut for that rank"):
        make_prefill_step(cfg, "cpu", mesh.MetaMesh({"data": 2, "model": 2}))(
            model, {"inputs": toks})
    split = cfg.replace(sharding=dataclasses.replace(cfg.sharding,
                                                     d_model="model"))
    with pytest.raises(NotImplementedError, match="d_model"):
        check_supported(split, "prefill")
