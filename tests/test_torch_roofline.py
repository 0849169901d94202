"""The roofline, the dry-run on ``meta`` and the input specs against the
JAX package, on the CPU.

The reference side is built from plans and shape structs only (no
``jax.jit``, no compile): ``repro.launch.roofline``'s parameter counts,
``model_flops`` and ``useful_decode_bytes``, its ``analyze`` on a record
made here, and ``repro.launch.steps.input_specs`` at ``mesh=None``.  Every
count is held equal, exactly; ``analyze`` field for field once the
port's module reads the reference's constants (patched here only).

The flash wrapper is a custom op: its CPU output is the plain version's
bit for bit, ``meta`` gives the shape and refuses a pair of head dims no
kernel serves, and ``FlopCounterMode`` counts it by its formula, on the
CPU and on ``meta`` alike.  At smoke width, one arch of each family runs
its train, prefill and decode steps on CPU tensors under
``FlopCounterMode`` and through ``launch.dryrun`` on ``meta``: the same
FLOPs and bytes, and ``argument_size`` the real inputs' bytes.  xLSTM's
two probes extrapolate to the whole trace at a third length exactly.
Inputs are drawn from numpy seeds.
"""
import math

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import repro.configs as JC
from repro.launch import mesh as jmesh
from repro.launch import roofline as jroofline
from repro.launch import steps as jsteps
from repro.models.config import SHAPES as JSHAPES

import repro_torch.configs as TC
from repro_torch.kernels.flash_attention import attended_keys, flash_attention
from repro_torch.kernels.ref import flash_attention_ref
from repro_torch.launch import dryrun, mesh, roofline
from repro_torch.launch.steps import input_specs
from repro_torch.models.config import MLAConfig as TMLA
from repro_torch.models.config import SHAPES, ShapeCell
from repro_torch.models.config import smoke_config as t_smoke

CELLS = TC.all_cells()
DECODE_CELLS = [(a, s) for a, s in CELLS if SHAPES[s].kind == "decode"]
# one arch of each family at smoke width; DeepSeek-V3 with MLA's true head
# dims (q.k 128 + 64, v 128) on 2 heads, a pair a flash kernel serves
SMOKE_ARCHS = ("qwen3_1_7b", "hubert_xlarge", "recurrentgemma_2b",
               "xlstm_125m", "llama4_scout_17b_a16e", "deepseek_v3_671b")
TRUE_MLA = dict(q_lora_rank=32, kv_lora_rank=32, qk_nope_head_dim=128,
                qk_rope_head_dim=64, v_head_dim=128)
SMOKE_B, SMOKE_S = 2, 32


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Many small torch ops: without this, 6 pytest-xdist workers on 8
    cores slow them several-fold by intra-op fan-out."""
    was = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(was)


def test_the_chip_constants_are_the_h100s():
    assert (mesh.PEAK_FLOPS, mesh.PEAK_F32_FLOPS, mesh.HBM_BW,
            mesh.LINK_BW) == (989e12, 67e12, 3.35e12, 450e9)


# -- counts against the reference -------------------------------------------

@pytest.mark.parametrize("arch", TC.ARCHS)
def test_param_counts_match_reference(arch):
    tcfg, jcfg = TC.get(arch), JC.get(arch)
    assert roofline.model_params(tcfg) == jroofline.model_params(jcfg)
    assert roofline.active_params(tcfg) == jroofline.active_params(jcfg)


@pytest.mark.parametrize("arch,shape", CELLS)
def test_model_flops_match_reference(arch, shape):
    assert CELLS == JC.all_cells()
    got = roofline.model_flops(arch, shape, 1)
    assert got == jroofline.model_flops(arch, shape, 1) and got > 0


@pytest.mark.parametrize("arch,shape", DECODE_CELLS)
def test_useful_decode_bytes_match_reference(arch, shape):
    assert len(DECODE_CELLS) == 11
    got = roofline.useful_decode_bytes(arch, shape)
    assert got == jroofline.useful_decode_bytes(arch, shape) and got > 0


def _records():
    """A train record, a decode record with collectives, and a probed
    record (``estimated`` read in place of ``full``)."""
    mem = {"argument_size": 3 << 30, "output_size": 1 << 20,
           "temp_size": 5 << 30}
    full = {"flops": 1.25e17, "bytes": 3.5e14, "coll": {}, "memory": mem}
    base = {"mesh": "x", "tag": "baseline", "devices": 1, "cycles": 21}
    return [
        {**base, "arch": "gemma2_9b", "shape": "train_4k", "full": full},
        {**base, "arch": "qwen3_1_7b", "shape": "decode_32k",
         "full": {**full, "flops": 2.5e12, "bytes": 1.75e12,
                  "coll": {"all-reduce": 3e9, "all-gather": 1e9}}},
        {**base, "arch": "xlstm_125m", "shape": "prefill_32k", "full": full,
         "estimated": {"flops_per_device": 2.0e14,
                       "bytes_per_device": 1.5e14,
                       "collective_bytes_per_device": {"all-to-all": 2e8}}},
    ]


@pytest.mark.parametrize("i", range(3))
def test_analyze_matches_reference(i, monkeypatch):
    rec = _records()[i]
    monkeypatch.setattr(roofline, "PEAK_FLOPS", jmesh.PEAK_FLOPS)
    monkeypatch.setattr(roofline, "HBM_BW", jmesh.HBM_BW)
    monkeypatch.setattr(roofline, "LINK_BW", jmesh.ICI_BW)
    got, want = roofline.analyze(rec), jroofline.analyze(rec)
    assert got.keys() == want.keys()
    for k, v in want.items():
        if k == "roofline_kind":
            assert got[k] == v.replace("MXU", "tensor cores")
        else:
            assert got[k] == v, k
    monkeypatch.undo()
    got = roofline.analyze(rec)
    est = rec.get("estimated")
    fl = est["flops_per_device"] if est else rec["full"]["flops"]
    by = est["bytes_per_device"] if est else rec["full"]["bytes"]
    coll = sum((est["collective_bytes_per_device"] if est
                else rec["full"]["coll"]).values())
    assert got["t_compute_s"] == fl / 989e12
    assert got["t_memory_s"] == by / 3.35e12
    assert got["t_collective_s"] == coll / 450e9


# -- input specs -------------------------------------------------------------

def _dtype(jdtype) -> torch.dtype:
    return getattr(torch, str(np.dtype(jdtype)))


def _ref_leaves(jcfg, tree, top=("embed", "final_norm", "head", "mtp_proj",
                                 "mtp_norm", "pos")):
    """The reference's stacked tree under the port's flat names
    (``layers.<i>.<path>``), body leaves unstacked: {name: (shape,
    dtype)}."""
    import jax
    n_pre, width = len(jcfg.prefix_blocks), len(jcfg.block_pattern)
    base = n_pre + jcfg.cycles * width
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        keys = [getattr(p, "key", getattr(p, "idx", None)) for p in path]
        shape, dtype = tuple(leaf.shape), _dtype(leaf.dtype)
        if keys[0] == "body":
            k = int(keys[1][1:].split("_")[0])
            for c in range(jcfg.cycles):
                name = ".".join(map(str, keys[2:]))
                out[f"layers.{n_pre + c * width + k}.{name}"] = \
                    (shape[1:], dtype)
        elif keys[0] in ("prefix", "rem"):
            i = keys[1] + (0 if keys[0] == "prefix" else base)
            out[f"layers.{i}." + ".".join(map(str, keys[2:]))] = \
                (shape, dtype)
        else:
            assert keys[0] in top + ("mtp_block",), keys
            out[".".join(map(str, keys))] = (shape, dtype)
    return out


def _port_leaves(tree, prefix=""):
    if isinstance(tree, torch.Tensor):
        return {prefix: (tuple(tree.shape), tree.dtype)}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
        out.update(_port_leaves(v, f"{prefix}.{k}" if prefix else str(k)))
    return out


@pytest.mark.parametrize("arch,shape", CELLS)
def test_input_specs_match_reference(arch, shape):
    """Shapes and dtypes of every argument, all on ``meta``.  The one
    difference: the xLSTM cells' states are float32 in the port (the
    dtype of the reference's carries after one step), where the
    reference's spec says the compute dtype."""
    tcfg, jcfg = TC.get(arch), JC.get(arch)
    _, want = jsteps.input_specs(jcfg, JSHAPES[shape], None)
    _, got = input_specs(tcfg, SHAPES[shape])
    assert all(t.device.type == "meta" for t in dryrun._tensors(got))
    params = {n: (tuple(p.shape), p.dtype)
              for n, p in got[0].named_parameters()}
    assert params == _ref_leaves(jcfg, want[0])
    kind = SHAPES[shape].kind
    if kind == "train":
        opt = got[1]
        assert {n: (tuple(t.shape), t.dtype) for n, t in opt["m"].items()} \
            == _ref_leaves(jcfg, want[1]["m"])
        assert _port_leaves(opt["v"]) == _port_leaves(opt["m"])
        assert (tuple(opt["step"].shape), opt["step"].dtype) == \
            ((), torch.int32) == (want[1]["step"].shape,
                                  _dtype(want[1]["step"].dtype))
    if kind in ("train", "prefill"):
        assert _port_leaves(got[-1]) == {
            k: (tuple(s.shape), _dtype(s.dtype)) for k, s in want[-1].items()}
        return
    caches, tokens = got[1], got[2]
    assert (tuple(tokens.shape), tokens.dtype) == \
        (tuple(want[2].shape), _dtype(want[2].dtype))
    ref = _ref_leaves(jcfg, want[1])
    for name, (shape_, dtype) in _port_leaves(caches).items():
        if ".cell." in name:
            assert ref[name] == (shape_, _dtype(jcfg.dtype("compute")))
            assert dtype == torch.float32
            ref[name] = (shape_, dtype)
    assert _port_leaves(caches) == ref


# -- the flash op ------------------------------------------------------------

def _qkv(rng, hd=16, vd=16, s=33, device="cpu"):
    shapes = ((2, 4, s, hd), (2, 2, s, hd), (2, 2, s, vd))
    return [torch.from_numpy(rng.standard_normal(sh).astype(np.float32))
            .to(device) for sh in shapes]


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 5),
                                           (False, 0), (False, 7)])
def test_flash_op_counts_its_formula_on_cpu_and_meta(causal, window):
    rng = np.random.default_rng(11)
    q, k, v = _qkv(rng)
    opts = dict(causal=causal, window=window, softcap=3.0)
    keys = sum(1 for i in range(33) for j in range(33)
               if (not causal or j <= i) and (window <= 0 or i - j < window))
    assert attended_keys(33, causal, window) == keys
    want = 2 * 2 * 4 * (16 + 16) * keys
    counts = []
    for dev in ("cpu", "meta"):
        with FlopCounterMode(display=False) as fc:
            out = flash_attention(*(t.to(dev) for t in (q, k, v)), **opts)
        counts.append(fc.get_total_flops())
        assert tuple(out.shape) == (2, 4, 33, 16) and out.device.type == dev
    assert counts == [want, want]
    assert torch.equal(flash_attention(q, k, v, **opts),
                       flash_attention_ref(q, k, v, **opts))


def test_flash_op_on_meta_refuses_what_the_card_refuses():
    rng = np.random.default_rng(12)
    out = flash_attention(*_qkv(rng, 192, 128, device="meta"))
    assert tuple(out.shape) == (2, 4, 33, 128) and out.device.type == "meta"
    with pytest.raises(ValueError, match="head dims"):
        flash_attention(*_qkv(rng, 96, 96, device="meta"))
    q, k, v = _qkv(rng, 96, 96)           # the CPU takes any pair
    assert torch.equal(flash_attention(q, k, v), flash_attention_ref(q, k, v))


# -- the dry-run at smoke width ----------------------------------------------

def _smoke(arch):
    cfg = t_smoke(TC.get(arch)).replace(param_dtype="float32",
                                        compute_dtype="float32")
    if cfg.mla is not None:
        cfg = cfg.replace(n_heads=2, n_kv_heads=2, mla=TMLA(**TRUE_MLA))
    return cfg


SMOKE_CASES = [(a, kind) for a in SMOKE_ARCHS
               for kind in ("train", "prefill", "decode")
               if not (a == "hubert_xlarge" and kind == "decode")]


@pytest.mark.parametrize("arch,kind", SMOKE_CASES)
def test_dryrun_on_meta_counts_the_cpu_step(arch, kind):
    cfg = _smoke(arch)
    cell = ShapeCell(f"smoke_{kind}", SMOKE_S, SMOKE_B, kind)
    rec = dryrun.dryrun(cfg, cell, arch=arch)
    seed = int(np.random.default_rng(len(arch)).integers(2**31))
    step, args = input_specs(cfg, cell, device="cpu",
                             generator=torch.Generator().manual_seed(seed))
    real = sum(t.numel() * t.element_size()
               for t in {id(t): t for t in dryrun._tensors(args)}.values())
    assert rec["full"]["memory"]["argument_size"] == real
    want = dryrun.trace_step(step, args)
    with FlopCounterMode(display=False) as fc:
        step(*input_specs(cfg, cell, device="cpu")[1])
    assert rec["full"]["flops"] == want["flops"] == fc.get_total_flops() > 0
    assert rec["full"]["bytes"] == want["bytes"] > 0
    assert ("estimated" in rec) == (arch == "xlstm_125m" and kind != "decode")
    a = roofline.analyze(rec)
    assert all(math.isfinite(a[k]) for k in ("t_step_s", "useful_ratio",
                                             "roofline_fraction"))


@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_xlstm_probes_extrapolate_exactly(kind):
    cfg = _smoke("xlstm_125m")
    s = 3 * dryrun.PROBE_LENS[0]
    cell = ShapeCell("third", s, SMOKE_B, kind)
    whole = dryrun.trace_step(*input_specs(cfg, cell))
    rec = dryrun.dryrun(cfg, cell)
    assert [rec[p]["seq_len"] for p in ("probe1", "probe2")] == \
        list(dryrun.PROBE_LENS)
    assert rec["estimated"]["flops_per_device"] == whole["flops"] > 0
    assert rec["estimated"]["bytes_per_device"] == whole["bytes"] > 0
    assert rec["full"]["memory"]["argument_size"] == \
        whole["memory"]["argument_size"]
