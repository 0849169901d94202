"""One process a rank: ``RankMesh`` on the CPU, gloo, ``file://``
rendezvous.

One launch of 4 ranks (``launch.ranks.run_ranks``, module fixture) runs
every job: wordcount, SSSP and PageRank on ``{"data": 4}`` and ``{"pod":
2, "data": 2}`` (and PageRank at a ``shuffle_cap`` of 16, which regrows),
each a run and two fine refreshes; ``compressed_psum``; a per-rank
snapshot restored; the MoE's ``a2a`` layer at smoke Llama 4 Scout and
DeepSeek-V3 on ``(data 1, model 4)`` and ``(2, 2)`` (and one case with a
low ``capacity_factor`` that drops slots); two smoke LMs' prefill with
``moe_impl="a2a"``; and the LM served tensor-parallel (``lm_tp``, in
float32 at smoke width: Gemma 2 and Qwen3 at ``(data 1, model 4)``,
where kv 2 falls back to replicated, and ``(2, 2)``; DeepSeek-V3's MLA,
MoE and MTP at ``(1, 4)`` and at ``(2, 2)`` with its experts over
``("data", "model")`` and slots dropped; Llama 4 Scout's MoE at ``(1,
4)`` under ``gather`` and ``a2a``; RecurrentGemma 2B's RG-LRU and xLSTM
125M's mLSTM and sLSTM at ``(1, 4)``); and the LM trained over the mesh
(``lm_train``: Qwen3-1.7B at ``(1, 4)`` and ``(2, 2)``, the latter with
the chunked loss under remat full, DeepSeek-V3 at ``(2, 2)`` with its
experts over ``("data", "model")``, MLA and MTP, RecurrentGemma 2B at
``(1, 4)``, one step each; Qwen3 at ``(2, 2)`` two steps and DeepSeek-V3
at ``(2, 2)`` through the ``a2a`` exchange one, against the port's
replicated steps).  All four
meshes are views of the one world of 4.  While the ranks run,
``REF_PROCS`` subprocesses run the reference on 4 forced host devices
(as ``tests/test_torch_distributed.py``'s mesh test): its ``a2a``, the
LMs laid out by ``param_shardings`` with their prefill and serve steps
jitted under the mesh (GSPMD, its MoE on ``gather``), and, on the same
layout with the batch split over ``"data"``, ``jax.value_and_grad`` of
``lm_loss`` and one ``adamw_update`` jitted together.

The sizes are ``tests/test_torch_distributed.py``'s (wordcount VOCAB 32 x
64 documents of 4 words; PageRank S 256, F 5; SSSP 96 vertices, 4
slots).  Tolerances: the engine on ranks equals ``LocalMesh`` at the same
P bit for bit (results, iteration counts, logs, ``ShuffleStats`` but for
its seconds, store sizes), on every rank; ``compressed_psum`` on ranks
equals the stacked form bit for bit; the ``a2a`` layer's expert ids equal
the reference's and its float32 output lies within 1e-5 of the largest
|output|; the LM's last-token logits with ``a2a`` within 1e-5 of the
port's ``gather`` prefill (no slot drops: 8 tokens a rank, under the
capacity's floor).  ``lm_tp``: each rank's parameter shards equal the
reference device's (the same device number: both meshes lay ranks out in
row order) bit for bit, the fused inputs by their own rule (``[a_r |
b_r]``, ``models.shard``); the prefill's last-token logits and 8 decode
steps' within 2e-4 of the largest |logit| of the reference's
(``tests/test_torch_models.py``'s LM bound); each rank's caches within
1e-5 of its part of the port's replicated run's (its rows, the kv heads
it reads, its RG-LRU columns; MLA's latent and the cells' states whole);
the last decode step within 2e-4 of the prefill of the decoded tokens.
``lm_train`` (``tests/test_torch_train.py``'s bounds): the loss and grad
norm within 1e-5, each rank's gradient shard within 1e-4 of the leaf's
largest |gradient| and each parameter shard after the step within 1e-4
of the leaf's largest |update|, against the reference's; the two
``"replicated"`` cases likewise against the port's replicated steps.
"""
import json
import os
import shutil
import subprocess
import sys
from datetime import timedelta

import numpy as np
import pytest
import torch
import torch.distributed as tdist

from repro_torch.api import (
    LocalMesh, MeshConfig, RunConfig, Session, make_delta,
)
from repro_torch.apps import pagerank as pr, sssp
from repro_torch.core.distributed import RankMesh
from repro_torch.launch import mesh as tmesh
from repro_torch.launch.ranks import (
    deltas_of, draw_moe, make_app, moe_config, report_summary, run_ranks,
    save_deltas,
)
from repro_torch.launch.steps import make_prefill_step
from repro_torch.models import lm as tlm
from repro_torch.models.config import smoke_config as t_smoke
from repro_torch.optim.compress import compressed_psum

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
MODULE = "repro_torch.launch.ranks"
WORLD = 4
VOCAB, L, N_DOCS = 32, 4, 64
S, F = 256, 5
V_SSSP = 96
PR_KW = dict(max_iters=60, tol=1e-7, cpc_threshold=5e-4,
             pdelta_threshold=1.0)
FLAT = {"data": 4}
POD = {"pod": 2, "data": 2}
LLAMA4, DEEPSEEK = "llama4_scout_17b_a16e", "deepseek_v3_671b"
F32_REL = 1e-5

# name -> (job, mesh, RunConfig kwargs, MeshConfig kwargs)
ENGINE = {
    "wc-flat": ("wordcount", FLAT, {"value_bytes": 4}, {}),
    "wc-pod": ("wordcount", POD, {"value_bytes": 4}, {"pod_axis": "pod"}),
    "sssp-flat": ("sssp", FLAT, {}, {}),
    "sssp-pod": ("sssp", POD, {}, {"pod_axis": "pod"}),
    "pr-flat": ("pagerank", FLAT, PR_KW, {"shuffle_cap": 512}),
    "pr-pod": ("pagerank", POD, PR_KW, {"pod_axis": "pod",
                                        "shuffle_cap": 512}),
    "pr-regrow": ("pagerank", FLAT, PR_KW, {"shuffle_cap": 16}),
}
# name -> (arch, mesh, x shape, capacity_factor or None, skewed router)
MOE = {
    "llama4-1x4": (LLAMA4, {"data": 1, "model": 4}, (2, 16), None, False),
    "llama4-2x2": (LLAMA4, {"data": 2, "model": 2}, (2, 16), None, False),
    "deepseek-1x4": (DEEPSEEK, {"data": 1, "model": 4}, (2, 16), None,
                     False),
    "deepseek-2x2": (DEEPSEEK, {"data": 2, "model": 2}, (2, 16), None,
                     False),
    "deepseek-drop": (DEEPSEEK, {"data": 1, "model": 4}, (2, 128), 0.25,
                      True),
}
MOE_LM = {"lm-llama4-1x4": (LLAMA4, {"data": 1, "model": 4}),
          "lm-deepseek-2x2": (DEEPSEEK, {"data": 2, "model": 2})}
# the LM tensor-parallel: name -> (arch, mesh, what a rank holds of its
# first layer of each kind (launch.ranks.held_parts: [q heads, kv heads or
# None for MLA, head dim], experts, d_ff columns), the job's other keys);
# B x S tokens (TP_B x TP_S unless "shape" says), the first TP_STEPS of
# them decoded
ONE_BY_4, TWO_BY_2 = {"data": 1, "model": 4}, {"data": 2, "model": 2}
LM_TP = {
    "tp-gemma2-1x4": ("gemma2_9b", ONE_BY_4, ([1, 1, 16], None, None), {}),
    "tp-gemma2-2x2": ("gemma2_9b", TWO_BY_2, ([2, 1, 16], None, None), {}),
    "tp-qwen3-1x4": ("qwen3_1_7b", ONE_BY_4, ([1, 1, 16], None, None), {}),
    "tp-qwen3-2x2": ("qwen3_1_7b", TWO_BY_2, ([2, 1, 16], None, None), {}),
    # MLA on 1 of 4 heads, 1 of the 4 experts, MTP held
    "tp-deepseek-1x4": (DEEPSEEK, ONE_BY_4, ([1, None, 16], 1, None), {}),
    # the experts over ("data", "model") as the full config's a2a has them,
    # 2 x 48 tokens at capacity_factor 0.25: slots drop in the prefill (the
    # capacity over all 96 tokens of both data ranks), none in the decode
    "tp-deepseek-2x2": (DEEPSEEK, TWO_BY_2, ([2, None, 16], 1, None), {
        "moe": {"ep_axes": ["data", "model"], "capacity_factor": 0.25},
        "shape": [TWO_BY_2["data"], 48]}),
    "tp-llama4-1x4": (LLAMA4, ONE_BY_4, ([1, 1, 16], 1, None), {}),
    # the a2a exchange in the prefill, the gather path in the decode (one
    # token does not split over "model"), on the weights, tokens and
    # reference run ("same_as") of the case above: the reference runs its
    # MoE on gather either way
    "tp-llama4-a2a-1x4": (LLAMA4, ONE_BY_4, ([1, 1, 16], 1, None),
                          {"replace": {"moe_impl": "a2a"},
                           "same_as": "tp-llama4-1x4"}),
    # RG-LRU on 16 of its 64 columns; attn_local's 4 heads split, its one
    # kv head replicated
    "tp-recurrentgemma-1x4": ("recurrentgemma_2b", ONE_BY_4,
                              ([1, 1, 16], None, 16), {}),
    # mLSTM on 32 of its 128 columns, the cells whole
    "tp-xlstm-1x4": ("xlstm_125m", ONE_BY_4, (None, None, 32), {}),
}
TP_B, TP_S, TP_STEPS = 2, 8, 8
# training over the mesh (``lm_train``): name -> (arch, mesh, the job's
# config keys, steps, held against the reference's GSPMD step or the
# port's own replicated run); TRAIN_B x TRAIN_S tokens a step, float32 at
# smoke width.  Qwen3's 2 x 2 takes the chunked loss (chunks of 4) under
# remat full, so that the loss's and the layers' collectives run again
# in the backward; DeepSeek-V3's experts lie over ("data", "model") and
# its MTP runs.
LM_TRAIN = {
    "train-qwen3-1x4": ("qwen3_1_7b", ONE_BY_4, {}, 1, "reference"),
    "train-qwen3-2x2": ("qwen3_1_7b", TWO_BY_2, {
        "replace": {"loss_chunk": 4, "remat": "full"}}, 1, "reference"),
    "train-deepseek-2x2": (DEEPSEEK, TWO_BY_2, {
        "moe": {"ep_axes": ["data", "model"]}}, 1, "reference"),
    "train-recurrentgemma-1x4": ("recurrentgemma_2b", ONE_BY_4, {}, 1,
                                 "reference"),
    "train-qwen3-2x2-steps": ("qwen3_1_7b", TWO_BY_2, {}, 2, "replicated"),
    # the MoE's a2a exchange and its reverse in the backward (the
    # reference runs its MoE on gather); no slot drops at this capacity,
    # so the replicated gather step is its yardstick
    "train-deepseek-a2a-2x2": (DEEPSEEK, TWO_BY_2, {
        "moe": {"ep_axes": ["data", "model"]},
        "replace": {"moe_impl": "a2a"}}, 1, "replicated"),
}
TRAIN_B, TRAIN_S = 2, 8
# AdamW's eps at 1 keeps the update smooth in the gradient (at 1e-8 the
# first step is lr times the gradient's sign, which rounding decides
# wherever the gradient is near 0), so that the parameters after a step
# are held to the gradients' bound
TRAIN_OPT = {"lr": 1e-2, "warmup": 1, "eps": 1.0}
# tests/test_torch_train.py's bounds: the loss within LOSS_TOL, each
# gradient leaf within GRAD_REL of its largest |value|
LOSS_TOL, GRAD_REL = 1e-5, 1e-4
# RankMesh.psum, one job over PSUM_MESH: name -> the axis group summed
PSUM_MESH = {"data": 2, "model": 2}
PSUM = {"psum-model": ["model"], "psum-world": ["data", "model"]}
LM_REL = 2e-4
CACHE_TOL = 1e-5
# the reference's subprocesses, each on 4 forced host devices
REF_PROCS = 2


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# Inputs
# ---------------------------------------------------------------------------

def _signed(rows, old, new):
    buf = np.empty((2 * rows.size,) + old.shape[1:], old.dtype)
    buf[0::2], buf[1::2] = old, new
    return np.repeat(rows.astype(np.int32), 2), buf, \
        np.tile(np.int8([-1, 1]), rows.size)


def _wordcount():
    docs = np.random.default_rng(7).integers(
        0, VOCAB, (N_DOCS, L)).astype(np.int32)
    rng, cur, deltas = np.random.default_rng(8), docs.copy(), []
    for n in (4, 12):
        rows = rng.choice(N_DOCS, n, replace=False)
        new = rng.integers(0, VOCAB, (n, L)).astype(np.int32)
        rid, buf, sign = _signed(rows, cur[rows], new)
        cur[rows] = new
        deltas.append((rid, {"w": buf}, sign))
    return save_deltas({"docs": docs, "vocab": VOCAB}, deltas)


def _pagerank():
    nbrs = pr.random_graph(S, F, seed=11, p_edge=0.5)
    rng, cur, deltas = np.random.default_rng(5), nbrs.copy(), []
    for n in (4, 4):
        rows = rng.choice(S, n, replace=False)
        new = np.where(rng.random((n, F)) < 0.5,
                       rng.integers(0, S, (n, F)), -1).astype(np.int32)
        rid, buf, sign = _signed(rows, cur[rows], new)
        cur[rows] = new
        deltas.append((rid, {"nbrs": buf}, sign))
    return save_deltas({"nbrs": nbrs}, deltas)


def _sssp():
    """10 rows lose 30% of their slots, then one vertex every in-edge
    (record id = row + 1: row 0 is the source's seed record)."""
    nbrs, w = sssp.random_weighted_graph(V_SSSP, 4, seed=2)
    rng, cur, deltas = np.random.default_rng(9), nbrs.copy(), []
    rows = rng.choice(V_SSSP, 10, replace=False)
    new = cur[rows].copy()
    new[rng.random(new.shape) < 0.3] = -1
    d = sssp.oracle(cur, w, 0)
    target = int(np.nonzero((d > 0) & (d < sssp.INF / 2))[0][-1])
    for rows, new in ((rows, new), (None, None)):
        if rows is None:
            rows = np.nonzero((cur == target).any(axis=1))[0]
            new = np.where(cur[rows] == target, -1, cur[rows]).astype(
                np.int32)
        rid, buf, sign = _signed(rows + 1, cur[rows], new)
        cur[rows] = new
        deltas.append((rid, {"nbrs": buf, "w": np.repeat(w[rows], 2, 0)},
                       sign))
    return save_deltas({"nbrs": nbrs, "w": w, "src": 0}, deltas)


def _moe_inputs(arch, shape, cf, skewed, seed):
    """An MoE layer's float32 weights at 1/sqrt(input width) and x; with
    ``skewed``, every token's first choice is expert 0 (as
    ``tests/test_torch_moe.py``'s skewed router)."""
    cfg = t_smoke(_full_cfg(arch))
    mo, d = cfg.moe, cfg.d_model
    rng = np.random.default_rng(seed)
    ffs = (mo.d_ff_shared or mo.d_ff_expert) * mo.num_shared
    draw = lambda shape, fan: (rng.standard_normal(shape, np.float32)
                               / np.float32(np.sqrt(fan)))
    w = {"norm": np.zeros(d, np.float32),
         "router": draw((d, mo.num_experts), d),
         "w_in": draw((mo.num_experts, d, 2 * mo.d_ff_expert), d),
         "w_out": draw((mo.num_experts, mo.d_ff_expert, d), mo.d_ff_expert)}
    if mo.num_shared:
        w["shared_in"] = draw((d, 2 * ffs), d)
        w["shared_out"] = draw((ffs, d), ffs)
    x = rng.normal(0, 1, shape + (d,)).astype(np.float32)
    if skewed:
        u = rng.normal(0, 1, d).astype(np.float32)
        u /= np.linalg.norm(u)
        x += 4 * np.sqrt(d) * u
        w["router"][:, 0] = 8 * u
    return {"x": x, **{f"w_{n}": a for n, a in w.items()}}


def _full_cfg(arch):
    import repro_torch.configs as C
    return C.get(arch)


def _moe_spec(name):
    arch, mesh, shape, cf, _ = MOE[name]
    spec = {"arch": arch, "smoke": True, "mesh": mesh,
            "replace": {"param_dtype": "float32",
                        "compute_dtype": "float32"}}
    if cf is not None:
        spec["capacity_factor"] = cf
    return spec


def _tp_spec(name):
    """The ``lm_tp`` job's config keys of case ``name``: smoke width in
    float32, the case's ``replace`` and ``moe``."""
    arch, mesh, _, extra = LM_TP[name]
    spec = {"arch": arch, "smoke": True, "mesh": mesh,
            "replace": dict(extra.get("replace", {}),
                            param_dtype="float32", compute_dtype="float32")}
    if "moe" in extra:
        spec["moe"] = extra["moe"]
    return spec


def _tp_config(name):
    from repro_torch.launch.ranks import lm_config
    return lm_config(_tp_spec(name))


def _tp_shape(name):
    return tuple(LM_TP[name][3].get("shape", (TP_B, TP_S)))


def _tp_weights(name, seed):
    """Every leaf of the smoke LM drawn with numpy, matrices at 1/sqrt of
    their input width (``launch.ranks.parity_fan_in``), norms zeros."""
    return _draw_weights(_tp_config(name), seed)


def _draw_weights(cfg, seed):
    from repro_torch.launch.ranks import parity_fan_in
    rng = np.random.default_rng(seed)
    flat = {}
    for name, s in tlm.plan_model(cfg).items():
        if s.init == "zeros":
            flat[name] = np.zeros(s.shape, np.float32)
            continue
        flat[name] = (rng.standard_normal(s.shape, np.float32) / np.float32(
            np.sqrt(parity_fan_in(name, s.shape))))
    return cfg, flat


def _train_spec(name):
    """The ``lm_train`` job's config keys of case ``name``: smoke width in
    float32, the case's ``replace`` and ``moe``."""
    arch, mesh, extra, steps, _ = LM_TRAIN[name]
    spec = {"arch": arch, "smoke": True, "mesh": mesh, "opt": TRAIN_OPT,
            "replace": dict(extra.get("replace", {}),
                            param_dtype="float32", compute_dtype="float32")}
    if "moe" in extra:
        spec["moe"] = extra["moe"]
    return spec


def _train_inputs(name, seed):
    """(config, weights, ids [steps, B, S + 1], mask [steps, B, S]): a
    fifth of the positions masked off."""
    from repro_torch.launch.ranks import lm_config
    cfg = lm_config(_train_spec(name))
    _, flat = _draw_weights(cfg, seed)
    rng = np.random.default_rng(seed + 100)
    steps = LM_TRAIN[name][3]
    toks = rng.integers(0, cfg.vocab, (steps, TRAIN_B, TRAIN_S + 1)
                        ).astype(np.int32)
    return cfg, flat, toks, rng.random((steps, TRAIN_B, TRAIN_S)) < 0.8


def _ref_paths(cfg, flat):
    """The reference tree's leaves by "/" path, and each port leaf's (path,
    cycle or None)."""
    from repro_torch.models.transfer import from_reference_tree, \
        to_reference_tree
    tree = to_reference_tree(cfg, {n: torch.from_numpy(a)
                                   for n, a in flat.items()})
    paths, where = {}, {}

    def walk(node, path):
        if isinstance(node, dict):
            out = {}
            for k, v in node.items():
                out[k] = walk(v, f"{path}/{k}" if path else k)
            return out
        if isinstance(node, list):
            return [walk(v, f"{path}/{i}") for i, v in enumerate(node)]
        paths[path] = node.numpy()
        if path.startswith("body/"):
            tags = np.empty(node.shape[0], object)
            for c in range(node.shape[0]):
                tags[c] = (path, c)
            return tags
        return (path, None)
    where = from_reference_tree(cfg, walk(tree, ""))
    return paths, where


def _lm_model(arch, seed=3):
    cfg = t_smoke(_full_cfg(arch)).replace(param_dtype="float32",
                                           compute_dtype="float32")
    return cfg, tlm.init_params(cfg, torch.Generator().manual_seed(seed),
                                device="cpu")


_REF_MOE = """
import json, sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec
import dataclasses, functools
from repro.optim import AdamWConfig, adamw_init, adamw_update
import repro.configs as C
from repro.models import blocks, meshctx
from repro.models import lm
from repro.models.common import rms_norm
from repro.models.config import smoke_config
from repro.launch.steps import make_prefill_step, make_serve_step
cases = json.loads(open(sys.argv[1]).read())
out, index = {}, {}


def case(c, z):
    # the case's config, mesh and weights laid out by param_shardings
    cfg = smoke_config(C.get(c["arch"])).replace(
        param_dtype="float32", compute_dtype="float32",
        **c.get("replace", {}))
    cfg = cfg.replace(sharding=dataclasses.replace(cfg.sharding,
                                                   batch=("data",)))
    if c.get("moe"):
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, **{
            k: tuple(v) if isinstance(v, list) else v
            for k, v in c["moe"].items()}))
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(
        tuple(c["mesh"].values())), tuple(c["mesh"]))
    tree = {}
    for k in z.files:
        if not k.startswith("r/"):
            continue
        node, parts = tree, k[2:].split("/")
        for a in parts[:-1]:
            node = node.setdefault(a, {})
        node[parts[-1]] = jnp.asarray(z[k])
    for k in ("prefix", "rem"):      # lists of blocks, by index
        node = tree.get(k, {})
        tree[k] = [node[str(i)] for i in range(len(node))]
    shard = lm.param_shardings(cfg, mesh)
    return cfg, mesh, shard, jax.device_put(tree, shard)


def flat(tree):
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path): np.asarray(a)
            for path, a in jax.tree_util.tree_leaves_with_path(tree)}


for name, c in cases["train"].items():
    # the loss, its gradients and one AdamW step, jitted under the mesh
    # with the batch split over "data" (GSPMD's collectives)
    z = np.load(c["data"])
    cfg, mesh, shard, params = case(c, z)
    opt_cfg = AdamWConfig(**c["opt"])
    rows = NamedSharding(mesh, PartitionSpec("data"))
    toks = z["toks"][0]
    batch = {k: jax.device_put(jnp.asarray(a), rows) for k, a in (
        ("inputs", toks[:, :-1]), ("targets", toks[:, 1:]),
        ("mask", z["mask"][0]))}

    def step(params, opt_state, batch):
        loss, grads = jax.value_and_grad(functools.partial(
            lm.lm_loss, cfg))(params, batch)
        new, _, info = adamw_update(grads, opt_state, params, opt_cfg)
        return loss, grads, new, info["grad_norm"]
    with mesh:
        loss, grads, new, gnorm = jax.jit(step)(
            params, adamw_init(params, opt_cfg), batch)
    out[name + "_loss"] = np.asarray(loss)
    out[name + "_gnorm"] = np.asarray(gnorm)
    out.update((f"{name}_g/{k}", a) for k, a in flat(grads).items())
    out.update((f"{name}_p/{k}", a) for k, a in flat(new).items())
for name, c in cases["lm"].items():
    z = np.load(c["data"])
    cfg, mesh, shard, params = case(c, z)
    index[name] = {}
    def record(path, s, a):
        key = "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                       for p in path)
        index[name][key] = {str(d.id): [list(sl.indices(n))[:2] for sl, n
                                        in zip(idx, a.shape)]
                            for d, idx in s.devices_indices_map(
                                a.shape).items()}
    jax.tree_util.tree_map_with_path(record, shard, params)
    toks = jnp.asarray(z["toks"])
    b, n = toks.shape[0], c["steps"]
    with mesh:
        out[name + "_prefill"] = np.asarray(jax.jit(make_prefill_step(cfg))(
            params, {"inputs": toks}))
        specs = lm.cache_specs(cfg, b, n, mesh)
        caches = jax.tree.map(lambda a, sp: jax.device_put(a, sp.sharding),
                              lm.init_caches(cfg, b, n), specs)
        serve = jax.jit(make_serve_step(cfg))
        steps = []
        for t in range(n):
            logits, caches = serve(params, caches, toks[:, t:t + 1])
            steps.append(np.asarray(logits))
    out[name + "_decode"] = np.stack(steps)
json.dump(index, open(sys.argv[3], "w"))
for name, c in cases["moe"].items():
    z = np.load(c["data"])
    cfg = smoke_config(C.get(c["arch"])).replace(
        param_dtype="float32", compute_dtype="float32", moe_impl="a2a")
    if c.get("capacity_factor") is not None:
        cfg = cfg.replace(moe=dataclasses.replace(
            cfg.moe, capacity_factor=c["capacity_factor"]))
    shape = tuple(c["mesh"].values())
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(shape),
                tuple(c["mesh"]))
    p = {k[2:]: jnp.asarray(z[k]) for k in z.files if k.startswith("w_")}
    x = jnp.asarray(z["x"])
    meshctx.set_mesh(mesh)
    y = jax.jit(lambda p, x: blocks.apply_moe(cfg, p, x))(p, x)
    meshctx.set_mesh(None)
    toks = rms_norm(x, p["norm"], cfg.norm_eps).reshape(-1, cfg.d_model)
    probs = jax.nn.softmax(toks.astype(jnp.float32)
                           @ p["router"].astype(jnp.float32), axis=-1)
    eid = jax.lax.top_k(probs, cfg.moe.top_k)[1]
    out[f"{name}_y"] = np.asarray(y)
    out[f"{name}_eid"] = np.asarray(eid)
np.savez(sys.argv[2], **out)
print("DONE")
"""


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Write every job's inputs, start the reference's subprocesses (its
    ``a2a`` layers and its GSPMD LMs), run the 4 ranks, then wait for the
    reference."""
    root = tmp_path_factory.mktemp("ranks")
    data = {"wordcount": _wordcount(), "sssp": _sssp(),
            "pagerank": _pagerank()}
    for job, arrays in data.items():
        np.savez(root / f"in_{job}.npz", **arrays)
    jobs = []
    for name, (job, mesh, cfg, mkw) in ENGINE.items():
        jobs.append({"job": job, "name": name,
                     "data": str(root / f"in_{job}.npz"), "mesh": mesh,
                     "config": cfg, "mesh_kw": dict(mkw, merge_workers=1),
                     "snapshot": name == "wc-flat"})
    rng = np.random.default_rng(1)
    comp = {"x": rng.normal(0, 1, (WORLD, 33, 7)).astype(np.float32)
            * np.float32([1, 10, 0.1, 3])[:, None, None],
            "err": rng.normal(0, 1e-3, (WORLD, 33, 7)).astype(np.float32)}
    np.savez(root / "in_compress.npz", **comp)
    jobs.append({"job": "compress", "name": "compress",
                 "data": str(root / "in_compress.npz")})
    np.savez(root / "in_psum.npz", **_psum_inputs())
    jobs.append({"job": "psum", "name": "psum", "mesh": PSUM_MESH,
                 "axes": list(PSUM.values()),
                 "data": str(root / "in_psum.npz")})
    ref_cases = {}
    for i, (name, (arch, mesh, shape, cf, skewed)) in enumerate(MOE.items()):
        path = root / f"in_{name}.npz"
        np.savez(path, **_moe_inputs(arch, shape, cf, skewed, 20 + i))
        jobs.append(dict(_moe_spec(name), job="moe", name=name,
                         data=str(path)))
        ref_cases[name] = {"arch": arch, "mesh": mesh,
                           "capacity_factor": cf, "data": str(path)}
    lm_cases = {}
    for i, name in enumerate(LM_TP):
        path = root / f"in_{name}.npz"
        same = LM_TP[name][3].get("same_as")
        spec = _tp_spec(name)
        jobs.append(dict(spec, job="lm_tp", name=name, data=str(path),
                         steps=TP_STEPS, dump=True))
        if same:
            shutil.copyfile(root / f"in_{same}.npz", path)
            continue
        cfg, flat = _tp_weights(name, 30 + i)
        paths, _ = _ref_paths(cfg, flat)
        tp_toks = np.random.default_rng(40 + i).integers(
            0, cfg.vocab, _tp_shape(name)).astype(np.int32)
        np.savez(path, toks=tp_toks, **{f"p.{n}": a for n, a in flat.items()},
                 **{f"r/{k}": a for k, a in paths.items()})
        lm_cases[name] = {"arch": spec["arch"], "mesh": spec["mesh"],
                          "moe": spec.get("moe"), "steps": TP_STEPS,
                          "data": str(path)}
    train_cases = {}
    for i, (name, (*_, steps, against)) in enumerate(LM_TRAIN.items()):
        path = root / f"in_{name}.npz"
        cfg, flat, tr_toks, tr_mask = _train_inputs(name, 60 + i)
        paths, _ = _ref_paths(cfg, flat)
        np.savez(path, toks=tr_toks, mask=tr_mask,
                 **{f"p.{n}": a for n, a in flat.items()},
                 **{f"r/{k}": a for k, a in paths.items()})
        spec = _train_spec(name)
        jobs.append(dict(spec, job="lm_train", name=name, data=str(path),
                         dump=True))
        if against == "reference":
            train_cases[name] = dict(spec, data=str(path),
                                     replace=LM_TRAIN[name][2].get(
                                         "replace", {}))
    toks = np.random.default_rng(4).integers(0, 256, (2, 16)).astype(
        np.int32)
    for name, (arch, mesh) in MOE_LM.items():
        cfg, model = _lm_model(arch)
        np.savez(root / f"in_{name}.npz", toks=toks,
                 **{f"p.{n}": t.detach().numpy()
                    for n, t in model.named_parameters()})
        jobs.append({"job": "moe_lm", "name": name, "arch": arch,
                     "smoke": True, "mesh": mesh,
                     "data": str(root / f"in_{name}.npz"),
                     "replace": {"param_dtype": "float32",
                                 "compute_dtype": "float32"}})
    (root / "spec.json").write_text(json.dumps({"jobs": jobs,
                                                "out": str(root)}))
    # the reference's cases in REF_PROCS subprocesses side by side (each
    # LM case's GSPMD compiles take seconds): every REF_PROCS-th LM case in
    # each, the MoE layers in the last
    names, train_names = sorted(lm_cases), sorted(train_cases)
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu", PYTHONPATH=SRC)
    refs = []
    for i in range(REF_PROCS):
        part = {"moe": ref_cases if i == REF_PROCS - 1 else {},
                "lm": {n: lm_cases[n] for n in names[i::REF_PROCS]},
                "train": {n: train_cases[n]
                          for n in train_names[i::REF_PROCS]}}
        (root / f"ref{i}.json").write_text(json.dumps(part))
        refs.append(subprocess.Popen(
            [sys.executable, "-c", _REF_MOE, str(root / f"ref{i}.json"),
             str(root / f"ref{i}.npz"), str(root / f"ref_index{i}.json")],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))
    try:
        results = run_ranks(MODULE, WORLD, backend="gloo", device="cpu",
                            timeout=300, args=[str(root / "spec.json")])
        errs = [ref.communicate(timeout=300)[1] for ref in refs]
    finally:
        for ref in refs:
            if ref.poll() is None:
                ref.kill()
                ref.wait()
    for ref, err in zip(refs, errs):
        assert ref.returncode == 0, err[-4000:]
    out, index = {}, {}
    for i in range(REF_PROCS):
        z = np.load(root / f"ref{i}.npz")
        out.update((k, z[k]) for k in z.files)
        index.update(json.loads((root / f"ref_index{i}.json").read_text()))
    for name, (*_, extra) in LM_TP.items():
        if "same_as" in extra:
            index[name] = index[extra["same_as"]]
            for part in ("_prefill", "_decode"):
                out[name + part] = out[extra["same_as"] + part]
    return {"root": root, "results": results, "data": data, "toks": toks,
            "ref": out, "ref_index": index}


# ---------------------------------------------------------------------------
# The engine on ranks against LocalMesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(ENGINE))
def test_engine_on_ranks_equals_local_mesh(ranks, name):
    """Run and two fine refreshes on 4 ranks: every rank's reports, and
    rank 0's results, equal a LocalMesh session's at the same P."""
    job, mesh, cfg, mkw = ENGINE[name]
    z = np.load(ranks["root"] / f"in_{job}.npz")
    app, data, key = make_app(job, z)
    sess = Session(app, RunConfig(device="cpu", mesh=MeshConfig(
        LocalMesh(mesh), merge_workers=1, **mkw), **cfg))
    want = [report_summary(sess.run(data))]
    results = [sess.result[key]]
    for d in deltas_of(z):
        want.append(report_summary(sess.update(make_delta(*d))))
        results.append(sess.result[key])
    got = np.load(ranks["root"] / f"{name}.npz")
    for i, r in enumerate(results):
        np.testing.assert_array_equal(got[f"r{i}"], r)
    modes = [w["mode"] for w in want]
    assert modes[0] == "distributed" and set(modes[1:]) <= {
        "distributed-incr", "distributed-i2"}, modes
    for r, out in enumerate(ranks["results"]):
        epochs = [{k: v for k, v in e.items() if k != "result"}
                  for e in out[name]["epochs"]]
        assert epochs == want, (name, r)
        assert out[name]["stores"] == 1
    digests = {tuple(e["result"] for e in out[name]["epochs"])
               for out in ranks["results"]}
    assert len(digests) == 1
    if name == "pr-regrow":
        assert want[0]["shuffle"]["regrows"] >= 1
        assert want[0]["shuffle"]["shuffle_cap"] > 16


def _psum_inputs():
    """Stacked partials [WORLD, ...] of magnitudes 1e-3 to 1e3, so that
    the order of adds shows."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((WORLD, 65, 33)).astype(np.float32)
    x *= np.float32(10.0) ** rng.integers(-3, 4, x.shape)
    return {"x_f32": x, "x_bf16": torch.from_numpy(x).bfloat16().view(
        torch.uint16).numpy()}


@pytest.mark.parametrize("name", sorted(PSUM))
def test_psum_on_ranks_is_the_rank_order_sum(ranks, name):
    """Every rank's ``psum`` equals the float32 sum of its group's
    partials added in rank order and rounded once, bit for bit, in
    float32 and bf16."""
    from repro_torch.core.distributed import coords_of
    axes = PSUM[name]
    z = _psum_inputs()
    for r in range(WORLD):
        mine = coords_of(PSUM_MESH, r)
        group = [q for q in range(WORLD) if all(
            coords_of(PSUM_MESH, q)[a] == mine[a] for a in PSUM_MESH
            if a not in axes)]
        assert len(group) == np.prod([PSUM_MESH[a] for a in axes])
        got = np.load(ranks["root"] / f"psum_r{r}.npz")
        for k, parts in z.items():
            t = torch.from_numpy(parts)
            if k == "x_bf16":
                t = t.view(torch.bfloat16)
            acc = t[group[0]].float()
            for q in group[1:]:
                acc = acc + t[q].float()
            want = acc.to(t.dtype)
            if k == "x_bf16":
                want = want.view(torch.uint16)
            np.testing.assert_array_equal(
                got[f"{'+'.join(axes)}.{k}"], want.numpy(),
                err_msg=f"{name} rank {r} {k}")


def test_compressed_psum_on_ranks_equals_stacked(ranks):
    z = np.load(ranks["root"] / "in_compress.npz")
    mean, err = compressed_psum(torch.from_numpy(z["x"]),
                                torch.from_numpy(z["err"]))
    for r in range(WORLD):
        got = np.load(ranks["root"] / f"compress_r{r}.npz")
        np.testing.assert_array_equal(got["mean"], mean[r].numpy())
        np.testing.assert_array_equal(got["err"], err[r].numpy())


# ---------------------------------------------------------------------------
# The MoE's a2a path
# ---------------------------------------------------------------------------

def _rel(want, got):
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    return float(np.abs(want - got).max() / max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("name", sorted(MOE))
def test_moe_a2a_on_ranks_matches_reference(ranks, name):
    """The port's ``apply_moe`` with ``moe_impl="a2a"`` on 4 ranks against
    the reference's on 4 host devices: expert ids equal, float32 output
    within 1e-5 of the largest |output|."""
    got = torch.load(ranks["root"] / f"{name}.pt")
    ref = ranks["ref"]
    arch, mesh, shape, cf, skewed = MOE[name]
    cfg = moe_config(_moe_spec(name))
    np.testing.assert_array_equal(got["eid"].numpy(), ref[f"{name}_eid"])
    assert _rel(ref[f"{name}_y"], got["y"]) < F32_REL
    out = ranks["results"][0][name]
    assert out["dropped"] == int((~got["kept"]).sum())
    assert (out["dropped"] > 0) == skewed, out["dropped"]
    assert out["experts"] == cfg.moe.num_experts // mesh["model"]


@pytest.mark.parametrize("name", sorted(MOE_LM))
def test_moe_lm_a2a_prefill_equals_gather(ranks, name):
    """Two smoke LMs' prefill with ``moe_impl="a2a"`` on 4 ranks (each
    holding its experts only) equals the port's ``gather`` prefill."""
    arch, _ = MOE_LM[name]
    cfg, model = _lm_model(arch)
    want = make_prefill_step(cfg, "cpu")(model, {"inputs": ranks["toks"]})
    got = torch.load(ranks["root"] / f"{name}.pt")["logits"]
    assert got.shape == want.shape
    assert _rel(want, got) < F32_REL


# ---------------------------------------------------------------------------
# The dense LM tensor-parallel against the reference's GSPMD
# ---------------------------------------------------------------------------

def _tp_replicated(root, name):
    """The port's replicated run on the job's weights: (config, weights,
    prefill logits, decode logits [steps, B, V], caches, the prefill's
    dropped slots)."""
    from repro_torch.launch.ranks import RoutingProbe, dropped_slots
    from repro_torch.launch.steps import make_serve_step
    from repro_torch.models.transfer import params_from_numpy, \
        to_reference_tree
    cfg = _tp_config(name)
    z = np.load(root / f"in_{name}.npz")
    flat = {k[2:]: torch.from_numpy(z[k]) for k in z.files
            if k.startswith("p.")}
    model = params_from_numpy(cfg, to_reference_tree(cfg, flat), "cpu")
    toks = torch.from_numpy(z["toks"])
    with RoutingProbe() as probe:
        pre = make_prefill_step(cfg, "cpu")(model, {"inputs": toks})
    dropped = dropped_slots(cfg, probe.eids)[0]
    serve = make_serve_step(cfg, "cpu")
    b = toks.shape[0]
    caches = tlm.init_caches(cfg, b, TP_STEPS, device="cpu")
    steps = []
    for t in range(TP_STEPS):
        out, caches = serve(model, caches, toks[:, t:t + 1])
        steps.append(out)
    return cfg, flat, pre, torch.stack(steps), caches, dropped


@pytest.fixture(scope="module")
def tp_replicated(ranks):
    return {name: _tp_replicated(ranks["root"], name) for name in LM_TP}


@pytest.mark.parametrize("name", sorted(LM_TP))
def test_lm_tp_shards_equal_gspmd(ranks, tp_replicated, name):
    """Each rank's parameters equal the reference device's shard (device
    r is rank r) bit for bit; each fused input (``ffn.w_in``, mLSTM's
    ``w_up``, sLSTM's ``up``, the MoE's ``shared_in``) holds ``[a_r |
    b_r]``, as many columns as the device's, and every one is split."""
    from repro_torch.core.distributed import coords_of
    from repro_torch.models.shard import Layout, is_fused_glu
    mesh = LM_TP[name][1]
    cfg, flat, *_ = tp_replicated[name]
    _, where = _ref_paths(cfg, {n: a.numpy() for n, a in flat.items()})
    index = ranks["ref_index"][name]
    plan = tlm.plan_model(cfg)
    fused = 0
    for r in range(WORLD):
        got = torch.load(ranks["root"] / f"{name}_r{r}.pt")["params"]
        assert sorted(got) == sorted(plan)
        layout = Layout(cfg, mesh, coords_of(mesh, r))
        for n, t in got.items():
            path, cyc = where[n]
            idx = [slice(a, b) for a, b in index[path][str(r)]]
            if cyc is not None:
                assert idx[0] == slice(0, cfg.cycles)
                idx = idx[1:]
            whole = flat[n].numpy()
            dev = whole[tuple(idx)]
            if is_fused_glu(cfg, n) and dev.shape != whole.shape:
                fused += 1
                assert dev.shape == tuple(t.shape)
                np.testing.assert_array_equal(
                    t.numpy(), layout.take(n, plan[n], whole))
                assert not np.array_equal(t.numpy(), dev)
            else:
                np.testing.assert_array_equal(t.numpy(), dev, err_msg=n)
    want = sum(is_fused_glu(cfg, n) for n in plan)
    assert want > 0
    assert fused == WORLD * want


@pytest.mark.parametrize("name", sorted(LM_TP))
def test_lm_tp_logits_match_reference(ranks, name):
    """Rank 0's prefill and 8 decode steps' logits (the whole [B, V] every
    rank returns) within 2e-4 of the reference's GSPMD run's; what each
    rank holds of its first layer of each kind."""
    got = torch.load(ranks["root"] / f"{name}.pt")
    ref = ranks["ref"]
    assert got["prefill"].shape == ref[f"{name}_prefill"].shape
    assert got["decode"].shape == ref[f"{name}_decode"].shape
    assert _rel(ref[f"{name}_prefill"], got["prefill"]) < LM_REL
    assert _rel(ref[f"{name}_decode"], got["decode"]) < LM_REL
    heads, experts, columns = LM_TP[name][2]
    for o in ranks["results"]:
        held = o[name]
        assert (held["heads"], held["experts"], held["columns"]) == \
            (heads, experts, columns), held


def _cache_part(layout, cfg, kind, key, want):
    """The rank's part of the replicated run's cache ``want`` (its rows
    already taken) of a layer of ``kind``: the kv heads its q heads read
    (GQA), its RG-LRU columns, or all of it (MLA's latent, the cells)."""
    if key in ("k", "v"):
        return want[:, :, layout.attn_heads().kv]
    if kind == "rec":
        part = layout.rec()
        return want[..., part.lo:part.lo + part.n]
    return want


@pytest.mark.parametrize("name", sorted(LM_TP))
def test_lm_tp_caches_and_decode_vs_prefill(ranks, tp_replicated, name):
    """Each rank's caches within 1e-5 of its part of the replicated run's
    (its rows; the kv heads it reads, its RG-LRU columns, MLA's latent
    and the cells' states whole); the sharded logits within 2e-4 of the
    replicated ones, and the last decode step of the prefill of the
    decoded tokens.  The DeepSeek-V3 case on (2, 2) drops slots in its
    prefill (none in the decode)."""
    from repro_torch.core.distributed import coords_of
    from repro_torch.models.common import softcap
    from repro_torch.models.shard import Layout
    mesh = LM_TP[name][1]
    cfg, _, pre, dec, caches, dropped = tp_replicated[name]
    assert (dropped > 0) == (name == "tp-deepseek-2x2"), dropped
    b = _tp_shape(name)[0]
    for r in range(WORLD):
        layout = Layout(cfg, mesh, coords_of(mesh, r))
        rows = layout.rows(b)[0]
        got = torch.load(ranks["root"] / f"{name}_r{r}.pt")["caches"]
        assert len(got) == len(caches["layers"])
        for kind, layer, want in zip(cfg.layer_kinds, got, caches["layers"]):
            assert sorted(layer) == sorted(want)
            for part, c in want.items():
                assert sorted(layer[part]) == sorted(c)
                for k, t in c.items():
                    w = _cache_part(layout, cfg, kind, k, t[rows])
                    assert layer[part][k].shape == w.shape, (kind, k)
                    assert float((layer[part][k] - w).abs().max()) < \
                        CACHE_TOL, (kind, k)
    got = torch.load(ranks["root"] / f"{name}.pt")
    assert _rel(pre, got["prefill"]) < LM_REL
    assert _rel(dec, got["decode"]) < LM_REL
    last = softcap(got["prefill_short"][:, 0], cfg.logit_softcap)
    assert _rel(last, got["decode"][-1]) < LM_REL


# ---------------------------------------------------------------------------
# Training over the mesh against the reference's GSPMD step
# ---------------------------------------------------------------------------

def _train_ref(ranks, name):
    """(config, the port's weights by name, the reference's loss, grad
    norm, gradients and parameters after its step, by the port's names:
    the body leaves' cycle taken from the reference's stacked leaf)."""
    cfg, flat, _, _ = _train_inputs(name, 60 + list(LM_TRAIN).index(name))
    _, where = _ref_paths(cfg, flat)
    ref = ranks["ref"]

    def by_name(tag):
        out = {}
        for n, (path, cyc) in where.items():
            a = ref[f"{name}_{tag}/{path}"]
            out[n] = a if cyc is None else a[cyc]
        return out
    return (cfg, flat, float(ref[name + "_loss"]),
            float(ref[name + "_gnorm"]), by_name("g"), by_name("p"))


def _rank_layouts(cfg, mesh):
    from repro_torch.core.distributed import coords_of
    from repro_torch.models.shard import Layout
    return [Layout(cfg, mesh, coords_of(mesh, r)) for r in range(WORLD)]


TRAIN_REF = sorted(n for n, c in LM_TRAIN.items() if c[4] == "reference")


@pytest.mark.parametrize("name", TRAIN_REF)
def test_lm_train_grads_match_reference(ranks, name):
    """The first step's loss (within 1e-5) and every rank's gradient shard
    of every leaf, the whole batch's (within 1e-4 of the leaf's largest
    |gradient|), against the reference's ``jax.value_and_grad(lm_loss)``
    jitted under its 4-device mesh, each device's shard; the fused inputs
    by the ``[a_r | b_r]`` rule (``Layout.take``)."""
    cfg, _, loss, _, grads, _ = _train_ref(ranks, name)
    plan = tlm.plan_model(cfg)
    mesh = LM_TRAIN[name][1]
    for r, layout in enumerate(_rank_layouts(cfg, mesh)):
        got = torch.load(ranks["root"] / f"{name}_r{r}.pt")
        assert abs(got["loss0"] - loss) <= LOSS_TOL * max(1.0, abs(loss))
        assert sorted(got["grads0"]) == sorted(plan)
        for n, g in got["grads0"].items():
            want = layout.take(n, plan[n], grads[n])
            assert tuple(g.shape) == want.shape, n
            assert float(np.abs(g.numpy() - want).max()) <= \
                GRAD_REL * float(np.abs(grads[n]).max()), (r, n)


@pytest.mark.parametrize("name", TRAIN_REF)
def test_lm_train_step_matches_reference(ranks, name):
    """One step of ``make_train_step(mesh=)``: every rank reports the
    reference's loss and grad norm (within 1e-5), and every parameter
    shard after it equals the reference's ``make_train_step`` under its
    mesh within 1e-4 of the leaf's largest |update|; the gradients'
    reduction over ``"data"`` ran where the batch splits."""
    cfg, flat, loss, gnorm, _, new = _train_ref(ranks, name)
    plan = tlm.plan_model(cfg)
    mesh = LM_TRAIN[name][1]
    for r, layout in enumerate(_rank_layouts(cfg, mesh)):
        out = ranks["results"][r][name]
        assert abs(out["loss"][0] - loss) <= LOSS_TOL * max(1.0, abs(loss))
        assert abs(out["grad_norm"][0] - gnorm) <= LOSS_TOL * max(1.0, gnorm)
        comm = out["comm"][0]
        assert (comm["grads"]["psum_calls"] > 0) == (mesh["data"] > 1)
        assert comm["backward"]["psum_calls"] > 0
        got = torch.load(ranks["root"] / f"{name}_r{r}.pt")["params"]
        for n, p in got.items():
            want = layout.take(n, plan[n], new[n])
            moved = np.abs(want - layout.take(n, plan[n], flat[n])).max()
            assert moved > 0, n
            assert float(np.abs(p.numpy() - want).max()) <= \
                GRAD_REL * moved, (r, n)


@pytest.mark.parametrize("name", sorted(
    n for n, c in LM_TRAIN.items() if c[4] == "replicated"))
def test_lm_train_on_ranks_equals_replicated(ranks, name):
    """``make_train_step(mesh=)`` on (data 2, model 2) against the port's
    own replicated steps (the MoE on ``gather``) on the same weights and
    batches: each step's loss and grad norm within 1e-5, the first step's
    gradient shards, the parameter shards and AdamW's first moments after
    the steps within 1e-4 of the leaf's largest |gradient|, |update| and
    |moment|.  Qwen3's two steps show
    the gradients' reduction over ``"data"`` and the global norm right
    without the reference; DeepSeek-V3's the ``a2a`` exchanges' reverse."""
    from repro_torch.launch.ranks import lm_config, train_batches, train_lm
    from repro_torch.launch.steps import value_and_grad
    from repro_torch.models.transfer import params_from_numpy, \
        to_reference_tree
    spec = dict(_train_spec(name), data=str(ranks["root"] / f"in_{name}.npz"))
    cfg = lm_config(spec).replace(moe_impl="gather")
    z = np.load(spec["data"])
    flat = {k[2:]: torch.from_numpy(z[k]) for k in z.files
            if k.startswith("p.")}
    model = params_from_numpy(cfg, to_reference_tree(cfg, flat), "cpu",
                              trainable=True)
    batches = train_batches(spec, torch.from_numpy(z["toks"]))
    _, grads = value_and_grad(cfg, model, batches[0])
    want, state = train_lm(cfg, model, batches, torch.device("cpu"),
                           opt=spec["opt"])
    plan = tlm.plan_model(cfg)
    params = dict(model.named_parameters())
    for r, layout in enumerate(_rank_layouts(cfg, spec["mesh"])):
        out = ranks["results"][r][name]
        for k in ("loss", "grad_norm"):
            assert np.allclose(out[k], want[k], rtol=LOSS_TOL, atol=0), k
        assert all(c["grads"]["psum_calls"] > 0 for c in out["comm"])
        got = torch.load(ranks["root"] / f"{name}_r{r}.pt")
        for n, g in got["grads0"].items():
            w = layout.take(n, plan[n], grads[n])
            assert float((g - w).abs().max()) <= \
                GRAD_REL * float(grads[n].abs().max()), (r, n)
        for n, p in got["params"].items():
            w = layout.take(n, plan[n], params[n].detach())
            moved = float((w - layout.take(n, plan[n], flat[n])).abs().max())
            assert float((p - w).abs().max()) <= GRAD_REL * moved, (r, n)
        assert sorted(got["m"]) == sorted(plan)
        for n, m in got["m"].items():
            w = layout.take(n, plan[n], state["m"][n])
            assert float((m - w).abs().max()) <= \
                GRAD_REL * float(state["m"][n].abs().max()), (r, n)


# ---------------------------------------------------------------------------
# Snapshots and failures
# ---------------------------------------------------------------------------

@pytest.fixture
def solo_group(tmp_path):
    """A process group of one rank in this process (gloo)."""
    tdist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rv'}",
                             rank=0, world_size=1,
                             timeout=timedelta(seconds=60))
    yield
    tdist.destroy_process_group()


def test_snapshot_per_rank_restores(ranks, solo_group):
    """The wordcount job checkpointed after ``run`` into one directory a
    rank, restored, and refreshed alike; a world of another size raises."""
    assert all(out["wc-flat"]["snapshot_equal"]
               for out in ranks["results"])
    root = ranks["root"] / "wc-flat-ckpt"
    assert sorted(p.name for p in root.iterdir()) == \
        [f"rank_{r:03d}" for r in range(WORLD)]
    z = np.load(ranks["root"] / "in_wordcount.npz")
    app, _, _ = make_app("wordcount", z)
    cfg = RunConfig(device="cpu", value_bytes=4, mesh=MeshConfig(
        RankMesh({"data": 1}, device="cpu", backend="gloo")))
    with pytest.raises(ValueError, match="4 rank"):
        Session.restore(app, str(root), cfg)


def test_rank_mesh_refuses_a_mismatch(solo_group):
    with pytest.raises(ValueError, match="world size is 1"):
        RankMesh({"data": 2}, device="cpu", backend="gloo")
    with pytest.raises(ValueError, match="backend"):
        RankMesh({"data": 1}, device="cpu", backend="mpi")
    with pytest.raises(ValueError, match="needs a process group of 4"):
        tmesh.make_host_mesh(4)
    with pytest.raises(ValueError, match="256 ranks"):
        tmesh.make_production_mesh(device="cpu", backend="gloo")
    mesh = RankMesh({"data": 1, "model": 1}, device="cpu", backend="gloo")
    with pytest.raises(ValueError, match="RankMesh"):
        RunConfig(device="cuda", mesh=MeshConfig(mesh))
    backwards = RankMesh({"data": 1, "pod": 1}, device="cpu",
                         backend="gloo")
    with pytest.raises(ValueError, match="pod axis comes before"):
        MeshConfig(backwards, pod_axis="pod")
    with pytest.raises(ValueError, match="follow the mesh's order"):
        backwards.group(("pod", "data"))
    assert (mesh.rank, mesh.world, dict(mesh.coords)) == \
        (0, 1, {"data": 0, "model": 0})
    assert tmesh.host_mesh_shape(8) == {"data": 2, "model": 4}
    assert tmesh.host_mesh_shape(8, ("pod", "data", "model")) == \
        {"pod": 1, "data": 2, "model": 4}


def test_expert_slice_needs_the_a2a_path():
    """A model holding a rank's experts only runs through ``a2a`` under a
    mesh; ``gather`` (or no mesh) refuses it."""
    cfg, model = _lm_model(LLAMA4)
    tree = {n: t.detach().numpy() for n, t in model.named_parameters()}
    half = {n: a[:2] if ".moe.w_" in n else a for n, a in tree.items()}
    sliced = tlm.LM(cfg, {n: torch.from_numpy(a) for n, a in half.items()},
                    ep_size=2)
    with pytest.raises(ValueError, match="expert-parallel slice"):
        make_prefill_step(cfg, "cpu")(sliced, {"inputs": np.zeros(
            (1, 4), np.int32)})
    with pytest.raises(ValueError, match="shape"):
        tlm.LM(cfg, {n: torch.from_numpy(a) for n, a in half.items()})


def test_draw_moe_slices_and_seeds_apart():
    """A rank's drawn expert slice equals that slice of the whole layer's
    draw, and no two experts or leaves share a generator seed, at an
    expert count past 100 (DeepSeek-V3's 256 at smoke width)."""
    import dataclasses
    cfg = t_smoke(_full_cfg(DEEPSEEK)).replace(param_dtype="float32",
                                               d_model=8)
    cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, num_experts=256,
                                              d_ff_expert=4, d_ff_shared=4))
    whole = draw_moe(cfg, 5, "cpu")
    for ep in ((0, 4), (3, 4), (63, 64)):
        part = draw_moe(cfg, 5, "cpu", ep=ep)
        lo, hi = ep[0] * 256 // ep[1], (ep[0] + 1) * 256 // ep[1]
        for n, a in part.items():
            want = whole[n][lo:hi] if n.startswith("w_") else whole[n]
            assert torch.equal(a, want), (ep, n)
    # every expert matrix's first row, and every other leaf's, is its own
    rows = [whole[n][e].flatten()[:4] for n in ("w_in", "w_out")
            for e in range(256)]
    rows += [whole[n].flatten()[:4] for n in ("router", "shared_in",
                                              "shared_out")]
    assert len({tuple(r.tolist()) for r in rows}) == len(rows)
    assert not torch.equal(draw_moe(cfg, 6, "cpu")["w_in"][0],
                           whole["w_in"][0])


@pytest.mark.parametrize("arch,mesh", [(DEEPSEEK, TWO_BY_2),
                                       (LLAMA4, ONE_BY_4)])
def test_draw_dense_shards_equal_the_replicated_draw(arch, mesh):
    """``draw_dense`` on a rank (only its experts drawn, each from its own
    seed) holds exactly the rank's part of the replicated draw, at every
    rank; DeepSeek-V3's experts over ("data", "model")."""
    from repro_torch.launch.mesh import MetaMesh
    from repro_torch.launch.ranks import draw_dense
    from repro_torch.models.shard import Layout
    cfg = t_smoke(_full_cfg(arch)).replace(param_dtype="float32")
    whole = dict(draw_dense(cfg, 7, "cpu").named_parameters())
    plan = tlm.plan_model(cfg)
    experts = [n for n in plan if tlm.is_expert_leaf(n)]
    assert experts and all(whole[n].shape[0] == cfg.moe.num_experts
                           for n in experts)
    for r in range(WORLD):
        where = MetaMesh(mesh, rank=r)
        layout = Layout.of(cfg, where)
        got = dict(draw_dense(cfg, 7, "cpu", mesh=where).named_parameters())
        assert sorted(got) == sorted(plan)
        for n, t in got.items():
            want = layout.take(n, plan[n], whole[n])
            assert torch.equal(t, want), (r, n)
        assert got[experts[0]].shape[0] == cfg.moe.num_experts // WORLD
    assert not torch.equal(whole[experts[0]][0], whole[experts[0]][1])


def test_nccl_without_a_card_raises():
    with pytest.raises(RuntimeError, match="CUDA"):
        RankMesh({"data": 1}, device="cpu", backend="nccl")
    with pytest.raises(RuntimeError, match="init_process_group"):
        RankMesh({"data": 1}, device="cpu", backend="gloo")


def test_a_dead_rank_fails_the_launch(tmp_path):
    """Rank 1 fails reading its row of a one-row input while rank 0 waits
    in the gather: the launcher kills rank 0 and raises with rank 1's
    error, well within its limit."""
    np.savez(tmp_path / "one.npz", x=np.zeros((1, 3), np.float32),
             err=np.zeros((1, 3), np.float32))
    (tmp_path / "spec.json").write_text(json.dumps({
        "jobs": [{"job": "compress", "name": "c",
                  "data": str(tmp_path / "one.npz")}],
        "out": str(tmp_path)}))
    with pytest.raises(RuntimeError, match="(?s)on 2 ranks: rank.*rank 1's stderr.*IndexError"):
        run_ranks(MODULE, 2, backend="gloo", device="cpu", timeout=120,
                  args=[str(tmp_path / "spec.json")])
