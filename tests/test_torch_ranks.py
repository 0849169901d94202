"""One process a rank: ``RankMesh`` on the CPU, gloo, ``file://``
rendezvous.

One launch of 4 ranks (``launch.ranks.run_ranks``, module fixture) runs
every job: wordcount, SSSP and PageRank on ``{"data": 4}`` and ``{"pod":
2, "data": 2}`` (and PageRank at a ``shuffle_cap`` of 16, which regrows),
each a run and two fine refreshes; ``compressed_psum``; a per-rank
snapshot restored; the MoE's ``a2a`` layer at smoke Llama 4 Scout and
DeepSeek-V3 on ``(data 1, model 4)`` and ``(2, 2)`` (and one case with a
low ``capacity_factor`` that drops slots); and two smoke LMs' prefill with
``moe_impl="a2a"``.  All four meshes are views of the one world of 4.
While the ranks run, one subprocess runs the reference's ``a2a`` on 4
forced host devices (as ``tests/test_torch_distributed.py``'s mesh test).

The sizes are ``tests/test_torch_distributed.py``'s (wordcount VOCAB 32 x
64 documents of 4 words; PageRank S 256, F 5; SSSP 96 vertices, 4
slots).  Tolerances: the engine on ranks equals ``LocalMesh`` at the same
P bit for bit (results, iteration counts, logs, ``ShuffleStats`` but for
its seconds, store sizes), on every rank; ``compressed_psum`` on ranks
equals the stacked form bit for bit; the ``a2a`` layer's expert ids equal
the reference's and its float32 output lies within 1e-5 of the largest
|output|; the LM's last-token logits with ``a2a`` within 1e-5 of the
port's ``gather`` prefill (no slot drops: 8 tokens a rank, under the
capacity's floor).
"""
import json
import os
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


def _lm_model(arch, seed=3):
    cfg = t_smoke(_full_cfg(arch)).replace(param_dtype="float32",
                                           compute_dtype="float32")
    return cfg, tlm.init_params(cfg, torch.Generator().manual_seed(seed),
                                device="cpu")


_REF_MOE = """
import json, sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh
import dataclasses
import repro.configs as C
from repro.models import blocks, meshctx
from repro.models.common import rms_norm
from repro.models.config import smoke_config
cases = json.loads(open(sys.argv[1]).read())
out = {}
for name, c in cases.items():
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
    """Write every job's inputs, start the reference's ``a2a`` subprocess,
    run the 4 ranks, then wait for the reference."""
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
    ref_cases = {}
    for i, (name, (arch, mesh, shape, cf, skewed)) in enumerate(MOE.items()):
        path = root / f"in_{name}.npz"
        np.savez(path, **_moe_inputs(arch, shape, cf, skewed, 20 + i))
        jobs.append(dict(_moe_spec(name), job="moe", name=name,
                         data=str(path)))
        ref_cases[name] = {"arch": arch, "mesh": mesh,
                           "capacity_factor": cf, "data": str(path)}
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
    (root / "ref.json").write_text(json.dumps(ref_cases))
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu", PYTHONPATH=SRC)
    ref = subprocess.Popen(
        [sys.executable, "-c", _REF_MOE, str(root / "ref.json"),
         str(root / "ref.npz")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        results = run_ranks(MODULE, WORLD, backend="gloo", device="cpu",
                            timeout=300, args=[str(root / "spec.json")])
        out, err = ref.communicate(timeout=300)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.wait()
    assert ref.returncode == 0, err[-4000:]
    return {"root": root, "results": results, "data": data, "toks": toks,
            "ref": np.load(root / "ref.npz")}


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
