"""One process a rank: the launcher and the jobs the ranks run.

:func:`run_ranks` starts ``n`` processes of ``python -m <module> ARGS``;
each reads its rank from the environment, joins the group with
:func:`init_rank` (a ``file://`` rendezvous in a fresh temporary
directory: no TCP port to race over) and prints one JSON line last.  This
module is such a program:

  python -m repro_torch.launch.ranks SPEC.json

runs the jobs of ``SPEC.json`` (``{"jobs": [...], "out": DIR}``) in
order, every rank the same jobs on the same inputs (SPMD), and prints
``{job name: its summary}``:

  * ``wordcount``, ``sssp``, ``pagerank``: a ``Session`` on
    ``RunConfig(mesh=MeshConfig(RankMesh(...)))``, ``run`` then each
    delta of the job's ``.npz``; each epoch's report (mode, iterations,
    changes, affected keys, logs, ``ShuffleStats`` but for its seconds,
    store sizes, a digest of the counts and the result), its seconds and
    exchange seconds, the kernels' launches and the device's peak memory.
    Rank 0 writes every epoch's result to ``DIR/<name>.npz``.  With
    ``"snapshot": true`` the session is checkpointed after ``run`` (one
    directory a rank), restored into a second session, and both take the
    deltas: ``snapshot_equal``.
  * ``compress``: ``optim.compress.compressed_psum`` of the rank's row of
    the ``.npz``'s stacked ``x`` and ``err``; each rank writes
    ``DIR/<name>_r<rank>.npz``.
  * ``moe``: one MoE layer through ``blocks.apply_moe`` with ``moe_impl=
    "a2a"`` under the ambient mesh, each rank holding its experts only;
    weights and ``x`` from the ``.npz`` or drawn on the device from a
    seed (:func:`draw_moe`).  Rank 0 writes ``y``, the expert ids and the
    kept slots to ``DIR/<name>.pt``.
  * ``moe_lm``: an LM's prefill with ``moe_impl="a2a"`` from the flat
    weights of the ``.npz`` (``params_from_numpy(..., ep=...)``); rank 0
    writes the logits.
  * ``psum``: ``RankMesh.psum`` of the rank's row of each stacked array of
    the ``.npz`` (float32; bfloat16 as its uint16 patterns, keys ending
    in ``_bf16``) over each axis group of ``spec["axes"]`` (a list of
    lists of ``spec["mesh"]``'s axes); each rank writes
    ``DIR/<name>_r<rank>.npz``, a group's sums under ``<axes joined by
    "+">.<key>``.
  * ``lm_tp``: an LM served tensor-parallel over ``spec["mesh"]``
    (``models.shard``; every block kind): each rank holds its shards, from
    the flat weights of the ``.npz`` (``params_from_numpy(..., mesh=...)``,
    its ``toks``) or drawn on the device from ``spec["seed"]``
    (:func:`draw_dense`, only the rank's experts; ids of
    ``spec["shape"]``); the config from ``arch``, ``smoke``, ``layers``,
    ``replace`` and ``moe`` (:func:`lm_config`); it prefills the first
    ``spec["steps"]`` ids
    (untimed), then all of them, then decodes those first ids from empty
    caches one step at a time, the last step held against the first
    prefill (:func:`serve_lm`; with ``"routes": true`` recording each MoE
    layer's experts and the prefill's logits at every position).  Rank 0
    writes the logits (and the routes) to
    ``DIR/<name>.pt``; with ``"dump": true`` every rank writes its
    parameters and caches to ``DIR/<name>_r<rank>.pt``.  Each rank reports its seconds (prefill,
    decode steps, inside ``psum`` and ``all_gather``), flash launches,
    what it holds (:func:`held_parts`), parameter bytes and peak memory.
  * ``lm_train``: an LM trained over ``spec["mesh"]``, each rank on its
    shards (``make_train_step(..., mesh=)``): the weights as ``lm_tp``'s
    (the ``.npz``'s ``p.<flat name>``, or :func:`draw_dense` from
    ``spec["seed"]``), the batches from the ``.npz``'s ``toks`` [N, B, S
    + 1] (inputs the first S, targets the last S) and ``mask`` [N, B, S]
    (all on without it), or drawn from the seed at ``spec["shape"]`` (N,
    B, S); AdamW by ``spec["opt"]`` (``AdamWConfig`` kwargs); N steps
    (:func:`train_lm`).  Each rank reports each step's loss, grad norm and
    seconds, what the mesh counted in each phase of each step (forward,
    backward, the gradients' reduction, the update), the flash launches a
    step, its parameter and moment bytes and peak memory; with ``"dump":
    true`` every rank writes ``DIR/<name>_r<rank>.pt``: the first step's
    loss and reduced gradients (:func:`launch.steps.value_and_grad`, run
    once more before the steps), the parameters and AdamW's first moments
    ``m`` after the last (with ``"dump": "params"`` only these two).

The kernels are built by the caller before the ranks start on a card
(:func:`run_ranks` does it), so that the ranks only load them.
"""
from __future__ import annotations

import hashlib
import json
import math
import os
import signal
import subprocess
import sys
import tempfile
import time
from datetime import timedelta
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

# seconds the launcher waits, after a rank fails, for the others to exit
GRACE_S = 5.0
ENV = ("REPRO_RANK", "REPRO_WORLD", "REPRO_INIT", "REPRO_BACKEND",
       "REPRO_DEVICE", "REPRO_TIMEOUT")


# ---------------------------------------------------------------------------
# The launcher
# ---------------------------------------------------------------------------

def _tail(path: Path, n: int = 6000) -> str:
    try:
        return path.read_text(errors="replace")[-n:]
    except OSError:
        return ""


def _kill(procs) -> None:
    for p in procs:
        if p.poll() is None:
            try:
                os.killpg(p.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
    for p in procs:
        p.wait()


def run_ranks(module: str, n: int, *, backend: str, device: str,
              timeout: float, args: Sequence[str] = ()) -> List[dict]:
    """Run ``python -m module *args`` as ranks 0..n-1 of one process group
    and return each rank's last JSON line (a dict), in rank order.

    ``backend`` is ``"gloo"`` or ``"nccl"``; ``device`` the ranks' device,
    ``"{rank}"`` in it standing for the rank (``"cuda:{rank}"``: a card
    each; ``"cuda:0"``: ranks sharing one card; ``"cpu"``).  Each process
    runs in a process group of its own; when one exits with an error, or
    ``timeout`` seconds pass, every one is killed and this raises with the
    failing ranks' standard error (a rank that dies takes its peers'
    collectives down with it: their errors come too).  Nothing is retried or switched.
    """
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"backend must be gloo or nccl, got {backend!r}")
    if device.startswith("cuda"):
        from repro_torch.kernels import _build
        _build.build_all()
    src = str(Path(__file__).resolve().parents[2])
    work = Path(tempfile.mkdtemp(prefix="repro-ranks-"))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [src] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    procs, outs, errs = [], [], []
    try:
        for r in range(n):
            env.update(REPRO_RANK=str(r), REPRO_WORLD=str(n),
                       REPRO_INIT=f"file://{work / 'rendezvous'}",
                       REPRO_BACKEND=backend,
                       REPRO_DEVICE=device.format(rank=r),
                       REPRO_TIMEOUT=str(timeout))
            outs.append(work / f"rank{r}.out")
            errs.append(work / f"rank{r}.err")
            with open(outs[-1], "wb") as o, open(errs[-1], "wb") as e:
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", module, *args], env=dict(env),
                    stdout=o, stderr=e, stdin=subprocess.DEVNULL,
                    start_new_session=True))
        deadline = time.monotonic() + timeout
        grace = None
        while True:
            codes = [p.poll() for p in procs]
            bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if bad and grace is None:
                # the others' errors follow within a moment: wait for
                # them, briefly, so that the report holds the first cause
                grace = min(deadline, time.monotonic() + GRACE_S)
            if bad and (None not in codes or time.monotonic() > grace):
                _kill(procs)
                raise RuntimeError(
                    f"{module} on {n} ranks: rank(s) {bad} exited with "
                    f"code(s) {[codes[r] for r in bad]}" + "".join(
                        f"\n--- rank {r}'s stderr ---\n{_tail(errs[r])}"
                        for r in bad))
            if all(c == 0 for c in codes):
                break
            if time.monotonic() > deadline:
                _kill(procs)
                raise TimeoutError(
                    f"{module} on {n} ranks passed its {timeout} s limit; "
                    f"rank 0's stderr:\n{_tail(errs[0])}")
            time.sleep(0.05)
        results = []
        for r in range(n):
            lines = [l for l in outs[r].read_text().splitlines()
                     if l.startswith("{")]
            if not lines:
                raise RuntimeError(f"rank {r} printed no JSON line:\n"
                                   f"{_tail(errs[r])}")
            results.append(json.loads(lines[-1]))
        return results
    finally:
        _kill(procs)
        for f in outs + errs:
            f.unlink(missing_ok=True)
        for f in work.iterdir():
            f.unlink(missing_ok=True)
        work.rmdir()


def init_rank():
    """Join the group :func:`run_ranks` set up: ``(rank, world, backend,
    device)``; the group's ``timeout`` is the launcher's, so that a rank
    left waiting in a collective fails instead of hanging.  Each rank
    takes ``cpu_count // world`` intra-op threads."""
    import torch
    import torch.distributed as tdist
    missing = [k for k in ENV if k not in os.environ]
    if missing:
        raise RuntimeError(f"not started by run_ranks: {missing} unset")
    rank, world = int(os.environ["REPRO_RANK"]), int(os.environ["REPRO_WORLD"])
    backend = os.environ["REPRO_BACKEND"]
    device = torch.device(os.environ["REPRO_DEVICE"])
    # the ranks share the host's cores: each takes its share of them
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    if device.type == "cuda":
        torch.cuda.set_device(device)
    tdist.init_process_group(
        backend, init_method=os.environ["REPRO_INIT"], rank=rank,
        world_size=world,
        timeout=timedelta(seconds=float(os.environ["REPRO_TIMEOUT"])))
    return rank, world, backend, device


# ---------------------------------------------------------------------------
# The jobs
# ---------------------------------------------------------------------------

def _digest(*arrays) -> str:
    h = hashlib.sha256()
    for a in arrays:
        a = np.ascontiguousarray(a)
        h.update(str((a.dtype, a.shape)).encode())
        h.update(a.tobytes())
    return h.hexdigest()[:16]


def report_summary(rep) -> dict:
    """A ``RunReport`` as JSON, its seconds apart (they differ from rank
    to rank and run to run; everything else must not)."""
    sh = rep.shuffle
    logs = [[l.iteration, l.n_input_changes, l.n_affected_dks,
             l.n_emitted, bool(l.mrbg_on), l.io_reads, l.io_bytes]
            for l in rep.logs]
    return {
        "mode": rep.mode, "iters": rep.iters, "epoch": rep.epoch,
        "max_change": [float(c) for c in rep.max_change],
        "affected_keys": rep.affected_keys, "logs": logs,
        "counts": None if rep.counts is None else _digest(rep.counts),
        "io": None if rep.io is None else [rep.io.n_reads,
                                           rep.io.bytes_read],
        "store": [rep.store_bytes, rep.live_bytes, rep.store_batches],
        "mrbg_on": bool(rep.mrbg_on),
        "shuffle": {"edges_exchanged": sh.edges_exchanged,
                    "bytes_moved": sh.bytes_moved, "dropped": sh.dropped,
                    "shuffle_cap": sh.shuffle_cap, "regrows": sh.regrows,
                    "steps": len(sh.exchange_seconds)},
    }


def deltas_of(z, prefix: str = "d") -> list:
    """The deltas ``<prefix><i>_rid``, ``_sign`` and ``_v_<name>`` of an
    ``.npz``, in order, as ``(rid, {name: values}, sign)``."""
    out, i = [], 0
    while f"{prefix}{i}_rid" in z.files:
        pre = f"{prefix}{i}_v_"
        out.append((z[f"{prefix}{i}_rid"],
                    {k[len(pre):]: z[k] for k in z.files
                     if k.startswith(pre)}, z[f"{prefix}{i}_sign"]))
        i += 1
    return out


def save_deltas(arrays: dict, deltas, prefix: str = "d") -> dict:
    """:func:`deltas_of`'s layout: ``arrays`` with ``deltas`` added."""
    for i, (rid, vals, sign) in enumerate(deltas):
        arrays[f"{prefix}{i}_rid"] = rid
        arrays[f"{prefix}{i}_sign"] = sign
        arrays.update((f"{prefix}{i}_v_{n}", a) for n, a in vals.items())
    return arrays


def make_app(job: str, z):
    """``(spec, data, result key)`` of an engine job from its ``.npz``."""
    if job == "wordcount":
        from repro_torch.apps import wordcount as wc
        return (*wc.make_job(z["docs"], int(z["vocab"])), "c")
    if job == "sssp":
        from repro_torch.apps import sssp
        return (*sssp.make_job(z["nbrs"], z["w"], int(z["src"])), "d")
    if job == "pagerank":
        from repro_torch.apps import pagerank
        return (*pagerank.make_job(z["nbrs"]), "r")
    raise ValueError(f"unknown engine job {job!r}")


def _sync(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _engine_job(spec: dict, ctx: dict) -> dict:
    import torch
    from repro_torch.api import MeshConfig, RunConfig, Session, make_delta
    from repro_torch.core.distributed import RankMesh
    from repro_torch.kernels import launch_counts, reset_launch_counts
    device = ctx["device"]
    z = np.load(spec["data"])
    app, data, key = make_app(spec["job"], z)
    mesh = RankMesh(spec["mesh"], device=device, backend=ctx["backend"])
    cfg = RunConfig(device=device.type, mesh=MeshConfig(
        mesh, **spec.get("mesh_kw", {})), **spec.get("config", {}))
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    reset_launch_counts()
    sess = Session(app, cfg)
    deltas = [make_delta(*d) for d in deltas_of(z)]
    epochs, results, seconds, exchange = [], {}, [], []
    for i, d in enumerate([None] + deltas):
        _sync(device)
        t0 = time.perf_counter()
        rep = sess.run(data) if d is None else sess.update(d)
        seconds.append(time.perf_counter() - t0)
        exchange.append(sum(rep.shuffle.exchange_seconds))
        res = sess.result[key]
        results[f"r{i}"] = res
        epochs.append(dict(report_summary(rep), result=_digest(res)))
        if d is None and spec.get("snapshot"):
            root = Path(ctx["out"]) / f"{spec['name']}-ckpt"
            sess.checkpoint(str(root))
            twin = Session.restore(app, str(root), cfg)
    out = {"epochs": epochs, "seconds": seconds,
           "exchange_seconds": exchange, "launches": launch_counts(),
           "stores": len(sess.stores),
           "peak_gib": (torch.cuda.max_memory_allocated(device) / 2**30
                        if device.type == "cuda" else float("nan"))}
    if spec.get("snapshot"):
        same = True
        for i, d in enumerate(deltas, 1):
            twin.update(d)
            same &= bool(np.array_equal(twin.result[key], results[f"r{i}"]))
        out["snapshot_equal"] = same
    if ctx["rank"] == 0:
        np.savez(Path(ctx["out"]) / f"{spec['name']}.npz", **results)
    return out


def _compress_job(spec: dict, ctx: dict) -> dict:
    import torch
    from repro_torch.core.distributed import RankMesh
    from repro_torch.optim.compress import compressed_psum
    device, rank = ctx["device"], ctx["rank"]
    z = np.load(spec["data"])
    mesh = RankMesh({"data": ctx["world"]}, device=device,
                    backend=ctx["backend"])
    x = torch.from_numpy(z["x"][rank]).to(device)
    err = torch.from_numpy(z["err"][rank]).to(device)
    mean, new_err = compressed_psum(x, err, mesh=mesh)
    np.savez(Path(ctx["out"]) / f"{spec['name']}_r{rank}.npz",
             mean=mean.cpu().numpy(), err=new_err.float().cpu().numpy())
    return {"mean": _digest(mean.cpu().numpy())}


def draw_moe(cfg, seed: int, device, ep=None) -> dict:
    """An MoE layer's weights drawn on ``device`` from ``seed``: norm
    zeros, every matrix normal at 1/sqrt(its input width) (the experts'
    second axis), each leaf, and each expert, from a generator seeded by
    its own name and index, so that a rank holding experts ``ep = (index,
    size)`` draws the same values a whole layer holds, without the rest."""
    import torch
    mo, d = cfg.moe, cfg.d_model
    dtype = cfg.dtype("param")
    ffs = (mo.d_ff_shared or mo.d_ff_expert) * mo.num_shared
    shapes = {"router": (d, mo.num_experts),
              "w_in": (mo.num_experts, d, 2 * mo.d_ff_expert),
              "w_out": (mo.num_experts, mo.d_ff_expert, d)}
    if mo.num_shared:
        shapes.update(shared_in=(d, 2 * ffs), shared_out=(ffs, d))
    e_lo, e_hi = 0, mo.num_experts
    if ep is not None:
        e_loc = mo.num_experts // ep[1]
        e_lo, e_hi = ep[0] * e_loc, (ep[0] + 1) * e_loc
    gen = torch.Generator(device=device)
    # one generator seed a (seed, leaf, expert): leaf k's expert e takes
    # key k * num_experts + e, so no two of them share a seed at any
    # expert count
    n_keys = len(shapes) * mo.num_experts

    def normal(shape, key: int, fan_in: int):
        gen.manual_seed(seed * n_keys + key)
        return torch.randn(shape, generator=gen, device=device).mul_(
            1.0 / math.sqrt(fan_in)).to(dtype)

    out = {"norm": torch.zeros(d, dtype=dtype, device=device)}
    for k, (name, shape) in enumerate(shapes.items()):
        key = k * mo.num_experts
        if name.startswith("w_"):
            out[name] = torch.stack([normal(shape[1:], key + e, shape[1])
                                     for e in range(e_lo, e_hi)])
        else:
            out[name] = normal(shape, key, shape[0])
    return out


def moe_inputs(cfg, spec: dict, device, ep=None):
    """``(weights, x)`` of a ``moe`` job: from its ``.npz`` (float32, the
    experts sliced to ``ep``) or drawn on ``device`` from ``spec["seed"]``
    (:func:`draw_moe`; x normal at 1/sqrt(d) of ``spec["shape"]``), in the
    config's dtypes."""
    import torch
    dtype = cfg.dtype("compute")
    if "data" not in spec:
        gen = torch.Generator(device=device).manual_seed(spec["seed"])
        x = torch.randn(tuple(spec["shape"]) + (cfg.d_model,), generator=gen,
                        device=device).mul_(1.0 / math.sqrt(cfg.d_model))
        return draw_moe(cfg, spec["seed"], device, ep=ep), x.to(dtype)
    z = np.load(spec["data"])
    w = {k[2:]: torch.from_numpy(z[k]) for k in z.files
         if k.startswith("w_")}
    if ep is not None:
        e_loc = cfg.moe.num_experts // ep[1]
        for n in ("w_in", "w_out"):
            w[n] = w[n][ep[0] * e_loc:(ep[0] + 1) * e_loc]
    return ({n: a.to(device, cfg.dtype("param")) for n, a in w.items()},
            torch.from_numpy(z["x"]).to(device, dtype))


def moe_config(spec: dict):
    """The job's config: ``arch`` (smoke width with ``"smoke": true``),
    ``replace`` kwargs and ``capacity_factor``; ``moe_impl="a2a"``."""
    import dataclasses
    import repro_torch.configs as C
    from repro_torch.models.config import smoke_config
    cfg = C.get(spec["arch"])
    if spec.get("smoke"):
        cfg = smoke_config(cfg)
    cfg = cfg.replace(moe_impl="a2a", **spec.get("replace", {}))
    if "capacity_factor" in spec:
        cfg = cfg.replace(moe=dataclasses.replace(
            cfg.moe, capacity_factor=spec["capacity_factor"]))
    return cfg


class RoutingProbe:
    """Records the experts every MoE layer chooses while it is open: it
    wraps ``blocks.moe_route`` (which ``apply_moe`` looks up by name at
    each call) and puts it back on closing, so the serving path pays
    nothing for it outside a probe.  ``eids``: one [N, K] tensor a layer a
    forward, in layer order, left on the route's device (a timed call
    under the probe syncs no more than without it)."""

    def __enter__(self):
        from repro_torch.models import blocks
        self.eids, self._route = [], blocks.moe_route

        def route(cfg, router, tokens):
            gate, eid = self._route(cfg, router, tokens)
            self.eids.append(eid)
            return gate, eid
        blocks.moe_route = route
        return self

    def __exit__(self, *exc):
        from repro_torch.models import blocks
        blocks.moe_route = self._route


def dropped_slots(cfg, eids) -> tuple:
    """(slots dropped, slots) of the (token, k) choices ``eids`` (one [N,
    K] tensor a layer of one forward): a slot drops where its position in
    its expert's buffer reaches the capacity for N tokens."""
    from repro_torch.models import blocks
    drop = sum(int((blocks.moe_slots(e, cfg.moe.num_experts)
                    >= blocks.moe_capacity(cfg, e.shape[0])).sum())
               for e in eids)
    return drop, sum(e.numel() for e in eids)


def _moe_job(spec: dict, ctx: dict) -> dict:
    import torch
    from repro_torch.core.distributed import RankMesh
    from repro_torch.models import blocks, meshctx
    device = ctx["device"]
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = moe_config(spec)
    mesh = RankMesh(spec["mesh"], device=device, backend=ctx["backend"])
    ep_axes = tuple(a for a in cfg.moe.ep_axes if a in mesh.shape)
    p_ep = math.prod(mesh.shape[a] for a in ep_axes)
    w, x = moe_inputs(cfg, spec, device, ep=(mesh.index(ep_axes), p_ep))
    p = blocks.Params(w)
    meshctx.set_mesh(mesh)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    try:
        with torch.no_grad(), RoutingProbe() as probe:
            y = blocks.apply_moe(cfg, p, x)         # one untimed call
            _sync(device)
            t0 = time.perf_counter()
            y = blocks.apply_moe(cfg, p, x)
            _sync(device)
            secs = time.perf_counter() - t0
    finally:
        meshctx.set_mesh(None)
    eid = probe.eids[-1]
    order, _, _, ok, _ = blocks.a2a_slots(cfg, eid, p_ep)
    kept = torch.zeros_like(ok)
    kept[order] = ok
    # every rank's ids and kept slots, put back in token order
    eids, keeps = mesh.all_gather(eid), mesh.all_gather(kept.view(eid.shape))
    b, s = x.shape[:2]
    eid_all = torch.empty((b, s) + tuple(eid.shape[1:]), dtype=eid.dtype)
    kept_all = torch.empty(eid_all.shape, dtype=torch.bool)
    for r in range(mesh.world):
        sl = blocks.a2a_block(cfg, mesh, b, s, r)
        shape = (sl[0].stop - sl[0].start, sl[1].stop - sl[1].start, -1)
        eid_all[sl] = eids[r].view(shape).cpu()
        kept_all[sl] = keeps[r].view(shape).cpu()
    if ctx["rank"] == 0:
        torch.save({"y": y.cpu(), "eid": eid_all.view(b * s, -1),
                    "kept": kept_all.view(b * s, -1)},
                   Path(ctx["out"]) / f"{spec['name']}.pt")
    return {"seconds": secs, "dropped": int((~kept_all).sum()),
            "slots": int(kept_all.numel()),
            "experts": cfg.moe.num_experts // p_ep,
            "peak_gib": (torch.cuda.max_memory_allocated(device) / 2**30
                         if device.type == "cuda" else float("nan"))}


def _moe_lm_job(spec: dict, ctx: dict) -> dict:
    import torch
    from repro_torch.core.distributed import RankMesh
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import meshctx
    from repro_torch.models.transfer import params_from_numpy, \
        to_reference_tree
    device = ctx["device"]
    cfg = moe_config(spec)
    mesh = RankMesh(spec["mesh"], device=device, backend=ctx["backend"])
    ep_axes = tuple(a for a in cfg.moe.ep_axes if a in mesh.shape)
    z = np.load(spec["data"])
    flat = {k[2:]: torch.from_numpy(z[k]) for k in z.files
            if k.startswith("p.")}
    model = params_from_numpy(
        cfg, to_reference_tree(cfg, flat), device=device,
        ep=(mesh.index(ep_axes), math.prod(mesh.shape[a] for a in ep_axes)))
    meshctx.set_mesh(mesh)
    try:
        logits = make_prefill_step(cfg, device)(model, {"inputs": z["toks"]})
    finally:
        meshctx.set_mesh(None)
    if ctx["rank"] == 0:
        torch.save({"logits": logits.float().cpu()},
                   Path(ctx["out"]) / f"{spec['name']}.pt")
    return {"logits": list(logits.shape)}


def _psum_job(spec: dict, ctx: dict) -> dict:
    import torch
    from repro_torch.core.distributed import RankMesh
    mesh = RankMesh(spec["mesh"], device=ctx["device"],
                    backend=ctx["backend"])
    z = np.load(spec["data"])
    out = {}
    for axes in spec["axes"]:
        for k in z.files:
            x = torch.from_numpy(z[k][ctx["rank"]].copy())
            if k.endswith("_bf16"):
                x = x.view(torch.bfloat16)
            y = mesh.psum(x.to(ctx["device"]), axes).cpu()
            out[f"{'+'.join(axes)}.{k}"] = (
                y.view(torch.uint16) if k.endswith("_bf16") else y).numpy()
    np.savez(Path(ctx["out"]) / f"{spec['name']}_r{ctx['rank']}.npz", **out)
    return {"calls": mesh.stats["psum_calls"]}


def parity_fan_in(name: str, shape) -> int:
    """The input width by whose square root a parity draw (:func:`draw_dense`,
    ``chip_smoke.parity_model``) divides a normal leaf: its first axis
    (the embedding's is the vocabulary, as the reference's), the first two
    of attention's ``wo`` [H, hd, d], the second of the experts'
    ``moe.w_in`` [E, d, 2ff] and ``moe.w_out`` [E, ff, d] (the first is
    the expert), the last of sLSTM's ``r_gates`` [4, H, dh, dh] (its
    recurrent product contracts dh)."""
    if name.endswith(".wo"):
        return shape[0] * shape[1]
    if name.endswith(".r_gates"):
        return shape[-1]
    if ".moe.w_" in name:
        return shape[1]
    return shape[0]


def draw_dense(cfg, seed: int, device, mesh=None, trainable: bool = False):
    """An LM drawn on ``device`` from ``seed``: norms zeros, every matrix
    normal at 1/sqrt(its input width) (:func:`parity_fan_in`), rounded to
    ``cfg.param_dtype``.  Each leaf comes from a generator seeded by its
    place in the plan, drawn whole in float32; an MoE's expert leaves
    (``moe.w_in``, ``moe.w_out``) an expert at a time, each expert from a
    seed of its own (:func:`expert_seed`).  ``mesh``: the model of the
    mesh's own rank, each leaf cut to its shard after the draw and only
    the rank's experts drawn, so that every rank, and a process without a
    mesh, hold the same values (DeepSeek-V3's [256, 7168, 4096] leaf would
    take 30 GB in float32 a rank whole).  ``trainable``: the model takes
    gradients."""
    import torch
    from repro_torch.models import lm
    from repro_torch.models.shard import Layout
    layout = None if mesh is None else Layout.of(cfg, mesh)
    plan = lm.plan_model(cfg)
    dtype = cfg.dtype("param")
    gen = torch.Generator(device=device)
    tensors = {}
    for k, (name, s) in enumerate(plan.items()):
        if s.init == "normal" and lm.is_expert_leaf(name):
            held = range(s.shape[0]) if layout is None else range(
                *layout.slices(s)[0].indices(s.shape[0]))
            t = torch.empty((len(held),) + tuple(s.shape[1:]), dtype=dtype,
                            device=device)
            for i, e in enumerate(held):
                gen.manual_seed(expert_seed(seed, len(plan), k, e,
                                            s.shape[0]))
                t[i] = torch.randn(s.shape[1:], generator=gen,
                                   device=device).mul_(
                    1.0 / math.sqrt(parity_fan_in(name, s.shape)))
            tensors[name] = t
            continue
        if s.init != "normal":
            t = (torch.zeros if s.init == "zeros" else torch.ones)(
                s.shape, device=device)
        else:
            gen.manual_seed(seed * len(plan) + k)
            t = torch.randn(s.shape, generator=gen, device=device).mul_(
                1.0 / math.sqrt(parity_fan_in(name, s.shape)))
        if layout is not None:
            t = layout.take(name, s, t)
        tensors[name] = t.to(dtype=dtype, copy=True)
        del t
    return lm.LM(cfg, tensors, trainable, layout=layout)


def expert_seed(seed: int, n_leaves: int, k: int, e: int, n_experts: int
                ) -> int:
    """The generator seed of expert ``e`` of plan leaf ``k`` in
    :func:`draw_dense`: past 2^40, apart from every leaf's seed
    ``seed * n_leaves + k``, and no two (leaf, expert) alike."""
    return 2**40 + (seed * n_leaves + k) * n_experts + e


def lm_config(spec: dict):
    """An ``lm_tp`` job's config: ``arch`` (smoke width with ``"smoke":
    true``, ``n_layers`` from ``"layers"``), ``replace`` kwargs (lists
    as tuples: ``prefix_blocks``) and ``moe`` kwargs for its ``MoEConfig``
    (``capacity_factor``, ``ep_axes``)."""
    import dataclasses
    import repro_torch.configs as C
    from repro_torch.models.config import smoke_config
    cfg = C.get(spec["arch"])
    if spec.get("smoke"):
        cfg = smoke_config(cfg)
    if spec.get("layers"):
        cfg = cfg.replace(n_layers=spec["layers"])
    if spec.get("moe"):
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, **{
            k: tuple(v) if isinstance(v, list) else v
            for k, v in spec["moe"].items()}))
    return cfg.replace(**{k: tuple(v) if isinstance(v, list) else v
                          for k, v in spec.get("replace", {}).items()})


def serve_lm(cfg, model, toks, steps: int, device, mesh=None,
             routes: bool = False) -> dict:
    """Serve ``toks`` [B, S] (a device tensor) with ``model``: the prefill
    of its first ``steps`` tokens (untimed: it warms the kernels, the
    library handles and the mesh's groups; the last decode step is held
    against it), the prefill's last-token logits, then those ``steps``
    tokens decoded one step at a time from empty caches.  Returns the
    logits (float32, on the host) and the seconds: ``prefill_s`` (the
    second prefill), ``decode_s`` a step, and, under ``mesh``, those spent
    inside its ``psum`` and ``all_gather`` (``prefill_comm``,
    ``decode_comm``), with the flash launches of the timed prefill;
    ``caches`` are the decode's.  ``routes``: also the experts each MoE
    layer chose (``routes``: ``prefill_short``, ``prefill`` and
    ``decode``, a list of [N, K] a layer, one such list a decode step,
    through :class:`RoutingProbe`) and the logits at every position of
    the prefill (``prefill_every`` [B, S, V], in the compute dtype), from
    an untimed prefill after the timed one, which the experts of
    ``prefill`` are; the decode steps' experts are copied to the host
    after each step's time is taken."""
    import contextlib
    import torch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models import lm, meshctx
    probe = RoutingProbe if routes else contextlib.nullcontext
    b, s = toks.shape
    prefill = make_prefill_step(cfg, device, mesh)
    serve = make_serve_step(cfg, device, mesh)
    with probe() as short_routes:
        short = prefill(model, {"inputs": toks[:, :steps]})
    reset_launch_counts()
    if mesh is not None:
        mesh.reset_stats()
    _sync(device)
    t0 = time.perf_counter()
    logits = prefill(model, {"inputs": toks})
    _sync(device)
    out = {"prefill_s": time.perf_counter() - t0,
           "flash": launch_counts()["flash_attention"]}
    if mesh is not None:
        out["prefill_comm"] = dict(mesh.stats)
    if routes:
        with torch.inference_mode(), meshctx.using(mesh), \
                RoutingProbe() as pre_routes:
            every = lm.prefill(cfg, model, toks, every=True).cpu()
    if mesh is not None:
        mesh.reset_stats()
    caches = lm.init_caches(cfg, b, steps, device=device, mesh=mesh)
    decoded, secs, step_routes = [], [], []
    for t in range(steps):
        t0 = time.perf_counter()
        with probe() as r:
            step, caches = serve(model, caches, toks[:, t:t + 1])
        _sync(device)
        secs.append(time.perf_counter() - t0)
        decoded.append(step.float().cpu())
        if routes:
            step_routes.append([e.cpu() for e in r.eids])
    if mesh is not None:
        out["decode_comm"] = dict(mesh.stats)
    out.update(decode_s=secs, caches=caches, logits={
        "prefill": logits.float().cpu(), "prefill_short": short.float().cpu(),
        "decode": torch.stack(decoded)})
    if routes:
        out["logits"].update(prefill_every=every, routes={
            "prefill_short": [e.cpu() for e in short_routes.eids],
            "prefill": [e.cpu() for e in pre_routes.eids],
            "decode": step_routes})
    return out


def lm_tp_inputs(cfg, spec: dict, device, mesh=None,
                 trainable: bool = False):
    """``(model, toks)`` of an ``lm_tp`` or ``lm_train`` job: from its
    ``.npz`` or drawn from its seed (:func:`draw_dense`; ids of
    ``spec["shape"]`` from the same seed), the model ``mesh``'s rank's."""
    import torch
    from repro_torch.models.transfer import params_from_numpy, \
        to_reference_tree
    if "data" in spec:
        z = np.load(spec["data"])
        flat = {k[2:]: torch.from_numpy(z[k]) for k in z.files
                if k.startswith("p.")}
        model = params_from_numpy(cfg, to_reference_tree(cfg, flat),
                                  device=device, trainable=trainable,
                                  mesh=mesh)
        toks = z["toks"]
    else:
        model = draw_dense(cfg, spec["seed"], device, mesh=mesh,
                           trainable=trainable)
        toks = np.random.default_rng(spec["seed"]).integers(
            0, cfg.vocab, spec["shape"]).astype(np.int32)
    return model, torch.from_numpy(toks).to(device)


def train_batches(spec: dict, toks) -> list:
    """An ``lm_train`` job's batches, one a step: ``toks`` [N, B, S + 1]
    cut into inputs and targets, the ``.npz``'s ``mask`` [N, B, S] or all
    on; drawn from the seed, ``spec["shape"]`` is (N, B, S) and the ids
    [N, B, S + 1]."""
    import torch
    mask = None
    if "data" in spec:
        z = np.load(spec["data"])
        if "mask" in z.files:
            mask = torch.from_numpy(z["mask"]).to(toks.device)
    out = []
    for i in range(toks.shape[0]):
        t = toks[i]
        out.append({"inputs": t[:, :-1], "targets": t[:, 1:],
                    "mask": torch.ones_like(t[:, 1:], dtype=torch.bool)
                    if mask is None else mask[i]})
    return out


def train_lm(cfg, model, batches, device, mesh=None, opt=None) -> tuple:
    """``len(batches)`` AdamW steps of ``model`` (built trainable) through
    ``make_train_step(cfg, AdamWConfig(**opt), device, mesh)``.  Returns
    ``(report, opt_state)``: the report holds each step's ``loss`` and
    ``grad_norm`` (floats), ``step_s`` (seconds, the device synchronised),
    ``flash`` (launches a step), ``comm`` (under ``mesh``: what it counted
    in each phase of each step), the parameter and moment bytes
    (``param_bytes``, ``opt_bytes``); the state is AdamW's after the last
    step."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import AdamWConfig, adamw_init
    opt_cfg = AdamWConfig(**(opt or {}))
    named = dict(model.named_parameters())
    state = adamw_init(named, opt_cfg)
    step = make_train_step(cfg, opt_cfg, device, mesh)
    out = {"loss": [], "grad_norm": [], "step_s": [], "flash": [],
           "comm": [], "param_bytes": sum(p.nbytes for p in named.values()),
           "opt_bytes": sum(t.nbytes for w in ("m", "v")
                            for t in state[w].values())}
    for batch in batches:
        reset_launch_counts()
        _sync(device)
        t0 = time.perf_counter()
        _, state, metrics = step(model, state, batch)
        _sync(device)
        out["step_s"].append(time.perf_counter() - t0)
        out["flash"].append(launch_counts()["flash_attention"])
        out["loss"].append(float(metrics["loss"]))
        out["grad_norm"].append(float(metrics["grad_norm"]))
        if mesh is not None:
            out["comm"].append(metrics["comm"])
    return out, state


def _lm_tp_job(spec: dict, ctx: dict) -> dict:
    import torch
    from repro_torch.core.distributed import RankMesh
    device = ctx["device"]
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = lm_config(spec)
    mesh = RankMesh(spec["mesh"], device=device, backend=ctx["backend"])
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    model, toks = lm_tp_inputs(cfg, spec, device, mesh)
    out = serve_lm(cfg, model, toks, spec["steps"], device, mesh,
                   routes=bool(spec.get("routes")))
    if ctx["rank"] == 0:
        torch.save(out["logits"], Path(ctx["out"]) / f"{spec['name']}.pt")
    if spec.get("dump"):
        torch.save({"params": {k: v.detach().cpu() for k, v in
                               model.named_parameters()},
                    "caches": [{part: {k: v.cpu() for k, v in c.items()}
                                for part, c in layer.items()}
                               for layer in out["caches"]["layers"]]},
                   Path(ctx["out"]) / f"{spec['name']}_r{ctx['rank']}.pt")
    del out["logits"], out["caches"]
    return dict(out, **held_parts(cfg, model),
                param_bytes=sum(p.nbytes for p in model.parameters()),
                peak_gib=(torch.cuda.max_memory_allocated(device) / 2**30
                          if device.type == "cuda" else float("nan")))


def lm_train_inputs(cfg, spec: dict, device, mesh=None) -> tuple:
    """``(model, batches)`` of an ``lm_train`` job: the model built
    trainable (``mesh``'s rank's) and its batches (:func:`train_batches`;
    drawn from the seed, the ids at ``spec["shape"]`` (N, B, S) plus one
    position)."""
    if "data" not in spec:
        n, b, s = spec["shape"]
        spec = dict(spec, shape=[n, b, s + 1])
    model, toks = lm_tp_inputs(cfg, spec, device, mesh, trainable=True)
    return model, train_batches(spec, toks)


def _lm_train_job(spec: dict, ctx: dict) -> dict:
    import torch
    from repro_torch.core.distributed import RankMesh
    from repro_torch.launch.steps import value_and_grad
    device = ctx["device"]
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = lm_config(spec)
    mesh = RankMesh(spec["mesh"], device=device, backend=ctx["backend"])
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    model, batches = lm_train_inputs(cfg, spec, device, mesh)
    dump = {}
    if spec.get("dump") is True:
        loss, grads = value_and_grad(cfg, model, batches[0], mesh)
        dump = {"loss0": float(loss),
                "grads0": {n: g.cpu() for n, g in grads.items()}}
        del grads
    out, state = train_lm(cfg, model, batches, device, mesh,
                          spec.get("opt"))
    if spec.get("dump"):
        dump["params"] = {k: v.detach().cpu() for k, v in
                          model.named_parameters()}
        dump["m"] = {k: v.cpu() for k, v in state["m"].items()}
        torch.save(dump,
                   Path(ctx["out"]) / f"{spec['name']}_r{ctx['rank']}.pt")
    del state
    return dict(out, **held_parts(cfg, model),
                peak_gib=(torch.cuda.max_memory_allocated(device) / 2**30
                          if device.type == "cuda" else float("nan")))


def held_parts(cfg, model) -> dict:
    """What a rank's model holds of the first layer of each part:
    ``heads`` [q heads, kv heads (None for MLA), head dim] of the first
    attention layer, ``experts`` of the first MoE layer, ``columns`` of
    the first RG-LRU or mLSTM layer (None where the model has none)."""
    out = {"heads": None, "experts": None, "columns": None}
    for layer in model.layers:
        attn, moe = getattr(layer, "attn", None), getattr(layer, "moe", None)
        rec = getattr(layer, "rec", None) or (
            layer.cell if layer.kind == "mlstm" else None)
        if attn is not None and out["heads"] is None:
            q = attn.part.q
            kv = None if attn.part.kv is None else \
                attn.part.kv.stop - attn.part.kv.start
            out["heads"] = [q.stop - q.start, kv, cfg.head_dim]
        if moe is not None and out["experts"] is None:
            out["experts"] = moe.part.n
        if rec is not None and out["columns"] is None:
            out["columns"] = rec.part.n
    return out


JOBS = {"wordcount": _engine_job, "sssp": _engine_job,
        "pagerank": _engine_job, "compress": _compress_job,
        "moe": _moe_job, "moe_lm": _moe_lm_job, "psum": _psum_job,
        "lm_tp": _lm_tp_job, "lm_train": _lm_train_job}


def main(argv: Optional[List[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    spec = json.loads(Path(argv[0]).read_text())
    import torch.distributed as tdist
    rank, world, backend, device = init_rank()
    ctx = {"rank": rank, "world": world, "backend": backend,
           "device": device, "out": spec["out"]}
    out: Dict[str, dict] = {}
    try:
        for job in spec["jobs"]:
            if job["job"] not in JOBS:
                raise ValueError(f"unknown job {job['job']!r}; the jobs are "
                                 f"{sorted(JOBS)}")
            t0 = time.perf_counter()
            out[job["name"]] = JOBS[job["job"]](job, ctx)
            out[job["name"]]["job_seconds"] = time.perf_counter() - t0
        tdist.barrier()
    finally:
        tdist.destroy_process_group()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
