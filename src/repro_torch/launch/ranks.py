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
    seen = []
    route = blocks.moe_route

    def spy(c, router, tokens):
        gate, eid = route(c, router, tokens)
        seen.append(eid)
        return gate, eid
    meshctx.set_mesh(mesh)
    blocks.moe_route = spy
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    try:
        with torch.no_grad():
            y = blocks.apply_moe(cfg, p, x)         # one untimed call
            _sync(device)
            t0 = time.perf_counter()
            y = blocks.apply_moe(cfg, p, x)
            _sync(device)
            secs = time.perf_counter() - t0
    finally:
        blocks.moe_route = route
        meshctx.set_mesh(None)
    eid = seen[-1]
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


JOBS = {"wordcount": _engine_job, "sssp": _engine_job,
        "pagerank": _engine_job, "compress": _compress_job,
        "moe": _moe_job, "moe_lm": _moe_lm_job}


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
