"""Session checkpoint/restore: one fault-tolerance surface for every mode.

Counterpart of ``repro.api.ckpt`` in the same layout, so that a snapshot
written by either package restores in the other:

  <root>/session.json          what kind of driver the snapshot belongs to
  <root>/it_NNNNNN/            incr-iter epochs (``repro_torch.core.ft``)
  <root>/ep_NNNNNN/            every other driver's epochs (atomic rename)

Every kind the reference writes is handled: ``onestep-mrbg``,
``onestep-accumulator``, ``incr-iter``, ``plain-iter``, ``query`` (a delta
query's per-stage views, stores and input schemas), and the meshed
``distributed`` (dense state with ``cpc`` in ``state.npz``) and
``distributed-onestep`` (``view.npz``) kinds, whose per-shard MRBG slices
go to ``shards.json`` plus ``mrbg_{p:03d}.npz``.  Device tensors are saved
as host numpy arrays of the reference's dtypes; a restored session puts
its state back on ``config.device``.  ``Session.restore`` rebuilds the newest epoch; the
next ``update(delta)`` continues exactly where the snapshot left off.
"""
from __future__ import annotations

import json
import os
import shutil
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.api.config import RunConfig
from repro_torch.core.incremental import ResultView
from repro_torch.core.iterative import State
from repro_torch.core.mrbg_store import (
    MRBGStore, load_store_state, store_blobs, store_meta,
)

# ---------------------------------------------------------------------------
# MRBG-Store blobs (one layout, shared with repro_torch.core.ft via
# repro_torch.core.mrbg_store.{store_blobs,store_meta,load_store_state})
# ---------------------------------------------------------------------------

def _store_to_npz(store: MRBGStore, path: Path) -> Dict:
    np.savez(path, **store_blobs(store))
    return store_meta(store)


def _store_from_npz(num_keys: int, path: Path, meta: Dict,
                    cfg: RunConfig) -> MRBGStore:
    store = MRBGStore(num_keys, meta["value_bytes"], policy=meta["policy"],
                      **cfg.store_kw())
    load_store_state(store, np.load(path), meta)
    return store


def _save_shard_stores(drv, tmp: Path) -> None:
    """Per-shard MRBG slices of a meshed driver (local-key space, so only
    a mesh of the same part count can reuse them)."""
    metas = None
    if drv.stores is not None:
        metas = [_store_to_npz(s, tmp / f"mrbg_{p:03d}.npz")
                 for p, s in enumerate(drv.stores)]
    (tmp / "shards.json").write_text(json.dumps(
        {"n_parts": drv.n_parts, "mrbg_on": drv.mrbg_on, "stores": metas}))


def _load_shard_stores(drv, d: Path, cfg: RunConfig) -> bool:
    """Rebuild ``drv.stores`` from a snapshot; False when the snapshot was
    taken with a different part count (local keys do not transfer)."""
    sj = d / "shards.json"
    if not sj.exists():
        return False
    meta = json.loads(sj.read_text())
    if meta["stores"] is None or meta["n_parts"] != drv.n_parts:
        return False
    drv.stores = [
        _store_from_npz(drv.rows, d / f"mrbg_{p:03d}.npz", m, cfg)
        for p, m in enumerate(meta["stores"])]
    drv.mrbg_on = meta["mrbg_on"]
    return True


def _atomic_epoch_dir(root: Path, epoch: int):
    tmp = root / f"ep_{epoch:06d}.tmp"
    final = root / f"ep_{epoch:06d}"
    old = root / f"ep_{epoch:06d}.old"
    if tmp.exists():
        shutil.rmtree(tmp)
    if old.exists():
        shutil.rmtree(old)
    tmp.mkdir(parents=True)

    def commit() -> Path:
        # never leave a window with no snapshot for this epoch: displace
        # the previous version, promote the new one, then drop the old
        if final.exists():
            os.rename(final, old)
        os.rename(tmp, final)
        if old.exists():
            shutil.rmtree(old)
        return final

    return tmp, commit


def _atomic_write_text(path: Path, text: str) -> None:
    tmp = path.with_suffix(path.suffix + ".tmp")
    tmp.write_text(text)
    os.replace(tmp, path)


def _latest_epoch_dir(root: Path) -> Path:
    """The newest committed snapshot dir (ignoring .tmp/.old leftovers)."""
    eps = sorted(d for d in root.glob("ep_??????") if d.is_dir())
    if not eps:
        raise FileNotFoundError(f"no session checkpoints under {root}")
    return eps[-1]


def _view_arrays(view: ResultView) -> Dict[str, np.ndarray]:
    return {"valid": view.valid, "counts": view.counts,
            **{f"v_{n}": a for n, a in view.values.items()}}


def _load_view(num_keys: int, z) -> ResultView:
    values = {k[2:]: z[k].copy() for k in z.files if k.startswith("v_")}
    return ResultView(num_keys, values, z["valid"].copy(),
                      z["counts"].copy())


# ---------------------------------------------------------------------------
# save
# ---------------------------------------------------------------------------

def save_session(session, root: str) -> Path:
    rootp = Path(root)
    rootp.mkdir(parents=True, exist_ok=True)
    drv = session._driver
    if session.epoch < 0:
        raise RuntimeError("nothing to checkpoint before run()")

    if drv.kind == "incr-iter":
        from repro_torch.core.ft import checkpoint_job
        out = checkpoint_job(drv.job, root, session.epoch)
    elif drv.kind == "onestep-mrbg":
        tmp, commit = _atomic_epoch_dir(rootp, session.epoch)
        np.savez(tmp / "view.npz", **_view_arrays(drv.view))
        meta = _store_to_npz(drv.store, tmp / "mrbg.npz")
        (tmp / "meta.json").write_text(json.dumps(meta))
        out = commit()
    elif drv.kind == "onestep-accumulator":
        tmp, commit = _atomic_epoch_dir(rootp, session.epoch)
        np.savez(tmp / "acc.npz", **_view_arrays(drv.job.view),
                 **{f"a_{n}": a for n, a in drv.job.raw_acc.items()})
        out = commit()
    elif drv.kind in ("plain-iter", "distributed"):
        tmp, commit = _atomic_epoch_dir(rootp, session.epoch)
        extra = ({"cpc": drv.cpc_accum} if drv.kind == "distributed" else {})
        np.savez(tmp / "state.npz",
                 struct_keys=drv._keys, struct_valid=drv._valid,
                 **{f"sv_{n}": a for n, a in drv.result().items()},
                 **{f"st_{n}": a for n, a in drv._values.items()},
                 **extra)
        if drv.kind == "distributed":
            _save_shard_stores(drv, tmp)
        out = commit()
    elif drv.kind == "distributed-onestep":
        tmp, commit = _atomic_epoch_dir(rootp, session.epoch)
        np.savez(tmp / "view.npz", **_view_arrays(drv.view))
        _save_shard_stores(drv, tmp)
        out = commit()
    elif drv.kind == "query":
        tmp, commit = _atomic_epoch_dir(rootp, session.epoch)
        metas = []
        for i, st in enumerate(drv.stages):
            np.savez(tmp / f"stage{i:02d}_view.npz", **_view_arrays(st.view))
            metas.append(_store_to_npz(st.store, tmp / f"stage{i:02d}.npz"))
        (tmp / "query.json").write_text(json.dumps(
            {"n_stages": len(drv.stages), "stores": metas,
             "affected": drv._affected,
             "schemas": [st.schemas for st in drv.stages]}))
        out = commit()
    else:                                 # pragma: no cover
        raise ValueError(f"unknown driver kind {drv.kind!r}")

    _atomic_write_text(rootp / "session.json", json.dumps(
        {"kind": drv.kind, "epoch": session.epoch, "mode": drv.mode,
         "name": session.spec.name}))
    return out


# ---------------------------------------------------------------------------
# restore
# ---------------------------------------------------------------------------

def load_session(cls, spec, root: str, config: Optional[RunConfig]):
    rootp = Path(root)
    meta = json.loads((rootp / "session.json").read_text())
    cfg = config or RunConfig()
    kind = meta["kind"]

    # the driver is chosen by config; pin the config to the snapshot's kind
    if kind == "onestep-mrbg":
        cfg = cfg.replace(onestep_path="mrbg")
    elif kind == "onestep-accumulator":
        cfg = cfg.replace(onestep_path="accumulator")
    elif kind == "plain-iter":
        cfg = cfg.replace(plain_shuffle=True, mesh=None)
    elif kind == "incr-iter":
        cfg = cfg.replace(plain_shuffle=False, mesh=None)
    elif kind in ("distributed", "distributed-onestep"):
        if cfg.mesh is None:
            raise ValueError("restoring a distributed session requires "
                             "RunConfig(mesh=...): meshes are not "
                             "serializable")
    elif kind != "query":
        raise ValueError(f"unknown snapshot kind {kind!r}")

    session = cls(spec, cfg)
    drv = session._driver
    session.epoch = meta["epoch"]
    drv.mode = meta["mode"]

    if kind == "incr-iter":
        from repro_torch.core.ft import restore_job
        job = restore_job(spec, root, device=session.device)
        # re-apply the session's config on the restored engine objects
        job.cpc_threshold = cfg.cpc_threshold
        job.pdelta_threshold = cfg.pdelta_threshold
        job._store_kw = cfg.store_kw()
        for k, v in cfg.store_kw().items():
            setattr(job.store, k, v)
        drv.job = job
    elif kind == "onestep-mrbg":
        d = _latest_epoch_dir(rootp)
        m = json.loads((d / "meta.json").read_text())
        drv.view = _load_view(spec.num_keys, np.load(d / "view.npz"))
        drv.store = _store_from_npz(spec.num_keys, d / "mrbg.npz", m, cfg)
        drv._counts = drv.view.counts
    elif kind == "onestep-accumulator":
        d = _latest_epoch_dir(rootp)
        az = np.load(d / "acc.npz")
        drv.job.view = _load_view(spec.num_keys, az)
        drv.job.raw_acc = {k[2:]: az[k].copy() for k in az.files
                           if k.startswith("a_")}
    elif kind == "query":
        from repro_torch.dql.driver import RecordingView
        d = _latest_epoch_dir(rootp)
        qmeta = json.loads((d / "query.json").read_text())
        if qmeta["n_stages"] != len(drv.stages):
            raise ValueError(
                f"snapshot has {qmeta['n_stages']} stages but the spec "
                f"lowered to {len(drv.stages)}; restore with the same plan")
        for i, st in enumerate(drv.stages):
            vz = np.load(d / f"stage{i:02d}_view.npz")
            v = _load_view(st.plan.num_keys, vz)
            st.view = RecordingView(st.plan.num_keys, v.values, v.valid,
                                    v.counts)
            st.store = _store_from_npz(st.plan.num_keys,
                                       d / f"stage{i:02d}.npz",
                                       qmeta["stores"][i], cfg)
            # json turns the (shape, dtype) tuples into lists — restore them
            st.schemas = [
                None if sch is None else
                {c: (tuple(shape), dt) for c, (shape, dt) in sch.items()}
                for sch in qmeta["schemas"][i]]
        drv._affected = qmeta.get("affected", -1)
    elif kind == "distributed-onestep":
        d = _latest_epoch_dir(rootp)
        drv.view = _load_view(spec.num_keys, np.load(d / "view.npz"))
        if not _load_shard_stores(drv, d, cfg):
            raise ValueError(
                "distributed one-step snapshots store per-shard MRBG slices "
                "in local-key space; restore with a mesh of the same part "
                "count as the one that wrote the checkpoint")
    else:                                 # plain-iter, distributed
        d = _latest_epoch_dir(rootp)
        sz = np.load(d / "state.npz")
        drv._keys = sz["struct_keys"].copy()
        drv._valid = sz["struct_valid"].copy()
        drv._values = {k[3:]: sz[k].copy() for k in sz.files
                       if k.startswith("st_")}
        state = {k[3:]: torch.from_numpy(sz[k].copy()).to(session.device)
                 for k in sz.files if k.startswith("sv_")}
        if kind == "distributed":
            from repro_torch.core.distributed import partition_state
            drv.state_parts = partition_state(state, spec.num_state,
                                              drv.n_parts)
            if "cpc" in sz.files:
                drv.cpc_accum = sz["cpc"].copy()
            drv._rebuild_rev()
            # per-shard MRBG slices transfer only onto an equal part count;
            # otherwise the next update() warm-converges and re-seeds them
            if not _load_shard_stores(drv, d, cfg):
                drv.stores = None
        else:
            drv.state = State(state, torch.ones(
                spec.num_state, dtype=torch.bool, device=session.device))
    return session
