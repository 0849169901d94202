"""Fault tolerance for the incremental iterative engine (paper Section 6).

Counterpart of ``repro.core.ft``, in the same on-disk layout, so that a
snapshot written by either package restores in the other:

  * ``checkpoint_job`` snapshots (state values, CPC accumulators, MRBG-Store
    batches + chunk index, structure mirror) atomically per iteration;
    device tensors are saved through the host as numpy arrays;
  * ``restore_job`` rebuilds an ``IncrIterJob`` on ``device`` exactly: the
    next refresh equals the one the uninterrupted job would have run;
  * ``FailureInjector`` deterministically raises at a chosen iteration to
    exercise the recovery path (the Fig. 13 experiment);
  * ``SkewMonitor`` is the straggler/load-balance hook (§6.2): it watches
    per-partition work and proposes a re-partition plan that splits the
    heaviest partition.
"""
from __future__ import annotations

import json
import os
import shutil
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.core.incr_iter import IncrIterJob
from repro_torch.core.iterative import IterSpec, State
from repro_torch.core.kvstore import make_kv
from repro_torch.core.mrbg_store import (
    load_store_state, store_blobs, store_meta,
)


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def checkpoint_job(job: IncrIterJob, root: str, iteration: int) -> Path:
    rootp = Path(root)
    rootp.mkdir(parents=True, exist_ok=True)
    tmp = rootp / f"it_{iteration:06d}.tmp"
    final = rootp / f"it_{iteration:06d}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()

    np.savez(tmp / "state.npz",
             **{f"sv_{k}": _host(v) for k, v in job.state.values.items()},
             cpc=job.cpc_accum,
             **{f"ev_{k}": _host(v) for k, v in job.emitted_values.items()},
             struct_valid=job.struct_valid, struct_keys=job.struct_keys,
             **{f"st_{k}": v for k, v in job.struct_values.items()})
    # MRBG-Store: batches + index (the paper's per-iteration MRBG checkpoint)
    store = job.store
    np.savez(tmp / "mrbg.npz", **store_blobs(store))
    meta = {"iteration": iteration, "n_batches": store.n_batches,
            "mrbg_on": job.mrbg_on, **store_meta(store)}
    (tmp / "meta.json").write_text(json.dumps(meta))
    if final.exists():
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def restore_job(spec: IterSpec, root: str, iteration: Optional[int] = None,
                *, device="cuda") -> IncrIterJob:
    """The newest (or the given) snapshot under ``root``, as a job whose
    state lives on ``device``."""
    rootp = Path(root)
    its = sorted(rootp.glob("it_??????"))
    if not its:
        raise FileNotFoundError(f"no checkpoints under {root}")
    d = its[-1] if iteration is None else rootp / f"it_{iteration:06d}"
    meta = json.loads((d / "meta.json").read_text())
    st = np.load(d / "state.npz")

    struct_vals = {k[3:]: st[k] for k in st.files if k.startswith("st_")}
    struct = make_kv(st["struct_keys"], struct_vals, st["struct_valid"])
    job = IncrIterJob(spec, struct, device=device,
                      value_bytes=meta["value_bytes"], policy=meta["policy"])
    dev = lambda a: torch.from_numpy(np.array(a)).to(job.device)
    sv = {k[3:]: dev(st[k]) for k in st.files if k.startswith("sv_")}
    ev = {k[3:]: dev(st[k]) for k in st.files if k.startswith("ev_")}
    job.state = State(sv, torch.ones(spec.num_state, dtype=torch.bool,
                                     device=job.device))
    job.emitted_values = ev
    job.cpc_accum = st["cpc"].copy()
    job.mrbg_on = meta["mrbg_on"]

    load_store_state(job.store, np.load(d / "mrbg.npz"), meta)
    return job


class FailureInjector:
    """Deterministically fail at iteration k (Fig. 13 experiment)."""

    def __init__(self, fail_at: int):
        self.fail_at = fail_at
        self.fired = False

    def __call__(self, iteration: int):
        if iteration == self.fail_at and not self.fired:
            self.fired = True
            raise RuntimeError(f"injected worker failure @ it {iteration}")


class SkewMonitor:
    """Straggler detection + re-partition planning (beyond-paper §6.2).

    Tracks per-partition work (edge counts / elapsed time); when the max
    exceeds ``ratio`` x median, proposes moving records from the heaviest
    partition to the lightest (preserving order, as SkewTune does, so the
    output can be reconstructed by concatenation).
    """

    def __init__(self, ratio: float = 1.5):
        self.ratio = ratio
        self.history = []

    def observe(self, per_partition_work: np.ndarray):
        self.history.append(np.asarray(per_partition_work))

    def plan(self) -> Optional[Dict[str, int]]:
        if not self.history:
            return None
        w = self.history[-1].astype(np.float64)
        med = max(np.median(w), 1e-9)
        if w.max() <= self.ratio * med:
            return None
        heavy = int(np.argmax(w))
        light = int(np.argmin(w))
        # % of the heavy partition's records to migrate
        move = int((w[heavy] - med) / max(w[heavy], 1) * 100)
        return {"from": heavy, "to": light, "percent": max(1, min(50, move))}
