"""Session: the supported way to drive the port's engine.

Counterpart of ``repro.api.session.Session`` on one device: a
:class:`JobSpec` or :class:`IterSpec` is declared once with one
:class:`RunConfig`, then

  * ``run(data)``     -> the full one-step job, or prime-loop convergence;
  * ``update(delta)`` -> the fine-grain MRBGraph merge (§3.3), the
                         accumulator fast path (§3.5), or the incremental
                         iterative refresh with CPC and auto MRBG-off (§5);
                         ``RunConfig(plain_shuffle=True)`` runs the plainMR
                         baseline instead;
  * ``rerun(data)``   -> drop the preserved state and recompute, as one more
                         epoch (the stream scheduler's other path);
  * ``checkpoint()`` / ``restore()`` -> fault tolerance (§6), in the
                         reference's npz + json layout, so that either
                         package restores the other's snapshots.

Data and deltas may be given on the host; the session moves them to
``config.device`` (``cuda`` unless the caller asks for the CPU).  A
lowered delta query (``repro_torch.dql.QuerySpec``) is one more kind,
driven by ``repro_torch.dql.driver._QueryDriver``; its multi-source data
and deltas arrive as ``{source: KV}`` / ``{source: DeltaKV}``.
"""
from __future__ import annotations

import time
from pathlib import Path
from typing import Dict, Optional, Union

import numpy as np
import torch

from repro_torch.api.config import RunConfig
from repro_torch.api.report import RunReport
from repro_torch.core.accumulator import AccumulatorJob
from repro_torch.core.engine import JobSpec, run_onestep
from repro_torch.core.incr_iter import IncrIterJob
from repro_torch.core.incremental import (
    DeltaKV, ResultView, _v2_dict, apply_delta_host, incremental_onestep,
    pad_delta, pad_mirror,
)
from repro_torch.core.iterative import IterSpec, State, run_plain
from repro_torch.core.kvstore import KV, edges_to_host, next_bucket
from repro_torch.core.mrbg_store import IOStats, MRBGStore
from repro_torch.tree import tree_map

Spec = Union[JobSpec, IterSpec]


def _to(tree, device: torch.device):
    return tree_map(lambda a: a.to(device), tree)


class Session:
    """Owns one declared job and all of its preserved state across epochs."""

    def __init__(self, spec: JobSpec, config: Optional[RunConfig] = None):
        self.spec = spec
        self.config = config or RunConfig()
        self.device = self.config.torch_device()
        self.epoch = -1                     # becomes 0 on run()
        self._last: Optional[RunReport] = None
        self.history: list = []
        self._driver = self._make_driver()

    def _make_driver(self):
        spec, config = self.spec, self.config
        if isinstance(spec, JobSpec):
            path = config.onestep_path
            if path == "auto":
                path = ("accumulator" if spec.reducer.invertible else "mrbg")
            return (_OneStepAccumulator(spec, config)
                    if path == "accumulator" else _OneStepMRBG(spec, config))
        if isinstance(spec, IterSpec):
            return (_PlainIter(spec, config, self.device)
                    if config.plain_shuffle
                    else _IncrIter(spec, config, self.device))
        from repro_torch.dql.driver import _QueryDriver
        from repro_torch.dql.lower import QuerySpec
        if isinstance(spec, QuerySpec):
            return _QueryDriver(spec, config, self.device)
        raise TypeError(f"spec must be JobSpec, IterSpec or QuerySpec, "
                        f"got {type(spec).__name__}")

    # -- lifecycle ---------------------------------------------------------
    def run(self, data: KV) -> RunReport:
        """Initial job: one-step run or iterative convergence."""
        if self.epoch >= 0:
            raise RuntimeError("run() already executed for this session; "
                               "apply changes with update(delta)")
        t0 = time.perf_counter()
        self._driver.run(_to(data, self.device))
        self.epoch = 0
        return self._finish(t0)

    def update(self, delta: DeltaKV) -> RunReport:
        """Refresh the preserved job against a signed delta input."""
        if self.epoch < 0:
            raise RuntimeError("update() before run(); execute the initial "
                               "job first")
        t0 = time.perf_counter()
        # bucket the delta's row capacity, as the reference does, so that
        # shapes (and therefore results) follow the same ladder (the query
        # driver buckets the feeds of a multi-source {source: DeltaKV})
        if isinstance(delta, DeltaKV):
            cap = next_bucket(delta.capacity, self.config.delta_bucket_min)
            if cap != delta.capacity:
                delta = pad_delta(delta, cap)
        self._driver.update(_to(delta, self.device))
        self.epoch += 1
        return self._finish(t0)

    def rerun(self, data: KV) -> RunReport:
        """Full re-computation refresh: drop every preserved structure and
        recompute from scratch on the (fully updated) input, as one more
        epoch of this session: the stream scheduler's alternative to
        ``update(delta)`` past the paper's Fig. 8 crossover."""
        if self.epoch < 0:
            raise RuntimeError("rerun() before run(); execute the initial "
                               "job first")
        t0 = time.perf_counter()
        self._driver = self._make_driver()   # fresh preserved state
        self._driver.run(_to(data, self.device))
        self.epoch += 1
        return self._finish(t0)

    def grow_records(self, capacity: int) -> None:
        """Extend the record-id address space to ``capacity`` rows.

        Drivers that mirror the structure file (iterative, plain) extend
        their mirrors with invalid rows and rebuild derived indexes;
        one-step drivers keep no per-record structure, so this is a no-op
        for them.  Shrinking is never performed.
        """
        hook = getattr(self._driver, "grow_records", None)
        if hook is not None:
            hook(int(capacity))

    def absorb_refresh(self, seconds: float) -> RunReport:
        """Account one refresh epoch executed outside ``update()`` (a
        batched cross-tenant refresh), so that ``epoch``, ``history`` and
        auto-checkpointing stay consistent with the per-tenant path."""
        if self.epoch < 0:
            raise RuntimeError("absorb_refresh() before run(); execute the "
                               "initial job first")
        self.epoch += 1
        return self._finish(time.perf_counter() - seconds)

    def _finish(self, t0: float) -> RunReport:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        rep = self.report(include_result=False)
        rep.seconds = time.perf_counter() - t0
        self._last = rep
        self.history.append(rep)
        if len(self.history) > self.config.report_history:
            del self.history[:-self.config.report_history]
        cfg = self.config
        if (cfg.checkpoint_dir is not None and cfg.checkpoint_every > 0
                and self.epoch % cfg.checkpoint_every == 0):
            self.checkpoint(cfg.checkpoint_dir)
        return rep

    # -- uniform outputs ---------------------------------------------------
    @property
    def result(self) -> Dict[str, np.ndarray]:
        """Dense host view of the job's current output values."""
        if self.epoch < 0:
            raise RuntimeError("no result before run()")
        return self._driver.result()

    def report(self, include_result: bool = True) -> RunReport:
        if self.epoch < 0:
            raise RuntimeError("no report before run()")
        rep = RunReport(name=self.spec.name, mode=self._driver.mode,
                        epoch=self.epoch, device=self.device.type,
                        result=self._driver.result() if include_result
                        else {})
        self._driver.fill(rep)
        if self._last is not None and self._last.epoch == self.epoch:
            rep.seconds = self._last.seconds
        return rep

    # -- fault tolerance ---------------------------------------------------
    def checkpoint(self, path: Optional[str] = None) -> Path:
        """Atomically snapshot all preserved state (view/state, MRBG-Store,
        CPC accumulators, structure mirror) under ``path``."""
        from repro_torch.api.ckpt import save_session
        target = path or self.config.checkpoint_dir
        if target is None:
            raise ValueError("no checkpoint path: pass one or set "
                             "RunConfig(checkpoint_dir=...)")
        return save_session(self, str(target))

    @classmethod
    def restore(cls, spec: Spec, path: str,
                config: Optional[RunConfig] = None) -> "Session":
        """Rebuild a session from :meth:`checkpoint` output (this package's
        or the reference's); the next ``update(delta)`` resumes exactly
        where the snapshot left off, on ``config.device``."""
        from repro_torch.api.ckpt import load_session
        return load_session(cls, spec, str(path), config)

    # -- preserved state (read-only use) -----------------------------------
    @property
    def view(self) -> Optional[ResultView]:
        return getattr(self._driver, "view", None)

    @property
    def state(self) -> Optional[State]:
        """The iterative drivers' dense state <DK, DV> on the device."""
        return getattr(self._driver, "state", None)

    # -- preserved-state accounting (serving-layer hooks) ------------------
    @property
    def store(self) -> Optional[MRBGStore]:
        """The driver's MRBG-Store, if this path preserves one."""
        return getattr(self._driver, "store", None)

    @property
    def stores(self) -> list:
        """Every MRBG-Store this session preserves: a query's per-stage
        stores, or ``[store]`` / ``[]`` (one device: no per-shard
        slices)."""
        sts = getattr(self._driver, "stores", None)
        if sts:
            return list(sts)
        st = self.store
        return [st] if st is not None else []

    def store_bytes(self) -> int:
        """MRBG file size including obsolete chunks (0 if nothing is
        preserved)."""
        return sum(s.file_bytes() for s in self.stores)

    def store_live_bytes(self) -> int:
        """Live chunk bytes."""
        return sum(s.live_bytes() for s in self.stores)

    def store_obsolete_bytes(self) -> int:
        """Obsolete (compactable) chunk bytes."""
        return sum(s.obsolete_bytes() for s in self.stores)

    def compact_store(self) -> int:
        """Offline MRBG compaction; returns the bytes reclaimed."""
        return sum(s.compact() for s in self.stores)


# ---------------------------------------------------------------------------
# Drivers: one per engine path; each owns the preserved state
# ---------------------------------------------------------------------------

class _OneStepMRBG:
    """run_onestep + MRBG-Store + incremental_onestep (§3.3/§3.4)."""

    kind = "onestep-mrbg"

    def __init__(self, spec: JobSpec, cfg: RunConfig):
        self.spec = spec
        self.cfg = cfg
        self.store = MRBGStore(spec.num_keys, cfg.value_bytes,
                               policy=cfg.store_policy, **cfg.store_kw())
        self.view: Optional[ResultView] = None
        self.mode = "onestep"
        self._counts: Optional[np.ndarray] = None
        self._affected = -1

    def run(self, inp: KV) -> None:
        res = run_onestep(self.spec, inp, preserve=True)
        host = edges_to_host(res.edges)
        self.store.append(host["k2"], host["mk"], _v2_dict(host["v2"]))
        self.view = ResultView.from_job(self.spec.num_keys, res.results,
                                        res.counts)
        self._counts = self.view.counts.copy()
        self.mode = "onestep"

    def update(self, delta: DeltaKV) -> None:
        self.store.reset_stats()
        stats = incremental_onestep(self.spec, delta, self.store, self.view)
        self._affected = int(stats.get("affected", 0))
        self._counts = self.view.counts
        self.mode = "incremental"

    def result(self) -> Dict[str, np.ndarray]:
        return self.view.as_dict()

    def fill(self, rep: RunReport) -> None:
        rep.counts = self._counts
        rep.affected_keys = self._affected
        rep.io = self.store.stats
        rep.store_bytes = self.store.file_bytes()
        rep.live_bytes = self.store.live_bytes()
        rep.store_batches = self.store.n_batches


class _OneStepAccumulator:
    """Accumulator-Reduce fast path: preserves only <K3,V3> (§3.5)."""

    kind = "onestep-accumulator"

    def __init__(self, spec: JobSpec, cfg: RunConfig):
        self.spec = spec
        self.cfg = cfg
        self.job = AccumulatorJob(spec)
        self.mode = "onestep"

    @property
    def view(self) -> Optional[ResultView]:
        return self.job.view

    def run(self, inp: KV) -> None:
        self.job.initial_run(inp)
        self.mode = "onestep"

    def update(self, delta: DeltaKV) -> None:
        self.job.incremental_run(delta)
        self.mode = "accumulator"

    def result(self) -> Dict[str, np.ndarray]:
        return self.job.view.as_dict()

    def fill(self, rep: RunReport) -> None:
        rep.counts = self.job.view.counts
        rep.mrbg_on = False               # nothing preserved beyond <K3,V3>


class _IncrIter:
    """IncrIterJob: converge once, then fine-grain refresh (§5)."""

    kind = "incr-iter"

    def __init__(self, spec: IterSpec, cfg: RunConfig, device: torch.device):
        self.spec = spec
        self.cfg = cfg
        self.device = device
        self.job: Optional[IncrIterJob] = None     # built on run()
        self.mode = "iterative"
        self._iters = 0
        self._max_change: list = []
        self._logs: list = []

    @property
    def state(self) -> Optional[State]:
        return self.job.state if self.job is not None else None

    @property
    def store(self) -> Optional[MRBGStore]:
        return self.job.store if self.job is not None else None

    def run(self, struct: KV) -> None:
        self.job = IncrIterJob(
            self.spec, struct, device=self.device,
            value_bytes=self.cfg.value_bytes, policy=self.cfg.store_policy,
            cpc_threshold=self.cfg.cpc_threshold,
            pdelta_threshold=self.cfg.pdelta_threshold,
            store_kw=self.cfg.store_kw())
        _, hist = self.job.initial_converge(max_iters=self.cfg.max_iters,
                                            tol=self.cfg.tol)
        self.mode = "iterative"
        self._iters = hist["iters"]
        self._max_change = hist["max_change"]
        self._logs = []

    def update(self, delta: DeltaKV) -> None:
        _, hist = self.job.refresh(delta, max_iters=self.cfg.refresh_iters_,
                                   tol=self.cfg.refresh_tol_)
        self.mode = hist["mode"]
        self._iters = hist["iters"]
        self._logs = hist.get("logs", [])
        self._max_change = []

    def grow_records(self, capacity: int) -> None:
        if self.job is not None:
            self.job.grow_records(capacity)

    def result(self) -> Dict[str, np.ndarray]:
        return self.job.state.to_host()

    def fill(self, rep: RunReport) -> None:
        rep.iters = self._iters
        rep.max_change = list(self._max_change)
        rep.logs = list(self._logs)
        if self._logs:
            rep.affected_keys = sum(l.n_affected_dks for l in self._logs)
            rep.io = IOStats(n_reads=sum(l.io_reads for l in self._logs),
                             bytes_read=sum(l.io_bytes for l in self._logs))
        store = self.job.store
        rep.store_bytes = store.file_bytes()
        rep.live_bytes = store.live_bytes()
        rep.store_batches = store.n_batches
        rep.mrbg_on = self.job.mrbg_on


class _PlainIter:
    """plainMR recomp baseline: re-shuffles structure data every iteration
    and recomputes every epoch from scratch (Algorithm 5 cost model)."""

    kind = "plain-iter"

    def __init__(self, spec: IterSpec, cfg: RunConfig, device: torch.device):
        self.spec = spec
        self.cfg = cfg
        self.device = device
        self.state: Optional[State] = None
        self.mode = "plainMR"
        self._iters = 0
        self._max_change: list = []

    def run(self, struct: KV) -> None:
        host = lambda a: a.cpu().numpy().copy()
        self._keys = host(struct.keys)
        self._values = {n: host(a) for n, a in struct.values.items()}
        self._valid = host(struct.valid)
        self._converge(self.cfg.max_iters, self.cfg.tol)

    def _struct_kv(self) -> KV:
        dev = lambda a: torch.from_numpy(a).to(self.device, copy=True)
        return KV(dev(self._keys),
                  {n: dev(a) for n, a in self._values.items()},
                  dev(self._valid))

    def _converge(self, max_iters: int, tol: float) -> None:
        self.state, hist = run_plain(self.spec, self._struct_kv(), None,
                                     max_iters=max_iters, tol=tol)
        self._iters = hist["iters"]
        self._max_change = hist["max_change"]

    def update(self, delta: DeltaKV) -> None:
        apply_delta_host(self._keys, self._values, self._valid, delta)
        # vanilla MR: recompute everything (under the refresh budget)
        self._converge(self.cfg.refresh_iters_, self.cfg.refresh_tol_)

    def grow_records(self, capacity: int) -> None:
        self._keys, self._values, self._valid = pad_mirror(
            self._keys, self._values, self._valid, capacity)

    def result(self) -> Dict[str, np.ndarray]:
        return self.state.to_host()

    def fill(self, rep: RunReport) -> None:
        rep.iters = self._iters
        rep.max_change = list(self._max_change)
        rep.mrbg_on = False
