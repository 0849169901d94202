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
  * ``RunConfig(mesh=MeshConfig(LocalMesh(...)))`` -> the same spec on P
                         logical shards of the device (§4.3): the sharded
                         prime loop or one-step run, then per-shard
                         fine-grain refresh (``_Distributed``,
                         ``_DistOneStep``); with a ``RankMesh`` the same
                         drivers run one shard a process, every rank
                         driving its own session on the same inputs;
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
from repro_torch.api.report import RunReport, ShuffleStats
from repro_torch.core import distributed as dist
from repro_torch.core.accumulator import AccumulatorJob
from repro_torch.core.engine import JobSpec, run_onestep
from repro_torch.core.incr_iter import (
    IncrIterJob, IterationLog, build_reverse_index, records_of_dks,
)
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
            if config.mesh is not None:
                return _DistOneStep(spec, config, self.device)
            path = config.onestep_path
            if path == "auto":
                path = ("accumulator" if spec.reducer.invertible else "mrbg")
            return (_OneStepAccumulator(spec, config)
                    if path == "accumulator" else _OneStepMRBG(spec, config))
        if isinstance(spec, IterSpec):
            if config.mesh is not None:
                return _Distributed(spec, config, self.device)
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
        """Every MRBG-Store this session preserves: the per-shard slices of
        a meshed session, a query's per-stage stores, or ``[store]`` /
        ``[]``."""
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


# ---------------------------------------------------------------------------
# Meshed drivers: P logical shards (repro_torch.core.distributed)
# ---------------------------------------------------------------------------

def _host_tensor(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _shard_stores(cfg: RunConfig, rows: int, n_parts: int) -> list:
    return [MRBGStore(rows, cfg.value_bytes, policy=cfg.store_policy,
                      **cfg.store_kw())
            for _ in range(n_parts)]


def _mesh_setup(drv, cfg: RunConfig) -> None:
    """A meshed driver's view of its mesh: ``shards``, the shards this
    process runs (all P on a LocalMesh, the rank's own on a RankMesh) and
    ``_slot`` (shard -> row of the local ``[L, ...]`` state)."""
    drv.mc = cfg.mesh
    drv.n_parts = drv.mc.n_parts
    drv.shards = dist.local_shards(drv.mc.mesh, drv.mc.axis,
                                   drv.mc.pod_axis)
    drv._slot = {p: i for i, p in enumerate(drv.shards)}


def _global_ints(drv, values) -> list:
    """Counts summed over every shard (over the ranks on a RankMesh)."""
    return drv.mc.mesh.all_reduce(
        torch.tensor(list(values), dtype=torch.int64)).tolist()


def _fill_stores(drv, rep: RunReport, io: bool) -> None:
    """The per-shard stores' sizes (and IO, with ``io``) summed over every
    shard into ``rep``."""
    sts = drv.stores
    nums = [sum(s.file_bytes() for s in sts), sum(s.live_bytes() for s in sts),
            sum(s.n_batches for s in sts)]
    if io:
        nums += [sum(s.stats.n_reads for s in sts),
                 sum(s.stats.bytes_read for s in sts)]
    nums = _global_ints(drv, nums)
    rep.store_bytes, rep.live_bytes, rep.store_batches = nums[:3]
    if io:
        rep.io = IOStats(n_reads=nums[3], bytes_read=nums[4])


def _exchange_delta(drv, delta: DeltaKV, project=None, state=None) -> list:
    """Phase 1 of a meshed refresh: partition ``delta`` by
    ``hash(project(key))`` (the key itself for ``project=None``) at a
    bucketed per-shard row capacity, so the step meets one signature per
    bucket; run the driver's delta-exchange step (re-Mapping against the
    state slices ``state`` when given) and account it in
    ``drv._shuffle``.  Returns each shard's received edges on the host."""
    n_parts = drv.n_parts
    keys = delta.keys.cpu().numpy()
    valid = delta.valid.cpu().numpy().astype(bool)
    dks = keys if project is None else dist._project_host(project, keys)
    load = np.bincount(dist._pid_host(dks, n_parts)[valid],
                       minlength=n_parts)
    cap = next_bucket(max(int(load.max(initial=0)), 1),
                      drv.cfg.delta_bucket_min)
    pk, pv, pvalid, psign = dist.local_rows(
        dist.partition_delta(delta, n_parts, cap, project=project),
        drv.shards, n_parts)
    if drv._dx_step is None:
        drv._dx_step = dist.make_delta_exchange_step(
            drv.spec, drv.mc.mesh, drv.mc.axis, pod_axis=drv.mc.pod_axis)
    tx = time.perf_counter()
    dev = lambda a: _host_tensor(a).to(drv.device)
    args = (dev(pk), tree_map(dev, pv), dev(pvalid), dev(psign))
    outs = drv._dx_step(*args) if state is None \
        else drv._dx_step(*args, state)
    shards, sent, _dropped = dist.delta_exchange_to_host(outs,
                                                         drv.mc.mesh)
    sh = drv._shuffle
    sh.exchange_seconds.append(time.perf_counter() - tx)
    sh.edges_exchanged += sent
    # bytes an exchanged edge carries: K2 + MK (4 + 4), valid + sign
    # (1 + 1), plus the V2 payload
    sh.bytes_moved += sent * (10 + drv.cfg.value_bytes)
    sh.shuffle_cap = outs[3]
    return shards


class _Distributed:
    """The sharded prime loop over a MeshConfig (§4.3).

    ``update`` is kv-pair-level by default (``MeshConfig(refresh="fine")``):
    delta rows are partitioned by ``hash(project(SK))`` (Eq. 2), one
    all_to_all routes the re-Mapped delta edges to their owner shards, and
    each shard merges them against its **local** MRBG slice with the
    single-device path's kernels.  CPC filtering and the §5.2 auto
    MRBG-off fallback run globally over the per-shard results.

    ``MeshConfig(refresh="warm")`` (or an unstable map topology, or a
    tripped MRBG-off) re-partitions the mirror and re-converges warm from
    the current state.  The state lives on the device as ``[L, rows, ...]``
    tensors of the L local shards; the structure mirror, the reverse index,
    the per-shard stores and the CPC accumulators on the host.  On a
    RankMesh (L = 1) each rank holds its shard's state, store and CPC
    accumulators; the host mirror and reverse index are every rank's, and
    the DKs each iteration emits are gathered from all ranks, so that the
    next iteration's delta rows, and every decision, are alike on all.
    """

    kind = "distributed"

    def __init__(self, spec: IterSpec, cfg: RunConfig, device: torch.device):
        if spec.replicate_state:
            raise ValueError(
                "replicate_state (all-to-one) specs broadcast their state; "
                "the co-partitioned distributed engine does not support "
                "them: run without a mesh (auto iterMR mode)")
        self.spec = spec
        self.cfg = cfg
        self.device = device
        _mesh_setup(self, cfg)
        self.rows = (spec.num_state + self.n_parts - 1) // self.n_parts
        self.state_parts: Optional[Dict[str, torch.Tensor]] = None
        # one MRBG slice per shard, keyed by local ids (K2 // P); None
        # until the first converge seeds them
        self.stores: Optional[list] = None
        self.cpc_accum = np.zeros(spec.num_state, np.float32)
        self.mrbg_on = True
        self.mode = "distributed"
        self._fine = (self.mc.refresh == "fine") and spec.stable_topology
        self._iters = 0
        self._max_change: list = []
        self._logs: list = []
        self._shuffle = ShuffleStats()
        self._step_cache: dict = {}       # converge steps, kept across epochs
        self._dx_step = None              # the delta-exchange step

    def _rebuild_rev(self) -> None:
        self.rev_indptr, self.rev_ids, self.dks_host = build_reverse_index(
            self.spec.project, self._keys, self._valid, self.spec.num_state)

    def run(self, struct: KV) -> None:
        host = lambda a: a.cpu().numpy().copy()
        self._keys = host(struct.keys)
        self._values = {n: host(a) for n, a in struct.values.items()}
        self._valid = host(struct.valid)
        self._rebuild_rev()
        if self.state_parts is None:      # may be pre-seeded by restore
            dks = torch.arange(self.spec.num_state, dtype=torch.int32,
                               device=self.device)
            self.state_parts = dist.local_rows(dist.partition_state(
                self.spec.init_state(dks), self.spec.num_state,
                self.n_parts), self.shards, self.n_parts)
        self._shuffle = ShuffleStats()
        self._logs = []
        self._converge(self.cfg.max_iters, self.cfg.tol)
        self.mode = "distributed"

    def _partition_cap(self) -> int:
        if self.mc.partition_cap is not None:
            return self.mc.partition_cap
        dks = dist._project_host(self.spec.project, self._keys)
        pid = dist._pid_host(dks, self.n_parts)
        load = np.bincount(pid[self._valid], minlength=self.n_parts)
        return next_bucket(max(int(load.max()), 1), 64)

    def _converge(self, max_iters: int, tol: float) -> None:
        mc = self.mc
        parts = dist.partition_struct(self.spec, self._keys, self._values,
                                      self._valid, self.n_parts,
                                      self._partition_cap())
        out, hist = dist.run_distributed(
            self.spec, mc.mesh, parts, self.state_parts,
            axis=mc.axis, pod_axis=mc.pod_axis,
            shuffle_cap=mc.shuffle_cap, max_iters=max_iters, tol=tol,
            device=self.device, auto_grow=mc.auto_grow,
            preserve_last=self._fine, step_cache=self._step_cache)
        self.state_parts = dict(out)
        self._iters = hist["iters"]
        self._max_change = hist["max_change"]
        sh = self._shuffle
        sh.edges_exchanged += hist["sent"]
        sh.bytes_moved += hist["sent"] * (10 + self.cfg.value_bytes)
        sh.exchange_seconds.extend(hist["exchange_seconds"])
        sh.shuffle_cap = hist["shuffle_cap"]
        sh.regrows += hist["regrows"]
        if self._fine:
            self._seed_stores(hist["last_edges"])

    def _seed_stores(self, last_edges) -> None:
        """Per-shard MRBG slices from the final iteration's received edges
        (``reduce(slice[p]) == state[p]`` by construction)."""
        self.stores = _shard_stores(self.cfg, self.rows, len(self.shards))
        for i, ed in enumerate(last_edges or []):
            if ed["k2"].size == 0:
                continue
            p = self.shards[i]
            local = ((ed["k2"].astype(np.int64) - p)
                     // self.n_parts).astype(np.int32)
            self.stores[i].append(local, ed["mk"], _v2_dict(ed["v2"]))
        self.cpc_accum[:] = 0.0
        self.mrbg_on = True

    # -- refresh -----------------------------------------------------------
    def update(self, delta: DeltaKV) -> None:
        self._shuffle = ShuffleStats()
        self._logs = []
        snap = self._snapshot()
        try:
            if not (self._fine and self.mrbg_on and self.stores is not None):
                # warm re-converge: mirror repartition + prime loop (it
                # re-seeds the per-shard slices when fine refresh is on, so
                # MRBG-off recovers like §5.2's rebuild-after-fallback)
                apply_delta_host(self._keys, self._values, self._valid,
                                 delta)
                self._rebuild_rev()
                self._converge(self.cfg.refresh_iters_, self.cfg.refresh_tol_)
                self.mode = "distributed-warm"
                return
            fell_back = self._fine_refresh(delta)
        except Exception:
            self._restore(snap)           # never leave the session diverged
            raise
        self.mode = "distributed-warm" if fell_back else "distributed-i2"

    def grow_records(self, capacity: int) -> None:
        n = self._keys.shape[0]
        self._keys, self._values, self._valid = pad_mirror(
            self._keys, self._values, self._valid, capacity)
        if self._keys.shape[0] != n:
            self._rebuild_rev()

    def _snapshot(self):
        return (self._keys.copy(),
                {n: a.copy() for n, a in self._values.items()},
                self._valid.copy(),
                {n: a.clone() for n, a in self.state_parts.items()},
                self.cpc_accum.copy(),
                ([s.clone() for s in self.stores]
                 if self.stores is not None else None),
                self.mrbg_on)

    def _restore(self, snap) -> None:
        (self._keys, self._values, self._valid, self.state_parts,
         self.cpc_accum, self.stores, self.mrbg_on) = snap
        self._rebuild_rev()

    def _fine_refresh(self, delta: DeltaKV) -> bool:
        """Kv-pair-level refresh; returns True if it fell back to warm."""
        cfg = self.cfg
        apply_delta_host(self._keys, self._values, self._valid, delta)
        self._rebuild_rev()
        self._max_change = []
        max_iters, tol = cfg.refresh_iters_, cfg.refresh_tol_

        # iteration 1: delta input = delta structure data
        n_input = int(delta.valid.sum())
        changed = self._fine_iteration(delta, iteration=1, n_input=n_input)
        if changed is None:               # P_Δ blew past the threshold
            self._fallback_converge(max_iters, tol)
            return True

        # iterations >= 2: delta input = delta state data (reverse index)
        for it in range(2, max_iters + 1):
            if changed.size == 0 or (self._max_change
                                     and self._max_change[-1] < tol):
                break
            recs = records_of_dks(self.rev_indptr, self.rev_ids, changed)
            if recs.size == 0:
                break
            d2 = DeltaKV(_host_tensor(self._keys[recs]), _host_tensor(recs),
                         {n: _host_tensor(a[recs])
                          for n, a in self._values.items()},
                         _host_tensor(self._valid[recs]),
                         torch.ones(recs.size, dtype=torch.int8))
            changed = self._fine_iteration(d2, iteration=it,
                                           n_input=int(changed.size))
            if changed is None:
                self._fallback_converge(max_iters - it, tol)
                return True
        self._iters = len(self._logs)
        return False

    def _fallback_converge(self, max_iters: int, tol: float) -> None:
        """§5.2 MRBG-off recovery: warm re-converge + store re-seed."""
        t0 = time.perf_counter()
        self._converge(max_iters, tol)
        self._logs.append(IterationLog(
            -1, 0, self.spec.num_state, self.spec.num_state, False,
            time.perf_counter() - t0))

    def _fine_iteration(self, delta: DeltaKV, iteration: int, n_input: int):
        """One fine-grain iteration: the delta exchange, then the per-shard
        merges.  Returns the emitted DKs, or None => fall back."""
        spec, cfg, n_parts = self.spec, self.cfg, self.n_parts
        t0 = time.perf_counter()
        for s in self.stores:
            s.reset_stats()

        # phase 1: partition the delta rows by hash(project(SK)) (Eq. 2)
        # and exchange the edges re-Mapped against the local state slices
        shards = _exchange_delta(self, delta, spec.project, self.state_parts)

        # phase 2: per-shard MRBG merges (disjoint global key sets), on
        # threads; the CPC and state updates apply in shard order
        affected_total = 0
        max_change = 0.0
        affected_parts = []
        merged = dist.merge_shards_parallel(
            spec.reducer, self.stores, n_parts, shards, device=self.device,
            workers=self.mc.merge_workers, shard_ids=self.shards)
        for p, aff, vals, _counts in merged:
            if aff.size == 0:
                continue
            affected_total += int(aff.size)
            local = torch.from_numpy(aff.astype(np.int64) // n_parts).to(
                self.device)
            new = {n: _host_tensor(a).to(self.device)
                   for n, a in vals.items()}
            i = self._slot[p]
            old = {n: a[i, local] for n, a in self.state_parts.items()}
            change = spec.difference(new, old).cpu().numpy()
            if change.size:
                max_change = max(max_change, float(change.max()))
            self.cpc_accum[aff] += change
            for n, a in new.items():
                self.state_parts[n][i, local] = a
            affected_parts.append(aff)
        affected_total, n_reads, n_bytes = _global_ints(self, (
            affected_total, sum(s.stats.n_reads for s in self.stores),
            sum(s.stats.bytes_read for s in self.stores)))
        max_change = dist.global_max(self.mc.mesh, max_change)

        if affected_total == 0:
            self._max_change.append(0.0)
            self._logs.append(IterationLog(
                iteration, n_input, 0, 0, True, time.perf_counter() - t0))
            return np.zeros(0, np.int64)
        self._max_change.append(max_change)

        # CPC (§5.3), global across shards: emit only above-threshold DKs
        affected_all = np.concatenate(affected_parts) if affected_parts \
            else np.zeros(0, np.int32)
        emit_mask = self.cpc_accum[affected_all] > cfg.cpc_threshold
        emitted = np.sort(affected_all[emit_mask]).astype(np.int64)
        self.cpc_accum[emitted] = 0.0
        emitted = np.sort(np.concatenate(
            self.mc.mesh.all_gather_object(emitted)))
        self._logs.append(IterationLog(
            iteration, n_input, affected_total, int(emitted.size), True,
            time.perf_counter() - t0, n_reads, n_bytes))

        # auto MRBG-off (§5.2): fine-grain state stops paying off
        p_delta = emitted.size / max(spec.num_state, 1)
        if p_delta > cfg.pdelta_threshold:
            self.mrbg_on = False
            return None
        return emitted

    def result(self) -> Dict[str, np.ndarray]:
        """The whole state (gathered from every rank on a RankMesh)."""
        parts = dist.gather_parts(self.mc.mesh, self.state_parts)
        return {n: a.cpu().numpy() for n, a in dist.unpartition_state(
            parts, self.spec.num_state).items()}

    def fill(self, rep: RunReport) -> None:
        rep.iters = self._iters
        rep.max_change = list(self._max_change)
        rep.logs = list(self._logs)
        if self._logs:
            rep.affected_keys = sum(l.n_affected_dks for l in self._logs)
            rep.io = IOStats(n_reads=sum(l.io_reads for l in self._logs),
                             bytes_read=sum(l.io_bytes for l in self._logs))
        if self.stores:
            _fill_stores(self, rep, io=False)
        rep.mrbg_on = bool(self.stores) and self.mrbg_on
        rep.shuffle = self._shuffle


class _DistOneStep:
    """Per-shard one-step job on a mesh: ``_OneStepMRBG``'s semantics, with
    the MRBGraph sliced across shards by the Eq. 1 hash.

    The initial run reuses the refresh machinery (every input record is an
    all-'+' delta against empty per-shard stores), so there is one step
    (the delta exchange) and one merge path from epoch 0 on.  On a
    RankMesh each rank keeps its shard's store; the merged keys of every
    rank are gathered, so that each rank's view is the whole result.
    """

    kind = "distributed-onestep"

    def __init__(self, spec: JobSpec, cfg: RunConfig, device: torch.device):
        self.spec = spec
        self.cfg = cfg
        self.device = device
        _mesh_setup(self, cfg)
        self.rows = (spec.num_keys + self.n_parts - 1) // self.n_parts
        self.stores: Optional[list] = None
        self.view: Optional[ResultView] = None
        self.mode = "distributed"
        self.mrbg_on = True
        self._affected = -1
        self._shuffle = ShuffleStats()
        self._dx_step = None

    def run(self, inp: KV) -> None:
        self._shuffle = ShuffleStats()
        self.stores = _shard_stores(self.cfg, self.rows, len(self.shards))
        self.view = None
        delta = DeltaKV(inp.keys, inp.keys, inp.values, inp.valid,
                        torch.ones(inp.capacity, dtype=torch.int8,
                                   device=inp.keys.device))
        self._refresh(delta)
        self.mode = "distributed"

    def update(self, delta: DeltaKV) -> None:
        self._shuffle = ShuffleStats()
        snap = ([s.clone() for s in self.stores],
                ResultView(self.view.num_keys,
                           {n: a.copy() for n, a in self.view.values.items()},
                           self.view.valid.copy(), self.view.counts.copy()))
        try:
            self._refresh(delta)
        except Exception:
            self.stores, self.view = snap
            raise
        self.mode = "distributed-incr"

    def _refresh(self, delta: DeltaKV) -> None:
        spec, n_parts = self.spec, self.n_parts
        for s in self.stores:
            s.reset_stats()

        shards = _exchange_delta(self, delta)
        affected_total = 0
        merged = dist.merge_shards_parallel(
            spec.reducer, self.stores, n_parts, shards, device=self.device,
            workers=self.mc.merge_workers, shard_ids=self.shards)
        # every shard's merges, in shard order (a RankMesh's ranks are its
        # shards, in order)
        merged = [m for part in self.mc.mesh.all_gather_object(merged)
                  for m in part]
        for p, aff, vals, counts in merged:
            if aff.size == 0:
                continue
            affected_total += int(aff.size)
            if self.view is None:
                self.view = ResultView(
                    spec.num_keys,
                    {n: np.zeros((spec.num_keys,) + a.shape[1:], a.dtype)
                     for n, a in vals.items()},
                    np.zeros(spec.num_keys, bool),
                    np.zeros(spec.num_keys, np.int32))
            self.view.patch(aff, vals, counts)
        self._affected = affected_total

    def result(self) -> Dict[str, np.ndarray]:
        return self.view.as_dict() if self.view is not None else {}

    def fill(self, rep: RunReport) -> None:
        rep.affected_keys = self._affected
        if self.view is not None:
            rep.counts = self.view.counts
        if self.stores:
            _fill_stores(self, rep, io=True)
        rep.shuffle = self._shuffle
