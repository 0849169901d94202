"""ServeTier: SLO-aware multi-tenant serving over stream sessions.

Counterpart of ``repro.serve.tier``.  The serving entry point (successor
of ``MultiSessionServer``, which shims onto this class).  One scheduler
thread drives every tenant's micro-batches, but unlike the old
round-robin sweep it:

- orders due tenants by SLO class and deadline slack
  (:mod:`repro_torch.serve.sched`);
- sheds best-effort submits under overload
  (:mod:`repro_torch.serve.admission`);
- stacks compatible small tenants' refreshes into one batched kernel
  launch (:mod:`repro_torch.serve.batch`) instead of launching per tenant;
- enforces the shared store budget obsolete-bytes-first, then spills
  cold tenants' MRBG stores to disk (:mod:`repro_torch.serve.spill`),
  reloading them transparently on their next delta.

With :meth:`ServeTier.start` the sweep runs in the tier's own thread and
every CUDA launch of a refresh goes to that thread's current stream; a
first use of a kernel builds or loads its library there, under the
build's lock.  ``launch_log`` keeps the sizes of the last batched
launches (tenants, combined rows, affected keys, key bucket).
"""
from __future__ import annotations

import collections
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from repro_torch.kernels import jitcache
from repro_torch.serve.admission import AdmissionController
from repro_torch.serve.batch import (
    MAX_GLOBAL_KEY, batch_signature, execute_group,
)
from repro_torch.serve.sched import SLOClass, order_by_priority
from repro_torch.serve.spill import SpillManager
from repro_torch.stream.session import StreamSession


@dataclass
class TenantHandle:
    """Tier-side bookkeeping for one tenant."""

    name: str
    ss: StreamSession
    slo: SLOClass
    group: Optional[str] = None
    last_active: float = field(default_factory=time.perf_counter)
    spilled: bool = False
    spill_meta: Optional[list] = None
    shed_submits: int = 0
    shed_rows: int = 0
    breaches: int = 0
    observed: int = 0
    spill_count: int = 0
    reclaimed_bytes: int = 0
    # rows admitted through tier.submit() and not yet refreshed; unlike
    # ss._inbox.qsize() (records, row counts opaque) this prices queued
    # work exactly, which is what admission's backlog estimate needs
    queued_rows: int = 0
    # breach-window latency reservoir (seconds); bounded, reset by callers
    # that want a measurement window rather than lifetime percentiles
    latency_samples: List[float] = field(default_factory=list)

    def reset_window(self) -> None:
        """Zero the SLO accounting window (breaches, sheds, latencies)."""
        self.shed_submits = self.shed_rows = 0
        self.breaches = self.observed = 0
        self.latency_samples.clear()

    def snapshot(self) -> Dict[str, object]:
        lat = sorted(self.latency_samples)
        p95 = (lat[min(len(lat) - 1,
                       int(round(0.95 * (len(lat) - 1))))] * 1e3
               if lat else None)
        return {
            "slo": self.slo.kind,
            "deadline_ms": self.slo.deadline_ms,
            "target_p95_ms": self.slo.target_p95_ms,
            "shed_submits": self.shed_submits,
            "shed_rows": self.shed_rows,
            "breaches": self.breaches,
            "observed": self.observed,
            "breach_rate": self.breaches / max(self.observed, 1),
            "latency_p95_ms": p95,
            "queued_rows": self.queued_rows,
            "spilled": self.spilled,
            "spill_count": self.spill_count,
            "reclaimed_bytes": self.reclaimed_bytes,
        }


class ServeTier:
    """Schedule many tenant :class:`StreamSession`\\ s over one engine."""

    def __init__(self, store_budget_bytes: Optional[int] = None,
                 poll_interval: float = 0.002,
                 batch_refresh: bool = True,
                 max_batch_tenants: int = 128,
                 spill_dir=None,
                 admission: Optional[AdmissionController] = None):
        self.store_budget_bytes = store_budget_bytes
        self.poll_interval = poll_interval
        self.batch_refresh = batch_refresh
        self.max_batch_tenants = max(int(max_batch_tenants), 1)
        self.handles: Dict[str, TenantHandle] = {}
        self.admission = admission or AdmissionController()
        self.spill = SpillManager(spill_dir) if spill_dir is not None else None
        self._stop_evt = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._over_budget = False
        self._sweeps = 0
        self._batched_launches = 0
        self._batched_refreshes = 0
        self.launch_log: collections.deque = collections.deque(maxlen=256)
        self._error: Optional[BaseException] = None

    # -- tenancy -----------------------------------------------------------
    @property
    def tenants(self) -> Dict[str, StreamSession]:
        """Name -> session view (read-only; kept for server compat)."""
        return {n: h.ss for n, h in self.handles.items()}

    def add(self, tenant: StreamSession, slo: Optional[SLOClass] = None,
            group: Optional[str] = None) -> StreamSession:
        """Admit a tenant; the tier owns its scheduling from now on (the
        tenant must not run its own worker thread).

        Admission runs the tenant's initial job — and, with
        ``StreamConfig(prewarm=True)``, compiles its delta bucket ladder —
        before it enters the sweep, so a new tenant never pays
        cold-compile latency out of the shared scheduler thread.  ``slo``
        defaults to best-effort; ``group`` partitions batched refresh
        (tenants only batch within their group).
        """
        if tenant.name in self.handles:
            raise ValueError(f"tenant {tenant.name!r} already registered")
        if tenant._thread is not None:
            raise ValueError(f"tenant {tenant.name!r} already runs its own "
                             f"worker; construct it unstarted")
        tenant.start(background=False)     # initial run, no thread
        tenant._managed = True             # this thread is its consumer now
        self.handles[tenant.name] = TenantHandle(
            tenant.name, tenant, slo or SLOClass.best_effort(), group)
        return tenant

    def remove(self, name: str) -> StreamSession:
        """Deregister a tenant and hand its session back (resident again
        if it was spilled; buffered rows stay queued for the caller to
        drain in sync mode)."""
        handle = self.handles.pop(name)
        if handle.spilled and self.spill is not None:
            self.spill.reload(handle)
        handle.ss._managed = False
        return handle.ss

    def __getitem__(self, name: str) -> StreamSession:
        return self.handles[name].ss

    def handle(self, name: str) -> TenantHandle:
        return self.handles[name]

    # -- ingestion ---------------------------------------------------------
    def submit(self, name: str, record_ids, values, sign, *, epoch: int = 0,
               timeout: Optional[float] = None) -> bool:
        """Submit one delta record through admission control.

        Returns ``False`` when the record was shed (best-effort tenant,
        tier overloaded) — the caller may retry later.  Latency and
        throughput classes are always admitted (backpressure applies).
        """
        handle = self.handles[name]
        n_rows = len(record_ids)
        if handle.slo.sheddable:
            backlog = self.admission.backlog_seconds(self.handles.values())
            if not self.admission.admit(handle, n_rows, backlog):
                handle.shed_submits += 1
                handle.shed_rows += n_rows
                return False
        handle.ss.submit(record_ids, values, sign, epoch=epoch,
                         timeout=timeout)
        handle.queued_rows += n_rows
        handle.last_active = time.perf_counter()
        return True

    # -- scheduling --------------------------------------------------------
    def start(self) -> "ServeTier":
        if self._thread is None:
            self._stop_evt.clear()
            self._thread = threading.Thread(target=self._loop,
                                            name="serve-tier", daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop_evt.set()
        if self._thread is not None:
            self._thread.join(timeout=30)
            self._thread = None

    def __enter__(self) -> "ServeTier":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def _loop(self) -> None:
        while not self._stop_evt.is_set():
            try:
                if not self.sweep():
                    time.sleep(self.poll_interval)
            except BaseException as e:       # noqa: BLE001 — surfaced via
                self._error = e              # _check_error on drain
                return

    def _check_error(self) -> None:
        if self._error is not None:
            raise RuntimeError("serving tier scheduler thread died; the "
                               "failing micro-batch was dropped"
                               ) from self._error

    def _serve_urgent(self) -> bool:
        """Refresh every due latency/throughput tenant immediately (solo).

        Called between best-effort work units as a preemption point: a
        latency-class row that arrives while the sweep is grinding
        through the best-effort herd waits for at most one launch, not
        the whole herd.
        """
        served = False
        for h in list(self.handles.values()):
            if h.slo.sheddable:
                continue
            h.ss._ingest()
            # _busy means an earlier prepared batch of this tenant is
            # still awaiting execution in the outer sweep; preparing a
            # second one here would refresh them out of order
            if h.ss._busy or not h.ss._should_fire():
                continue
            with h.ss._lock:
                if h.spilled and self.spill is not None:
                    self.spill.reload(h)
                prep = h.ss.prepare_batch()
            if prep is None:
                continue
            with h.ss._lock:
                h.ss.execute_prepared(prep)
            self._after_refresh(h, prep)
            served = True
        return served

    def sweep(self) -> bool:
        """One scheduling pass: ingest everywhere, prepare every due
        tenant in SLO order, refresh batched groups with one launch each
        and the rest solo (non-sheddable tenants preempt between work
        units), then enforce the store budget.  Returns True if any
        tenant made progress."""
        progressed = False
        handles = list(self.handles.values())
        for h in handles:
            h.ss._ingest()
        due = order_by_priority([h for h in handles if h.ss._should_fire()])

        prepared: List[tuple] = []
        for h in due:
            ss = h.ss
            with ss._lock:
                if h.spilled and self.spill is not None:
                    self.spill.reload(h)     # cold tenant woke up
                prep = ss.prepare_batch()
            if prep is not None:
                prepared.append((h, prep))

        groups: Dict[tuple, List[tuple]] = {}
        solos: List[tuple] = []
        for h, prep in prepared:
            sig = batch_signature(h.ss, prep) if self.batch_refresh else None
            if sig is not None:
                groups.setdefault(sig + (h.group,), []).append((h, prep))
            else:
                solos.append((h, prep))

        chunks: List[List[tuple]] = []
        for sig, items in groups.items():
            num_keys = items[0][0].ss.session.spec.num_keys
            limit = max(1, min(self.max_batch_tenants,
                               MAX_GLOBAL_KEY // max(num_keys, 1)))
            while items:
                chunk, items = items[:limit], items[limit:]
                if len(chunk) == 1:
                    solos.append(chunk[0])
                else:
                    chunks.append(chunk)

        # non-sheddable solos run before any best-effort work grinds;
        # after that, every launch is a preemption point
        solos.sort(key=lambda hp: hp[0].slo.rank)
        while solos and not solos[0][0].slo.sheddable:
            h, prep = solos.pop(0)
            with h.ss._lock:
                h.ss.execute_prepared(prep)
            self._after_refresh(h, prep)
            progressed = True

        for chunk in chunks:
            self.launch_log.append(execute_group(
                chunk, chunk[0][0].ss.session.config.delta_bucket_min))
            self._batched_launches += 1
            self._batched_refreshes += len(chunk)
            for h, prep in chunk:
                self._after_refresh(h, prep)
            progressed = True
            progressed |= self._serve_urgent()

        for h, prep in solos:
            with h.ss._lock:
                h.ss.execute_prepared(prep)
            self._after_refresh(h, prep)
            progressed = True
            progressed |= self._serve_urgent()

        self._enforce_budget()
        self._sweeps += 1
        return progressed

    def _after_refresh(self, handle: TenantHandle, prep) -> None:
        now = time.perf_counter()
        handle.last_active = now
        handle.queued_rows = max(0, handle.queued_rows - prep.n_in)
        if handle.slo.target_p95_ms is not None:
            latency = now - prep.first_arrival
            handle.observed += 1
            handle.latency_samples.append(latency)
            if len(handle.latency_samples) > 4096:
                del handle.latency_samples[:2048]
            if latency * 1e3 > handle.slo.target_p95_ms:
                handle.breaches += 1

    # -- shared store budget ----------------------------------------------
    def total_store_bytes(self) -> int:
        return sum(h.ss.store_bytes() for h in self.handles.values())

    def _enforce_budget(self) -> None:
        if self.store_budget_bytes is None:
            return
        total = self.total_store_bytes()
        if total <= self.store_budget_bytes:
            self._over_budget = False
            return
        # 1) compact: most obsolete bytes first (ties: least recently
        # active first), crediting each tenant's reclaim in stats()
        order = sorted(self.handles.values(),
                       key=lambda h: (-h.ss.session.store_obsolete_bytes(),
                                      h.last_active))
        for h in order:
            if total <= self.store_budget_bytes:
                break
            reclaimed = h.ss.compact_store()
            if reclaimed:
                h.reclaimed_bytes += reclaimed
                total -= reclaimed
        # 2) still over: spill cold tenants' stores to disk, least
        # important first (best-effort before latency), LRU within class
        if self.spill is not None:
            for h in sorted(self.handles.values(),
                            key=lambda h: (-h.slo.rank, h.last_active)):
                if total <= self.store_budget_bytes:
                    break
                if h.spilled or not h.ss.idle:
                    continue
                freed = self.spill.spill(h)
                if freed:
                    h.spill_count += 1
                    total -= freed
        self._over_budget = total > self.store_budget_bytes

    # -- synchronization / outputs ----------------------------------------
    def drain(self, timeout: float = 60.0) -> None:
        """Flush and process everything buffered in every tenant."""
        deadline = time.perf_counter() + timeout
        for h in self.handles.values():
            h.ss._flush = True
        try:
            while True:
                self._check_error()
                if self._thread is None:
                    self.sweep()
                if all(h.ss.idle for h in self.handles.values()):
                    return
                if time.perf_counter() > deadline:
                    lag = {n: h.ss._pending_rows + h.ss._inbox.qsize()
                           for n, h in self.handles.items() if not h.ss.idle}
                    raise TimeoutError(f"tier drain exceeded {timeout}s; "
                                       f"lagging tenants: {lag}")
                if self._thread is not None:
                    time.sleep(self.poll_interval)
        finally:
            for h in self.handles.values():
                h.ss._flush = False

    def stats(self) -> Dict[str, object]:
        tenants = {n: h.ss.metrics.snapshot()
                   for n, h in self.handles.items()}
        out = {
            "tenants": tenants,
            "classes": {n: h.snapshot() for n, h in self.handles.items()},
            "total_store_bytes": self.total_store_bytes(),
            "store_budget_bytes": self.store_budget_bytes,
            "over_budget": self._over_budget,
            "sweeps": self._sweeps,
            "batched_launches": self._batched_launches,
            "batched_refreshes": self._batched_refreshes,
            "reclaimed_bytes": {n: h.reclaimed_bytes
                                for n, h in self.handles.items()},
            "admission": self.admission.snapshot(),
            # process-wide latency-tail telemetry (shared jit caches)
            "retrace_batches": sum(t["retrace_batches"]
                                   for t in tenants.values()),
            "rows_rejected": sum(t["rows_rejected"]
                                 for t in tenants.values()),
            # tier-wide coalescer savings (rows the engine never saw)
            "rows_cancelled": sum(t["rows_cancelled"]
                                  for t in tenants.values()),
            "net_inserts": sum(t["net_inserts"] for t in tenants.values()),
            "net_deletes": sum(t["net_deletes"] for t in tenants.values()),
            "jit": jitcache.snapshot(),
        }
        if self.spill is not None:
            out["spill"] = self.spill.snapshot()
        return out
