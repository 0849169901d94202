"""StreamSession: the async serving driver over one Session.

Counterpart of ``repro.stream.session``, with the same names and behaviour.

One thread owns the engine; producers push signed delta rows through a
bounded queue (blocking ``submit`` = backpressure) and/or a
:class:`repro_torch.stream.DeltaSource` is polled.  Rows are micro-batched
(``StreamConfig.max_batch_records`` / ``max_batch_delay``), coalesced, and
applied through whichever refresh path the :class:`RefreshScheduler`
picks — fine-grain incremental ``update()`` or full ``rerun()`` on the
maintained input mirror.  ``drain()`` blocks until every available row is
reflected in ``result``; ``snapshot()`` checkpoints the session together
with the stream watermark so a replayable source can resume after
recovery.

The worker thread issues the CUDA work of the coalescer and of every
refresh on PyTorch's current stream of the session's device (the default
stream: the thread creates none), where the kernels launch
(``repro_torch.kernels._build.stream_ptr``); the first use of a kernel may
build or load its library inside the worker, under the build's lock.  A
batch is marked ``retraced`` when ``jitcache.generation()`` moved between
the start of its coalescing and the end of its refresh, i.e. when it built
or loaded a kernel library: the port's counterpart of a retrace.
"""
from __future__ import annotations

import json
import queue as queue_mod
import threading
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.api.config import RunConfig, StreamConfig
from repro_torch.api.session import Session, Spec
from repro_torch.core.incremental import apply_delta_host, make_delta
from repro_torch.core.kvstore import KV, next_bucket
from repro_torch.kernels import jitcache
from repro_torch.stream.coalesce import (
    CoalesceResult, coalesce, coalesce_rows, concat_records,
)
from repro_torch.stream.metrics import StreamMetrics
from repro_torch.stream.scheduler import RefreshScheduler
from repro_torch.stream.source import DeltaRecord, DeltaSource


def _host(a) -> np.ndarray:
    """A host copy of a tensor or an array."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy().copy()
    return np.array(a)


@dataclass
class PreparedBatch:
    """One micro-batch after coalescing and mirror application, before the
    refresh itself.  ``StreamSession._process_batch`` consumes these
    in-place; the serving tier's batched cross-tenant path pulls them out
    via :meth:`StreamSession.prepare_batch`, runs many tenants' refreshes
    through one kernel launch, then calls ``commit_batch``/``rollback_batch``.
    """

    records: List[DeltaRecord]
    first_arrival: float
    epoch: int
    n_in: int
    res: CoalesceResult
    rows: Optional[np.ndarray]       # mirror rows saved for rollback
    saved: Optional[tuple]           # (keys, values, valid) at those rows
    decision: Optional[Any]          # scheduler decision; None => noop
    gen0: int = 0                    # jitcache.generation() at the start
    coalesce_s: float = 0.0          # host clock of the coalescer
    mirror_s: float = 0.0            # host clock of the mirror update


class StreamSession:
    """Continuously refresh one declared job from a delta stream."""

    def __init__(self, spec: Spec, data: KV,
                 source: Optional[DeltaSource] = None,
                 config: Optional[RunConfig] = None,
                 stream: Optional[StreamConfig] = None,
                 name: str = "session"):
        self.name = name
        self.session = Session(spec, config)
        self.sconfig = stream or StreamConfig()
        self.source = source
        self.scheduler = RefreshScheduler(self.sconfig)
        self.metrics = StreamMetrics()

        # input mirror (the partitioned input file on HDFS): rerun() and
        # the cold-run oracle both read it
        self._mkeys = _host(data.keys)
        self._mvalues = {n: _host(a) for n, a in data.values.items()}
        self._mvalid = _host(data.valid)

        self._inbox: queue_mod.Queue = queue_mod.Queue(
            maxsize=self.sconfig.queue_capacity)
        self._pending: List[Tuple[DeltaRecord, float]] = []
        self._pending_rows = 0
        self._lock = threading.RLock()       # engine + mirror + scheduler
        self._stop_evt = threading.Event()
        self._flush = False
        self._busy = False
        self._starved = False                # last ingest found nothing
        self._managed = False                # scheduled by a serving tier
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._prewarmed = False
        self.grow_events = 0                 # mirror-capacity doublings
        # seconds of the last refreshed batch's parts: coalesce, mirror
        # update (growth, rollback copy, apply), refresh
        self.last_split: Dict[str, float] = {}

    # -- lifecycle ---------------------------------------------------------
    def start(self, background: bool = True) -> "StreamSession":
        """Run the initial job, then (optionally) start the worker thread.

        ``background=False`` leaves batch processing to explicit
        :meth:`step` calls (one thread drives ingestion and refreshes) —
        the mode a :class:`repro_torch.serve.ServeTier` uses to time-slice
        many tenants over its own thread.
        """
        with self._lock:
            if self.session.epoch < 0:
                rep = self.session.run(self._mirror_kv())
                self.scheduler.seed(rep.seconds)
            if self.sconfig.prewarm and not self._prewarmed:
                self._prewarm()
                self._prewarmed = True
        if background and self._thread is None:
            self._stop_evt.clear()           # allow stop() -> start() cycles
            self._thread = threading.Thread(
                target=self._loop, name=f"stream-{self.name}", daemon=True)
            self._thread.start()
        return self

    def _prewarm(self) -> None:
        """Run the delta bucket ladder before real traffic arrives.

        Pushes numerically inert deltas ('-' then '+' of a record's current
        mirror value — a no-op on every refresh path) through
        ``session.update()`` at each power-of-two row capacity of the
        ladder, as the reference does to compile it; here that builds and
        loads every kernel the refresh path and the coalescer use, so that
        no real micro-batch pays for it.
        """
        rows = np.nonzero(self._mvalid)[0]
        if rows.size == 0:
            return
        minimum = self.session.config.delta_bucket_min
        top = next_bucket(
            self.sconfig.prewarm_rows or self.sconfig.max_batch_records,
            minimum)
        floor = next_bucket(1, max(minimum, 2))
        device = self.session.device
        # ladder sizes: one full noop per row bucket above the minimum
        # (above the floor the valid count pins the downstream edge bucket),
        # plus a doubling sub-ladder inside the minimum bucket — there the
        # row capacity is clamped to the floor while the *valid* count (and
        # with it the edge bucket) still varies freely
        sizes, v = [], 2
        while v < floor:
            sizes.append(v)
            v *= 2
        while v <= top:
            sizes.append(v)
            v *= 2
        for size in sizes:
            delta = self._noop_delta(size, rows)
            if self.sconfig.coalesce:
                # real batches hit the coalescer's kernels first; run them
                # at this bucket too (the output is discarded — the engine
                # is warmed with the delta below)
                coalesce_rows(delta.record_ids.numpy(),
                              {n: a.numpy() for n, a in delta.values.items()},
                              delta.sign.numpy(), device=device)
            self.session.update(delta)

    def _noop_delta(self, cap: int, rows: np.ndarray):
        """A ``cap``-row delta of '-'/'+' pairs replaying current values."""
        sel = rows[np.arange(cap // 2) % rows.size]
        rid = np.repeat(sel, 2).astype(np.int32)
        values = {n: np.repeat(a[sel], 2, axis=0)
                  for n, a in self._mvalues.items()}
        sign = np.tile(np.array([-1, 1], np.int8), cap // 2)
        keys = np.repeat(self._mkeys[sel], 2).astype(np.int32)
        return make_delta(rid, values, sign, keys=keys)

    def stop(self) -> None:
        """Stop the worker; rows not yet processed stay buffered."""
        self._stop_evt.set()
        if self._thread is not None:
            self._thread.join(timeout=30)
            self._thread = None

    def __enter__(self) -> "StreamSession":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- ingestion ---------------------------------------------------------
    def submit(self, record_ids, values, sign, *, epoch: int = 0,
               timeout: Optional[float] = None) -> None:
        """Push one group of signed delta rows.  Blocks while the ingest
        queue is full (backpressure); raises ``queue.Full`` on timeout."""
        rec = DeltaRecord(record_ids=record_ids, values=values, sign=sign,
                          timestamp=time.time(), epoch=epoch)
        self.submit_record(rec, timeout=timeout)

    def submit_record(self, record: DeltaRecord,
                      timeout: Optional[float] = None) -> None:
        """Validate and enqueue one record; raises ``ValueError`` on record
        ids outside the input mirror (the batch it would have joined — and
        the worker thread — are unaffected)."""
        self._validate_record(record)
        self._inbox.put((record, time.perf_counter()), block=True,
                        timeout=timeout)

    def _validate_record(self, rec: DeltaRecord) -> None:
        rid = np.asarray(rec.record_ids)
        if rid.size == 0:
            return
        lo, hi = int(rid.min()), int(rid.max())
        if lo < 0:
            raise ValueError(
                f"record id {lo} outside the input mirror capacity "
                f"{self._mkeys.shape[0]}; record ids must be >= 0")
        # with grow_records (the default) the mirror grows geometrically on
        # overflow, so only a configured ceiling rejects inserts
        if self.sconfig.grow_records:
            limit = self.sconfig.max_records
        else:
            limit = self._mkeys.shape[0]
        if limit is not None and hi >= limit:
            hint = ("raise StreamConfig(max_records=...)"
                    if self.sconfig.grow_records
                    else "pass StreamConfig(grow_records=True) to stream "
                         "inserts")
            raise ValueError(
                f"record id {hi} outside the input mirror capacity "
                f"{limit}; {hint}")

    def _grow_to(self, needed: int) -> None:
        """Geometric input-mirror growth: extend the mirror (invalid rows)
        and the session driver's record structures to the next power-of-two
        capacity >= ``needed``.  Caller holds ``_lock``."""
        cap = self._mkeys.shape[0]
        if needed <= cap:
            return
        # next power of two >= max(needed, 2*cap): O(log) growth events
        new_cap = next_bucket(max(needed, 2 * cap), 1)
        if self.sconfig.max_records is not None:
            new_cap = min(new_cap, self.sconfig.max_records)
        pad = new_cap - cap
        self._mkeys = np.concatenate(
            [self._mkeys,
             np.zeros((pad,) + self._mkeys.shape[1:], self._mkeys.dtype)])
        self._mvalues = {
            n: np.concatenate([a, np.zeros((pad,) + a.shape[1:], a.dtype)])
            for n, a in self._mvalues.items()}
        self._mvalid = np.concatenate(
            [self._mvalid, np.zeros(pad, bool)])
        self.session.grow_records(new_cap)
        self.grow_events += 1

    def _ingest(self) -> bool:
        """Move rows from the inbox and the source into the pending batch
        (never beyond one batch's budget: the inbox stays bounded and the
        producers blocked — that is the backpressure path)."""
        # not idle while probing: a concurrent drain() must not observe the
        # window where a record left the inbox but isn't pending yet
        self._starved = False
        progressed = False
        budget = self.sconfig.max_batch_records - self._pending_rows
        while budget > 0:
            try:
                rec, arrival = self._inbox.get_nowait()
            except queue_mod.Empty:
                break
            self._pending.append((rec, arrival))
            self._pending_rows += rec.n_rows
            budget -= rec.n_rows
            progressed = True
        if self.source is not None and budget > 0 and \
                not self.source.exhausted:
            now = time.perf_counter()
            for rec in self.source.poll(budget):
                try:
                    self._validate_record(rec)
                except ValueError:
                    # drop the bad record, keep the stream (and the other
                    # records of this poll) alive
                    self.metrics.observe_rejected(rec.n_rows)
                    continue
                self._pending.append((rec, now))
                self._pending_rows += rec.n_rows
                progressed = True
        self._starved = not progressed and not self._pending
        return progressed

    def _should_fire(self) -> bool:
        if not self._pending:
            return False
        if self._flush or self._pending_rows >= self.sconfig.max_batch_records:
            return True
        oldest = self._pending[0][1]
        return (time.perf_counter() - oldest) >= self.sconfig.max_batch_delay

    # -- the refresh step --------------------------------------------------
    def step(self) -> bool:
        """One synchronous scheduling quantum: ingest, then process at most
        one micro-batch.  Returns True if a refresh ran."""
        self._ingest()
        if not self._should_fire():
            return False
        self._process_batch()
        return True

    def _loop(self) -> None:
        while not self._stop_evt.is_set():
            try:
                if not self.step():
                    time.sleep(self.sconfig.poll_interval)
            except BaseException as e:       # noqa: BLE001 — surfaced via
                self._error = e              # _check_error on drain/result
                return

    def _check_error(self) -> None:
        if self._error is not None:
            raise RuntimeError(
                f"stream worker for {self.name!r} died; the failing "
                f"micro-batch was dropped") from self._error

    def prepare_batch(self) -> Optional[PreparedBatch]:
        """Assemble the pending micro-batch into an applied-but-unrefreshed
        unit of work: coalesce, grow + mutate the input mirror (rollback
        state captured), and take the scheduler's refresh decision.

        Caller must hold ``_lock`` and must follow up with exactly one of
        :meth:`commit_batch` (after executing the decision — here or in the
        serving tier's batched cross-tenant launch) or
        :meth:`rollback_batch` (on failure).  Marks the session busy until
        then.  Returns ``None`` when nothing is pending.
        """
        if not self._pending:
            return None
        self._busy = True
        gen0 = jitcache.generation()
        try:
            batch = self._pending
            self._pending = []
            self._pending_rows = 0
            records = [r for r, _ in batch]
            first_arrival = min(a for _, a in batch)
            epoch = max(r.epoch for r in records)
            n_in = sum(r.n_rows for r in records)

            t0 = time.perf_counter()
            if self.sconfig.coalesce:
                res = coalesce(records, device=self.session.device)
            else:
                rids, vals, signs = concat_records(records)
                res = CoalesceResult(make_delta(rids, vals, signs),
                                     n_in, n_in, 0, 0, 0)
            t1 = time.perf_counter()
            if res.delta is None:              # everything cancelled out
                return PreparedBatch(records, first_arrival, epoch, n_in,
                                     res, None, None, None, gen0,
                                     coalesce_s=t1 - t0)
            # mirror mutation must be rollback-able: rerun() consumes the
            # updated mirror, so it cannot simply be deferred until after
            # the refresh succeeds
            rid = res.delta.record_ids.cpu().numpy()
            dvalid = res.delta.valid.cpu().numpy()
            if dvalid.any():
                self._grow_to(int(rid[dvalid].max()) + 1)
            rows = np.unique(rid[dvalid])
            saved = (self._mkeys[rows].copy(),
                     {n: a[rows].copy() for n, a in self._mvalues.items()},
                     self._mvalid[rows].copy())
            apply_delta_host(self._mkeys, self._mvalues, self._mvalid,
                             res.delta)
            t2 = time.perf_counter()
            decision = self.scheduler.decide(
                res.n_out, state_rows=int(self._mvalid.sum()),
                store_file_bytes=self.session.store_bytes(),
                store_live_bytes=self.session.store_live_bytes())
            return PreparedBatch(records, first_arrival, epoch, n_in, res,
                                 rows, saved, decision, gen0,
                                 coalesce_s=t1 - t0, mirror_s=t2 - t1)
        except BaseException:
            self._busy = False
            raise

    def rollback_batch(self, prep: PreparedBatch) -> None:
        """Put the mirror back after a failed refresh so it keeps matching
        the state the engine actually computed.  (Mirror growth is *not*
        undone — the extra rows are invalid and harmless.)"""
        try:
            if prep.saved is not None:
                skeys, svals, svalid = prep.saved
                self._mkeys[prep.rows] = skeys
                for n, a in self._mvalues.items():
                    a[prep.rows] = svals[n]
                self._mvalid[prep.rows] = svalid
        finally:
            self._busy = False

    def commit_batch(self, prep: PreparedBatch, action: str,
                     refresh_s: float, retraced: bool) -> None:
        """Record a completed refresh (run here or by the serving tier) in
        the scheduler's cost model and the metrics."""
        try:
            if prep.decision is not None and action != "noop":
                self.scheduler.observe(action, prep.res.n_out, refresh_s,
                                       compiled=retraced)
            res = prep.res
            self.metrics.observe_batch(
                n_in=prep.n_in, n_engine=res.n_out, action=action,
                latency_s=time.perf_counter() - prep.first_arrival,
                refresh_s=refresh_s, epoch=prep.epoch, retraced=retraced,
                n_cancelled=res.n_cancelled, n_inserts=res.n_inserts,
                n_deletes=res.n_deletes)
        finally:
            self._busy = False

    def execute_prepared(self, prep: PreparedBatch) -> str:
        """Run a prepared batch's scheduled refresh on this session's own
        engine — the per-tenant path (the serving tier's batched path runs
        the engine itself and calls commit/rollback directly).  Caller
        holds ``_lock``.  Returns the action taken."""
        if prep.decision is None:
            self.commit_batch(prep, "noop", 0.0, False)
            return "noop"
        try:
            if prep.decision.action == "update":
                rep = self.session.update(prep.res.delta)
            else:
                rep = self.session.rerun(self._mirror_kv())
        except BaseException:
            self.rollback_batch(prep)
            raise
        # surface the coalescer's savings on the epoch's RunReport so the
        # session history (the scheduler's raw material) carries them
        rep.coalesce = {
            "n_in": prep.res.n_in, "n_out": prep.res.n_out,
            "n_records": prep.res.n_records,
            "n_inserts": prep.res.n_inserts,
            "n_deletes": prep.res.n_deletes,
            "n_cancelled": prep.res.n_cancelled}
        # a kernel library built or loaded since the batch started (the
        # coalescer included) marks its wall-clock as compile-tainted
        retraced = jitcache.generation() != prep.gen0
        self.last_split = {"coalesce": prep.coalesce_s,
                           "mirror": prep.mirror_s, "refresh": rep.seconds}
        self.commit_batch(prep, prep.decision.action, rep.seconds, retraced)
        return prep.decision.action

    def _process_batch(self) -> None:
        with self._lock:
            prep = self.prepare_batch()
            if prep is not None:
                self.execute_prepared(prep)

    # -- synchronization ---------------------------------------------------
    @property
    def idle(self) -> bool:
        """No buffered input, no batch in flight, nothing the source can
        offer right now."""
        return (self._inbox.empty() and not self._pending
                and not self._busy and self._starved)

    def drain(self, timeout: float = 60.0) -> None:
        """Block until every available delta row is reflected in
        ``result`` (flushes partial micro-batches immediately)."""
        deadline = time.perf_counter() + timeout
        self._flush = True
        try:
            while True:
                self._check_error()
                if self._thread is None and not self._managed:
                    self.step()              # sync mode: we are the consumer
                if self.idle:
                    return
                if time.perf_counter() > deadline:
                    raise TimeoutError(
                        f"drain() exceeded {timeout}s "
                        f"(inbox={self._inbox.qsize()}, "
                        f"pending={self._pending_rows} rows)")
                if self._thread is not None or self._managed:
                    time.sleep(min(self.sconfig.poll_interval, 0.005))
        finally:
            self._flush = False

    # -- outputs -----------------------------------------------------------
    @property
    def result(self) -> Dict[str, np.ndarray]:
        self._check_error()
        with self._lock:
            return self.session.result

    def report(self, **kw):
        with self._lock:
            return self.session.report(**kw)

    def _mirror_kv(self) -> KV:
        # copies: the mirror is edited in place by later batches
        t = lambda a: torch.from_numpy(a.copy())
        return KV(t(self._mkeys), {n: t(a) for n, a in self._mvalues.items()},
                  t(self._mvalid))

    def mirror_kv(self) -> KV:
        """The fully-updated input as of the last processed batch — what a
        cold ``run()`` would consume to reproduce ``result``."""
        with self._lock:
            return self._mirror_kv()

    def snapshot(self, path: Optional[str] = None) -> Path:
        """Checkpoint the session plus the stream watermark; a replayable
        source can ``rewind(watermark)`` after restore and re-drain."""
        with self._lock:
            out = self.session.checkpoint(path)
            root = Path(path or self.session.config.checkpoint_dir)
            (root / "stream.json").write_text(json.dumps(
                {"watermark": self.metrics.last_epoch,
                 "epoch": self.session.epoch, "name": self.name}))
        return out

    def compact_store(self) -> int:
        """Reclaim obsolete MRBG bytes (a serving tier's budget lever)."""
        with self._lock:
            reclaimed = self.session.compact_store()
        if reclaimed:
            self.metrics.observe_compaction(reclaimed)
        return reclaimed

    def store_bytes(self) -> int:
        with self._lock:
            return self.session.store_bytes()
