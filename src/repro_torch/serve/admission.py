"""Admission control: shed best-effort submits when the tier is saturated.

A copy of ``repro.serve.admission`` (pure Python, no device work).

The controller estimates the tier-wide *backlog* — how many seconds of
refresh work are already queued across all tenants, priced by each
tenant's own :class:`~repro_torch.stream.scheduler.RefreshScheduler` EWMA cost
model — and rejects new best-effort rows once that estimate exceeds a
budget.  Latency- and throughput-class tenants are always admitted; they
rely on backpressure (the bounded ingest queue) instead of shedding.

Queued rows are priced exactly: the tier counts rows at ``submit()``
time (``TenantHandle.queued_rows``) and credits them back as refreshes
consume them, so work sitting in the ingest queue — whose per-record row
counts are otherwise opaque without draining it — weighs its true size.
For sessions fed around the tier the estimate falls back to
``_pending_rows`` plus one row per queued record.  One deliberate
admitting-side approximation remains: a tenant with no clean ``update``
cost sample yet is priced at zero, because the seeded rerun estimate
includes cold-compile time and would shed the whole fleet at startup.
"""
from __future__ import annotations

from typing import Iterable


class AdmissionController:
    """Sheds best-effort work once estimated queued work exceeds
    ``max_backlog_seconds``."""

    def __init__(self, max_backlog_seconds: float = 0.25):
        if max_backlog_seconds <= 0:
            raise ValueError("max_backlog_seconds must be > 0")
        self.max_backlog_seconds = float(max_backlog_seconds)
        self.shed_submits = 0
        self.shed_rows = 0

    def backlog_seconds(self, handles: Iterable) -> float:
        """Predicted seconds of refresh work already buffered tier-wide."""
        total = 0.0
        for h in handles:
            ss = h.ss
            rows = max(int(getattr(h, "queued_rows", 0)),
                       ss._pending_rows + ss._inbox.qsize())
            if rows <= 0:
                continue
            est_u, est_rerun = ss.scheduler.estimates(rows)
            if est_u is None:
                continue                      # no clean sample yet: admit
            # only the cost-comparing policies are free to take the
            # cheaper rerun path; under the paper policy the crossover is
            # a ratio rule, so queued rows cost the incremental path
            if est_rerun is not None and ss.scheduler.config.policy != "paper":
                est_u = min(est_u, est_rerun)
            total += est_u
        return total

    def admit(self, handle, n_rows: int, backlog_s: float) -> bool:
        """Admission decision for one submit; counts the shed on refusal."""
        if not handle.slo.sheddable:
            return True
        if backlog_s <= self.max_backlog_seconds:
            return True
        self.shed_submits += 1
        self.shed_rows += int(n_rows)
        return False

    def snapshot(self) -> dict:
        return {"max_backlog_seconds": self.max_backlog_seconds,
                "shed_submits": self.shed_submits,
                "shed_rows": self.shed_rows}
