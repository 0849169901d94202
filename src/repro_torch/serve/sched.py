"""SLO classes and deadline-slack priority ordering for the serving tier.

A copy of ``repro.serve.sched`` (pure Python, no device work).

Each tenant is admitted under one of three service classes:

- ``latency``     — interactive tenants with a p95 refresh-latency target;
                    scheduled first, never shed.
- ``throughput``  — bulk tenants that care about sustained updates/sec;
                    scheduled after latency tenants, never shed.
- ``best-effort`` — background tenants; scheduled last and shed by
                    admission control when the tier is overloaded.

Within a class, due tenants are ordered by *deadline slack*: the time left
until the oldest pending row blows its deadline, minus the refresh cost
the tenant's own :class:`~repro_torch.stream.scheduler.RefreshScheduler` EWMA
model predicts for the pending rows.  Most-negative slack first — the
tenant closest to (or deepest into) a breach refreshes next.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import List, Optional

LATENCY = "latency"
THROUGHPUT = "throughput"
BEST_EFFORT = "best-effort"
KINDS = (LATENCY, THROUGHPUT, BEST_EFFORT)
_RANK = {LATENCY: 0, THROUGHPUT: 1, BEST_EFFORT: 2}


@dataclass(frozen=True)
class SLOClass:
    """A tenant's service-level objective.

    ``deadline_ms`` bounds how long a submitted row may wait before its
    refresh completes (drives scheduling order); ``target_p95_ms`` is the
    latency class's advertised p95 (drives breach accounting in
    ``stats()``).
    """

    kind: str = BEST_EFFORT
    deadline_ms: float = 200.0
    target_p95_ms: Optional[float] = None

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown SLO class {self.kind!r}; "
                             f"expected one of {KINDS}")
        if self.deadline_ms <= 0:
            raise ValueError("deadline_ms must be > 0")
        if self.target_p95_ms is not None and self.target_p95_ms <= 0:
            raise ValueError("target_p95_ms must be > 0 (or None)")

    @property
    def rank(self) -> int:
        return _RANK[self.kind]

    @property
    def sheddable(self) -> bool:
        return self.kind == BEST_EFFORT

    @classmethod
    def latency(cls, target_p95_ms: float = 50.0,
                deadline_ms: Optional[float] = None) -> "SLOClass":
        return cls(LATENCY, deadline_ms or target_p95_ms, target_p95_ms)

    @classmethod
    def throughput(cls, deadline_ms: float = 1000.0) -> "SLOClass":
        return cls(THROUGHPUT, deadline_ms)

    @classmethod
    def best_effort(cls, deadline_ms: float = 5000.0) -> "SLOClass":
        return cls(BEST_EFFORT, deadline_ms)


def deadline_slack(handle, now: Optional[float] = None) -> float:
    """Seconds of headroom before ``handle``'s oldest pending row misses
    its deadline, net of the predicted refresh cost.  Negative = already
    (predicted to be) in breach."""
    if now is None:
        now = time.perf_counter()
    ss = handle.ss
    pending = ss._pending
    waited = (now - pending[0][1]) if pending else 0.0
    rows = max(ss._pending_rows, 1)
    est_u, est_rerun = ss.scheduler.estimates(rows)
    est = est_u if est_u is not None else (est_rerun or 0.0)
    return handle.slo.deadline_ms / 1e3 - waited - est


def order_by_priority(handles, now: Optional[float] = None) -> List:
    """Scheduling order for one sweep: class rank first (latency <
    throughput < best-effort), then most-negative deadline slack."""
    if now is None:
        now = time.perf_counter()
    return sorted(handles,
                  key=lambda h: (h.slo.rank, deadline_slack(h, now)))
