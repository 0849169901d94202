"""repro_torch.serve — SLO-aware multi-tenant serving tier.

Counterpart of ``repro.serve``, with the same modules and names.  The
serving entry point for fleets of incremental tenants: per-tenant SLO
classes with deadline-slack scheduling, admission control that sheds
best-effort work under overload, batched cross-tenant refresh (many
small tenants, one launch of each kernel), and cold-store spill to disk
under a shared memory budget.  Replaces
``repro_torch.stream.MultiSessionServer`` (kept as a deprecated shim).

    from repro_torch.serve import ServeTier, loadgen

    tier = ServeTier(max_batch_tenants=128)
    mirrors = loadgen.make_fleet(tier, 1000)          # on cuda
    loadgen.run_rounds(tier, mirrors, rounds=3)
"""
from repro_torch.serve.admission import AdmissionController
from repro_torch.serve.sched import (BEST_EFFORT, LATENCY, THROUGHPUT,
                                     SLOClass, deadline_slack,
                                     order_by_priority)
from repro_torch.serve.spill import SpillManager
from repro_torch.serve.tier import ServeTier, TenantHandle

__all__ = [
    "AdmissionController",
    "BEST_EFFORT",
    "LATENCY",
    "THROUGHPUT",
    "SLOClass",
    "SpillManager",
    "ServeTier",
    "TenantHandle",
    "deadline_slack",
    "order_by_priority",
]
