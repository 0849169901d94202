"""MultiSessionServer — deprecated shim over the serving tier.

Counterpart of ``repro.stream.server``.  The round-robin multi-tenant
server grew into a real serving tier with SLO classes, admission
control, batched cross-tenant refresh, and cold-store spill; that code
lives in :mod:`repro_torch.serve`.  This class keeps the old name and
behavior (plain FIFO sweeps, per-tenant refresh, no spill) so existing
callers migrate on their own schedule:

    server = MultiSessionServer(...)                # before
    tier = repro_torch.serve.ServeTier(...)         # after (slo=, group=)
"""
from __future__ import annotations

import warnings
from typing import Optional

from repro_torch.serve.tier import ServeTier


class MultiSessionServer(ServeTier):
    """Deprecated: use :class:`repro_torch.serve.ServeTier`."""

    def __init__(self, store_budget_bytes: Optional[int] = None,
                 poll_interval: float = 0.002):
        warnings.warn(
            "MultiSessionServer is deprecated; use "
            "repro_torch.serve.ServeTier (adds SLO classes, admission "
            "control, batched cross-tenant refresh, and cold-store spill)",
            DeprecationWarning, stacklevel=2)
        super().__init__(store_budget_bytes=store_budget_bytes,
                         poll_interval=poll_interval,
                         batch_refresh=False)
