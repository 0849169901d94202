"""RunReport: the one result/telemetry surface of a Session epoch.

Counterpart of ``repro.api.report`` for the single-device paths and
delta queries; ``device`` replaces ``backend``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core.incr_iter import IterationLog
from repro_torch.core.mrbg_store import IOStats

# engine paths a report can come from (the single-device paths)
MODES = (
    "onestep",            # full one-step run (JobSpec)
    "incremental",        # fine-grain one-step refresh (§3.3)
    "accumulator",        # accumulator-Reduce refresh (§3.5)
    "iterative",          # full prime-loop convergence (iterMR, §4)
    "plainMR",            # plain-shuffle cost-model baseline (Algorithm 5)
    "i2",                 # incremental iterative refresh (§5)
    "iterMR-fallback",    # auto MRBG-off recomputation (§5.2)
    "query",              # full evaluation of a compiled delta query (dql)
    "query-incremental",  # per-stage preserved-state query refresh (dql)
)


@dataclass
class ShuffleStats:
    """Network-exchange telemetry of one epoch; zeros on one device."""

    edges_exchanged: int = 0
    bytes_moved: int = 0
    dropped: int = 0
    exchange_seconds: List[float] = field(default_factory=list)
    shuffle_cap: int = 0
    regrows: int = 0


@dataclass
class RunReport:
    """Uniform report for one ``run``/``update`` epoch of a Session."""

    name: str                         # spec name
    mode: str                         # one of MODES
    epoch: int                        # 0 = initial run, then +1 per update
    device: str                       # 'cuda' or 'cpu'
    iters: int = 1                    # engine iterations this epoch
    seconds: float = 0.0              # wall-clock of this epoch
    max_change: List[float] = field(default_factory=list)
    logs: List[IterationLog] = field(default_factory=list)
    affected_keys: int = -1           # keys re-reduced by a refresh (-1: n/a)
    counts: Optional[np.ndarray] = None   # per-key in-edge counts
    io: Optional[IOStats] = None      # MRBG-Store reads for this epoch
    store_bytes: int = 0              # MRBG file size (incl. obsolete chunks)
    live_bytes: int = 0               # live chunk bytes
    store_batches: int = 0
    mrbg_on: bool = True
    shuffle: ShuffleStats = field(default_factory=ShuffleStats)
    # coalescer savings for the batch that produced this epoch, attached by
    # the stream layer (None outside streaming): n_in/n_out/n_records/
    # n_inserts/n_deletes/n_cancelled of the CoalesceResult
    coalesce: Optional[Dict[str, int]] = None
    # dense output values; {} when the producer skipped materialization
    result: Dict[str, np.ndarray] = field(default_factory=dict)

    def summary(self) -> str:
        parts = [f"{self.name}[{self.mode}] epoch={self.epoch}",
                 f"iters={self.iters}", f"device={self.device}",
                 f"{self.seconds * 1e3:.1f}ms"]
        if self.affected_keys >= 0:
            parts.append(f"affected={self.affected_keys}")
        if self.max_change:
            parts.append(f"max_change={self.max_change[-1]:.3g}")
        if self.store_bytes:
            parts.append(f"store={self.store_bytes}B "
                         f"(live {self.live_bytes}B)")
        if self.coalesce and self.coalesce.get("n_cancelled"):
            parts.append(f"coalesced=-{self.coalesce['n_cancelled']}rows")
        return " ".join(parts)
