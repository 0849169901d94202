"""RunReport: the one result/telemetry surface of a Session epoch.

Counterpart of ``repro.api.report``; ``device`` replaces ``backend``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core.incr_iter import IterationLog
from repro_torch.core.mrbg_store import IOStats

# engine paths a report can come from
MODES = (
    "onestep",            # full one-step run (JobSpec)
    "incremental",        # fine-grain one-step refresh (§3.3)
    "accumulator",        # accumulator-Reduce refresh (§3.5)
    "iterative",          # full prime-loop convergence (iterMR, §4)
    "plainMR",            # plain-shuffle cost-model baseline (Algorithm 5)
    "i2",                 # incremental iterative refresh (§5)
    "iterMR-fallback",    # auto MRBG-off recomputation (§5.2)
    "distributed",        # sharded prime loop / one-step run (§4.3)
    "distributed-incr",   # per-shard delta refresh, one-step (§3.3 on mesh)
    "distributed-i2",     # per-shard delta refresh, iterative CPC (§5 on mesh)
    "distributed-warm",   # mirror re-partition + warm re-converge fallback
    "query",              # full evaluation of a compiled delta query (dql)
    "query-incremental",  # per-stage preserved-state query refresh (dql)
)


@dataclass
class ShuffleStats:
    """Exchange telemetry of one epoch, uniform across modes.

    Single-device paths report zeros; meshed paths fill in the all_to_all
    traffic between shards.  ``exchange_seconds`` is the wall-clock of each
    exchange-bearing step (host-observed, to its first sync, so it
    includes the step's Map, sorts and, in the converge loop, Reduce).
    """

    edges_exchanged: int = 0       # valid edges through all_to_all this epoch
    bytes_moved: int = 0           # edges * per-edge record bytes
    dropped: int = 0               # edges lost to shuffle_cap (0 post-regrow)
    exchange_seconds: List[float] = field(default_factory=list)
    shuffle_cap: int = 0           # per (src, dst) capacity actually used
    regrows: int = 0               # times the cap auto-regrew this epoch


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
        if self.shuffle.edges_exchanged or self.shuffle.dropped:
            parts.append(f"shuffle={self.shuffle.edges_exchanged}e/"
                         f"{self.shuffle.bytes_moved}B"
                         + (f" dropped={self.shuffle.dropped}"
                            if self.shuffle.dropped else ""))
        return " ".join(parts)
