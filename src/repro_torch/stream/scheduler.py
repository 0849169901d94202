"""Refresh scheduling: incremental ``update()`` vs full ``rerun()``.

A copy of ``repro.stream.scheduler`` (the port imports nothing of the
reference), with the same names and behaviour.

The paper's Fig. 8 shows the crossover offline: fine-grain incremental
refresh wins while |Δ|/|D| is small and loses to plain recomputation once
the delta grows past a workload-dependent ratio.  A serving layer has to
take that decision *online*, per micro-batch.  Three policies:

  * ``paper``      — the static crossover: rerun iff the delta-to-state
    ratio exceeds ``StreamConfig.crossover``.  Deterministic and
    reproduces the paper's offline choice; the baseline the other two are
    judged against.
  * ``latency``    — minimize this batch's wall-clock: EWMA cost models of
    both paths (seconds-per-delta-row for update, seconds-per-rerun from
    the Session's RunReport history) are compared and the cheaper path
    taken; until both paths have been observed the crossover prior
    decides.
  * ``throughput`` — like ``latency``, but additionally forces a rerun
    when the MRBG file has bloated past ``store_bloat`` x live bytes:
    a rerun rebuilds the store from scratch (free compaction), trading one
    slow batch for sustained refresh speed.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

from repro_torch.api.config import StreamConfig

ACTIONS = ("update", "rerun")


@dataclass(frozen=True)
class RefreshDecision:
    action: str                  # "update" | "rerun"
    reason: str                  # human-readable justification
    delta_ratio: float           # |Δ| rows / |D| live records
    est_update: Optional[float]  # predicted seconds (None: no model yet)
    est_rerun: Optional[float]


class RefreshScheduler:
    """Online cost-model refresh policy for one session."""

    MAX_DECISIONS = 256          # kept decision tail (counters are exact)

    def __init__(self, config: Optional[StreamConfig] = None):
        self.config = config or StreamConfig()
        self._sec_per_delta_row: Optional[float] = None   # EWMA, update path
        self._sec_per_rerun: Optional[float] = None       # EWMA, rerun path
        self.decisions: List[RefreshDecision] = []        # bounded tail
        self.action_counts = {a: 0 for a in ACTIONS}
        self.compile_skips = 0       # observations excluded (compile-tainted)

    # -- cost model --------------------------------------------------------
    def _ewma(self, old: Optional[float], new: float) -> float:
        a = self.config.cost_ema
        return new if old is None else (1 - a) * old + a * new

    def seed(self, initial_run_seconds: float) -> None:
        """The initial ``run()`` is the first observation of rerun cost."""
        self._sec_per_rerun = self._ewma(self._sec_per_rerun,
                                         initial_run_seconds)

    def observe(self, action: str, n_delta_rows: int,
                seconds: float, *, compiled: bool = False) -> None:
        """Fold one measured refresh into the model.

        ``compiled=True`` marks an observation whose wall-clock includes
        a kernel build or load (``repro_torch.kernels.jitcache``).  Folding
        such a one-off into the EWMA would make the touched path look orders
        of magnitude slower than its steady state and skew update-vs-rerun
        decisions for many batches; it is excluded instead (counted in
        ``compile_skips``).
        """
        if compiled:
            self.compile_skips += 1
            return
        if action == "rerun":
            self._sec_per_rerun = self._ewma(self._sec_per_rerun, seconds)
        elif n_delta_rows > 0:
            self._sec_per_delta_row = self._ewma(
                self._sec_per_delta_row, seconds / n_delta_rows)

    def estimates(self, n_delta_rows: int):
        est_u = (None if self._sec_per_delta_row is None
                 else self._sec_per_delta_row * n_delta_rows)
        return est_u, self._sec_per_rerun

    # -- the decision ------------------------------------------------------
    def decide(self, n_delta_rows: int, state_rows: int,
               store_file_bytes: int = 0,
               store_live_bytes: int = 0) -> RefreshDecision:
        cfg = self.config
        ratio = n_delta_rows / max(state_rows, 1)
        est_u, est_r = self.estimates(n_delta_rows)

        def done(action, reason):
            d = RefreshDecision(action, reason, ratio, est_u, est_r)
            self.decisions.append(d)
            if len(self.decisions) > self.MAX_DECISIONS:
                del self.decisions[:-self.MAX_DECISIONS]
            self.action_counts[action] += 1
            return d

        if cfg.policy == "paper":
            if ratio >= cfg.crossover:
                return done("rerun", f"delta ratio {ratio:.3f} >= "
                                     f"crossover {cfg.crossover} (Fig. 8)")
            return done("update", f"delta ratio {ratio:.3f} < "
                                  f"crossover {cfg.crossover}")

        if cfg.policy == "throughput" and store_live_bytes > 0 and \
                store_file_bytes > cfg.store_bloat * store_live_bytes:
            return done("rerun",
                        f"store bloat {store_file_bytes}B > "
                        f"{cfg.store_bloat:g}x live {store_live_bytes}B "
                        f"(rerun rebuilds the MRBG file)")

        # latency (and throughput when not bloated): cheapest predicted path
        if est_u is not None and est_r is not None:
            if est_u <= est_r:
                return done("update", f"predicted {est_u * 1e3:.2f}ms <= "
                                      f"rerun {est_r * 1e3:.2f}ms")
            return done("rerun", f"predicted update {est_u * 1e3:.2f}ms > "
                                 f"rerun {est_r * 1e3:.2f}ms")
        # cold model: fall back to the crossover prior
        if ratio >= cfg.crossover:
            return done("rerun", f"cold cost model; delta ratio "
                                 f"{ratio:.3f} >= crossover prior")
        return done("update", f"cold cost model; delta ratio {ratio:.3f} "
                              f"< crossover prior")
