"""Session: the supported way to drive the port's engine.

Counterpart of ``repro.api.session.Session`` for one-step jobs: a
:class:`JobSpec` is declared once with one :class:`RunConfig`, then
``run(data)`` executes the full job and ``update(delta)`` refreshes it
through the fine-grain MRBGraph merge (§3.3) or the accumulator fast path
(§3.5).  Data and deltas may be given on the host; the session moves them
to ``config.device`` (``cuda`` unless the caller asks for the CPU).

Iterative jobs (``IterSpec``) come with slice 2 and delta queries
(``QuerySpec``) with slice 4; both raise ``NotImplementedError`` here.
"""
from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.api.config import RunConfig
from repro_torch.api.report import RunReport
from repro_torch.core.accumulator import AccumulatorJob
from repro_torch.core.engine import JobSpec, run_onestep
from repro_torch.core.incremental import (
    DeltaKV, ResultView, _v2_dict, incremental_onestep, pad_delta,
)
from repro_torch.core.kvstore import KV, edges_to_host, next_bucket
from repro_torch.core.mrbg_store import MRBGStore
from repro_torch.tree import tree_map

_LATER_SLICES = {"IterSpec": "slice 2 (iterative jobs)",
                 "QuerySpec": "slice 4 (delta queries)"}


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
            path = config.onestep_path
            if path == "auto":
                path = ("accumulator" if spec.reducer.invertible else "mrbg")
            return (_OneStepAccumulator(spec, config)
                    if path == "accumulator" else _OneStepMRBG(spec, config))
        later = _LATER_SLICES.get(type(spec).__name__)
        if later is not None:
            raise NotImplementedError(
                f"{type(spec).__name__} is not ported yet: it comes with "
                f"{later}")
        raise TypeError(f"spec must be a JobSpec, got {type(spec).__name__}")

    # -- lifecycle ---------------------------------------------------------
    def run(self, data: KV) -> RunReport:
        """Initial job: the full one-step run."""
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
        # shapes (and therefore results) follow the same ladder
        cap = next_bucket(delta.capacity, self.config.delta_bucket_min)
        if cap != delta.capacity:
            delta = pad_delta(delta, cap)
        self._driver.update(_to(delta, self.device))
        self.epoch += 1
        return self._finish(t0)

    def _finish(self, t0: float) -> RunReport:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        rep = self.report(include_result=False)
        rep.seconds = time.perf_counter() - t0
        self._last = rep
        self.history.append(rep)
        if len(self.history) > self.config.report_history:
            del self.history[:-self.config.report_history]
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

    # -- preserved state (read-only use) -----------------------------------
    @property
    def view(self) -> Optional[ResultView]:
        return getattr(self._driver, "view", None)

    @property
    def store(self) -> Optional[MRBGStore]:
        """The driver's MRBG-Store, if this path preserves one."""
        return getattr(self._driver, "store", None)


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
