"""RunConfig: the engine's knobs, declared once.

Counterpart of ``repro.api.config.RunConfig`` for the paths the port runs
so far (one-step MRBG and accumulator, iterative and incremental
iterative), with the reference's names and defaults.  ``device`` takes the
place of the reference's ``backend``: ``"cuda"`` (the default) runs the
hand-written kernels and raises when there is no card; ``"cpu"`` runs
their plain versions.  Nothing else selects the plain versions.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Optional

import torch

from repro_torch.core.mrbg_store import (
    DEFAULT_CACHE, DEFAULT_FIX_WINDOW, DEFAULT_GAP_T, POLICIES,
)

ONESTEP_PATHS = ("auto", "mrbg", "accumulator")
DEVICES = ("cuda", "cpu")


@dataclass(frozen=True)
class RunConfig:
    # -- where the engine runs: 'cuda' (kernels) or 'cpu' (plain versions)
    device: str = "cuda"

    # -- one-step path: 'mrbg' preserves the fine-grain MRBGraph (§3.3),
    #    'accumulator' keeps only <K3,V3> (§3.5), 'auto' picks the
    #    accumulator when the reducer is an abelian group
    onestep_path: str = "auto"

    # -- MRBG-Store (§3.4 / §5.2)
    value_bytes: int = 8
    store_policy: str = "multi-dynamic-window"
    gap_threshold: int = DEFAULT_GAP_T
    cache_bytes: int = DEFAULT_CACHE
    fix_window_bytes: int = DEFAULT_FIX_WINDOW

    # -- convergence control (iterative specs)
    max_iters: int = 100
    tol: float = 1e-4
    refresh_max_iters: Optional[int] = None      # None -> max_iters
    refresh_tol: Optional[float] = None          # None -> tol

    # -- incremental iterative (§5.3 / §5.2)
    cpc_threshold: float = 0.0
    pdelta_threshold: float = 0.5

    # -- plainMR cost modeling (Algorithm 5 baseline): re-shuffle the
    #    structure data every iteration instead of keeping the loop warm
    plain_shuffle: bool = False

    # -- distributed execution comes with a later slice
    mesh: Optional[Any] = None

    # -- telemetry: RunReports kept on Session.history
    report_history: int = 64

    # -- deltas entering Session.update() are padded up to the next
    #    power-of-two bucket (>= delta_bucket_min rows), as the reference
    delta_bucket_min: int = 64

    def __post_init__(self):
        if self.device not in DEVICES:
            raise ValueError(f"device must be one of {DEVICES}, "
                             f"got {self.device!r}")
        if self.onestep_path not in ONESTEP_PATHS:
            raise ValueError(
                f"onestep_path must be one of {ONESTEP_PATHS}, "
                f"got {self.onestep_path!r}")
        if self.store_policy not in POLICIES:
            raise ValueError(
                f"store_policy must be one of {POLICIES}, "
                f"got {self.store_policy!r}")
        if self.mesh is not None:
            raise NotImplementedError(
                "RunConfig(mesh=...) is not ported yet: distributed "
                "execution comes with slice 3")
        if self.report_history < 1:
            raise ValueError("report_history must be >= 1")
        if self.delta_bucket_min < 1:
            raise ValueError("delta_bucket_min must be >= 1")

    def replace(self, **kw) -> "RunConfig":
        return dataclasses.replace(self, **kw)

    @property
    def refresh_iters_(self) -> int:
        return self.max_iters if self.refresh_max_iters is None \
            else self.refresh_max_iters

    @property
    def refresh_tol_(self) -> float:
        return self.tol if self.refresh_tol is None else self.refresh_tol

    def store_kw(self) -> dict:
        """MRBG-Store constructor knobs beyond (num_keys, value_bytes)."""
        return {"gap_threshold": self.gap_threshold,
                "cache_bytes": self.cache_bytes,
                "fix_window_bytes": self.fix_window_bytes}

    def torch_device(self) -> torch.device:
        """The device to run on; raises when CUDA is asked for and absent."""
        if self.device == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "RunConfig(device='cuda') but torch.cuda.is_available() is "
                "False; pass RunConfig(device='cpu') to run the plain "
                "versions on the CPU")
        return torch.device(self.device)
