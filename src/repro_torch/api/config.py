"""RunConfig: the engine's knobs, declared once.

Counterpart of ``repro.api.config``, with the reference's names and
defaults: :class:`MeshConfig` (distributed execution over the logical
shards of a ``repro_torch.core.distributed.LocalMesh``, or one process a
shard on a ``RankMesh``), :class:`RunConfig`
and the streaming layer's :class:`StreamConfig`.  ``device`` takes the
place of the reference's ``backend``: ``"cuda"`` (the default) runs the
hand-written kernels and raises when there is no card; ``"cpu"`` runs
their plain versions.  Nothing else selects the plain versions.  The
reference's ``compilation_cache_dir`` has no counterpart: the kernels'
build directory, keyed by the sources' digest, already persists across
processes.
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
REFRESH_MODES = ("fine", "warm")


@dataclass(frozen=True)
class MeshConfig:
    """Validated distributed-execution knobs (§4.3), one object per mesh.

    ``RunConfig(mesh=MeshConfig(LocalMesh({"data": 8}), ...))`` runs the
    job as 8 logical shards, all on ``RunConfig.device``;
    ``MeshConfig(RankMesh({"data": 8}, device=..., backend=...))`` as 8
    ranks, each on the mesh's device, whose shards must be every rank.
    """

    # the mesh: a repro_torch.core.distributed.LocalMesh or RankMesh
    mesh: Any

    # partition axis (+ optional pod axis flattened into one exchange axis)
    axis: str = "data"
    pod_axis: Optional[str] = None

    # per (src, dst) shard edge capacity of the converge-loop all_to_all;
    # overflow auto-regrows up the bucket ladder unless auto_grow=False
    shuffle_cap: int = 4096
    auto_grow: bool = True

    # host-side structure-partition row capacity (None -> sized from data)
    partition_cap: Optional[int] = None

    # update() semantics under the mesh:
    #   'fine' -> kv-pair-level delta refresh against per-shard MRBG slices
    #   'warm' -> re-partition the host mirror and warm re-converge (the
    #             Fig. 8 rerun-side baseline)
    refresh: str = "fine"

    # host threads for the fine-grain per-shard MRBG merges (disjoint
    # stores): 0 = auto (min(8, cpus, shards)), 1 = sequential, n = n
    merge_workers: int = 0

    def __post_init__(self):
        from repro_torch.core.distributed import (LocalMesh, RankMesh,
                                                  exchange_axes)
        if not isinstance(self.mesh, (LocalMesh, RankMesh)):
            raise ValueError(f"MeshConfig.mesh must be a LocalMesh or a "
                             f"RankMesh, got {type(self.mesh).__name__}")
        shape = self.mesh.shape
        if self.axis not in shape:
            raise ValueError(f"mesh has no axis {self.axis!r} "
                             f"(axes: {tuple(shape)})")
        if self.pod_axis is not None:
            if self.pod_axis not in shape:
                raise ValueError(f"mesh has no pod axis {self.pod_axis!r} "
                                 f"(axes: {tuple(shape)})")
            if self.pod_axis == self.axis:
                raise ValueError("pod_axis must differ from axis")
        if self.shuffle_cap < 1:
            raise ValueError("shuffle_cap must be >= 1")
        if self.partition_cap is not None and self.partition_cap < 1:
            raise ValueError("partition_cap must be >= 1")
        if self.refresh not in REFRESH_MODES:
            raise ValueError(f"refresh must be one of {REFRESH_MODES}, "
                             f"got {self.refresh!r}")
        if self.merge_workers < 0:
            raise ValueError("merge_workers must be >= 0 (0 = auto)")
        if isinstance(self.mesh, RankMesh):
            axes = exchange_axes(self.axis, self.pod_axis)
            if self.n_parts != self.mesh.world:
                raise ValueError(
                    f"a RankMesh runs one shard a rank: the exchange axes "
                    f"{axes} hold {self.n_parts} shards, the mesh "
                    f"{self.mesh.world} ranks")
            if [a for a in shape if a in axes] != list(axes):
                raise ValueError(f"a RankMesh's pod axis comes before its "
                                 f"data axis (shard = pod * |data| + data "
                                 f"= rank): {tuple(shape)}")

    @property
    def n_parts(self) -> int:
        shape = self.mesh.shape
        return shape[self.axis] * (shape[self.pod_axis]
                                   if self.pod_axis else 1)

    def replace(self, **kw) -> "MeshConfig":
        return dataclasses.replace(self, **kw)


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

    # -- distributed execution: a MeshConfig turns the same spec into the
    #    sharded engine (§4.3); no separate entry point
    mesh: Optional[MeshConfig] = None

    # -- checkpointing (§6): directory + cadence in epochs (0 = manual via
    #    Session.checkpoint only)
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 0

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
        if self.mesh is not None and not isinstance(self.mesh, MeshConfig):
            raise TypeError("RunConfig(mesh=...) takes a MeshConfig: "
                            "RunConfig(mesh=MeshConfig(mesh, axis=..., ...))")
        rank_dev = self._rank_device()
        if rank_dev is not None and rank_dev.type != self.device:
            raise ValueError(f"RunConfig(device={self.device!r}) but the "
                             f"RankMesh's device is {rank_dev}")
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
        """The device to run on (a RankMesh's own, ``cuda:<k>``, when the
        mesh is one); raises when CUDA is asked for and absent."""
        if self.device == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "RunConfig(device='cuda') but torch.cuda.is_available() is "
                "False; pass RunConfig(device='cpu') to run the plain "
                "versions on the CPU")
        rank_dev = self._rank_device()
        return rank_dev if rank_dev is not None else torch.device(self.device)

    def _rank_device(self) -> Optional[torch.device]:
        """A RankMesh's device (None for no mesh or a LocalMesh)."""
        return getattr(getattr(self.mesh, "mesh", None), "device", None)


STREAM_POLICIES = ("latency", "throughput", "paper")


@dataclass(frozen=True)
class StreamConfig:
    """Knobs of the ``repro_torch.stream`` serving layer (one per
    StreamSession), as ``repro.api.config.StreamConfig``.

    Micro-batching trades refresh latency against per-record overhead; the
    scheduler policy decides, per micro-batch, between the fine-grain
    incremental refresh and full re-computation (the paper's Fig. 8
    crossover, applied online).
    """

    # -- micro-batching: a refresh fires when ``max_batch_records`` delta
    #    rows are buffered or ``max_batch_delay`` seconds elapsed since the
    #    first buffered row, whichever comes first
    max_batch_records: int = 4096
    max_batch_delay: float = 0.05

    # -- ingestion: bounded buffer between producers and the refresh
    #    driver; a full buffer blocks submit() (backpressure)
    queue_capacity: int = 64
    poll_interval: float = 0.002       # idle sleep between source polls

    # -- coalescer: merge/cancel opposing +/- rows per record before the
    #    engine sees them (False streams raw rows through)
    coalesce: bool = True

    # -- input-mirror growth: record ids past the seed data's capacity
    #    grow the mirror (and every driver-side record structure) up the
    #    power-of-two ladder; ``grow_records=False`` rejects them at the
    #    seed capacity; ``max_records`` bounds growth (ids at or past it
    #    are rejected at ingest)
    grow_records: bool = True
    max_records: Optional[int] = None

    # -- refresh scheduling
    policy: str = "paper"              # latency | throughput | paper
    crossover: float = 0.25            # |delta|/|D| where full recompute wins
    cost_ema: float = 0.5              # EWMA factor of online cost estimates
    store_bloat: float = 4.0           # throughput: rerun when file/live > x

    # -- pre-warm: push no-op deltas through the delta bucket ladder
    #    (delta_bucket_min up to prewarm_rows, default max_batch_records)
    #    on start(), so the first real micro-batch finds every kernel
    #    built and loaded
    prewarm: bool = False
    prewarm_rows: Optional[int] = None

    def __post_init__(self):
        if self.policy not in STREAM_POLICIES:
            raise ValueError(
                f"policy must be one of {STREAM_POLICIES}, "
                f"got {self.policy!r}")
        if self.queue_capacity < 1 or self.max_batch_records < 1:
            raise ValueError("queue_capacity and max_batch_records must "
                             "be >= 1")
        if self.max_records is not None and self.max_records < 1:
            raise ValueError("max_records must be >= 1 (or None)")

    def replace(self, **kw) -> "StreamConfig":
        return dataclasses.replace(self, **kw)
