"""repro_torch.api — drive the port's engine, as ``repro.api`` drives JAX's.

    from repro_torch.api import Session, RunConfig, make_delta
    from repro_torch.apps import wordcount as wc

    spec, data = wc.make_job(docs, vocab=60)
    session = Session(spec, RunConfig())         # device='cuda' by default
    session.run(data)
    session.update(make_delta(rid, vals, sign))
    session.result

``RunConfig(device="cpu")`` runs the kernels' plain versions on the CPU.
``RunConfig(mesh=MeshConfig(LocalMesh({"data": 8})))`` runs the same spec
on 8 logical shards of the device; ``MeshConfig(RankMesh(...))``, one
process a shard (``repro_torch.launch.ranks``).
"""
from repro_torch.api.config import (
    STREAM_POLICIES, MeshConfig, RunConfig, StreamConfig,
)
from repro_torch.api.report import MODES, RunReport, ShuffleStats
from repro_torch.api.session import Session

# the declaration vocabulary, re-exported so callers need only this module
from repro_torch.core.distributed import LocalMesh, RankMesh
from repro_torch.core.engine import JobSpec, emit_multi, emit_single
from repro_torch.core.incremental import DeltaKV, make_delta
from repro_torch.core.iterative import IterSpec, State, default_difference
from repro_torch.core.kvstore import (
    KV, Edges, Reducer, make_edges, make_kv, max_reducer, mean_reducer,
    min_reducer, sum_reducer,
)

__all__ = [
    "Session", "RunConfig", "MeshConfig", "LocalMesh", "RankMesh",
    "StreamConfig",
    "STREAM_POLICIES",
    "RunReport", "ShuffleStats", "MODES",
    "JobSpec", "IterSpec", "State", "default_difference",
    "DeltaKV", "make_delta",
    "KV", "Edges", "Reducer", "make_kv", "make_edges",
    "sum_reducer", "min_reducer", "max_reducer", "mean_reducer",
    "emit_single", "emit_multi",
]
