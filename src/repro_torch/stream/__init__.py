"""repro_torch.stream — continuous ingestion over ``repro_torch.api``.

Counterpart of ``repro.stream``, with the same modules and names:

  * :mod:`repro_torch.stream.source`    — ``DeltaSource``: timestamped
    signed delta records with epoch watermarks (in-memory queue,
    replayable JSONL tail, synthetic generator).
  * :mod:`repro_torch.stream.coalesce`  — micro-batch coalescer: cancels
    opposing +/- rows per record before the engine sees them, on the sort
    and segment-sum kernels.
  * :mod:`repro_torch.stream.scheduler` — incremental ``update()`` or full
    ``rerun()`` per micro-batch (the paper's Fig. 8 crossover, online).
  * :mod:`repro_torch.stream.session`   — ``StreamSession``: async driver
    with a bounded ingest queue (backpressure), ``drain``/``stop``/
    ``snapshot``.
  * :mod:`repro_torch.stream.server`    — ``MultiSessionServer``: a
    deprecated shim over :class:`repro_torch.serve.ServeTier`.
  * :mod:`repro_torch.stream.metrics`   — counters, sustained updates/sec,
    refresh-latency percentiles.

    from repro_torch.stream import StreamSession
    from repro_torch.apps import wordcount as wc

    spec, data, source = wc.make_stream(docs, vocab, frac=0.02, epochs=10)
    with StreamSession(spec, data, source=source) as ss:   # on cuda
        ss.drain()
    ss.result["c"]                       # == cold run on the final input
"""
from repro_torch.api.config import STREAM_POLICIES, StreamConfig
from repro_torch.stream.coalesce import CoalesceResult, coalesce, coalesce_rows
from repro_torch.stream.metrics import StreamMetrics
from repro_torch.stream.scheduler import RefreshDecision, RefreshScheduler
from repro_torch.stream.session import PreparedBatch, StreamSession
from repro_torch.stream.source import (
    DeltaRecord, DeltaSource, FileTailSource, QueueSource, SyntheticSource,
)

__all__ = [
    "StreamConfig", "STREAM_POLICIES",
    "DeltaRecord", "DeltaSource", "QueueSource", "FileTailSource",
    "SyntheticSource",
    "CoalesceResult", "coalesce", "coalesce_rows",
    "RefreshScheduler", "RefreshDecision",
    "StreamSession", "PreparedBatch", "MultiSessionServer",
    "StreamMetrics",
]


def __getattr__(name):
    # lazy: repro_torch.stream.server shims onto repro_torch.serve, which
    # itself imports repro_torch.stream.session — a cycle at package init
    if name == "MultiSessionServer":
        from repro_torch.stream.server import MultiSessionServer
        return MultiSessionServer
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
