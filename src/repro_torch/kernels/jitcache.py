"""Build and load telemetry of the kernel libraries.

Counterpart of ``repro.kernels.jitcache``, with the same counters and
meanings.  On the TPU the latency tail of a streaming refresh is trace and
compile time; in the port it is the build of the kernel libraries
(``_build``): ``nvcc`` for each source not yet built, then one load of each
library a process uses.  So here

  * a *trace* is the load of one kernel library into the process
    (``count_trace("build:<name>")`` from ``_build.library``): the first
    use of a kernel in a process, nvcc or not;
  * a *compile* is one ``nvcc`` run (``count_compile`` from
    ``_build.build_all``), with its wall seconds.  The build directory,
    keyed by the sources' digest, persists across processes, so a loaded
    library whose file was already built traces but does not compile, as a
    persistent-cache hit does in the reference.

:func:`generation` moves on every trace; a caller brackets a region with
it ("did this refresh build or load a kernel?").  The stream scheduler
uses it to leave compile-tainted cost observations out.  Steady state
moves nothing.  The reference's persistent executable cache
(``enable_persistent_cache``) has no counterpart: the build directory is
that cache already.
"""
from __future__ import annotations

import collections
import threading
from typing import Dict

_lock = threading.Lock()
_traces: collections.Counter = collections.Counter()
_generation = 0
_compiles = 0
_compile_seconds = 0.0


def count_trace(name: str) -> None:
    """Record one trace: here, the load of one kernel library."""
    global _generation
    with _lock:
        _traces[name] += 1
        _generation += 1


def count_compile(n: int, seconds: float) -> None:
    """Record ``n`` nvcc builds that took ``seconds`` of wall time."""
    global _compiles, _compile_seconds
    with _lock:
        _compiles += n
        _compile_seconds += seconds


def generation() -> int:
    """Monotonic counter bumped on every trace (bracket refreshes with it)."""
    return _generation


def trace_counts() -> Dict[str, int]:
    """Traces by name since process start."""
    with _lock:
        return dict(_traces)


def traces_total() -> int:
    with _lock:
        return sum(_traces.values())


def compiles_total() -> int:
    """nvcc builds since process start."""
    return _compiles


def compile_seconds_total() -> float:
    return _compile_seconds


def snapshot() -> Dict[str, float]:
    """One consistent view of all counters (for benchmarks/metrics)."""
    with _lock:
        return {"traces": sum(_traces.values()),
                "compiles": _compiles,
                "compile_seconds": _compile_seconds}
