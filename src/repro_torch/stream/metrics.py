"""Per-tenant streaming telemetry: throughput, latency percentiles, modes.

A copy of ``repro.stream.metrics`` (the port imports nothing of the
reference), with the same names and behaviour.

Latency is measured end-to-end per micro-batch: from the earliest buffered
row's enqueue timestamp to the moment the refreshed result is visible.
Sustained updates/sec counts delta rows entering the coalescer (the
tenant-facing unit of work), not engine rows.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional


class StreamMetrics:
    """Thread-safe counters + a bounded latency reservoir."""

    def __init__(self, max_samples: int = 4096):
        self._lock = threading.Lock()
        self.max_samples = max_samples
        self.t_start = time.perf_counter()
        self.busy_seconds = 0.0          # time spent inside refreshes
        self.rows_in = 0                 # delta rows ingested
        self.rows_engine = 0             # rows surviving the coalescer
        self.rows_cancelled = 0          # rows the coalescer cancelled
        self.net_inserts = 0             # records whose net effect inserted
        self.net_deletes = 0             # records whose net effect deleted
        self.rows_rejected = 0           # rows refused at ingest (bad ids)
        self.retrace_batches = 0         # batches that traced a jit kernel
        self.batches = 0
        self.refreshes: Dict[str, int] = {}   # action -> count
        self.compactions = 0
        self.bytes_reclaimed = 0
        self.last_epoch = -1             # highest source watermark applied
        self._latencies: List[float] = []     # end-to-end batch latency (s)
        self._refresh_seconds: List[float] = []

    # -- recording ---------------------------------------------------------
    def observe_batch(self, n_in: int, n_engine: int, action: str,
                      latency_s: float, refresh_s: float,
                      epoch: int = -1, retraced: bool = False,
                      n_cancelled: int = 0, n_inserts: int = 0,
                      n_deletes: int = 0) -> None:
        with self._lock:
            self.rows_in += n_in
            self.rows_engine += n_engine
            self.rows_cancelled += n_cancelled
            self.net_inserts += n_inserts
            self.net_deletes += n_deletes
            self.batches += 1
            self.retrace_batches += int(retraced)
            self.refreshes[action] = self.refreshes.get(action, 0) + 1
            self.busy_seconds += refresh_s
            self.last_epoch = max(self.last_epoch, epoch)
            for buf, v in ((self._latencies, latency_s),
                           (self._refresh_seconds, refresh_s)):
                buf.append(v)
                if len(buf) > self.max_samples:
                    del buf[:len(buf) - self.max_samples]

    def observe_compaction(self, bytes_reclaimed: int) -> None:
        with self._lock:
            self.compactions += 1
            self.bytes_reclaimed += bytes_reclaimed

    def observe_rejected(self, n_rows: int) -> None:
        """Rows refused at ingest validation (e.g. out-of-range ids)."""
        with self._lock:
            self.rows_rejected += n_rows

    # -- reading -----------------------------------------------------------
    @staticmethod
    def _pct(samples: List[float], p: float) -> float:
        if not samples:
            return 0.0
        s = sorted(samples)
        idx = min(len(s) - 1, max(0, int(round(p / 100.0 * (len(s) - 1)))))
        return s[idx]

    def latency_pct(self, p: float) -> float:
        with self._lock:
            return self._pct(self._latencies, p)

    def refresh_pct(self, p: float) -> float:
        with self._lock:
            return self._pct(self._refresh_seconds, p)

    def updates_per_sec(self) -> float:
        """Sustained ingested rows per second of refresh busy-time."""
        with self._lock:
            return self.rows_in / self.busy_seconds \
                if self.busy_seconds > 0 else 0.0

    def snapshot(self) -> Dict[str, object]:
        with self._lock:
            lat, ref = list(self._latencies), list(self._refresh_seconds)
            out = {
                "rows_in": self.rows_in,
                "rows_engine": self.rows_engine,
                "coalesce_savings": 1.0 - (self.rows_engine /
                                           max(self.rows_in, 1)),
                "rows_cancelled": self.rows_cancelled,
                "net_inserts": self.net_inserts,
                "net_deletes": self.net_deletes,
                "rows_rejected": self.rows_rejected,
                "batches": self.batches,
                "retrace_batches": self.retrace_batches,
                "refreshes": dict(self.refreshes),
                "busy_seconds": self.busy_seconds,
                "updates_per_sec": self.rows_in / self.busy_seconds
                if self.busy_seconds > 0 else 0.0,
                "compactions": self.compactions,
                "bytes_reclaimed": self.bytes_reclaimed,
                "last_epoch": self.last_epoch,
            }
        for name, buf in (("latency", lat), ("refresh", ref)):
            out[f"{name}_p50_ms"] = self._pct(buf, 50) * 1e3
            out[f"{name}_p95_ms"] = self._pct(buf, 95) * 1e3
        return out
