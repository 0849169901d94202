"""Delta sources: where continuously-arriving updates enter the system.

A copy of ``repro.stream.source`` (the port imports nothing of the
reference), with the same names and behaviour.

A :class:`DeltaRecord` is one timestamped group of signed delta rows — the
paper's ΔD in motion, stamped with the producer's epoch watermark.  A
:class:`DeltaSource` emits them in arrival order; the StreamSession polls,
micro-batches, coalesces and refreshes.

Three sources cover the serving spectrum:

  * :class:`QueueSource`     — in-memory bounded queue (push-based
    producers; backpressure via blocking ``push``).
  * :class:`FileTailSource`  — replayable JSONL tail, the stand-in for a
    durable log (Kafka topic / HDFS append file): each line is one record,
    re-reads resume from the current offset, ``rewind()`` replays.
  * :class:`SyntheticSource` — wraps :class:`repro_torch.data.DeltaStream` to
    generate an evolving dataset for examples/benchmarks.
"""
from __future__ import annotations

import json
import queue as queue_mod
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np


@dataclass(frozen=True)
class DeltaRecord:
    """One group of signed delta rows ('-' old row then '+' new row for an
    update, exactly the paper's §3.1 encoding)."""

    record_ids: np.ndarray               # [N] int32
    values: Dict[str, np.ndarray]        # name -> [N, ...]
    sign: np.ndarray                     # [N] int8 (+1 insert / -1 delete)
    timestamp: float = 0.0               # producer wall-clock (seconds)
    epoch: int = 0                       # producer watermark

    def __post_init__(self):
        object.__setattr__(self, "record_ids",
                           np.asarray(self.record_ids, np.int32))
        object.__setattr__(self, "sign", np.asarray(self.sign, np.int8))
        object.__setattr__(self, "values",
                           {n: np.asarray(a) for n, a in self.values.items()})
        n = self.record_ids.shape[0]
        if self.sign.shape[0] != n or any(
                a.shape[0] != n for a in self.values.values()):
            raise ValueError("record_ids, sign and every values leaf must "
                             "share the leading row dimension")

    @property
    def n_rows(self) -> int:
        return int(self.record_ids.shape[0])


class DeltaSource:
    """Pull interface of the ingestion layer."""

    def poll(self, max_rows: int) -> List[DeltaRecord]:
        """Return available records (possibly []) without blocking.  May
        return slightly more than ``max_rows`` rows: records are atomic."""
        raise NotImplementedError

    @property
    def exhausted(self) -> bool:
        """True once no further record will ever be emitted."""
        raise NotImplementedError

    @property
    def watermark(self) -> int:
        """Highest epoch fully emitted so far (-1 before the first)."""
        raise NotImplementedError

    def close(self) -> None:
        pass


class QueueSource(DeltaSource):
    """Bounded in-memory queue: ``push`` blocks when full (backpressure to
    the producer), ``seal()`` marks the end of the stream."""

    def __init__(self, capacity: int = 1024):
        self._q: queue_mod.Queue = queue_mod.Queue(maxsize=capacity)
        self._sealed = False
        self._watermark = -1

    def push(self, record: DeltaRecord, timeout: Optional[float] = None):
        if self._sealed:
            raise RuntimeError("push() on a sealed QueueSource")
        self._q.put(record, block=True, timeout=timeout)

    def seal(self) -> None:
        self._sealed = True

    def poll(self, max_rows: int) -> List[DeltaRecord]:
        out: List[DeltaRecord] = []
        rows = 0
        while rows < max_rows:
            try:
                rec = self._q.get_nowait()
            except queue_mod.Empty:
                break
            out.append(rec)
            rows += rec.n_rows
            self._watermark = max(self._watermark, rec.epoch)
        return out

    @property
    def exhausted(self) -> bool:
        return self._sealed and self._q.empty()

    @property
    def watermark(self) -> int:
        return self._watermark


class FileTailSource(DeltaSource):
    """Replayable JSONL tail.

    Each line encodes one :class:`DeltaRecord`:

        {"epoch": 3, "ts": 1700000000.0, "record_ids": [5, 5],
         "sign": [-1, 1], "values": {"nbrs": [[...], [...]]}}

    ``poll`` consumes complete lines past the current offset, so a file
    being appended by another process is tailed incrementally;
    ``follow=False`` treats end-of-file as end-of-stream.  ``rewind()``
    replays from the beginning — the recovery story for a lost serving
    node is "restore the snapshot, rewind the log to the snapshot's
    watermark, drain".
    """

    def __init__(self, path: str, dtypes: Optional[Dict[str, str]] = None,
                 follow: bool = False):
        self.path = path
        self.dtypes = dtypes or {}
        self.follow = follow
        self._offset = 0
        self._watermark = -1
        self._skip_through = -1
        self._eof_seen = False

    def rewind(self, epoch: int = -1) -> None:
        """Replay records with epoch > ``epoch`` (default: everything)."""
        self._offset = 0
        self._watermark = -1
        self._skip_through = epoch
        self._eof_seen = False

    def _parse(self, line: str) -> Optional[DeltaRecord]:
        obj = json.loads(line)
        values = {n: np.asarray(a, dtype=self.dtypes.get(n))
                  for n, a in obj["values"].items()}
        return DeltaRecord(record_ids=obj["record_ids"], values=values,
                           sign=obj["sign"], timestamp=obj.get("ts", 0.0),
                           epoch=obj.get("epoch", 0))

    def poll(self, max_rows: int) -> List[DeltaRecord]:
        out: List[DeltaRecord] = []
        rows = 0
        try:
            with open(self.path, "r") as f:
                f.seek(self._offset)
                while rows < max_rows:
                    pos = f.tell()
                    line = f.readline()
                    if not line.endswith("\n"):   # incomplete tail / EOF
                        self._offset = pos
                        self._eof_seen = True
                        break
                    self._offset = f.tell()
                    if not line.strip():
                        continue
                    rec = self._parse(line)
                    if rec.epoch <= self._skip_through:
                        continue      # before the rewind cursor: replayed
                    out.append(rec)
                    rows += rec.n_rows
                    self._watermark = max(self._watermark, rec.epoch)
        except FileNotFoundError:
            self._eof_seen = True
        return out

    @property
    def exhausted(self) -> bool:
        return self._eof_seen and not self.follow

    @property
    def watermark(self) -> int:
        return self._watermark

    @staticmethod
    def write(path: str, records: Sequence[DeltaRecord],
              append: bool = True) -> None:
        """Append records to the log (the producer side, and the test rig)."""
        with open(path, "a" if append else "w") as f:
            for r in records:
                f.write(json.dumps(
                    {"epoch": r.epoch, "ts": r.timestamp,
                     "record_ids": np.asarray(r.record_ids).tolist(),
                     "sign": np.asarray(r.sign).tolist(),
                     "values": {n: np.asarray(a).tolist()
                                for n, a in r.values.items()}}) + "\n")


class SyntheticSource(DeltaSource):
    """Evolving-dataset generator: one DeltaRecord per epoch, ``epochs``
    total, produced by a :class:`repro_torch.data.DeltaStream` mutator.  The
    mutated host mirror stays readable as ``self.values`` — the oracle
    input for end-to-end checks."""

    def __init__(self, values: Dict[str, np.ndarray], frac: float = 0.05,
                 seed: int = 0, epochs: int = 10,
                 mutator: Optional[Callable] = None):
        from repro_torch.data import DeltaStream
        self.stream = DeltaStream(values, frac=frac, seed=seed,
                                  mutator=mutator)
        self.epochs = epochs
        self._emitted = 0

    @property
    def values(self) -> Dict[str, np.ndarray]:
        """The fully-updated dataset mirror (advances as polls consume)."""
        return self.stream.values

    def poll(self, max_rows: int) -> List[DeltaRecord]:
        out: List[DeltaRecord] = []
        rows = 0
        while self._emitted < self.epochs and rows < max_rows:
            rid, vals, sign = self.stream.delta()
            rec = DeltaRecord(record_ids=rid, values=vals, sign=sign,
                              timestamp=time.time(), epoch=self._emitted)
            out.append(rec)
            rows += rec.n_rows
            self._emitted += 1
        return out

    @property
    def exhausted(self) -> bool:
        return self._emitted >= self.epochs

    @property
    def watermark(self) -> int:
        return self._emitted - 1
