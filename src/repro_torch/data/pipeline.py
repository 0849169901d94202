"""Data pipeline: deterministic token streams for the LM and delta-input
streams for the MapReduce engine.

Counterpart of ``repro.data.pipeline`` (numpy only), copied from it:

  * the LM stack: ``lm_batches`` yields {"inputs","targets","mask"} batches.
    Tokens are generated *hash-deterministically* per (stream, position), so
    any data shard can materialize exactly its slice without coordination —
    a restarted job regenerates byte-identical data from the step counter
    alone.  A file-backed mode memory-maps a token bin for real corpora.

  * the MapReduce engine: ``DeltaStream`` produces the paper's signed delta
    inputs from an evolving dataset (graph edits / new documents per epoch).

Both emit the same bytes as the reference from the same seed.
"""
from __future__ import annotations

import threading
import queue as queue_mod
from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np

_MUL = np.uint64(0x9E3779B97F4A7C15)


def _mix(x: np.ndarray) -> np.ndarray:
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return x ^ (x >> np.uint64(31))


def synthetic_tokens(start: int, count: int, vocab: int,
                     seed: int = 0) -> np.ndarray:
    """Deterministic pseudo-corpus: token[i] = mix(i, seed) % vocab, with
    mild bigram structure so losses are learnable."""
    idx = np.arange(start, start + count, dtype=np.uint64)
    h = _mix(idx * _MUL + np.uint64(seed))
    toks = (h % np.uint64(max(vocab - 2, 1))).astype(np.int64)
    # inject structure: every 4th token repeats the previous one
    rep = (idx % np.uint64(4)) == np.uint64(3)
    toks = np.where(rep, np.roll(toks, 1), toks)
    return toks.astype(np.int32)


@dataclass
class LMDataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    bin_path: Optional[str] = None     # file-backed corpus (int32 bin)
    mask_prob: float = 0.0             # >0: masked-LM batches (hubert-style)


def _tokens_at(cfg: LMDataConfig, start: int, count: int) -> np.ndarray:
    if cfg.bin_path:
        data = np.memmap(cfg.bin_path, dtype=np.int32, mode="r")
        idx = (np.arange(start, start + count) % data.shape[0])
        return np.asarray(data[idx])
    return synthetic_tokens(start, count, cfg.vocab, cfg.seed)


def lm_batch_at_step(cfg: LMDataConfig, step: int) -> Dict[str, np.ndarray]:
    """Materialize the full global batch for ``step`` (deterministic)."""
    n = cfg.global_batch * (cfg.seq_len + 1)
    flat = _tokens_at(cfg, step * n, n).reshape(cfg.global_batch,
                                                cfg.seq_len + 1)
    inputs = flat[:, :-1]
    targets = flat[:, 1:]
    mask = np.ones_like(targets, bool)
    if cfg.mask_prob > 0:
        rng = np.random.default_rng(cfg.seed * 100003 + step)
        mask = rng.random(targets.shape) < cfg.mask_prob
    return {"inputs": np.ascontiguousarray(inputs),
            "targets": np.ascontiguousarray(targets), "mask": mask}


def lm_batches(cfg: LMDataConfig, start_step: int = 0,
               prefetch: int = 2) -> Iterator[Dict[str, np.ndarray]]:
    """Host prefetch iterator (background thread keeps ``prefetch`` batches
    ready while the device step runs)."""
    q: queue_mod.Queue = queue_mod.Queue(maxsize=prefetch)
    stop = threading.Event()

    def worker():
        step = start_step
        while not stop.is_set():
            try:
                q.put(lm_batch_at_step(cfg, step), timeout=0.5)
                step += 1
            except queue_mod.Full:
                continue

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            yield q.get()
    finally:
        stop.set()


class DeltaStream:
    """Evolving-dataset generator for the MapReduce engine.

    Each epoch mutates ``frac`` of the records; ``delta()`` returns the
    paper-format signed delta ('-' old row, '+' new row) and updates the
    mirror.
    """

    def __init__(self, values: Dict[str, np.ndarray], frac: float = 0.1,
                 seed: int = 0, mutator=None):
        self.values = {k: v.copy() for k, v in values.items()}
        self.frac = frac
        self.seed = seed
        self.epoch = 0
        self.mutator = mutator

    def delta(self):
        rng = np.random.default_rng(self.seed * 7919 + self.epoch)
        n = next(iter(self.values.values())).shape[0]
        k = max(1, int(n * self.frac))
        rows = np.sort(rng.choice(n, k, replace=False)).astype(np.int32)
        old = {nm: a[rows].copy() for nm, a in self.values.items()}
        if self.mutator is not None:
            new = self.mutator(rng, rows, old)
        else:
            new = {nm: rng.permutation(a) for nm, a in old.items()}
        for nm in self.values:
            self.values[nm][rows] = new[nm]
        self.epoch += 1

        record_ids = np.repeat(rows, 2)
        sign = np.tile(np.array([-1, 1], np.int8), k)
        vals = {}
        for nm in old:
            buf = np.empty((2 * k,) + old[nm].shape[1:], old[nm].dtype)
            buf[0::2] = old[nm]
            buf[1::2] = new[nm]
            vals[nm] = buf
        return record_ids, vals, sign
