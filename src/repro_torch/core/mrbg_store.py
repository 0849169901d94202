"""MRBG-Store: preservation + retrieval of fine-grain MRBGraph states.

The port's own copy of ``repro.core.mrbg_store`` (numpy only), kept byte
for byte in behaviour: the same batches, index, four read policies and
``IOStats`` accounting.  The store lives on the host by design, on the
GPU machine as on the TPU one.

Faithful port of Section 3.4 / 5.2 of the paper, adapted to the
accelerator node's memory hierarchy:

  Hadoop                         this implementation
  ---------------------------    ------------------------------------------
  local-disk MRBGraph file       host-memory numpy batches ("disk")
  chunk (all edges of one K2)    contiguous record slice within a batch
  in-memory hash chunk index     dense numpy (batch, start, len) arrays
  read cache + dynamic window    simulated windows + bulk numpy reads
  append buffer + offline        append-only batch list + ``compact()``
  compaction

The store is deliberately a *host-side* object: Hadoop's MRBG file lives on
local disk outside the task JVM, and here the preserved states live outside
the device computation, feeding padded device buffers to the device
merge+reduce (see ``repro_torch.core.incremental``).

All four retrieval policies of Table 4 are implemented (index-only,
single-fix-window, multi-fix-window, multi-dynamic-window) with exact
#read / bytes-read accounting, and the reads are *actually performed* through
a cache buffer so that wall-clock time tracks the simulated I/O.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

# Default knobs (paper: T = 100KB; cache sized like Hadoop's io.sort.mb scale)
DEFAULT_GAP_T = 100 * 1024
DEFAULT_CACHE = 4 * 1024 * 1024
DEFAULT_FIX_WINDOW = 1024 * 1024

POLICIES = ("index-only", "single-fix-window", "multi-fix-window",
            "multi-dynamic-window")


@dataclasses.dataclass
class IOStats:
    n_reads: int = 0
    bytes_read: int = 0
    bytes_useful: int = 0
    cache_hits: int = 0

    def add(self, other: "IOStats") -> None:
        self.n_reads += other.n_reads
        self.bytes_read += other.bytes_read
        self.bytes_useful += other.bytes_useful
        self.cache_hits += other.cache_hits


class _Batch:
    """One sorted segment of chunks, the unit produced by a merge pass."""

    __slots__ = ("k2", "mk", "v2", "sign", "offset")

    def __init__(self, k2, mk, v2, sign, offset: int):
        self.k2 = k2          # [E] int32, sorted
        self.mk = mk          # [E] int32
        self.v2 = v2          # dict name -> [E, ...] array
        self.sign = sign      # [E] int8 (always +1 inside the store)
        self.offset = offset  # global file offset in records

    @property
    def size(self) -> int:
        return int(self.k2.shape[0])


class MRBGStore:
    """Append-only chunk store with a dense per-key index.

    ``num_keys`` is the dense K2 key-space size (one potential chunk per key).
    """

    def __init__(self, num_keys: int, value_bytes: int,
                 policy: str = "multi-dynamic-window",
                 gap_threshold: int = DEFAULT_GAP_T,
                 cache_bytes: int = DEFAULT_CACHE,
                 fix_window_bytes: int = DEFAULT_FIX_WINDOW):
        assert policy in POLICIES, policy
        self.num_keys = num_keys
        self.record_bytes = 8 + value_bytes        # k2 + mk + payload
        self.policy = policy
        self.gap_threshold = gap_threshold
        self.cache_bytes = cache_bytes
        self.fix_window_bytes = fix_window_bytes

        self.batches: List[_Batch] = []
        # chunk index: latest version of each key's chunk
        self.idx_batch = np.full(num_keys, -1, np.int32)
        self.idx_start = np.zeros(num_keys, np.int32)
        self.idx_len = np.zeros(num_keys, np.int32)
        self.stats = IOStats()
        self.file_records = 0                      # includes obsolete chunks
        self.live_records = 0

    # -- helpers ----------------------------------------------------------
    def _rec(self, nbytes: int) -> int:
        """Convert a byte budget to whole records (>=1)."""
        return max(1, nbytes // self.record_bytes)

    def reset_stats(self) -> None:
        self.stats = IOStats()

    def clone(self, policy: Optional[str] = None) -> "MRBGStore":
        s = MRBGStore(self.num_keys, self.record_bytes - 8,
                      policy or self.policy, self.gap_threshold,
                      self.cache_bytes, self.fix_window_bytes)
        s.batches = list(self.batches)
        s.idx_batch = self.idx_batch.copy()
        s.idx_start = self.idx_start.copy()
        s.idx_len = self.idx_len.copy()
        s.file_records = self.file_records
        s.live_records = self.live_records
        return s

    def clear(self) -> None:
        """Drop every batch and index entry in place.

        The serving tier spills a cold tenant's store to disk
        (:func:`store_blobs`/:func:`store_meta`), clears it to release the
        memory, and later repopulates the *same* object with
        :func:`load_store_state` — a bit-for-bit round trip.
        """
        self.batches = []
        self.idx_batch[:] = -1
        self.idx_start[:] = 0
        self.idx_len[:] = 0
        self.file_records = 0
        self.live_records = 0

    # -- ingestion --------------------------------------------------------
    def append(self, k2: np.ndarray, mk: np.ndarray, v2: Dict[str, np.ndarray],
               sign: Optional[np.ndarray] = None) -> None:
        """Append a merge pass's output chunks as a new sorted batch and
        repoint the index (old chunk versions become obsolete in place,
        Section 3.4 'Incremental Storage of MRBGraph Changes')."""
        k2 = np.asarray(k2, np.int32)
        if k2.size == 0:
            return
        mk = np.asarray(mk, np.int32)
        if sign is None:
            sign = np.ones(k2.shape[0], np.int8)
        batch = _Batch(k2, mk, {n: np.asarray(a) for n, a in v2.items()},
                       np.asarray(sign, np.int8), self.file_records)
        bid = len(self.batches)
        self.batches.append(batch)
        self.file_records += batch.size

        # chunk boundaries within the sorted batch
        keys, starts, lens = _chunk_spans(k2)
        self.live_records -= int(self.idx_len[keys].sum())
        self.idx_batch[keys] = bid
        self.idx_start[keys] = starts
        self.idx_len[keys] = lens
        self.live_records += int(lens.sum())

    def mark_deleted(self, keys: np.ndarray) -> None:
        """Drop keys whose chunks became empty after a merge."""
        keys = np.asarray(keys, np.int32)
        if keys.size == 0:
            return
        self.live_records -= int(self.idx_len[keys].sum())
        self.idx_batch[keys] = -1
        self.idx_len[keys] = 0

    # -- retrieval --------------------------------------------------------
    def query(self, keys_sorted: np.ndarray):
        """Retrieve the latest chunks for ``keys_sorted`` (ascending).

        Returns (k2, mk, v2 dict, per_key_len) concatenated in key order.
        I/O is simulated per the configured policy and accounted in
        ``self.stats``; data physically flows through read-cache buffers so
        that wall time follows bytes_read + n_reads.
        """
        keys = np.asarray(keys_sorted, np.int64)
        present = keys[(keys >= 0) & (keys < self.num_keys)]
        present = present[self.idx_batch[present] >= 0]
        per_key_len = np.zeros(keys.shape[0], np.int32)
        mask = (keys >= 0) & (keys < self.num_keys)
        valid_keys = keys[mask]
        lens = np.where(self.idx_batch[valid_keys] >= 0,
                        self.idx_len[valid_keys], 0)
        per_key_len[mask] = lens

        if present.size == 0:
            empty_v2 = None
            return (np.zeros(0, np.int32), np.zeros(0, np.int32), empty_v2,
                    per_key_len)

        plan = self._plan_reads(present)
        out_k2, out_mk, out_v2 = self._execute_reads(present, plan)
        return out_k2, out_mk, out_v2, per_key_len

    # The read planner implements Algorithm 1 (+ the Section 5.2
    # multi-dynamic-window extension).  It returns, for each requested key,
    # which simulated read supplies it; reads are (batch, start, length).
    def _plan_reads(self, keys: np.ndarray):
        bids = self.idx_batch[keys]
        starts = self.idx_start[keys]
        lens = self.idx_len[keys]
        n = keys.shape[0]
        reads: List[tuple] = []          # (batch, start_rec, len_rec)
        src = np.zeros(n, np.int32)      # read id serving key i

        cache_rec = self._rec(self.cache_bytes)
        gap_rec = self._rec(self.gap_threshold)
        fix_rec = self._rec(self.fix_window_bytes)

        if self.policy == "index-only":
            for i in range(n):
                src[i] = len(reads)
                reads.append((bids[i], starts[i], lens[i]))
            self.stats.n_reads += n
            rb = int(lens.sum()) * self.record_bytes
            self.stats.bytes_read += rb
            self.stats.bytes_useful += rb
            return reads, src

        if self.policy == "single-fix-window":
            # One window over the global file; chunk positions jump between
            # batches, defeating the window (Table 4's pathological case).
            win = (0, -1, -1)  # global [lo, hi) in records, serving read id
            for i in range(n):
                batch = self.batches[bids[i]]
                gpos = batch.offset + starts[i]
                if win[0] <= gpos and gpos + lens[i] <= win[1]:
                    self.stats.cache_hits += 1
                    src[i] = win[2]
                else:
                    w = max(fix_rec, int(lens[i]))
                    rid = len(reads)
                    # data past the batch end is useless for chunk hits:
                    # clamp the *hit* range (stats still count w bytes).
                    hit_end = min(gpos + w, batch.offset + batch.size)
                    win = (gpos, hit_end, rid)
                    reads.append((int(bids[i]), int(starts[i]), w))
                    self.stats.n_reads += 1
                    self.stats.bytes_read += w * self.record_bytes
                    src[i] = rid
            self.stats.bytes_useful += int(lens.sum()) * self.record_bytes
            return reads, src

        # multi-window policies: one window per batch (Section 5.2)
        windows: Dict[int, tuple] = {}
        for i in range(n):
            b, s, l = int(bids[i]), int(starts[i]), int(lens[i])
            win = windows.get(b)
            if win is not None and win[0] <= s and s + l <= win[1]:
                self.stats.cache_hits += 1
                src[i] = win[2]
                continue
            if self.policy == "multi-fix-window":
                w = max(fix_rec, l)
            else:  # multi-dynamic-window: Algorithm 1 over same-batch keys
                w = l
                j = i
                last_end = s + l
                while True:
                    j = _next_in_batch(bids, j, b)
                    if j < 0:
                        break
                    nxt_start, nxt_len = int(starts[j]), int(lens[j])
                    gap = nxt_start - last_end
                    if gap < 0:   # already covered / out of order guard
                        break
                    if gap >= gap_rec:
                        break
                    if (w + gap + nxt_len) > cache_rec:
                        break
                    w = w + gap + nxt_len
                    last_end = nxt_start + nxt_len
                w = min(w, max(cache_rec, l))
            rid = len(reads)
            reads.append((b, s, w))
            windows[b] = (s, s + w, rid)
            src[i] = rid
            self.stats.n_reads += 1
            self.stats.bytes_read += w * self.record_bytes
        self.stats.bytes_useful += int(lens.sum()) * self.record_bytes
        return reads, src

    def _execute_reads(self, keys: np.ndarray, plan):
        reads, src = plan
        # 1) physically perform each simulated read into a cache buffer
        caches = []
        for (b, s, w) in reads:
            batch = self.batches[b]
            end = min(s + w, batch.size)
            caches.append((batch, int(s),
                           {"k2": batch.k2[s:end].copy(),
                            "mk": batch.mk[s:end].copy(),
                            "v2": {n: a[s:end].copy()
                                   for n, a in batch.v2.items()}}))
        # 2) slice every requested chunk out of its cache
        k2_parts, mk_parts = [], []
        v2_parts: Dict[str, list] = {}
        for i in range(keys.shape[0]):
            k = int(keys[i])
            b, s, l = (int(self.idx_batch[k]), int(self.idx_start[k]),
                       int(self.idx_len[k]))
            batch, cstart, cache = caches[src[i]]
            lo = s - cstart
            k2_parts.append(cache["k2"][lo:lo + l])
            mk_parts.append(cache["mk"][lo:lo + l])
            for nme, arr in cache["v2"].items():
                v2_parts.setdefault(nme, []).append(arr[lo:lo + l])
        out_k2 = np.concatenate(k2_parts) if k2_parts else np.zeros(0, np.int32)
        out_mk = np.concatenate(mk_parts) if mk_parts else np.zeros(0, np.int32)
        out_v2 = {n: np.concatenate(p) for n, p in v2_parts.items()}
        return out_k2, out_mk, out_v2

    # -- maintenance ------------------------------------------------------
    def compact(self) -> int:
        """Offline reconstruction (paper: 'the MRBGraph file is reconstructed
        off-line when the worker is idle'): rewrite a single batch holding
        only the latest version of every chunk.  Returns the file bytes
        reclaimed (the multi-tenant server's budget enforcement unit)."""
        before = self.file_bytes()
        live = np.nonzero(self.idx_batch >= 0)[0]
        if live.size == 0:
            self.batches = []
            self.file_records = 0
            return before
        k2, mk, v2, _ = self.query(live)
        self.batches = []
        self.file_records = 0
        self.idx_batch[:] = -1
        self.idx_len[:] = 0
        self.live_records = 0
        self.append(k2, mk, v2)
        return before - self.file_bytes()

    @property
    def n_batches(self) -> int:
        return len(self.batches)

    def file_bytes(self) -> int:
        return self.file_records * self.record_bytes

    def live_bytes(self) -> int:
        return self.live_records * self.record_bytes

    def obsolete_bytes(self) -> int:
        """Bytes held by superseded chunk versions (reclaimable)."""
        return (self.file_records - self.live_records) * self.record_bytes


# ---------------------------------------------------------------------------
# Store (de)serialization: the one batch/index npz layout, shared by the
# per-iteration engine checkpoints (repro.core.ft) and the Session
# checkpoints (repro.api.ckpt)
# ---------------------------------------------------------------------------

def store_blobs(store: "MRBGStore") -> Dict[str, np.ndarray]:
    """Every array of the store, keyed for one flat ``np.savez``."""
    blobs = {"idx_batch": store.idx_batch, "idx_start": store.idx_start,
             "idx_len": store.idx_len}
    for i, b in enumerate(store.batches):
        blobs[f"b{i}_k2"] = b.k2
        blobs[f"b{i}_mk"] = b.mk
        blobs[f"b{i}_sign"] = b.sign
        for n, a in b.v2.items():
            blobs[f"b{i}_v2_{n}"] = a
    return blobs


def store_meta(store: "MRBGStore") -> Dict[str, Any]:
    """The non-array state needed to rebuild the store around the blobs."""
    return {"offsets": [b.offset for b in store.batches],
            "v2_names": sorted({n for b in store.batches for n in b.v2}),
            "file_records": store.file_records,
            "live_records": store.live_records,
            "value_bytes": store.record_bytes - 8,
            "policy": store.policy}


def load_store_state(store: "MRBGStore", npz, meta: Dict[str, Any]) -> None:
    """Populate a freshly constructed store from store_blobs/store_meta."""
    names = meta["v2_names"]
    for i, off in enumerate(meta["offsets"]):
        v2 = {n: npz[f"b{i}_v2_{n}"] for n in names
              if f"b{i}_v2_{n}" in npz.files}
        store.batches.append(_Batch(npz[f"b{i}_k2"], npz[f"b{i}_mk"], v2,
                                    npz[f"b{i}_sign"], off))
    store.idx_batch = npz["idx_batch"].copy()
    store.idx_start = npz["idx_start"].copy()
    store.idx_len = npz["idx_len"].copy()
    store.file_records = meta["file_records"]
    store.live_records = meta["live_records"]


def _chunk_spans(sorted_k2: np.ndarray):
    """Return (unique keys, start offsets, lengths) of each chunk."""
    keys, starts = np.unique(sorted_k2, return_index=True)
    lens = np.diff(np.append(starts, sorted_k2.shape[0])).astype(np.int32)
    return keys.astype(np.int64), starts.astype(np.int32), lens


def _next_in_batch(bids: np.ndarray, j: int, b: int) -> int:
    """Index of the next requested key that lives in batch ``b`` after j."""
    for k in range(j + 1, bids.shape[0]):
        if bids[k] == b:
            return k
    return -1
