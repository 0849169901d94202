"""Cold-store spill: serialize idle tenants' MRBG stores to disk.

A tenant that hasn't seen traffic recently still pins its preserved
MRBG-Store in host memory.  Under budget pressure the tier spills such
tenants: each store's blobs go to one ``.npz`` per store (the same
serialization the checkpoint format uses — :func:`store_blobs` /
:func:`store_meta` / :func:`load_store_state`), the in-memory store is
cleared in place, and the next delta for that tenant transparently
reloads it first.  Because the npz round-trip preserves every chunk byte
and the index arrays exactly, a spilled-then-reloaded tenant's next
refresh is bit-for-bit identical to one that never spilled.

Counterpart of ``repro.serve.spill`` on the port's store helpers (the
host-side MRBG-Store is the same in both packages).
"""
from __future__ import annotations

from pathlib import Path
from typing import List

import numpy as np

from repro_torch.core.mrbg_store import (
    load_store_state, store_blobs, store_meta,
)


class SpillManager:
    """Spills and reloads tenants' MRBG stores under a spill directory."""

    def __init__(self, spill_dir):
        self.dir = Path(spill_dir)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.spills = 0
        self.reloads = 0
        self.bytes_spilled = 0

    def _paths(self, handle) -> List[Path]:
        return [self.dir / f"{handle.name}.mrbg_{i:03d}.npz"
                for i in range(len(handle.ss.session.stores))]

    def spill(self, handle) -> int:
        """Serialize every store of ``handle``'s session and release the
        in-memory copies.  Returns the bytes freed.  Caller must ensure
        the tenant is idle (no batch in flight)."""
        ss = handle.ss
        with ss._lock:
            if handle.spilled:
                return 0
            freed = ss.session.store_bytes()
            metas = []
            for store, path in zip(ss.session.stores, self._paths(handle)):
                np.savez(path, **store_blobs(store))
                metas.append(store_meta(store))
                store.clear()
            handle.spill_meta = metas
            handle.spilled = True
        self.spills += 1
        self.bytes_spilled += freed
        return freed

    def reload(self, handle) -> None:
        """Restore ``handle``'s stores from disk (no-op when resident)."""
        ss = handle.ss
        with ss._lock:
            if not handle.spilled:
                return
            for store, meta, path in zip(ss.session.stores,
                                         handle.spill_meta,
                                         self._paths(handle)):
                with np.load(path) as npz:
                    load_store_state(store, npz, meta)
                path.unlink()
            handle.spill_meta = None
            handle.spilled = False
        self.reloads += 1

    def discard(self, handle) -> None:
        """Drop ``handle``'s spill files (tenant removed while spilled)."""
        for path in self._paths(handle):
            path.unlink(missing_ok=True)

    def snapshot(self) -> dict:
        return {"spills": self.spills, "reloads": self.reloads,
                "bytes_spilled": self.bytes_spilled}
