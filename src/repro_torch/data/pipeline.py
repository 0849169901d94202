"""Delta-input streams for the MapReduce engine.

Counterpart of ``repro.data.pipeline``'s ``DeltaStream`` (numpy only):
the paper's signed delta inputs from an evolving dataset (graph edits or
rewritten documents per epoch).  Seeded like the reference's, so both
packages emit the same records.  The LM token pipeline of the reference
module is not ported yet (ROADMAP Queue 1 item 16b).
"""
from __future__ import annotations

from typing import Dict

import numpy as np


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
