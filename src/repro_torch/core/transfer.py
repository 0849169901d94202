"""Carry a one-step session's preserved state across from plain arrays.

The data here takes the place of a model's weights: a session that ran
elsewhere (for instance the JAX package) hands over its preserved state as
numpy arrays, and :func:`session_from_state` builds a port ``Session``
whose next ``update(delta)`` continues from it.  The state is a dict:

  ``view``     — ``{"values": {name: [K, ...]}, "valid": [K] bool,
                   "counts": [K]}``: the dense result view (both paths);
  ``store``    — MRBG path only: ``{"batches": [{"k2", "mk", "v2": {name:
                   array}, "sign", "offset"}, ...], "idx_batch",
                   "idx_start", "idx_len", "file_records",
                   "live_records"}``;
  ``raw_acc``  — accumulator path only: ``{name: [K, ...]}`` raw
                   (pre-finalize) accumulators.

Arrays are copied, so the source may keep using its own.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np

from repro_torch.api.config import RunConfig
from repro_torch.api.session import Session, _OneStepAccumulator
from repro_torch.core.engine import JobSpec
from repro_torch.core.incremental import ResultView
from repro_torch.core.mrbg_store import MRBGStore, _Batch


def view_from_arrays(num_keys: int, view: Dict[str, Any]) -> ResultView:
    return ResultView(num_keys,
                      {n: np.array(a) for n, a in view["values"].items()},
                      np.array(view["valid"], bool), np.array(view["counts"]))


def store_from_arrays(store: MRBGStore, state: Dict[str, Any]) -> None:
    """Fill a freshly constructed store with the given batches and index."""
    store.batches = [
        _Batch(np.array(b["k2"], np.int32), np.array(b["mk"], np.int32),
               {n: np.array(a) for n, a in b["v2"].items()},
               np.array(b["sign"], np.int8), int(b["offset"]))
        for b in state["batches"]]
    store.idx_batch = np.array(state["idx_batch"], np.int32)
    store.idx_start = np.array(state["idx_start"], np.int32)
    store.idx_len = np.array(state["idx_len"], np.int32)
    store.file_records = int(state["file_records"])
    store.live_records = int(state["live_records"])


def session_from_state(spec: JobSpec, config: RunConfig,
                       state: Dict[str, Any]) -> Session:
    """A port Session at epoch 0 holding ``state``; call ``update`` next."""
    sess = Session(spec, config)
    drv = sess._driver
    view = view_from_arrays(spec.num_keys, state["view"])
    if isinstance(drv, _OneStepAccumulator):
        drv.job.view = view
        drv.job.raw_acc = {n: np.array(a)
                           for n, a in state["raw_acc"].items()}
    else:
        store_from_arrays(drv.store, state["store"])
        drv.view = view
        drv._counts = view.counts.copy()
    sess.epoch = 0
    return sess
