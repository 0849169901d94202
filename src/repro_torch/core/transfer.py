"""Carry a session's preserved state across from plain arrays.

The data here takes the place of a model's weights: a session that ran
elsewhere (for instance the JAX package) hands over its preserved state as
numpy arrays, and :func:`session_from_state` builds a port ``Session``
whose next ``update(delta)`` continues from it.  The state is a dict.

One-step sessions (``JobSpec``):

  ``view``     — ``{"values": {name: [K, ...]}, "valid": [K] bool,
                   "counts": [K]}``: the dense result view (both paths);
  ``store``    — MRBG path only: ``{"batches": [{"k2", "mk", "v2": {name:
                   array}, "sign", "offset"}, ...], "idx_batch",
                   "idx_start", "idx_len", "file_records",
                   "live_records"}``;
  ``raw_acc``  — accumulator path only: ``{name: [K, ...]}`` raw
                   (pre-finalize) accumulators.

Incremental iterative sessions (``IterSpec``, the ``IncrIterJob`` state):

  ``state``    — ``{name: [num_state, ...]}`` converged state values;
  ``valid``    — ``[num_state]`` bool;
  ``emitted_values`` — ``{name: [num_state, ...]}`` values as of each
                   key's last emission;
  ``cpc_accum`` — ``[num_state]`` float32 CPC accumulators;
  ``mrbg_on``  — bool;
  ``struct``   — ``{"keys": [N], "values": {name: [N, ...]}, "valid":
                   [N] bool}``: the structure mirror;
  ``store``    — the MRBG-Store, as above.

Arrays are copied, so the source may keep using its own.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np

import torch

from repro_torch.api.config import RunConfig
from repro_torch.api.session import (
    Session, _IncrIter, _OneStepAccumulator, _OneStepMRBG,
)
from repro_torch.core.incr_iter import IncrIterJob
from repro_torch.core.incremental import ResultView
from repro_torch.core.iterative import State
from repro_torch.core.kvstore import make_kv
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


def _device_tree(arrays: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    return {n: torch.tensor(np.array(a), device=device)
            for n, a in arrays.items()}


def _incr_iter_from_arrays(drv: _IncrIter, state: Dict[str, Any]) -> None:
    struct = state["struct"]
    cfg = drv.cfg
    job = IncrIterJob(
        drv.spec, make_kv(np.array(struct["keys"], np.int32),
                          {n: np.array(a) for n, a in
                           struct["values"].items()},
                          np.array(struct["valid"], bool)),
        device=drv.device, value_bytes=cfg.value_bytes,
        policy=cfg.store_policy, cpc_threshold=cfg.cpc_threshold,
        pdelta_threshold=cfg.pdelta_threshold, store_kw=cfg.store_kw())
    job.state = State(_device_tree(state["state"], drv.device),
                      torch.tensor(np.array(state["valid"], bool),
                                   device=drv.device))
    job.emitted_values = _device_tree(state["emitted_values"], drv.device)
    job.cpc_accum = np.array(state["cpc_accum"], np.float32)
    job.mrbg_on = bool(state["mrbg_on"])
    store_from_arrays(job.store, state["store"])
    drv.job = job


def session_from_state(spec, config: RunConfig,
                       state: Dict[str, Any]) -> Session:
    """A port Session at epoch 0 holding ``state``; call ``update`` next."""
    sess = Session(spec, config)
    drv = sess._driver
    if isinstance(drv, _IncrIter):
        _incr_iter_from_arrays(drv, state)
    elif isinstance(drv, _OneStepAccumulator):
        drv.job.view = view_from_arrays(spec.num_keys, state["view"])
        drv.job.raw_acc = {n: np.array(a)
                           for n, a in state["raw_acc"].items()}
    elif isinstance(drv, _OneStepMRBG):
        store_from_arrays(drv.store, state["store"])
        drv.view = view_from_arrays(spec.num_keys, state["view"])
        drv._counts = drv.view.counts.copy()
    else:
        raise TypeError(f"no preserved state to carry into a "
                        f"{type(drv).__name__} session")
    sess.epoch = 0
    return sess
