"""WordCount — the canonical accumulator-Reduce example (paper §3.5).

Counterpart of ``repro.apps.wordcount``.  Records are documents: fixed-width
arrays of word ids (-1 padding).  Map emits <word, 1>; Reduce is a sum, so
both the MRBGraph engine and the accumulator fast path apply.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.engine import JobSpec, emit_multi
from repro_torch.core.kvstore import KV, make_kv, sum_reducer


def make_input(doc_ids: np.ndarray, docs: np.ndarray, valid=None) -> KV:
    """Host (CPU) tensors; ``Session.run`` moves them to its device."""
    if valid is None:
        valid = np.ones(len(doc_ids), bool)
    return make_kv(np.asarray(doc_ids, np.int32),
                   {"w": torch.as_tensor(np.asarray(docs, np.int32))}, valid)


def map_fn(kv: KV, sign):
    words = kv.values["w"]                    # [N, L]
    n, l = words.shape
    v2 = {"c": torch.ones((n, l), dtype=torch.float32, device=words.device)}
    valid = (words >= 0) & kv.valid[:, None]
    return emit_multi(words, v2, kv.keys, valid, record_sign=sign)


def make_spec(vocab: int) -> JobSpec:
    return JobSpec(map_fn, sum_reducer(), vocab, "wordcount")


def make_job(docs: np.ndarray, vocab: int, doc_ids=None, valid=None):
    """Uniform app entry: ``(spec, data)`` ready for ``repro_torch.api.Session``."""
    if doc_ids is None:
        doc_ids = np.arange(len(docs), dtype=np.int32)
    return make_spec(vocab), make_input(doc_ids, docs, valid)


def doc_mutator(vocab: int):
    """Evolving-corpus mutator: rewrite the selected documents."""
    def mut(rng, rows, old):
        return {"w": rng.integers(0, vocab,
                                  old["w"].shape).astype(np.int32)}
    return mut


def oracle(docs: np.ndarray, vocab: int, valid=None) -> np.ndarray:
    """Word counts of the valid documents (float64, as the reference)."""
    docs = np.asarray(docs)
    if valid is not None:
        docs = docs[np.asarray(valid, bool)]
    words = docs[docs >= 0]
    counts = np.bincount(words, minlength=vocab)
    if counts.size > vocab:
        raise IndexError(f"word id {int(words.max())} out of vocab {vocab}")
    return counts.astype(np.float64)
