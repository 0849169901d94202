"""APriori frequent-pair counting (paper §8.1.3), one-step + accumulator.

Counterpart of ``repro.apps.apriori``.  After a preprocessing pass picks
the candidate list of frequent word pairs, the MapReduce job counts each
pair's occurrences over the tweet corpus: Map checks every candidate pair
against a tweet's word set and emits <pair_id, 1>; Reduce sums.  This is
the paper's showcase for the accumulator-Reduce optimization: no MRBGraph
is preserved at all.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.engine import JobSpec, emit_multi
from repro_torch.core.kvstore import KV, make_kv, sum_reducer


def make_input(tweet_ids: np.ndarray, tweets: np.ndarray, valid=None) -> KV:
    """tweets: [N, L] word ids, -1 padding.  Host (CPU) tensors;
    ``Session.run`` moves them to its device."""
    if valid is None:
        valid = np.ones(len(tweet_ids), bool)
    return make_kv(np.asarray(tweet_ids, np.int32),
                   {"w": np.asarray(tweets, np.int32)}, valid)


def make_spec(pairs: np.ndarray) -> JobSpec:
    """pairs: [P, 2] candidate word-id pairs; they move to the words'
    device where the Map first reads them."""
    pairs_host = torch.as_tensor(np.asarray(pairs, np.int32))
    p = pairs.shape[0]
    on = {}

    def map_fn(kv: KV, sign):
        words = kv.values["w"]                              # [N, L]
        dev = words.device
        if dev not in on:
            on[dev] = pairs_host.to(dev)
        pa, pb = on[dev][:, 0], on[dev][:, 1]
        has_a = (words[:, None, :] == pa[None, :, None]).any(-1)   # [N, P]
        has_b = (words[:, None, :] == pb[None, :, None]).any(-1)
        present = has_a & has_b & kv.valid[:, None]
        k2 = torch.arange(p, dtype=torch.int32, device=dev)[None, :] \
            .expand(present.shape)
        ones = torch.ones(present.shape, dtype=torch.float32, device=dev)
        return emit_multi(k2, {"c": ones}, kv.keys, present,
                          record_sign=sign)

    return JobSpec(map_fn, sum_reducer(), p, "apriori")


def make_job(tweets: np.ndarray, pairs: np.ndarray, tweet_ids=None,
             valid=None):
    """Uniform app entry: ``(spec, data)`` ready for
    ``repro_torch.api.Session``."""
    if tweet_ids is None:
        tweet_ids = np.arange(len(tweets), dtype=np.int32)
    return make_spec(pairs), make_input(tweet_ids, tweets, valid)


def candidate_pairs(tweets: np.ndarray, vocab: int, top: int = 64,
                    seed: int = 0) -> np.ndarray:
    """Preprocessing job: pick candidate pairs from frequent words."""
    counts = np.bincount(tweets[tweets >= 0].reshape(-1), minlength=vocab)
    frequent = np.argsort(-counts)[:max(4, int(np.sqrt(2 * top)) + 2)]
    pairs = []
    for i in range(len(frequent)):
        for j in range(i + 1, len(frequent)):
            pairs.append((frequent[i], frequent[j]))
            if len(pairs) >= top:
                return np.asarray(pairs, np.int32)
    return np.asarray(pairs, np.int32)


def oracle(tweets: np.ndarray, pairs: np.ndarray, valid=None) -> np.ndarray:
    """Pair counts of the valid tweets (float64, as the reference)."""
    tweets = np.asarray(tweets)
    if valid is not None:
        tweets = tweets[np.asarray(valid, bool)]
    has = lambda w: (tweets[:, None, :] == w[None, :, None]).any(-1)
    return (has(pairs[:, 0]) & has(pairs[:, 1])).sum(0).astype(np.float64)
