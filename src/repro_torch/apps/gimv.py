"""GIM-V (Generalized Iterated Matrix-Vector multiplication) — paper
Algorithm 4, many-to-one dependency.

Counterpart of ``repro.apps.gimv``.  Structure: SK = matrix block id
(i * nb + j), SV = dense sub-block m[bs, bs].  State: DK = vector block
id j, DV = {"v": [bs]}.  project((i, j)) = j: *many* matrix blocks depend
on *one* vector block.

combine2   = block matmul  m_ij @ v_j        (the Map)
combineAll = sum over j                      (the Reduce)
assign     = damped update alpha * Mv + (1-alpha) * b   (finalize)

With alpha < 1/||M|| this is a contraction, so it converges to
v* = (I - alpha M)^-1 (1-alpha) b, a deterministic oracle.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.engine import emit_single
from repro_torch.core.iterative import IterSpec
from repro_torch.core.kvstore import KV, make_kv, sum_reducer

ALPHA = 0.8


def make_struct(blocks: np.ndarray, nb: int, valid_rows=None) -> KV:
    """blocks: [nb*nb, bs, bs]; record id = i * nb + j (row-major)."""
    s = blocks.shape[0]
    assert s == nb * nb
    if valid_rows is None:
        valid_rows = np.ones(s, bool)
    return make_kv(np.arange(s, dtype=np.int32),
                   {"m": np.asarray(blocks, np.float32)}, valid_rows)


def make_spec(nb: int, bs: int, b_vec: np.ndarray) -> IterSpec:
    """b_vec: [nb, bs] the constant term (e.g. teleport vector); it moves
    to the state's device where the finalize first reads it."""
    b_host = torch.as_tensor(np.asarray(b_vec, np.float32))
    b_on = {}

    def map_fn(struct: KV, dv, sign):
        m = struct.values["m"]               # [N, bs, bs]
        vj = dv["v"]                         # [N, bs] gathered by project
        mv = torch.einsum("nab,nb->na", m, vj)   # combine2
        i_block = torch.div(struct.keys, nb, rounding_mode="floor")
        return emit_single(i_block.to(torch.int32), {"v": mv},
                           struct.keys, struct.valid, record_sign=sign)

    def finalize(keys, acc, counts):          # combineAll + assign
        dev = acc["v"].device
        if dev not in b_on:
            b_on[dev] = b_host.to(dev)
        safe = keys.clamp(0, nb - 1).to(torch.int64)
        return {"v": ALPHA * acc["v"] + (1.0 - ALPHA) * b_on[dev][safe]}

    return IterSpec(
        map_fn=map_fn,
        reducer=sum_reducer(finalize),
        project=lambda sk: torch.remainder(sk, nb).to(torch.int32),
        num_state=nb,
        init_state=lambda dks: {"v": torch.zeros((nb, bs),
                                                 dtype=torch.float32,
                                                 device=dks.device)},
        difference=lambda c, p: (c["v"] - p["v"]).abs().amax(dim=1),
        stable_topology=True,
        name="gimv",
    )


def make_job(blocks: np.ndarray, nb: int, bs: int, b_vec: np.ndarray,
             valid_rows=None):
    """Uniform app entry: ``(spec, data)`` ready for
    ``repro_torch.api.Session``."""
    return make_spec(nb, bs, b_vec), make_struct(blocks, nb, valid_rows)


def oracle(blocks: np.ndarray, nb: int, bs: int, b_vec: np.ndarray,
           iters: int = 300, tol: float = 1e-10,
           valid_rows=None) -> np.ndarray:
    """Dense fixpoint of v = alpha * M v + (1 - alpha) * b."""
    m = np.zeros((nb * bs, nb * bs))
    for r in range(nb * nb):
        if valid_rows is not None and not valid_rows[r]:
            continue
        i, j = divmod(r, nb)
        m[i * bs:(i + 1) * bs, j * bs:(j + 1) * bs] = blocks[r]
    b = b_vec.reshape(-1).astype(np.float64)
    v = np.zeros(nb * bs)
    for _ in range(iters):
        nv = ALPHA * (m @ v) + (1 - ALPHA) * b
        done = np.abs(nv - v).max() < tol
        v = nv
        if done:
            break
    return v.reshape(nb, bs)


def random_blocks(nb: int, bs: int, seed: int = 0, density: float = 0.6):
    """Random sub-stochastic blocked matrix (spectral radius < 1)."""
    rng = np.random.default_rng(seed)
    m = rng.random((nb * bs, nb * bs)) * (rng.random((nb * bs, nb * bs))
                                          < density)
    m = m / np.maximum(m.sum(axis=0, keepdims=True), 1.0)   # column-normalize
    return np.ascontiguousarray(
        m.reshape(nb, bs, nb, bs).transpose(0, 2, 1, 3)
        .reshape(nb * nb, bs, bs)).astype(np.float32)
