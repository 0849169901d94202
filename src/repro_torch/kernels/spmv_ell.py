"""ELL-format SpMV — PageRank's propagation step as one kernel.

Counterpart of ``repro.kernels.spmv_ell.spmv_ell``: ``y[j]`` is the sum of
``contrib[i, f]`` over the slots with ``nbrs[i, f] == j``; -1 padding and
ids >= V are dropped.  The TPU kernel turns the scatter into a one-hot
matmul per (row tile, output block).  On the H100 it is ``segment_sum``
at D = 1 with counts off over the flattened slots, and
``csrc/spmv_ell.cu`` runs on the same core, ``csrc/scatter_sum.cuh``, in
its direct variant: one pass of 16-byte loads, padding dropped before any
add, each run of equal ids one L2 atomic into ``y``.  The probes
(``tools/scatter_probes.py``) put the L2 at ~73 G adds/s beside the
stream of slots, so 2^25 live slots of 2^26 take at least ~0.46 ms; the
core's partition measured slower here (it moves each live slot twice).
No workspace (``spmv_ell_workspace_bytes`` gives the launcher's minimum).
float32 adds in a run-dependent order, so ``y`` equals a sequential sum
only up to the reordering of its additions (exact on integer-valued
data).

No engine path calls it, in the port as in the JAX package: the iterative
engine runs PageRank's Map and Reduce as separate stages.

CUDA tensors launch the kernel or raise; CPU tensors take the plain
version :func:`ref.spmv_ell_ref`, and only they.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, count_launch
from repro_torch.kernels.ref import spmv_ell_ref
from repro_torch.kernels.segment_reduce import MAX_ROWS, MAX_SEGMENTS


def spmv_ell(nbrs: torch.Tensor, contrib: torch.Tensor,
             num_vertices: int) -> torch.Tensor:
    """nbrs [S, F] int32 (-1 padding), contrib [S, F] float32 -> y [V]."""
    if nbrs.ndim != 2 or contrib.shape != nbrs.shape:
        raise ValueError(f"spmv_ell takes nbrs and contrib [S, F], got "
                         f"{tuple(nbrs.shape)}, {tuple(contrib.shape)}")
    if nbrs.device != contrib.device:
        raise ValueError("spmv_ell inputs lie on different devices")
    if nbrs.device.type == "cpu":
        return spmv_ell_ref(nbrs, contrib, num_vertices)
    if nbrs.device.type != "cuda":
        raise ValueError(f"spmv_ell runs on cuda or cpu, not {nbrs.device}")
    v = max(int(num_vertices), 0)
    if nbrs.numel() > MAX_ROWS or v > MAX_SEGMENTS:
        raise ValueError(f"the spmv_ell kernel takes at most {MAX_ROWS} "
                         f"slots and {MAX_SEGMENTS} vertices, got "
                         f"{nbrs.numel()}, {v}")
    y = torch.empty(v, dtype=torch.float32, device=nbrs.device)
    if v:
        # the launcher writes every element of y
        lib = _build.library("spmv_ell")
        nbrs = nbrs.to(torch.int32).contiguous()
        contrib = contrib.to(torch.float32).contiguous()
        ws = torch.empty(lib.spmv_ell_workspace_bytes(nbrs.numel(), v),
                         dtype=torch.uint8, device=nbrs.device)
        rc = lib.spmv_ell_launch(nbrs.data_ptr(), contrib.data_ptr(),
                                 y.data_ptr(), nbrs.numel(), v,
                                 ws.data_ptr(), ws.numel(),
                                 _build.stream_ptr(nbrs.device))
        _build.check(lib, rc, "spmv_ell")
        count_launch(spmv_ell)
    return y


spmv_ell.launches = 0
