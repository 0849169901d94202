"""ELL-format SpMV — PageRank's propagation step as one kernel.

Counterpart of ``repro.kernels.spmv_ell.spmv_ell``: ``y[j]`` is the sum of
``contrib[i, f]`` over the slots with ``nbrs[i, f] == j``; -1 padding and
ids >= V are dropped.  The TPU kernel turns the scatter into a one-hot
matmul per (row tile, output block); on the H100 ``csrc/spmv_ell.cu`` is
the scatter itself, one thread per slot adding into ``y`` with an atomic.
float32 atomics add in a run-dependent order, so ``y`` equals a
sequential sum only up to the reordering of its additions.  It is bounded
by device-memory bytes.

No engine path calls it, in the port as in the JAX package: the iterative
engine runs PageRank's Map and Reduce as separate stages.

CUDA tensors launch the kernel or raise; CPU tensors take the plain
version :func:`ref.spmv_ell_ref`, and only they.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import spmv_ell_ref


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
    y = torch.empty(v, dtype=torch.float32, device=nbrs.device)
    if v:
        # the launcher zeroes y on the stream before it adds
        lib = _build.library("spmv_ell")
        nbrs = nbrs.to(torch.int32).contiguous()
        contrib = contrib.to(torch.float32).contiguous()
        rc = lib.spmv_ell_launch(nbrs.data_ptr(), contrib.data_ptr(),
                                 y.data_ptr(), nbrs.numel(), v,
                                 _build.stream_ptr(nbrs.device))
        _build.check(lib, rc, "spmv_ell")
        spmv_ell.launches += 1
    return y


spmv_ell.launches = 0
