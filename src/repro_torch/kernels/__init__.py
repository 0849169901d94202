"""The port's kernels: hand-written CUDA for the H100, plain versions beside.

Each kernel wrapper keeps a launch count (``<wrapper>.launches``), which
adds one where the wrapper launches its kernel and nowhere else, so that a
run can show that its main path went through the kernels.  Kernel modules
build nothing at import; see ``_build``.
"""
from __future__ import annotations

from typing import Dict


def _wrappers():
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.fused import fused_shuffle_reduce
    from repro_torch.kernels.segment_reduce import segment_minmax, segment_sum
    from repro_torch.kernels.sort_u32 import sort_lex
    from repro_torch.kernels.spmv_ell import spmv_ell
    return {"sort_lex": sort_lex, "segment_sum": segment_sum,
            "fused_shuffle_reduce": fused_shuffle_reduce,
            "segment_minmax": segment_minmax, "spmv_ell": spmv_ell,
            "flash_attention": flash_attention}


def launch_counts() -> Dict[str, int]:
    """Launches of each kernel since the last :func:`reset_launch_counts`."""
    return {name: fn.launches for name, fn in _wrappers().items()}


def reset_launch_counts() -> None:
    for fn in _wrappers().values():
        fn.launches = 0
