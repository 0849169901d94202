"""Build and load the hand-written CUDA kernels (plain C interface + ctypes).

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into its own
shared library under ``kernels/build/`` (git-ignored), named by a hash of
the sources so that an edit rebuilds and an unchanged tree reuses the
library.  All sources compile in parallel, one ``nvcc`` each, at the first
use of any kernel; nothing is fetched or pre-built.  The libraries link the
CUDA runtime statically and take PyTorch's stream and device pointers as
plain integers (``c_void_p``).  Headers under ``csrc/`` (``common.cuh``,
``wgmma.cuh``, ``scatter_sum.cuh``, ``collapse.cuh``) are part of the
hash.  The flash kernel's TMA descriptors come from libcuda's
``cuTensorMapEncodeTiled``, which it looks up through the CUDA runtime's
entry-point query at its first launch, so no library links ``-lcuda``.
Each nvcc run counts as a compile and each load of a library as a trace
in ``jitcache``.  One lock covers building and loading, so a first launch
from a worker thread (``repro_torch.stream``) builds once.

Nothing here runs at import: the CPU tests import every module, and the
loader only touches ``nvcc`` when a CUDA tensor asks for a kernel.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

import torch

from repro_torch.kernels import jitcache

_CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
SOURCES = ("sort", "segment_sum", "fused", "segment_minmax", "spmv_ell",
           "flash_attention")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
              "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float
_SZ = ctypes.c_size_t
# exported C functions: name -> (argtypes, restype)
_SIGNATURES = {
    "sort": {
        "sort_lex_workspace_bytes": ([_LL], _SZ),
        "sort_lex_launch": ([_P, _P, _P, _P, _P, _LL, _P, _P], _I),
    },
    "segment_sum": {
        "segment_sum_workspace_bytes": ([_LL, _I, _I, _I], _SZ),
        "segment_sum_launch": ([_P, _P, _P, _P, _LL, _I, _I, _I, _P, _SZ,
                                _P], _I),
    },
    "fused": {
        "fused_small_launch": ([_P] * 6 + [_I] * 4 + [_P] * 8, _I),
        "fused_runs_workspace_bytes": ([_I, _I], _SZ),
        "fused_runs_launch": ([_P] * 7 + [_I] * 4 + [_P] * 5 + [_SZ, _P],
                              _I),
    },
    "segment_minmax": {
        "segment_minmax_launch": ([_P, _P, _P, _LL, _I, _I, _I, _I, _P], _I),
    },
    "spmv_ell": {
        "spmv_ell_workspace_bytes": ([_LL, _I], _SZ),
        "spmv_ell_launch": ([_P, _P, _P, _LL, _I, _P, _SZ, _P], _I),
    },
    "flash_attention": {
        "flash_attention_launch": ([_P] * 4 + [_I] * 9 + [_F, _P], _I),
    },
}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
build_seconds: float = 0.0        # wall time of the last build_all()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on the "
                       "machine with the card (PATH or CUDA_HOME)")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(_CSRC.iterdir()):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _lib_path(name: str, digest: str) -> Path:
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build_all() -> float:
    """Compile every source not yet built, all ``nvcc`` processes at once.

    Returns the seconds spent; raises with the compiler's output on failure.
    The ptxas report (registers, shared memory, spills) is kept beside each
    library as ``<lib>.log``.
    """
    global build_seconds
    t0 = time.perf_counter()
    digest = _digest()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = [n for n in SOURCES if not _lib_path(n, digest).exists()]
    if todo:
        nvcc = _nvcc()
        procs = {}
        for name in todo:
            tmp = BUILD_DIR / f".lib{name}-{digest}.{os.getpid()}.so"
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(_CSRC), "-o", str(tmp),
                   str(_CSRC / f"{name}.cu")]
            procs[name] = (tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
        failed = []
        for name, (tmp, proc) in procs.items():
            out, _ = proc.communicate()
            final = _lib_path(name, digest)
            final.with_suffix(".log").write_text(out)
            if proc.returncode != 0:
                failed.append(f"--- {name}.cu (rc {proc.returncode})\n{out}")
                continue
            os.replace(tmp, final)
        jitcache.count_compile(len(todo), time.perf_counter() - t0)
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    build_seconds = time.perf_counter() - t0
    return build_seconds


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building all on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        build_all()
        lib = ctypes.CDLL(str(_lib_path(name, _digest())))
        for fn, (argtypes, restype) in _SIGNATURES[name].items():
            f = getattr(lib, fn)
            f.argtypes = argtypes
            f.restype = restype
        lib.repro_error_string.argtypes = [_I]
        lib.repro_error_string.restype = ctypes.c_char_p
        _libs[name] = lib
        jitcache.count_trace(f"build:{name}")
        return lib


def reset(build_dir=None) -> None:
    """Forget the loaded libraries, and with ``build_dir`` build into that
    directory from now on: the next use of each kernel loads it again (and
    builds it, in an empty directory), as in a fresh process."""
    global BUILD_DIR
    with _lock:
        _libs.clear()
        if build_dir is not None:
            BUILD_DIR = Path(build_dir)


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error."""
    if rc != 0:
        msg = lib.repro_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def stream_ptr(device) -> int:
    """PyTorch's current stream on ``device``, as the launchers take it."""
    return torch.cuda.current_stream(device).cuda_stream
