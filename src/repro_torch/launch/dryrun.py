"""Dry-run of every (arch x shape) cell on ``meta`` tensors, for one H100.

Counterpart of ``repro.launch.dryrun``, which lowers and compiles each
step on a TPU mesh of 256 or 512 chips and reads XLA's cost and memory
analyses.  Here each step runs once, eagerly, on ``meta`` tensors
(``launch.steps.input_specs``): nothing is allocated and nothing is
timed, but every op the step dispatches on the card is dispatched, at the
cell's shapes, and counted:

- ``flops``: ``torch.utils.flop_counter.FlopCounterMode``'s total (matrix
  products and the flash op, by its formula; elementwise work is not
  counted, as XLA's cost analysis counts it only in part);
- ``bytes``: the bytes every op that is not a view reads and writes (each
  tensor argument and result once; :class:`Traffic`);
- ``memory``: ``argument_size``, the bytes the step's arguments hold;
  ``output_size``, the bytes of the new storages its result holds;
  ``temp_size``, the peak of the storages the step allocated, less the
  output, so that the three add up to the predicted peak.  Storages are
  keyed by identity and freed when they die, as the caching allocator
  frees them (it rounds each block up to 512 bytes; this count does not).

The record keeps the reference's keys (``arch``, ``shape``, ``mesh``,
``tag``, ``devices``, ``cycles``, ``full``), so that ``launch.roofline``
reads it as the reference's reads its own: ``devices`` is 1, ``coll`` is
empty (one card has no collectives), and ``trace_s`` (the seconds of the
run on ``meta``) stands for ``lower_s``; there is no ``compile_s``.  An
eager run counts every layer, so the reference's layer probes are not
needed.  A config with token-loop blocks (``mlstm``, ``slstm``: xLSTM
steps its tokens one at a time in Python) is run at two short lengths
instead (:data:`PROBE_LENS`) and extrapolated linearly to S: its record
carries ``probe1``, ``probe2`` and ``estimated``, as the reference's
records do, and ``full`` holds the extrapolated counts.  Records go to
the git-ignored ``build/dryrun/<arch>__<shape>__h100x1__<tag>.json``.

  python -m repro_torch.launch.dryrun --arch qwen3_1_7b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--skip-existing]
  python -m repro_torch.launch.dryrun --arch chameleon_34b --shape \\
      train_4k --tag remat_dots --set remat=dots

``--multi-pod`` (the reference's 2 x 16 x 16 mesh) raises: the ranks and
their exchange exist (``repro_torch.core.distributed.RankMesh``,
``launch.mesh.make_production_mesh``), but the port has no GSPMD, so the
LM itself is not sharded across cards; only the MoE's ``a2a`` layer
splits its experts over ranks (ROADMAP.md Queue 1).
"""
from __future__ import annotations

import argparse
import json
import multiprocessing
import sys
import threading
import time
import traceback
import weakref
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path
from typing import Any, Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

ART = Path(__file__).resolve().parents[3] / "build" / "dryrun"
MESH = "h100x1"
# the lengths a token-loop config is run at; S must be a multiple of the
# first for the extrapolation to stay in integers
PROBE_LENS = (8, 16)
TOKEN_LOOP_KINDS = ("mlstm", "slstm")


def _tensors(tree, out=None) -> list:
    """The tensors of ``tree`` (nested tuples, lists and dicts), a
    module's parameters and buffers included."""
    out = [] if out is None else out
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            _tensors(x, out)
    elif isinstance(tree, dict):
        for x in tree.values():
            _tensors(x, out)
    elif isinstance(tree, torch.nn.Module):
        out.extend(tree.parameters())
        out.extend(tree.buffers())
    return out


def _storages(tree) -> Dict[int, int]:
    return {t.untyped_storage()._cdata: t.untyped_storage().nbytes()
            for t in _tensors(tree)}


def storage_bytes(tree, exclude=()) -> int:
    """Bytes of the distinct storages the tensors of ``tree`` hold, less
    those ``exclude``'s tensors hold."""
    held = _storages(exclude)
    return sum(n for k, n in _storages(tree).items() if k not in held)


class Traffic(TorchDispatchMode):
    """Counts, over the ops dispatched inside it, the bytes each op that is
    not a view reads and writes (``bytes``), and the bytes of the storages
    they allocate that are alive (``live``) and at most alive (``peak``).
    Storages of ``held`` (the step's arguments) are not counted as
    allocated.  A storage is freed when the last tensor on it dies, which
    autograd's engine may do on its own thread."""

    def __init__(self, held=()):
        super().__init__()
        self.bytes = self.live = self.peak = 0
        self._keys = {t.untyped_storage()._cdata for t in _tensors(held)}
        self._lock = threading.RLock()

    def _free(self, key: int, n: int) -> None:
        with self._lock:
            self._keys.discard(key)
            self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = _tensors(out)
        with self._lock:
            if not func.is_view:
                self.bytes += sum(t.nbytes for t in _tensors((args, kwargs)))
                self.bytes += sum(t.nbytes for t in outs)
            for t in outs:
                st = t.untyped_storage()
                key = st._cdata
                if key in self._keys:
                    continue
                self._keys.add(key)
                n = st.nbytes()
                self.live += n
                self.peak = max(self.peak, self.live)
                weakref.finalize(st, self._free, key, n)
        return out


def trace_step(step, args) -> Dict[str, Any]:
    """Run ``step(*args)`` once under the counters; the reference's
    ``_compile_once`` record, with ``trace_s`` for ``lower_s``."""
    traffic = Traffic(args)
    flops = FlopCounterMode(display=False)
    t0 = time.perf_counter()
    with flops, traffic:
        out = step(*args)
    trace_s = time.perf_counter() - t0
    output = storage_bytes(out, exclude=args)
    del out
    return {
        "trace_s": round(trace_s, 3),
        "flops": float(flops.get_total_flops()),
        "bytes": float(traffic.bytes),
        "coll": {},
        "memory": {"argument_size": storage_bytes(args),
                   "output_size": output,
                   "temp_size": max(traffic.peak - output, 0)},
    }


def has_token_loop(cfg) -> bool:
    return any(k in TOKEN_LOOP_KINDS for k in cfg.layer_kinds)


def _extrapolate(a: float, b: float, s: int) -> float:
    """The affine count through (PROBE_LENS[0], a) and (PROBE_LENS[1], b)
    at ``s``."""
    p1, p2 = PROBE_LENS
    return float(int(a) + (int(b) - int(a)) * (s - p1) // (p2 - p1))


def dryrun(cfg, cell, tag: str = "baseline", arch: Optional[str] = None
           ) -> Dict[str, Any]:
    """The record of one cell: ``cfg`` at ``cell`` (a ``ShapeCell``) on
    ``meta``, probed along tokens where the config has token-loop blocks
    and the cell runs a whole sequence."""
    from repro_torch.launch.steps import input_specs
    from repro_torch.models.config import ShapeCell
    rec = {"arch": arch or cfg.name, "shape": cell.name, "mesh": MESH,
           "tag": tag, "devices": 1, "cycles": cfg.cycles,
           "cell": {"seq_len": cell.seq_len,
                    "global_batch": cell.global_batch, "kind": cell.kind}}
    if cell.kind == "decode" or not has_token_loop(cfg):
        rec["full"] = trace_step(*input_specs(cfg, cell))
        return rec
    s = cell.seq_len
    if s % PROBE_LENS[0] or s < PROBE_LENS[1]:
        raise ValueError(f"{cfg.name}: S {s} is not a multiple of the probe "
                         f"length {PROBE_LENS[0]} of at least "
                         f"{PROBE_LENS[1]}")
    probes = []
    for p in PROBE_LENS:
        pcell = ShapeCell(cell.name, p, cell.global_batch, cell.kind)
        probes.append({"seq_len": p,
                       **trace_step(*input_specs(cfg, pcell))})
    p1, p2 = probes
    est = {"flops_per_device": _extrapolate(p1["flops"], p2["flops"], s),
           "bytes_per_device": _extrapolate(p1["bytes"], p2["bytes"], s),
           "collective_bytes_per_device": {}}
    _, args = input_specs(cfg, cell)
    memory = {k: _extrapolate(p1["memory"][k], p2["memory"][k], s)
              for k in ("output_size", "temp_size")}
    rec["full"] = {"trace_s": round(p1["trace_s"] + p2["trace_s"], 3),
                   "flops": est["flops_per_device"],
                   "bytes": est["bytes_per_device"], "coll": {},
                   "memory": {"argument_size": storage_bytes(args),
                              **memory}}
    rec.update(probe1=p1, probe2=p2, estimated=est)
    return rec


def record_path(arch: str, shape: str, tag: str) -> Path:
    return ART / f"{arch}__{shape}__{MESH}__{tag}.json"


def dryrun_cell(arch: str, shape: str, overrides=None,
                tag: str = "baseline") -> Dict[str, Any]:
    """Dry-run ``arch`` at the cell ``shape`` (a name of ``SHAPES``), with
    ``overrides`` for its config, and write its record."""
    import repro_torch.configs as C
    from repro_torch.models.config import SHAPES
    cfg = C.get(arch)
    if overrides:
        cfg = cfg.replace(**overrides)
    rec = dryrun(cfg, SHAPES[shape], tag, arch)
    full = rec["full"]
    probed = " (probed at S " + ", ".join(
        str(rec[k]["seq_len"]) for k in ("probe1", "probe2")) + ")" \
        if "estimated" in rec else ""
    print(f"[{arch} x {shape} x {MESH} x {tag}] trace {full['trace_s']:.2f} "
          f"s{probed}: flops {full['flops']:.4g} bytes {full['bytes']:.4g} "
          f"memory {full['memory']}", flush=True)
    ART.mkdir(parents=True, exist_ok=True)
    record_path(arch, shape, tag).write_text(json.dumps(rec, indent=1))
    return rec


def parse_overrides(pairs) -> Dict[str, Any]:
    """``key=value`` pairs, each value an int, a float or else a string."""
    overrides = {}
    for kv in pairs:
        k, v = kv.split("=", 1)
        for conv in (int, float):
            try:
                v = conv(v)
                break
            except ValueError:
                continue
        overrides[k] = v
    return overrides


def _run_cell(job):
    """One cell of ``--all`` in a worker: (arch, shape, seconds, the
    traceback or None)."""
    arch, shape, overrides, tag = job
    t0 = time.perf_counter()
    try:
        dryrun_cell(arch, shape, overrides, tag)
        err = None
    except Exception:               # report every cell, then fail
        err = traceback.format_exc()
    return arch, shape, time.perf_counter() - t0, err


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true",
                    help="not ported: the LM is not sharded across "
                         "cards")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--tag", default="baseline")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--set", nargs="*", default=[],
                    help="config overrides: key=value (int/float/str)")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells traced at once, each in a process of its "
                         "own")
    args = ap.parse_args(argv)
    if args.multi_pod:
        raise NotImplementedError(
            "--multi-pod: the LM sharded across cards is not ported (the "
            "port has no GSPMD; ranks and the MoE's a2a layer exist, but "
            "every other weight would be replicated on each card); see "
            "ROADMAP.md Queue 1")
    import repro_torch.configs as C
    if args.all:
        cells = C.all_cells()
    elif args.arch and args.shape:
        cells = [(args.arch, args.shape)]
    else:
        ap.error("give --arch and --shape, or --all")
    overrides = parse_overrides(args.set) or None
    jobs = []
    for arch, shape in cells:
        if args.skip_existing and record_path(arch, shape, args.tag).exists():
            print(f"skip {arch} x {shape} (exists)")
            continue
        jobs.append((arch, shape, overrides, args.tag))
    if args.jobs > 1 and len(jobs) > 1:
        # a worker that dies breaks the pool (and raises) instead of being
        # replaced; spawned workers import this module, not the caller's
        with ProcessPoolExecutor(
                min(args.jobs, len(jobs)),
                mp_context=multiprocessing.get_context("spawn")) as pool:
            done = list(pool.map(_run_cell, jobs))
    else:
        done = [_run_cell(job) for job in jobs]
    failures = []
    for arch, shape, secs, err in done:
        print(f"  {arch} x {shape}: {secs:.2f} s")
        if err is not None:
            print(err)
            failures.append((arch, shape, err.strip().splitlines()[-1][:200]))
    if failures:
        print("FAILURES:")
        for f in failures:
            print(" ", f)
        return 1
    print("dry-run complete")
    return 0


if __name__ == "__main__":
    sys.exit(main())
