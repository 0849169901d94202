#!/usr/bin/env python3
"""What one ``RankMesh.psum`` of the tensor-parallel LM costs on gloo, on a
CUDA card.

    python3 tools/psum_probe.py [--ranks 4] [--reps 20]

Starts ``--ranks`` processes on gloo (``file://`` rendezvous), all on
``cuda:0`` as ``chip_smoke.py`` phase 15 runs them, each holding one
partial of Gemma 2 9B's layer output at phase 15 (e)'s prefill, [1,
2048, 3584] bf16, and times (median of ``--reps`` after 3 warm-ups, each
started after a barrier) four ways of moving the same bytes:

  * ``stacked``: ``RankMesh.psum``'s own staging: the bytes copied to
    pageable host memory, ``all_gather`` into a list, stacked, copied
    back, added on the card in float32 in rank order;
  * ``pinned``: the bytes through pinned buffers and one
    ``all_gather_into_tensor``, added on the card;
  * ``host_sum``: as ``pinned``, added on the host, the sum copied back;
  * ``wire``: the ``all_gather_into_tensor`` of the pinned bytes alone.

The three sums are checked bit for bit against each other.  Prints the
card's name and power limit, then one line of seconds.  Imports neither
JAX nor the JAX package.
"""
from __future__ import annotations

import argparse
import os
import statistics
import subprocess
import tempfile
import time

import torch
import torch.distributed as tdist
import torch.multiprocessing as mp

SHAPE = (1, 2048, 3584)


def _probe(rank: int, world: int, path: str, reps: int) -> None:
    tdist.init_process_group("gloo", init_method=f"file://{path}",
                             rank=rank, world_size=world)
    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev).manual_seed(rank)
    t = torch.randn(SHAPE, generator=gen, device=dev).bfloat16()
    nbytes = t.numel() * t.element_size()
    send = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    recv = torch.empty(world * nbytes, dtype=torch.uint8, pin_memory=True)

    def add(parts: torch.Tensor) -> torch.Tensor:
        acc = parts[0].float()
        for p in parts[1:]:
            acc += p
        return acc.bfloat16()

    def stacked():
        w = t.contiguous().view(torch.uint8).cpu()
        parts = [torch.empty_like(w) for _ in range(world)]
        tdist.all_gather(parts, w)
        return add(torch.stack(parts).to(dev).view(torch.bfloat16))

    def gather_pinned() -> torch.Tensor:
        send.copy_(t.reshape(-1).view(torch.uint8))
        tdist.all_gather_into_tensor(recv, send)
        return recv.view(torch.bfloat16).view((world,) + SHAPE)

    def pinned():
        return add(gather_pinned().to(dev, non_blocking=True))

    def host_sum():
        return add(gather_pinned()).to(dev)

    def wire():
        tdist.all_gather_into_tensor(recv, send)

    secs, ref = {}, None
    for name, fn in (("stacked", stacked), ("pinned", pinned),
                     ("host_sum", host_sum), ("wire", wire)):
        runs = []
        for _ in range(reps + 3):
            torch.cuda.synchronize(dev)
            tdist.barrier()
            t0 = time.perf_counter()
            y = fn()
            torch.cuda.synchronize(dev)
            runs.append(time.perf_counter() - t0)
        if y is not None:
            ref = y if ref is None else ref
            assert torch.equal(y.cpu(), ref.cpu()), name
        secs[name] = statistics.median(runs[3:])
    if rank == 0:
        print(f"torch {torch.__version__}, {world} gloo ranks on one card, "
              f"[1, 2048, 3584] bf16, median s: {secs}", flush=True)
    tdist.destroy_process_group()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("psum_probe: needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    with tempfile.TemporaryDirectory() as d:
        mp.spawn(_probe, args=(args.ranks, os.path.join(d, "rv"),
                               args.reps), nprocs=args.ranks)


if __name__ == "__main__":
    main()
