"""The card's constants, read by the roofline and the chip smoke test, and
the mesh makers.

Counterpart of ``repro.launch.mesh``.  The constants are one NVIDIA H100
SXM's, from NVIDIA's data sheet (dense rates, no sparsity, at the full
700 W power limit; a card set below it runs slower under load), in place
of the reference's TPU v5e ones.  The mesh makers build the reference's
shapes as a ``repro_torch.core.distributed.RankMesh`` over the current
process group, one rank a card (or a CPU process): the caller starts the
ranks (``repro_torch.launch.ranks.run_ranks``) and initialises the group,
and picks each rank's device and the backend.
"""
from __future__ import annotations

import math

# bf16 (and fp16) on the tensor cores, dense: the rate charged for matrix
# products and attention
PEAK_FLOPS = 989e12
# float32 outside the tensor cores: the rate charged for the engine
# kernels' adds and key compares
PEAK_F32_FLOPS = 67e12
# HBM3, bytes a second
HBM_BW = 3.35e12
# NVLink 4, bytes a second each way between two cards: read only by the
# roofline's collective term, which is 0 on one card
LINK_BW = 450e9

PRODUCTION = {"data": 16, "model": 16}
MULTI_POD = {"pod": 2, "data": 16, "model": 16}
SINGLE_POD_WITH_POD_AXIS = {"pod": 1, "data": 16, "model": 16}


def host_mesh_shape(n: int = 8, axes=("data", "model")) -> dict:
    """The reference's ``make_host_mesh`` shape: (2, n/2) on two axes,
    (1, 2, n/2) on three."""
    sizes = (2, n // 2) if len(axes) == 2 else (1, 2, n // 2)
    if len(axes) not in (2, 3) or math.prod(sizes) != n:
        raise ValueError(f"a host mesh takes 2 or 3 axes and an even n, "
                         f"got {n} over {tuple(axes)}")
    return dict(zip(axes, sizes))


def _rank_mesh(shape: dict, device, backend: str, what: str):
    import torch.distributed as tdist
    from repro_torch.core.distributed import RankMesh
    need = math.prod(shape.values())
    have = tdist.get_world_size() if tdist.is_initialized() else None
    if have != need:
        raise ValueError(f"{what} {shape} needs a process group of {need} "
                         f"ranks; this process's group has "
                         f"{have if have is not None else 'none'}")
    return RankMesh(shape, device=device, backend=backend)


def make_production_mesh(*, multi_pod: bool = False, device,
                         backend: str = "nccl"):
    """(16, 16) over ("data", "model"), or (2, 16, 16) with "pod" first:
    256 or 512 ranks."""
    return _rank_mesh(MULTI_POD if multi_pod else PRODUCTION, device,
                      backend, "make_production_mesh")


def make_single_pod_with_pod_axis(*, device, backend: str = "nccl"):
    """(1, 16, 16), so that the ("pod", "data", "model") rules hold on one
    pod."""
    return _rank_mesh(SINGLE_POD_WITH_POD_AXIS, device, backend,
                      "make_single_pod_with_pod_axis")


def make_host_mesh(n: int = 8, axes=("data", "model"), *, device="cpu",
                   backend: str = "gloo"):
    """The reference's small test mesh (:func:`host_mesh_shape`) over ``n``
    ranks."""
    return _rank_mesh(host_mesh_shape(n, axes), device, backend,
                      "make_host_mesh")
