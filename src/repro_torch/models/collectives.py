"""Collectives with a backward, for a model cut for one rank of a mesh.

A model cut by ``models.shard`` writes its collectives out
(``RankMesh.psum``, ``all_gather``, ``all_to_all``; on ``meta``, a
``launch.mesh.MetaMesh``'s ``psum`` and ``all_gather``, which count their
bytes).  Training needs the
adjoint of each, and which adjoint is right depends on how the output is
used, not on the collective alone.  Every function here calls only the
mesh's own collectives, so that the same code runs on a ``RankMesh`` and
on a ``MetaMesh``, whose backward collectives are then counted too:

- :func:`reduce_out`: a sum over ``axes`` whose output every rank of the
  axes uses alike (a row-parallel product's partials, the vocab-parallel
  embedding, the loss's sums over the vocabulary, the reported loss over
  the batch's axes).  The backward is the identity: each rank's partial
  entered the sum once.
- :func:`split_in`: a tensor that every rank of ``axes`` holds alike (a
  replicated activation or parameter) entering the rank's share of split
  work (its heads, ``d_ff`` columns, experts or vocabulary rows).  The
  forward is the identity; the backward sums the ranks' partial
  gradients over ``axes``, so that every rank holds the whole.
- :func:`reduce_own_rows`: the MoE's sum over ``axes`` of a whole
  batch's output [n, b, ...], of which each rank keeps its own block of
  rows.  The ranks downstream use different rows, so the gradient of the
  sum is every block's gradient stacked: an ``all_gather`` over the
  batch's ``rows`` axes.
- :func:`gather_rows`: the ranks' rows gathered over ``rows`` into the
  whole batch, on which each rank does its share of the MoE's work.  The
  backward sums the ranks' partial gradients over ``axes`` (every axis
  that split that work) and keeps the rank's own block.
- :func:`gather_alike`: an ``all_gather`` over the world whose output
  every rank uses alike (the a2a path's output blocks): the backward
  keeps the rank's own block of the gradient.
- :func:`exchange`: ``all_to_all``; its adjoint is the reverse
  ``all_to_all``.

Serving calls the same functions: without autograd recording
(``inference_mode``, or no input that needs a gradient) each is its
forward, the collective alone.
"""
from __future__ import annotations

from typing import Tuple

import torch


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axes):
        return mesh.psum(t, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.psum(g, ctx.axes), None, None


class _ReduceOwnRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axes, rows, own):
        ctx.mesh, ctx.rows = mesh, rows
        return mesh.psum(t, axes)[own] if axes else t[own].clone()

    @staticmethod
    def backward(ctx, g):
        whole = ctx.mesh.all_gather(g, ctx.rows) if ctx.rows else g[None]
        return whole, None, None, None, None


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, rows, axes, own):
        ctx.mesh, ctx.axes, ctx.own = mesh, axes, own
        return mesh.all_gather(t, rows) if rows else t[None].clone()

    @staticmethod
    def backward(ctx, g):
        if ctx.axes:
            g = ctx.mesh.psum(g, ctx.axes)
        return g[ctx.own], None, None, None, None


class _GatherAlike(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh):
        ctx.own = mesh.rank
        return mesh.all_gather(t)

    @staticmethod
    def backward(ctx, g):
        return g[ctx.own], None


class _Exchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, send, mesh, axes):
        ctx.mesh, ctx.axes, ctx.shape = mesh, axes, send.shape
        return mesh.all_to_all(send, axes)

    @staticmethod
    def backward(ctx, g):
        back = ctx.mesh.all_to_all(g.reshape(ctx.shape), ctx.axes)
        return back.reshape(ctx.shape), None, None


def reduce_out(mesh, t: torch.Tensor, axes: Tuple[str, ...]) -> torch.Tensor:
    """``mesh.psum(t, axes)``; its backward the identity (no axes: ``t``)."""
    if not axes:
        return t
    return _Reduce.apply(t, mesh, tuple(axes))


def split_in(mesh, t: torch.Tensor, axes: Tuple[str, ...]) -> torch.Tensor:
    """``t`` itself; its backward the sum of the gradient over ``axes``."""
    if not axes:
        return t
    return _Split.apply(t, mesh, tuple(axes))


def reduce_own_rows(mesh, t: torch.Tensor, axes: Tuple[str, ...],
                    rows: Tuple[str, ...], own: int) -> torch.Tensor:
    """``t`` [n, b, ...], the partials of the whole batch's n blocks of
    rows (in the order of ``rows``), summed over ``axes``; returns block
    ``own`` [b, ...].  Backward: the blocks' gradients gathered over
    ``rows``, the same on every rank."""
    return _ReduceOwnRows.apply(t, mesh, tuple(axes), tuple(rows), own)


def gather_rows(mesh, t: torch.Tensor, rows: Tuple[str, ...],
                axes: Tuple[str, ...], own: int) -> torch.Tensor:
    """The rank's rows ``t`` [b, ...] gathered over ``rows``: [n, b, ...]
    (``t[None]`` without rows).  Backward: the gradient summed over
    ``axes``, block ``own``."""
    return _GatherRows.apply(t, mesh, tuple(rows), tuple(axes), own)


def gather_alike(mesh, t: torch.Tensor) -> torch.Tensor:
    """``mesh.all_gather(t)`` over the world; backward, the rank's own
    block of the gradient."""
    return _GatherAlike.apply(t, mesh)


def exchange(mesh, send: torch.Tensor, axes: Tuple[str, ...]) -> torch.Tensor:
    """``mesh.all_to_all(send, axes)``; backward, the reverse
    ``all_to_all``."""
    return _Exchange.apply(send, mesh, tuple(axes))


def tally(mesh) -> dict:
    """What ``mesh`` has counted so far: a ``RankMesh``'s ``stats`` (the
    seconds and calls of its ``psum`` and ``all_gather``), a
    ``MetaMesh``'s ``coll`` (its collectives' output bytes by kind)."""
    return dict(mesh.stats if hasattr(mesh, "stats") else mesh.coll)


def tally_since(mesh, before: dict) -> dict:
    """:func:`tally` less ``before``."""
    return {k: v - before.get(k, 0) for k, v in tally(mesh).items()}
