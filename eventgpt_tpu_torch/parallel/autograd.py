"""The mesh's collectives as autograd Functions: the gradients GSPMD derives.

The JAX package gets every gradient of a sharded program from ``jax.grad``:
GSPMD transposes each collective it inserted. The port's ranks call the
collectives themselves (``parallel/mesh.Mesh``), and a plain collective
cuts the autograd graph, so each collective a gradient crosses is one of
these Functions, its backward the transpose of its forward:

  * ``copy_to(x, mesh, axis)`` -- forward the identity, backward an
    all-reduce over ``axis``. It goes on the (replicated) input of a
    column-parallel product: each rank's columns give a partial gradient
    of the input.
  * ``reduce_from(x, mesh, axis)`` -- forward an all-reduce over ``axis``,
    backward the identity: the row-parallel products (``o``, ``down``)
    and the vocab-parallel embedding lookup.
  * ``gather_from(x, mesh, axis, dim)`` -- forward an all-gather along
    ``dim``, backward the rank's own block of the (replicated) gradient:
    the lm_head's logits gathered over ``model``.
  * ``all_to_all(x, mesh, axis, split_dim, concat_dim)`` -- backward the
    inverse exchange (``split_dim`` and ``concat_dim`` swapped).
  * ``ppermute(x, mesh, axis, shift)`` -- backward ``ppermute(-shift)``.

On an axis of size 1 each returns its input, and on a tensor that does
not require grad it is the plain collective (the serving path). ``torch.distributed.nn``'s
all-reduce all-reduces its gradient again (on a replicated gradient that
multiplies it by the axis size), and ``Mesh.all_reduce`` cuts the graph:
neither belongs on a gradient's path.
"""

from __future__ import annotations

import torch


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce(g.clone(), ctx.axis), None, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        return mesh.all_reduce(x.clone(), axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim, ctx.size = mesh, axis, dim, x.shape[dim]
        return mesh.all_gather(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        i = ctx.mesh.coord[ctx.axis]
        return g.narrow(ctx.dim, i * ctx.size, ctx.size).contiguous(), None, None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, split_dim, concat_dim):
        ctx.mesh, ctx.axis, ctx.split, ctx.concat = mesh, axis, split_dim, concat_dim
        return mesh.all_to_all(x, axis, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        return (ctx.mesh.all_to_all(g.contiguous(), ctx.axis, ctx.concat, ctx.split),
                None, None, None, None)


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, shift):
        ctx.mesh, ctx.axis, ctx.shift = mesh, axis, shift
        return mesh.ppermute(x, axis, shift)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.ppermute(g.contiguous(), ctx.axis, -ctx.shift), None, None, None


def _trivial(mesh, axis: str) -> bool:
    return mesh is None or mesh.shape[axis] == 1


def _graph(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def copy_to(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    if _trivial(mesh, axis) or not _graph(x):
        return x
    return _CopyTo.apply(x, mesh, axis)


def reduce_from(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    if _trivial(mesh, axis):
        return x
    return _ReduceFrom.apply(x, mesh, axis) if _graph(x) else mesh.all_reduce(x, axis)


def gather_from(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    if _trivial(mesh, axis):
        return x
    return _GatherFrom.apply(x, mesh, axis, dim) if _graph(x) else mesh.all_gather(x, axis, dim)


def all_to_all(x: torch.Tensor, mesh, axis: str, split_dim: int, concat_dim: int) -> torch.Tensor:
    if _trivial(mesh, axis):
        return x
    if _graph(x):
        return _AllToAll.apply(x, mesh, axis, split_dim, concat_dim)
    return mesh.all_to_all(x, axis, split_dim, concat_dim)


def ppermute(x: torch.Tensor, mesh, axis: str, shift: int = 1) -> torch.Tensor:
    if _trivial(mesh, axis):
        return x
    return _PPermute.apply(x, mesh, axis, shift) if _graph(x) else mesh.ppermute(x, axis, shift)
