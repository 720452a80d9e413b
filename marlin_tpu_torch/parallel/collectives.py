"""Collectives over a mesh axis, for the multi-rank strategies.

The JAX package's ``shard_map`` programs move data with ``lax.ppermute``,
``lax.psum``, ``lax.all_to_all`` and an output sharding that gathers the
result; here each is a ``torch.distributed`` call over the process group of
one mesh axis (:meth:`~marlin_tpu_torch.mesh.Mesh.group`). The autograd
functions make them differentiable under the port's *logical in/out*
contract: every rank holds the same logical inputs and computes the same
loss from the same logical output, so

- :class:`Scatter` (take this rank's block of a replicated tensor) has the
  gather of the blocks' gradients as its backward;
- :class:`Gather` (join every rank's block into the replicated tensor) has
  the cut of this rank's block of the gradient as its backward;
- :class:`AllReduce` sums over the axis, and its backward is the identity
  (the gradient of a replicated output is the same on every rank), the
  transpose of ``psum`` under ``shard_map``;
- :class:`Replicate` is the identity on a replicated tensor that each rank
  feeds into its own share of a function (the shares then summed by
  :class:`AllReduce`), and its backward sums the shares' gradients, so each
  rank holds the whole gradient again;
- :class:`AllToAll` re-splits a tensor across ranks, and its backward is
  the inverse all-to-all;
- :class:`Shift` sends to the next rank of the axis and receives from the
  previous one (``ppermute`` by +1, not wrapping), and its backward sends
  the gradient the other way.

bf16 tensors travel as their bytes (a uint8 view of the last dimension),
since gloo moves some dtypes only.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..mesh import Sharding

__all__ = ["Scatter", "Gather", "AllReduce", "Replicate", "AllToAll", "Shift",
           "all_gather_cat", "all_reduce_sum", "all_reduce_leaves", "block",
           "ring_send_recv", "finish", "mesh_index", "all_gather_mesh",
           "all_reduce_mesh"]


def _bits(t: torch.Tensor) -> torch.Tensor:
    t = t.contiguous()
    return t.view(torch.uint8) if t.dtype == torch.bfloat16 else t


def _unbits(t: torch.Tensor, dtype) -> torch.Tensor:
    return t.view(dtype) if dtype == torch.bfloat16 else t


def all_gather_cat(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """Every rank's ``x`` along ``axis``, joined in axis order along ``dim``."""
    if mesh.shape[axis] == 1 and mesh.ranks is None:
        return x
    b = _bits(x)
    parts = [torch.empty_like(b) for _ in range(mesh.shape[axis])]
    dist.all_gather(parts, b, group=mesh.group(axis))
    return torch.cat([_unbits(p, x.dtype) for p in parts], dim=dim)


def block(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """This rank's block of ``x`` along ``dim`` (split over ``axis``)."""
    spec = [None] * x.ndim
    spec[dim] = axis
    return Sharding(mesh, tuple(spec)).local(x)


def ring_send_recv(tensors, mesh, axis: str, tag0: int = 0):
    """Start sending ``tensors`` to the next rank along ``axis`` (wrapping)
    and receiving as many from the previous one, tagged from ``tag0`` (two
    rotations in flight at once take apart tags). Returns ``(received,
    works)``; call :func:`finish` on them before reading ``received``."""
    line = mesh.line(axis)
    i = mesh.index(axis)
    p = len(line)
    to, frm = line[(i + 1) % p], line[(i - 1) % p]
    group = mesh.group(axis)
    ops, recv = [], []
    for tag, t in enumerate(tensors, tag0):
        b = _bits(t)
        r = torch.empty_like(b)
        ops.append(dist.P2POp(dist.isend, b, to, group, tag))
        ops.append(dist.P2POp(dist.irecv, r, frm, group, tag))
        recv.append((r, t.dtype))
    return recv, dist.batch_isend_irecv(ops)


def finish(recv, works) -> list[torch.Tensor]:
    """Wait for :func:`ring_send_recv` and return what arrived."""
    for w in works:
        w.wait()
    return [_unbits(r, dt) for r, dt in recv]


class Scatter(torch.autograd.Function):
    """``Scatter.apply(x, mesh, axis, dim)``: this rank's block of the
    replicated ``x`` along ``dim``; backward gathers the blocks' gradients."""

    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.meta = (mesh, axis, dim)
        return block(x, mesh, axis, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        mesh, axis, dim = ctx.meta
        return all_gather_cat(g.contiguous(), mesh, axis, dim), None, None, \
            None


class Gather(torch.autograd.Function):
    """``Gather.apply(x, mesh, axis, dim)``: every rank's block joined along
    ``dim``; backward keeps this rank's block of the gradient."""

    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.meta = (mesh, axis, dim)
        return all_gather_cat(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, dim = ctx.meta
        return block(g, mesh, axis, dim).contiguous(), None, None, None


def all_reduce_sum(x, mesh, axis: str) -> torch.Tensor:
    """The sum of every rank's ``x`` along ``axis`` (a new tensor)."""
    x = x.contiguous().clone()
    dist.all_reduce(x, group=mesh.group(axis))
    return x


class AllReduce(torch.autograd.Function):
    """``AllReduce.apply(x, mesh, axis)``: the sum of every rank's ``x``;
    backward passes the (replicated) gradient through."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        return all_reduce_sum(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class Replicate(torch.autograd.Function):
    """``Replicate.apply(x, mesh, axis)``: ``x`` itself, for a rank that
    computes its share of a function of the replicated ``x``; backward sums
    the shares' gradients over the axis."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.meta = (mesh, axis)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        mesh, axis = ctx.meta
        return all_reduce_sum(g, mesh, axis), None, None


def all_reduce_leaves(tensors, mesh, axis: str) -> list:
    """Each tensor summed over ``axis``, in one flat all-reduce a dtype: the
    tensors are joined in the order given (every rank must pass the same
    shapes in the same order), reduced, and cut apart again."""
    out = list(tensors)
    for dt in dict.fromkeys(t.dtype for t in out):
        idx = [i for i, t in enumerate(out) if t.dtype == dt]
        flat = all_reduce_sum(torch.cat([out[i].reshape(-1) for i in idx]),
                              mesh, axis)
        for i, part in zip(idx, flat.split([out[i].numel() for i in idx])):
            out[i] = part.view_as(out[i])
    return out


def mesh_index(mesh) -> int:
    """This rank's position in the mesh's row-major order of ranks (0 in a
    world of one)."""
    return 0 if mesh.ranks is None else mesh.ranks.index(dist.get_rank())


def all_gather_mesh(x: torch.Tensor, mesh, dim: int) -> torch.Tensor:
    """Every rank's ``x`` joined along ``dim`` in the mesh's row-major rank
    order: the gather over each axis in turn, the last axis first."""
    for axis in reversed(mesh.axis_names):
        x = all_gather_cat(x, mesh, axis, dim)
    return x


def all_reduce_mesh(x: torch.Tensor, mesh) -> torch.Tensor:
    """The sum of every rank's ``x`` over the whole mesh."""
    for axis in mesh.axis_names:
        x = all_reduce_sum(x, mesh, axis)
    return x


def _all_to_all(x, mesh, axis):
    b = _bits(x)
    out = torch.empty_like(b)
    dist.all_to_all_single(out, b, group=mesh.group(axis))
    return _unbits(out, x.dtype)


class AllToAll(torch.autograd.Function):
    """``AllToAll.apply(x, mesh, axis)``: ``x`` is ``(p, ...)``; block ``j``
    goes to rank ``j`` of ``axis``, and block ``j`` of the result came from
    rank ``j``. Its own inverse, so also its backward."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.meta = (mesh, axis)
        return _all_to_all(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        mesh, axis = ctx.meta
        return _all_to_all(g, mesh, axis), None, None


def _shift(x, mesh, axis, step):
    """Send ``x`` ``step`` places along ``axis`` without wrapping; the ranks
    nothing reaches get zeros."""
    line = mesh.line(axis)
    i = mesh.index(axis)
    group = mesh.group(axis)
    b = _bits(x)
    out = torch.zeros_like(b)
    ops = []
    if 0 <= i + step < len(line):
        ops.append(dist.P2POp(dist.isend, b, line[i + step], group))
    if 0 <= i - step < len(line):
        ops.append(dist.P2POp(dist.irecv, out, line[i - step], group))
    if ops:
        for w in dist.batch_isend_irecv(ops):
            w.wait()
    return _unbits(out, x.dtype)


class Shift(torch.autograd.Function):
    """``Shift.apply(x, mesh, axis)``: the previous rank's ``x`` (zeros on
    the first rank); backward sends the gradient back to the previous
    rank."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.meta = (mesh, axis)
        return _shift(x, mesh, axis, 1)

    @staticmethod
    def backward(ctx, g):
        mesh, axis = ctx.meta
        return _shift(g, mesh, axis, -1), None, None
