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

The matrices across ranks (``matrix/dense.py``) hold one block each of a
zero-padded array under a :class:`~marlin_tpu_torch.mesh.Sharding` and move
through four functions, each one collective over the world: :func:`remap`
(rectangles of source layouts into a destination layout, transposed or
not, in one ``all_to_all_single``; :func:`redistribute` is its one-source
case), :func:`gather_logical` (the whole array, by one all-gather),
:func:`reduce_to` (a reduce-scatter of whole partial sums into a layout)
and :func:`permute_rows`.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..mesh import Sharding
from ..obs import trace as obs_trace

__all__ = ["Scatter", "Gather", "AllReduce", "Replicate", "AllToAll", "Shift",
           "all_gather_cat", "all_reduce_sum", "all_reduce_leaves", "block",
           "ring_send_recv", "finish", "mesh_index", "all_gather_mesh",
           "all_reduce_mesh", "remap", "redistribute", "gather_logical",
           "reduce_to", "permute_rows"]


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


# ------------------------------------------------- layouts of a matrix
# A layout is a Sharding and the padded global shape its blocks cut; every
# rank of the world calls these functions in the same order with the same
# layouts (each computes the whole plan, so no sizes travel).

def _rank() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() \
        else 0


def _world() -> int:
    return dist.get_world_size() if dist.is_available() and \
        dist.is_initialized() else 1


def _positions(sharding) -> dict:
    """global rank -> grid position of the sharding's mesh."""
    return {sharding.rank_of(p): p for p in sharding.positions()}


def _holders(sharding, padded) -> dict:
    """block coordinate -> (bounds, global ranks holding it, in grid
    order)."""
    out: dict = {}
    for p in sharding.positions():
        key = sharding.block_index(p, len(padded))
        if key not in out:
            out[key] = (sharding.bounds(padded, p), [])
        out[key][1].append(sharding.rank_of(p))
    return out


def _meet(a, b):
    out = tuple((max(x0, y0), min(x1, y1)) for (x0, x1), (y0, y1) in zip(a, b))
    return None if any(x0 >= x1 for x0, x1 in out) else out


def _sl(rng, origin):
    return tuple(slice(a - o, b - o) for (a, b), o in zip(rng, origin))


def _plan(items, dst, dst_padded) -> list:
    """Every piece of a :func:`remap`: ``(sender, receiver, item, source
    slices in the sender's block, destination slices in the receiver's
    block)``, in one order every rank computes alike. Of the ranks holding
    a source block, the receiver sends to itself when it is one of them,
    else the holder at ``receiver % copies`` does, which spreads the
    load."""
    pieces = []
    dst_pos = sorted(_positions(dst).items())
    for t, (_, src, src_padded, region, at, tr) in enumerate(items):
        # a transposed item's dimensions land in reverse order
        orient = (lambda x: tuple(reversed(x))) if tr else tuple
        starts = [r0 for r0, _ in orient(region)]
        for _key, (bnds, ranks) in sorted(_holders(src, src_padded).items()):
            ov = _meet(bnds, region)
            if ov is None:
                continue
            landed = tuple((a - r0 + o, b - r0 + o) for (a, b), r0, o
                           in zip(orient(ov), starts, at))
            for d_rank, d in dst_pos:
                dbnds = dst.bounds(dst_padded, d)
                got = _meet(landed, dbnds)
                if got is None:
                    continue
                back = orient(tuple((a - o + r0, b - o + r0) for (a, b), r0, o
                                    in zip(got, starts, at)))
                sender = d_rank if d_rank in ranks else \
                    ranks[d_rank % len(ranks)]
                pieces.append((sender, d_rank, t,
                               _sl(back, [b[0] for b in bnds]),
                               _sl(got, [b[0] for b in dbnds])))
    return pieces


def _same_blocks(src, src_padded, dst, dst_padded) -> bool:
    """Whether two layouts put the same block on every rank."""
    if tuple(src_padded) != tuple(dst_padded):
        return False
    a, b = _positions(src), _positions(dst)
    return a.keys() == b.keys() and all(
        src.bounds(src_padded, a[r]) == dst.bounds(dst_padded, b[r])
        for r in a)


def _exchange(pieces, payload, out, dtype) -> None:
    """Run the pieces of a plan: each rank's own pieces are copied in
    place, the rest travel as bytes in one ``all_to_all_single`` over the
    world (skipped when no piece crosses ranks)."""
    me, world = _rank(), _world()
    for sender, receiver, t, src_sl, dst_sl in pieces:
        if sender == me and receiver == me:
            out[dst_sl] += payload(t, src_sl)
    if not any(s != r for s, r, *_ in pieces):
        return
    item = torch.empty((), dtype=dtype).element_size()
    sends = [[] for _ in range(world)]
    recv_sizes = [0] * world
    recvs = []
    for sender, receiver, t, src_sl, dst_sl in pieces:
        if sender == receiver:
            continue
        if sender == me:
            sends[receiver].append(payload(t, src_sl).contiguous()
                                   .reshape(-1).view(torch.uint8))
        if receiver == me:
            n = 1
            for s in dst_sl:
                n *= s.stop - s.start
            recvs.append((sender, dst_sl, n * item))
            recv_sizes[sender] += n * item
    dev = out.device
    send_sizes = [sum(x.numel() for x in s) for s in sends]
    flat = torch.cat([x for s in sends for x in s]) if any(send_sizes) \
        else torch.empty((0,), dtype=torch.uint8, device=dev)
    got = torch.empty((sum(recv_sizes),), dtype=torch.uint8, device=dev)
    dist.all_to_all_single(got, flat.to(dev), recv_sizes, send_sizes)
    offs = [0] * world
    start = 0
    for r in range(world):
        offs[r] = start
        start += recv_sizes[r]
    for sender, dst_sl, nbytes in recvs:
        blk = got[offs[sender]:offs[sender] + nbytes]
        offs[sender] += nbytes
        shape = tuple(s.stop - s.start for s in dst_sl)
        out[dst_sl] += blk.view(dtype).reshape(shape)


def remap(items, dst, dst_padded, dtype=None, device=None) -> torch.Tensor:
    """This rank's block of a new array laid out by ``dst`` (a
    :class:`~marlin_tpu_torch.mesh.Sharding`) over ``dst_padded``, built
    from rectangles of source arrays; zero where nothing lands. Each item
    is ``(local, src, src_padded, region, at, transpose)``: this rank's
    block ``local`` of a source laid out by ``src`` over ``src_padded``,
    the ``region`` (``(start, stop)`` a dimension) of its global array to
    move, where the region's first corner lands in the destination, and
    whether it lands transposed (2-D only). Every piece moves once, from
    one of the ranks holding it, in one ``all_to_all_single`` (a rank's own
    pieces are copied without it)."""
    items = [tuple(it) for it in items]
    dtype = dtype or items[0][0].dtype
    device = device or items[0][0].device
    out = torch.zeros(dst.block_shape(dst_padded), dtype=dtype, device=device)

    def payload(t, sl):
        x = items[t][0][sl]
        return (x.T if items[t][5] else x).to(device=device, dtype=dtype)

    with obs_trace.span("remap.plan"):
        pieces = _plan(items, dst, dst_padded)
    with obs_trace.span("remap.exchange"):
        _exchange(pieces, payload, out, dtype)
    return out


def redistribute(local, src, dst, shape, src_padded=None, dst_padded=None
                 ) -> torch.Tensor:
    """Move a ``shape`` array from the layout ``src`` (its blocks over
    ``src_padded``, default ``src.padded_shape(shape)``) to ``dst``: this
    rank's new block, by the overlap of each source block with each
    destination block, in one ``all_to_all_single``. The pads stay zero.
    Where both layouts put the same block on every rank, ``local`` itself
    comes back."""
    src_padded = tuple(src_padded or src.padded_shape(shape))
    dst_padded = tuple(dst_padded or dst.padded_shape(shape))
    if _same_blocks(src, src_padded, dst, dst_padded):
        return local
    region = tuple((0, int(n)) for n in shape)
    return remap([(local, src, src_padded, region, (0,) * len(shape),
                   False)], dst, dst_padded)


def gather_logical(local, src, shape, src_padded=None, dst: int | None = None
                   ) -> torch.Tensor | None:
    """The whole ``shape`` array of a layout, from every rank's block by one
    all-gather over the world (one gather to rank ``dst`` when given: the
    other ranks get ``None``). A world of one slices its own block."""
    src_padded = tuple(src_padded or src.padded_shape(shape))
    crop = tuple(slice(0, int(n)) for n in shape)
    if src.mesh.ranks is None:
        return local[crop]
    me, world = _rank(), _world()
    b = _bits(local.contiguous())
    if dst is None:
        parts = [torch.empty_like(b) for _ in range(world)]
        dist.all_gather(parts, b)
    else:
        parts = [torch.empty_like(b) for _ in range(world)] \
            if me == dst else None
        dist.gather(b, parts, dst=dst)
        if me != dst:
            return None
    out = torch.empty(src_padded, dtype=local.dtype, device=local.device)
    for p in src.positions():
        sl = tuple(slice(a, z) for a, z in src.bounds(src_padded, p))
        out[sl] = _unbits(parts[src.rank_of(p)], local.dtype)
    return out[crop]


def reduce_to(partial, contribute: bool, dst, dst_padded, shape
              ) -> torch.Tensor:
    """A reduce-scatter: the sum, over the ranks that ``contribute``, of
    their whole ``shape`` arrays ``partial``, arriving as this rank's block
    of the ``dst`` layout (one ``all_to_all_single``; no rank forms the
    sum of the whole)."""
    region = tuple((0, int(n)) for n in shape)
    senders = _all_flags(contribute)
    pieces = []
    for d_rank, d in sorted(_positions(dst).items()):
        got = _meet(region, dst.bounds(dst_padded, d))
        if got is None:
            continue
        lo = [b[0] for b in dst.bounds(dst_padded, d)]
        for s in senders:
            pieces.append((s, d_rank, 0, _sl(got, [0] * len(got)),
                           _sl(got, lo)))
    out = torch.zeros(dst.block_shape(dst_padded), dtype=partial.dtype,
                      device=partial.device)
    _exchange(pieces, lambda t, sl: partial[sl], out, partial.dtype)
    return out


def _all_flags(flag: bool) -> list[int]:
    """The ranks whose ``flag`` is true (every rank calls it)."""
    world = _world()
    if world == 1:
        return [0] if flag else []
    t = torch.zeros((world,), dtype=torch.int64)
    t[_rank()] = int(bool(flag))
    dev = _collective_device()
    t = t.to(dev)
    dist.all_reduce(t)
    return [r for r in range(world) if int(t[r])]


def _collective_device() -> torch.device:
    """The device a world's small control tensors travel on (the card
    under NCCL)."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def permute_rows(local, src, padded, perm) -> torch.Tensor:
    """This rank's block, in the same layout, of the array whose row ``i``
    is row ``perm[i]`` of the source (``perm`` a host sequence over the
    first ``len(perm)`` rows; the rows past it stay zero). Each row moves
    once, from one rank holding it, in one ``all_to_all_single``."""
    import numpy as np

    perm = np.asarray(perm, dtype=np.int64)
    rows_per = src.block_shape(padded)[0]
    pieces = []
    holders = _holders(src, padded)
    for d_rank, d in sorted(_positions(src).items()):
        dbnds = src.bounds(padded, d)
        r0, r1 = dbnds[0]
        dst_rows = np.arange(r0, min(r1, len(perm)))
        if not len(dst_rows):
            continue
        want = perm[dst_rows]
        col_key = src.block_index(d, len(padded))[1:]
        owners = want // rows_per
        for o in np.unique(owners):
            bnds, ranks = holders[(int(o),) + tuple(col_key)]
            sender = d_rank if d_rank in ranks else ranks[d_rank % len(ranks)]
            sel = owners == o
            pieces.append((sender, d_rank,
                           torch.as_tensor(want[sel] - bnds[0][0]),
                           torch.as_tensor(dst_rows[sel] - r0)))
    return _exchange_rows(pieces, local)


def _exchange_rows(pieces, local) -> torch.Tensor:
    """:func:`_exchange` for row pieces ``(sender, receiver, source rows,
    destination rows)``."""
    me, world = _rank(), _world()
    out = torch.zeros_like(local)
    dev = local.device
    for s, r, src_rows, dst_rows in pieces:
        if s == me and r == me:
            out[dst_rows.to(dev)] = local[src_rows.to(dev)]
    if not any(s != r for s, r, *_ in pieces):
        return out
    row_bytes = local[0:1].numel() * local.element_size()
    sends = [[] for _ in range(world)]
    recv_sizes = [0] * world
    recvs = []
    for s, r, src_rows, dst_rows in pieces:
        if s == r:
            continue
        if s == me:
            sends[r].append(local[src_rows.to(dev)].contiguous().reshape(-1)
                            .view(torch.uint8))
        if r == me:
            recvs.append((s, dst_rows))
            recv_sizes[s] += len(dst_rows) * row_bytes
    send_sizes = [sum(x.numel() for x in s) for s in sends]
    flat = torch.cat([x for s in sends for x in s]) if any(send_sizes) \
        else torch.empty((0,), dtype=torch.uint8, device=dev)
    got = torch.empty((sum(recv_sizes),), dtype=torch.uint8, device=dev)
    dist.all_to_all_single(got, flat, recv_sizes, send_sizes)
    offs, start = [0] * world, 0
    for r in range(world):
        offs[r] = start
        start += recv_sizes[r]
    for s, dst_rows in recvs:
        n = len(dst_rows) * row_bytes
        blk = got[offs[s]:offs[s] + n]
        offs[s] += n
        out[dst_rows.to(dev)] = blk.view(local.dtype).reshape(
            (len(dst_rows),) + tuple(local.shape[1:]))
    return out
