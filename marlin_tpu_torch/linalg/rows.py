"""The blocked factorizations and substitutions on row blocks over ranks.

Counterpart of the JAX package's sharded linalg
(``marlin_tpu/linalg/factorizations.py:134-529``), where each blocked
factorization is one XLA program under a ``with_sharding_constraint`` on the
row-sharded carried matrix. Here each rank of a mesh over
``torch.distributed`` ranks holds its rows of the padded matrix, in the
layout ``("rows", None)`` (a matrix of another layout is redistributed to it
and back), and the loop over the block columns runs on every rank:

- the diagonal block ``b × b`` of step ``i`` lies on one rank (the padded
  size is a multiple of ``b`` times the row shards, so every rank's rows are
  whole blocks); that rank factors it (``torch.linalg``, cuSOLVER on the
  card), as the single-device loop does, and broadcasts what the others
  need over the rows axis: the inverted triangles and the ``U12`` row
  block (LU), or ``L11⁻¹`` (Cholesky);
- every rank updates only its own trailing rows; Cholesky's rank-b update
  needs the whole ``n × b`` ``L21`` column, all-gathered, never the
  trailing matrix;
- ``pivot="block"`` keeps the row swaps inside the pivot block, so no row
  leaves its rank; ``pivot="panel"`` all-gathers the ``n × b`` panel
  column, eliminates it on every rank alike, and moves the swapped rows
  between ranks (``collectives.permute_rows``).

The triangular solves run block forward and back substitution across the
row owners (:func:`forward`, :func:`backward`): the owner of each rank block
of rows solves its diagonal block and broadcasts the result, and every later
rank subtracts its share.
"""

from __future__ import annotations

import numpy as np
import torch

from ..mesh import Sharding, pad_to_multiple

__all__ = ["RowLayout", "padded_size", "lu_rows", "cholesky_rows",
           "forward", "backward", "triangles", "eye_rows", "rhs_rows"]


class RowLayout:
    """This rank's rows of an ``n_pad × n_pad`` working copy of a matrix
    over ranks: ``r0:r1`` of the rows axis (``p`` shards of ``rp`` rows;
    the other mesh axes hold copies and compute alike)."""

    def __init__(self, mat, n_pad: int):
        self.mesh = mat.mesh
        self.axis = mat.spec[0] if len(mat.spec) else None
        self.p = self.mesh.shape[self.axis] if self.axis else 1
        self.n_pad = n_pad
        self.rp = n_pad // self.p
        self.sharding = Sharding(self.mesh, (self.axis, None))
        self.me = self.mesh.index(self.axis) if self.axis else 0
        self.r0 = self.me * self.rp
        self.r1 = self.r0 + self.rp

    def owner(self, row: int) -> int:
        return row // self.rp

    def load(self, mat) -> torch.Tensor:
        """This rank's rows of ``mat`` padded to ``n_pad`` with an identity
        tail (a copy: the factorizations update it in place)."""
        from ..parallel import collectives as col

        local = col.redistribute(mat.data, mat.sharding, self.sharding,
                                 mat.shape, mat._padded_shape,
                                 (self.n_pad, self.n_pad)).clone()
        rows = torch.arange(self.r0, self.r1, device=local.device)
        tail = rows >= mat.num_rows()
        local[tail, rows[tail]] = 1.0
        return local

    def store(self, local: torch.Tensor, mat, shape=None):
        """A matrix of ``mat``'s layout holding the leading ``shape`` (default
        ``mat.shape``) of the rows ``local``."""
        from ..parallel import collectives as col

        shape = tuple(shape or mat.shape)
        dst = mat.sharding
        out = col.redistribute(local, self.sharding, dst, shape,
                               (self.n_pad, local.shape[1]),
                               dst.padded_shape(shape))
        return mat._from_local(out, shape)

    def bcast(self, x: torch.Tensor | None, owner: int, shape, dtype,
              device) -> torch.Tensor:
        """The owner's ``x`` on every rank of the rows axis."""
        if self.p == 1:
            return x
        import torch.distributed as dist

        if self.me != owner:
            x = torch.empty(shape, dtype=dtype, device=device)
        x = x.contiguous()
        dist.broadcast(x, src=self.mesh.line(self.axis)[owner],
                       group=self.mesh.group(self.axis))
        return x

    def gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's rows ``x`` stacked in row order."""
        if self.p == 1:
            return x
        from ..parallel import collectives as col

        return col.all_gather_cat(x.contiguous(), self.mesh, self.axis, 0)

    def rows(self, device) -> torch.Tensor:
        return torch.arange(self.r0, self.r1, device=device)


def padded_size(n: int, block: int, p: int) -> int:
    """A multiple of ``block`` times the row shards, so every rank's rows
    are whole pivot blocks. (A multiple of lcm(block, p), the JAX package's
    ``_padded_size``, is not always one; the extra pad is identity blocks,
    which leave the factors' leading ``n × n`` as they are.)"""
    return pad_to_multiple(n, block * p)


def lu_rows(lay: RowLayout, a: torch.Tensor, block: int, pivot: str,
            schedule: str):
    """Blocked LU of the rows ``a`` (in place). Returns (LU rows, global
    permutation on every rank)."""
    if pivot == "panel":
        return _lu_panel(lay, a, block)
    from .factorizations import _lu_block, _triangle_inverses

    n = lay.n_pad
    dev, dt = a.device, a.dtype
    gperm = torch.arange(n, device=dev)
    eye_b = torch.eye(block, dtype=dt, device=dev)
    rows = lay.rows(dev)
    cols = torch.arange(n, device=dev)
    for i in range(n // block):
        o, e = i * block, (i + 1) * block
        own = lay.owner(o)
        lo = o - lay.r0
        pay = p = None
        if lay.me == own:
            lu, p = _lu_block(a[lo:lo + block, o:e])
            l11_inv, u11_inv = _triangle_inverses(lu, eye_b)
            stripe = a[lo:lo + block, :][p]
            if schedule == "shrinking":
                u12 = l11_inv @ stripe[:, e:]
                a[lo:lo + block, :] = stripe
                a[lo:lo + block, o:e] = lu
                a[lo:lo + block, e:] = u12
            else:
                u12 = l11_inv @ stripe
                a[lo:lo + block, :] = torch.where(
                    (cols >= o) & (cols < e), torch.nn.functional.pad(
                        lu, (o, n - e)), stripe)
            pay = torch.cat([u11_inv, u12], dim=1)
        width = block + (n - e if schedule == "shrinking" else n)
        pay = lay.bcast(pay, own, (block, width), dt, dev)
        p = lay.bcast(p, own, (block,), torch.int64, dev)
        u11_inv, u12 = pay[:, :block], pay[:, block:]
        gperm[o:e] = gperm[o:e][p]
        if schedule == "shrinking":
            mine = slice(max(lay.r0, e) - lay.r0, lay.rp)
            l21 = a[mine, o:e] @ u11_inv
            a[mine, e:].addmm_(l21, u12, alpha=-1.0)
            a[mine, o:e] = l21
        else:
            cpan = a[:, o:e]
            below = rows[:, None] >= e
            a[:, o:e] = torch.where(below, cpan @ u11_inv, cpan)
            _trailing(lay, a, o, block, u12, rows, cols)
    return a, gperm


def _trailing(lay, a, o, block, u12, rows, cols) -> None:
    """The masked schedule's epilogue on this rank's rows (the
    single-device ``_trailing_update``): ``U12`` right of the panel into
    the pivot rows, and the masked rank-b product."""
    right = cols[None, :] >= o + block
    if lay.me == lay.owner(o):
        lo = o - lay.r0
        a[lo:lo + block, :] = torch.where(right, u12, a[lo:lo + block, :])
    below = rows[:, None] >= o + block
    l21_m = torch.where(below, a[:, o:o + block], 0.0)
    a.addmm_(l21_m, torch.where(right, u12, 0.0), alpha=-1.0)


def _lu_panel(lay: RowLayout, a: torch.Tensor, block: int):
    """Panel-pivot LU on rows: the ``n × b`` panel column all-gathered and
    eliminated on every rank alike (the single-device column loop), its
    swaps applied to the rows across ranks, then the masked epilogue."""
    from ..parallel import collectives as col
    from .factorizations import _swap_rows

    n = lay.n_pad
    dev, dt = a.device, a.dtype
    gperm = torch.arange(n, device=dev)
    row_idx = torch.arange(n, device=dev)
    rows = lay.rows(dev)
    panel_col_idx = torch.arange(block, device=dev)
    eye_b = torch.eye(block, dtype=dt, device=dev)
    for i in range(n // block):
        o = i * block
        pan = lay.gather_rows(a[:, o:o + block]).clone()
        pivots = torch.zeros((block,), dtype=torch.int64, device=dev)
        for j in range(block):
            c = o + j
            mag = torch.where(row_idx >= c, pan[:, j].abs(), -1.0)
            piv = torch.argmax(mag)
            _swap_rows(pan, c, piv)
            pivots[j] = piv
            column = pan[:, j].clone()
            pivot_val = column[c]
            safe = torch.where(pivot_val.abs() > 0, pivot_val, 1.0)
            factor = torch.where(row_idx > c, column / safe, 0.0)
            pivot_row = torch.where(panel_col_idx > j, pan[c], 0.0)
            pan -= factor[:, None] * pivot_row[None, :]
            pan[:, j] = torch.where(row_idx > c, factor, column)
        step = np.arange(n)
        for j, pv in enumerate(pivots.tolist()):
            step[[o + j, pv]] = step[[pv, o + j]]
        a = col.permute_rows(a, lay.sharding, (n, n), step) if lay.p > 1 \
            else a[torch.as_tensor(step, device=dev)]
        gperm = gperm[torch.as_tensor(step, device=dev)]
        a[:, o:o + block] = pan[lay.r0:lay.r1]
        own = lay.owner(o)
        u12 = None
        if lay.me == own:
            lo = o - lay.r0
            l11 = torch.tril(a[lo:lo + block, o:o + block], -1) + eye_b
            l11_inv = torch.linalg.solve_triangular(l11, eye_b, upper=False,
                                                    unitriangular=True)
            u12 = l11_inv @ a[lo:lo + block, :]
        u12 = lay.bcast(u12, own, (block, n), dt, dev)
        _trailing(lay, a, o, block, u12, rows, torch.arange(n, device=dev))
    return a, gperm


def cholesky_rows(lay: RowLayout, a: torch.Tensor, block: int,
                  schedule: str) -> torch.Tensor:
    """Blocked Cholesky (lower) of the rows ``a`` (in place); returns the
    rows of ``tril``."""
    from .factorizations import _cholesky_block

    n = lay.n_pad
    dev, dt = a.device, a.dtype
    eye_b = torch.eye(block, dtype=dt, device=dev)
    rows = lay.rows(dev)
    for i in range(n // block):
        o, e = i * block, (i + 1) * block
        own = lay.owner(o)
        lo = o - lay.r0
        pay = None
        if lay.me == own:
            l11 = _cholesky_block(a[lo:lo + block, o:e])
            l11_inv = torch.linalg.solve_triangular(l11, eye_b, upper=False)
            pay = torch.cat([l11, l11_inv], dim=1)
        pay = lay.bcast(pay, own, (block, 2 * block), dt, dev)
        l11, l11_inv = pay[:, :block], pay[:, block:]
        if schedule == "shrinking":
            if lay.me == own:
                a[lo:lo + block, o:e] = l11
            mine = slice(max(lay.r0, e) - lay.r0, lay.rp)
            l21 = a[mine, o:e] @ l11_inv.T
            a[mine, o:e] = l21
            panel = lay.gather_rows(torch.where(rows[:, None] >= e,
                                                a[:, o:e], 0.0))
            a[mine, e:].addmm_(l21, panel[e:].T, alpha=-1.0)
        else:
            cpan = a[:, o:e]
            l21 = cpan @ l11_inv.T
            below = rows[:, None] >= e
            at_block = (rows[:, None] >= o) & (rows[:, None] < e)
            l11_tall = torch.zeros_like(cpan)
            if lay.me == own:
                l11_tall[lo:lo + block] = l11
            cpan_new = torch.where(below, l21,
                                   torch.where(at_block, l11_tall, cpan))
            l21_m = torch.where(below, l21, 0.0)
            a.addmm_(l21_m, lay.gather_rows(l21_m).T, alpha=-1.0)
            a[:, o:e] = cpan_new
    return torch.where(torch.arange(n, device=dev)[None, :] <= rows[:, None],
                       a, 0.0)


def forward(lay: RowLayout, l: torch.Tensor, r: torch.Tensor,
            unit: bool) -> torch.Tensor:
    """``L⁻¹ R`` on rows: ``l`` this rank's rows of a lower-triangular
    ``n_pad × n_pad`` matrix, ``r`` its rows of the right-hand sides.
    Rank block by rank block, in order: the owner solves its diagonal block
    and broadcasts its rows of the solution, and every later rank subtracts
    their share."""
    r = r.clone()
    for q in range(lay.p):
        c = slice(q * lay.rp, (q + 1) * lay.rp)
        y = None
        if lay.me == q:
            y = torch.linalg.solve_triangular(l[:, c], r, upper=False,
                                              unitriangular=unit)
            r = y
        y = lay.bcast(y, q, r.shape, r.dtype, r.device)
        if lay.me > q:
            r -= l[:, c] @ y
    return r


def backward(lay: RowLayout, u: torch.Tensor, r: torch.Tensor
             ) -> torch.Tensor:
    """``U⁻¹ R`` on rows, as :func:`forward` from the last rank block."""
    r = r.clone()
    for q in reversed(range(lay.p)):
        c = slice(q * lay.rp, (q + 1) * lay.rp)
        y = None
        if lay.me == q:
            y = torch.linalg.solve_triangular(u[:, c], r, upper=True)
            r = y
        y = lay.bcast(y, q, r.shape, r.dtype, r.device)
        if lay.me < q:
            r -= u[:, c] @ y
    return r


def triangles(lay: RowLayout, lu: torch.Tensor):
    """The unit-lower and upper rows of combined LU rows."""
    cols = torch.arange(lay.n_pad, device=lu.device)[None, :]
    rows = lay.rows(lu.device)[:, None]
    l = torch.where(cols < rows, lu, 0.0) + (cols == rows).to(lu.dtype)
    return l, torch.where(cols >= rows, lu, 0.0)


def eye_rows(lay: RowLayout, dtype, device) -> torch.Tensor:
    """This rank's rows of the ``n_pad`` identity."""
    cols = torch.arange(lay.n_pad, device=device)[None, :]
    return (cols == lay.rows(device)[:, None]).to(dtype)


def rhs_rows(lay: RowLayout, rhs: torch.Tensor) -> torch.Tensor:
    """This rank's rows of a whole right-hand side, zero-padded to
    ``n_pad``."""
    out = torch.zeros((lay.rp, rhs.shape[1]), dtype=rhs.dtype,
                      device=rhs.device)
    top = min(lay.r1, rhs.shape[0])
    if top > lay.r0:
        out[:top - lay.r0] = rhs[lay.r0:top]
    return out
