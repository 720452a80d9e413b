"""Blocked dense factorizations: LU, Cholesky and the inverse.

Counterpart of ``marlin_tpu/linalg/factorizations.py``. The reference runs
block LU / Cholesky / inverse as panel + trailing-update loops orchestrated
by Spark's coordinating process, collecting each pivot block there to
factor it (DenseVecMatrix.scala:283-466 LU, 475-561 Cholesky, 568-764
inverse). The JAX
package makes the whole factorization one jitted XLA program with the pivot
block factored on the device. Here it is an eager loop over the block
columns on the matrix's device: the pivot block is factored there
(``torch.linalg.lu_factor_ex``, ``cholesky_ex``, ``solve_triangular``), the
panel and trailing updates are ``torch.matmul`` products with TF32 off (the
JAX package pins ``precision="highest"``), and pivots and the permutation
stay device tensors, so no step waits for the device: the loop issues every
step's work and returns.

Two schedules (``schedule=`` on the public functions), as in the JAX
package:

- ``"shrinking"``: every step's panel and trailing slices have their true
  shrinking extents, the ideal 2n³/3 FLOPs for LU.
- ``"masked"``: every step runs the same full-width products with masked
  operands (zero outside the trailing region), about 3x the ideal FLOPs; the
  JAX package's single ``fori_loop`` body, kept with its arithmetic. The only
  schedule for ``pivot="panel"``.

``"auto"`` resolves as the JAX package's ``_resolve_schedule`` does, a rule
measured on a TPU; ``PERF.md`` holds the card's times of both.

The trailing updates run in place (``addmm_`` on the padded copy of the
input): one n² buffer less a step than the JAX package's functional update.

Pivoting: ``pivot="block"`` (default) pivots within the b×b pivot block only,
as the reference does, with the row swaps applied across the full width and
the global permutation accumulated; ``pivot="panel"`` searches the full
trailing column for each elimination column (LAPACK getrf style), a serial
loop over the columns. Both use partial pivoting by the largest |value|;
where two candidates tie, the card's and the CPU's LAPACK may pick either.

Panel updates multiply by the explicitly inverted b×b pivot triangles, the
same numerical trade the reference and the JAX package make (an
ill-conditioned pivot block carries κ·eps into the panel); callers with
adversarial inputs take ``mode="local"``.

Square inputs are padded with an identity tail to a multiple of
``lcm(block, row shards)`` (one shard here), so the padded problem stays
nonsingular.
"""

from __future__ import annotations

import math

import torch

from ..config import get_config
from ..mesh import pad_to_multiple
from ..ops.local import precision_scope

__all__ = ["lu_decompose", "cholesky_decompose", "inverse", "PIVOT_STRATEGIES",
           "SCHEDULES"]

PIVOT_STRATEGIES = ("block", "panel")
SCHEDULES = ("auto", "shrinking", "masked")

# above this many block steps "auto" takes the masked schedule (the JAX
# package's unroll cap: one compiled GEMM shape per shrinking step)
_MAX_UNROLL_STEPS = 64


def _require_pivot(pivot: str) -> None:
    if pivot not in PIVOT_STRATEGIES:
        raise ValueError(
            f"unknown pivot strategy: {pivot!r} (one of {PIVOT_STRATEGIES})"
        )


def _resolve_schedule(schedule: str, nb: int, pivot: str = "block",
                      op: str = "lu") -> str:
    """The JAX package's rule, unchanged: "auto" is "masked" for Cholesky
    and for panel pivoting, "shrinking" for block-pivot LU up to
    ``_MAX_UNROLL_STEPS`` block steps."""
    if schedule not in SCHEDULES:
        raise ValueError(f"unknown schedule: {schedule!r} (one of {SCHEDULES})")
    if schedule == "shrinking" and pivot == "panel":
        raise ValueError('schedule="shrinking" supports pivot="block" only '
                         '(panel pivoting keeps the masked full-width loop)')
    if schedule == "auto":
        if op == "cholesky":
            return "masked"
        return ("shrinking" if pivot == "block" and nb <= _MAX_UNROLL_STEPS
                else "masked")
    return schedule


def _pad_with_identity(a: torch.Tensor, n_pad: int) -> torch.Tensor:
    """A new n_pad×n_pad tensor holding the n×n ``a`` and an identity tail
    block, so factorizations of it restrict to ``a``. Always a copy: the
    factorizations update it in place."""
    n = a.shape[0]
    out = torch.zeros((n_pad, n_pad), dtype=a.dtype, device=a.device)
    out[:n, :n] = a
    if n_pad > n:
        out[n:, n:].fill_diagonal_(1.0)
    return out


def _lu_block(piv: torch.Tensor):
    """``jax.lax.linalg.lu`` of one pivot block: the combined LU factors and
    the permutation ``p`` with ``piv[p] == L @ U``, a device tensor (LAPACK's
    sequential 1-based swaps unpacked on the device, no host read)."""
    lu, pivots, _ = torch.linalg.lu_factor_ex(piv)
    perm_mat, _, _ = torch.lu_unpack(lu, pivots, unpack_data=False)
    # piv = P L U, so P^T piv = L U: row i of it is row p[i] of piv
    return lu, perm_mat.argmax(dim=0)


def _triangle_inverses(lu: torch.Tensor, eye_b: torch.Tensor):
    """The inverses of the unit-lower and upper triangles of ``lu``, by two
    b×b triangular solves."""
    l11 = torch.tril(lu, -1) + eye_b
    u11 = torch.triu(lu)
    l11_inv = torch.linalg.solve_triangular(l11, eye_b, upper=False,
                                            unitriangular=True)
    u11_inv = torch.linalg.solve_triangular(u11.T, eye_b, upper=False).T
    return l11_inv, u11_inv


def _swap_rows(x: torch.Tensor, r1: int, r2: torch.Tensor) -> None:
    """Swap row ``r1`` and row ``r2`` (a 0-d device index) of ``x`` in
    place, without reading ``r2`` on the host."""
    pair = torch.cat([r2.new_full((1,), r1), r2.view(1)])
    x.index_copy_(0, pair.flip(0), x.index_select(0, pair))


def _trailing_update(a: torch.Tensor, o: int, block: int,
                     u12: torch.Tensor) -> None:
    """Shared epilogue of both masked LU variants, in place: write U12
    right of the panel and subtract the masked rank-b outer product, zero
    outside the trailing region, so the full-size product only changes A22.
    Expects the column panel of ``a`` to hold L21 below the diagonal
    block."""
    n = a.shape[0]
    idx = torch.arange(n, device=a.device)
    right = idx[None, :] >= o + block
    a[o:o + block, :] = torch.where(right, u12, a[o:o + block, :])
    below = idx[:, None] >= o + block
    l21_m = torch.where(below, a[:, o:o + block], 0.0)
    u12_m = torch.where(right, u12, 0.0)
    a.addmm_(l21_m, u12_m, alpha=-1.0)


def _blocked_lu(a: torch.Tensor, block: int):
    """Right-looking blocked LU with block-local partial pivoting, masked
    full-width schedule, in place on ``a``. Returns (LU combined, global
    permutation)."""
    n = a.shape[0]
    dev = a.device
    gperm = torch.arange(n, device=dev)
    idx = torch.arange(n, device=dev)
    eye_b = torch.eye(block, dtype=a.dtype, device=dev)
    for i in range(n // block):
        o = i * block
        lu, p = _lu_block(a[o:o + block, o:o + block])
        l11_inv, u11_inv = _triangle_inverses(lu, eye_b)
        # row panel: permute its rows, keep the permuted L part left of the
        # panel, the combined lu block in the diagonal (U12: the epilogue)
        rpan = a[o:o + block, :][p]
        in_block = (idx[None, :] >= o) & (idx[None, :] < o + block)
        lu_wide = torch.zeros_like(rpan)
        lu_wide[:, o:o + block] = lu
        a[o:o + block, :] = torch.where(in_block, lu_wide, rpan)
        # column panel: rows >= o + b get L21 = A21 U11^-1
        cpan = a[:, o:o + block]
        l21 = cpan @ u11_inv
        below = idx[:, None] >= o + block
        a[:, o:o + block] = torch.where(below, l21, cpan)
        _trailing_update(a, o, block, l11_inv @ rpan)
        gperm[o:o + block] = gperm[o:o + block][p]
    return a, gperm


def _blocked_lu_panel_pivot(a: torch.Tensor, block: int):
    """Right-looking blocked LU with full-height panel pivoting (LAPACK
    getrf style), in place on ``a``: each elimination column picks its
    pivot over the whole trailing column. The elimination runs column by
    column on the (n × b) panel; the chosen swaps are then replayed across
    the full width and the permutation (laswp), and the trailing update is
    the shared masked rank-b product. Returns (LU combined, permutation)."""
    n = a.shape[0]
    dev = a.device
    gperm = torch.arange(n, device=dev)
    row_idx = torch.arange(n, device=dev)
    panel_col_idx = torch.arange(block, device=dev)
    eye_b = torch.eye(block, dtype=a.dtype, device=dev)
    for i in range(n // block):
        o = i * block
        pan = a[:, o:o + block].clone()
        pivots = torch.zeros((block,), dtype=torch.int64, device=dev)
        for j in range(block):
            c = o + j
            mag = torch.where(row_idx >= c, pan[:, j].abs(), -1.0)
            piv = torch.argmax(mag)
            _swap_rows(pan, c, piv)
            pivots[j] = piv
            col = pan[:, j].clone()
            pivot_val = col[c]
            safe = torch.where(pivot_val.abs() > 0, pivot_val, 1.0)
            factor = torch.where(row_idx > c, col / safe, 0.0)
            pivot_row = torch.where(panel_col_idx > j, pan[c], 0.0)
            pan -= factor[:, None] * pivot_row[None, :]
            pan[:, j] = torch.where(row_idx > c, factor, col)
        for j in range(block):
            _swap_rows(a, o + j, pivots[j])
            _swap_rows(gperm, o + j, pivots[j])
        a[:, o:o + block] = pan
        # shared epilogue: U12 from the panel's unit-lower triangle
        l11 = torch.tril(a[o:o + block, o:o + block], -1) + eye_b
        l11_inv = torch.linalg.solve_triangular(l11, eye_b, upper=False,
                                                unitriangular=True)
        _trailing_update(a, o, block, l11_inv @ a[o:o + block, :])
    return a, gperm


def _blocked_lu_shrinking(a: torch.Tensor, block: int):
    """Right-looking blocked LU, block-local pivoting, shrinking extents: no
    masks and the ideal FLOP count, in place on ``a``. Returns (LU
    combined, permutation)."""
    n = a.shape[0]
    dev = a.device
    gperm = torch.arange(n, device=dev)
    eye_b = torch.eye(block, dtype=a.dtype, device=dev)
    for i in range(n // block):
        o, e = i * block, (i + 1) * block
        lu, p = _lu_block(a[o:e, o:e])
        l11_inv, u11_inv = _triangle_inverses(lu, eye_b)
        # permute the whole row stripe (the L entries left of the panel
        # swap with it, as laswp does)
        stripe = a[o:e, :][p]
        gperm[o:e] = gperm[o:e][p]
        a[o:e, :] = stripe
        a[o:e, o:e] = lu
        if e < n:
            u12 = l11_inv @ stripe[:, e:]
            l21 = a[e:, o:e] @ u11_inv
            a[e:, e:].addmm_(l21, u12, alpha=-1.0)
            a[o:e, e:] = u12
            a[e:, o:e] = l21
    return a, gperm


def _cholesky_block(piv: torch.Tensor) -> torch.Tensor:
    """``jnp.linalg.cholesky`` of one pivot block: the lower factor of the
    symmetrised block, without the check that would read its status on the
    host (a block that is not positive definite gives a partial factor)."""
    return torch.linalg.cholesky_ex((piv + piv.T) / 2).L


def _blocked_cholesky_shrinking(a: torch.Tensor, block: int) -> torch.Tensor:
    """Shrinking-extent blocked Cholesky (lower), in place on ``a``; the same
    schedule as :func:`_blocked_lu_shrinking`."""
    n = a.shape[0]
    eye_b = torch.eye(block, dtype=a.dtype, device=a.device)
    for i in range(n // block):
        o, e = i * block, (i + 1) * block
        l11 = _cholesky_block(a[o:e, o:e])
        a[o:e, o:e] = l11
        if e < n:
            l11_inv = torch.linalg.solve_triangular(l11, eye_b, upper=False)
            l21 = a[e:, o:e] @ l11_inv.T
            a[e:, e:].addmm_(l21, l21.T, alpha=-1.0)
            a[e:, o:e] = l21
    return torch.tril(a)


def _blocked_cholesky(a: torch.Tensor, block: int) -> torch.Tensor:
    """Right-looking blocked Cholesky (lower), masked full-width schedule,
    in place on ``a``. No pivoting (SPD input)."""
    n = a.shape[0]
    row_idx = torch.arange(n, device=a.device)[:, None]
    eye_b = torch.eye(block, dtype=a.dtype, device=a.device)
    for i in range(n // block):
        o = i * block
        l11 = _cholesky_block(a[o:o + block, o:o + block])
        l11_inv = torch.linalg.solve_triangular(l11, eye_b, upper=False)
        cpan = a[:, o:o + block]
        l21 = cpan @ l11_inv.T
        below = row_idx >= o + block
        at_block = (row_idx >= o) & (row_idx < o + block)
        l11_tall = torch.zeros_like(cpan)
        l11_tall[o:o + block] = l11
        cpan_new = torch.where(below, l21, torch.where(at_block, l11_tall, cpan))
        l21_m = torch.where(below, l21, 0.0)
        a.addmm_(l21_m, l21_m.T, alpha=-1.0)
        # the block column, which the rank-b update also touched
        a[:, o:o + block] = cpan_new
    return torch.tril(a)


def _require_square(mat):
    if mat.num_rows() != mat.num_cols():
        raise ValueError(f"factorization needs a square matrix, got {mat.shape}")


def _mode_to_local(mode: str, n: int) -> bool:
    cfg = get_config()
    if mode in ("local", "breeze"):  # "breeze" kept as a parity alias
        return True
    if mode in ("dist", "distspark"):
        return False
    if mode == "auto":  # reference: n > 6000 -> dist (DenseVecMatrix.scala:289-298)
        return n <= cfg.local_fallback_dim
    raise ValueError(f"unknown factorization mode: {mode}")


def _row_shards(mat) -> int:
    """The row-axis shard count of the matrix (1 on the port's mesh)."""
    ax = mat.spec[0] if len(mat.spec) > 0 else None
    return mat.mesh.shape[ax] if ax is not None else 1


def _padded_size(mat, n: int, block: int) -> int:
    """The padded size of a blocked factorization: a multiple of
    lcm(block, row shards), the JAX package's ``_pad_and_sharding`` rule
    (here without its sharding constraint: one device holds the matrix)."""
    return pad_to_multiple(n, math.lcm(block, _row_shards(mat)))


def _lu_factor(schedule: str, pivot: str):
    if pivot == "panel":
        return _blocked_lu_panel_pivot
    return _blocked_lu_shrinking if schedule == "shrinking" else _blocked_lu


def lu_decompose(mat, mode: str = "auto", block_size: int | None = None,
                 pivot: str = "block", schedule: str = "auto"):
    """Block LU with partial pivoting (DenseVecMatrix.luDecompose,
    DenseVecMatrix.scala:283-466). Returns ``(L, U, perm)`` where ``perm`` is
    the row-permutation vector: ``A[perm] == L @ U``. ``perm`` stays a device
    tensor (int64); reading it on the host is the caller's wait.

    ``pivot``: "block" restricts the pivot search to the b×b pivot block
    (the reference's choice); "panel" searches the full trailing column per
    elimination step (LAPACK getrf behaviour).

    ``schedule``: "shrinking" (true shrinking extents, the ideal 2n³/3
    FLOPs), "masked" (full-width masked updates, ~3x the FLOPs), or "auto"
    (shrinking for block-pivot factorizations up to 64 steps)."""
    _require_square(mat)
    _require_pivot(pivot)
    _resolve_schedule(schedule, 1, pivot)  # arg validation in EVERY mode
    n = mat.num_rows()
    a = mat.logical()
    with precision_scope("highest"):
        if _mode_to_local(mode, n):
            lu, p = _lu_block(a)
            eye = torch.eye(n, dtype=a.dtype, device=a.device)
            return mat._wrap(torch.tril(lu, -1) + eye), mat._wrap(torch.triu(lu)), p
        b = min(block_size or get_config().lu_base_size, n)
        n_pad = _padded_size(mat, n, b)
        sched = _resolve_schedule(schedule, n_pad // b, pivot)
        lu_pad, perm = _lu_factor(sched, pivot)(_pad_with_identity(a, n_pad), b)
        lu_log = lu_pad[:n, :n]
        eye = torch.eye(n, dtype=a.dtype, device=a.device)
        l = torch.tril(lu_log, -1) + eye
        u = torch.triu(lu_log)
    return mat._wrap(l), mat._wrap(u), perm[:n]


def cholesky_decompose(mat, mode: str = "auto", block_size: int | None = None,
                       schedule: str = "auto"):
    """Block Cholesky, lower factor (DenseVecMatrix.choleskyDecompose,
    DenseVecMatrix.scala:475-561). Returns L with ``A == L @ Lᵀ``.
    ``schedule`` as in :func:`lu_decompose`, except that ``"auto"`` resolves
    to ``"masked"`` here, as in the JAX package."""
    _require_square(mat)
    _resolve_schedule(schedule, 1, op="cholesky")  # arg validation in EVERY mode
    n = mat.num_rows()
    a = mat.logical()
    with precision_scope("highest"):
        if _mode_to_local(mode, n):
            return mat._wrap(_cholesky_block(a))
        b = min(block_size or get_config().cholesky_base_size, n)
        n_pad = _padded_size(mat, n, b)
        sched = _resolve_schedule(schedule, n_pad // b, op="cholesky")
        chol = (_blocked_cholesky_shrinking if sched == "shrinking"
                else _blocked_cholesky)
        l_pad = chol(_pad_with_identity(a, n_pad), b)
    return mat._wrap(l_pad[:n, :n])


def _inverse_via_lu(a: torch.Tensor, block: int, pivot: str = "block",
                    schedule: str = "masked") -> torch.Tensor:
    """The inverse of the padded ``a`` (updated in place) from its blocked
    LU and two triangular solves."""
    lu_pad, perm = _lu_factor(schedule, pivot)(a, block)
    n = a.shape[0]
    eye = torch.eye(n, dtype=a.dtype, device=a.device)
    l = torch.tril(lu_pad, -1) + eye
    u = torch.triu(lu_pad)
    # A[perm] = L U  =>  A^{-1} = (U^{-1} L^{-1}) P  where P x = x[perm]
    l_inv = torch.linalg.solve_triangular(l, eye, upper=False,
                                          unitriangular=True)
    pa_inv = torch.linalg.solve_triangular(u, l_inv, upper=True)
    return pa_inv[:, torch.argsort(perm)]


def inverse(mat, mode: str = "auto", block_size: int | None = None,
            pivot: str = "block", schedule: str = "auto"):
    """Matrix inverse (DenseVecMatrix.inverse, DenseVecMatrix.scala:568-764):
    blocked LU and two triangular solves. ``pivot`` and ``schedule`` as in
    :func:`lu_decompose` (the schedule applies to the LU stage)."""
    _require_square(mat)
    _require_pivot(pivot)
    _resolve_schedule(schedule, 1, pivot)  # arg validation in EVERY mode
    n = mat.num_rows()
    a = mat.logical()
    with precision_scope("highest"):
        if _mode_to_local(mode, n):
            return mat._wrap(torch.linalg.inv_ex(a).inverse)
        b = min(block_size or get_config().inverse_base_size, n)
        n_pad = _padded_size(mat, n, b)
        sched = _resolve_schedule(schedule, n_pad // b, pivot)
        inv_pad = _inverse_via_lu(_pad_with_identity(a, n_pad), b, pivot, sched)
    return mat._wrap(inv_pad[:n, :n])
