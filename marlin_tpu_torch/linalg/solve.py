"""Linear-system solves on dense matrices.

Counterpart of ``marlin_tpu/linalg/solve.py``. The reference stops at the
factorizations (its ALS even inverts explicitly, ALSHelp.scala:388-392); the
JAX package closes the gap, and so does this module:

- :func:`lu_solve` — reuse an ``(L, U, perm)`` from :func:`lu_decompose`
  against one or many right-hand sides (two triangular solves).
- :func:`cholesky_solve` — the SPD counterpart, reusing ``L`` from
  :func:`cholesky_decompose`.
- :func:`solve` — factor-and-solve with the same mode knobs.

The triangular solves are ``torch.linalg.solve_triangular`` on the factors'
device; no explicit inverse is ever formed.
"""

from __future__ import annotations

import torch

from ..ops.local import precision_scope
from .factorizations import PIVOT_STRATEGIES, _mode_to_local, lu_decompose

__all__ = ["lu_solve", "cholesky_solve", "solve"]


def _as_tensor(x, like: torch.Tensor | None = None) -> torch.Tensor:
    """A dense matrix or vector (its logical tensor), a tensor, a numpy
    array or a list, as a tensor; on ``like``'s device and dtype when
    given."""
    t = x.logical() if hasattr(x, "logical") else torch.as_tensor(x)
    return t if like is None else t.to(device=like.device, dtype=like.dtype)


def _rhs_tensor(b, like: torch.Tensor):
    t = _as_tensor(b, like)
    return (t[:, None], True) if t.ndim == 1 else (t, False)


def _factor_and_rhs(factor, b):
    """Shared coercion and validation of the factor-reuse solvers: returns
    (factor tensor, 2-D rhs on its device, was_vector)."""
    f = _as_tensor(factor)
    rhs, was_vector = _rhs_tensor(b, f)
    if rhs.shape[0] != f.shape[0]:
        raise ValueError(
            f"rhs has {rhs.shape[0]} rows, factorization is {f.shape[0]}"
        )
    return f, rhs, was_vector


def lu_solve(l, u, perm, b):
    """Solve ``A x = b`` given ``A[perm] = L U`` from :func:`lu_decompose`.
    ``b``: vector, matrix, or dense matrix/vector; returns a tensor of the
    same logical shape on the factors' device (``perm`` may be a device
    tensor, numpy or a list)."""
    l_t, rhs, was_vector = _factor_and_rhs(l, b)
    u_t = _as_tensor(u)
    perm = torch.as_tensor(perm, device=l_t.device)
    with precision_scope("highest"):
        y = torch.linalg.solve_triangular(l_t, rhs[perm], upper=False,
                                          unitriangular=True)
        x = torch.linalg.solve_triangular(u_t, y, upper=True)
    return x[:, 0] if was_vector else x


def cholesky_solve(l, b):
    """Solve ``A x = b`` given ``A = L Lᵀ`` from :func:`cholesky_decompose`
    (two triangular solves; the SPD counterpart of :func:`lu_solve`)."""
    l_t, rhs, was_vector = _factor_and_rhs(l, b)
    with precision_scope("highest"):
        y = torch.linalg.solve_triangular(l_t, rhs, upper=False)
        x = torch.linalg.solve_triangular(l_t.T, y, upper=True)
    return x[:, 0] if was_vector else x


def solve(mat, b, mode: str = "auto", pivot: str = "block",
          block_size: int | None = None):
    """Solve ``mat @ x = b``. Small systems go through one local solve
    (``torch.linalg.solve_ex``); large ones factor with the blocked LU
    (``pivot``/``block_size`` forwarded) and back-substitute — never through
    an explicit inverse."""
    if pivot not in PIVOT_STRATEGIES:
        raise ValueError(
            f"unknown pivot strategy: {pivot!r} (one of {PIVOT_STRATEGIES})"
        )
    n = mat.num_rows()
    if mat.num_cols() != n:
        raise ValueError(f"solve needs a square matrix, got {mat.shape}")
    a = mat.logical()
    rhs, was_vector = _rhs_tensor(b, a)
    if rhs.shape[0] != n:
        raise ValueError(f"rhs has {rhs.shape[0]} rows, matrix is {n}x{n}")
    if _mode_to_local(mode, n):
        with precision_scope("highest"):
            x = torch.linalg.solve_ex(a, rhs).result
        return x[:, 0] if was_vector else x
    l, u, perm = lu_decompose(mat, mode=mode, pivot=pivot, block_size=block_size)
    return lu_solve(l, u, perm, rhs[:, 0] if was_vector else rhs)
