"""LU factors of a square matrix: ``A[perm] == L @ U``."""

from __future__ import annotations

import numpy as np
import torch


def perm_from_pivots(pivots: torch.Tensor) -> torch.Tensor:
    """LAPACK's 1-based sequential row swaps as a permutation ``perm``
    (``A[perm] == L @ U``)."""
    piv = pivots.cpu().numpy().astype(np.int64) - 1
    perm = np.arange(piv.shape[0])
    for i, p in enumerate(piv):
        if p != i:
            perm[i], perm[p] = perm[p], perm[i]
    return torch.from_numpy(perm)


def factor(a: torch.Tensor):
    """``(LU, perm)`` of ``a`` in float64 by LAPACK's partial pivoting
    (``torch.linalg.lu_factor``): L's strict lower triangle and U in one
    matrix, L's unit diagonal implied."""
    lu, pivots = torch.linalg.lu_factor(a.double())
    return lu, perm_from_pivots(pivots)


def backward_error(a, l, u, perm) -> torch.Tensor:
    """The componentwise backward error of ``A[perm] = L U``: the largest
    |A[perm] - L U| over |L| |U|, entry by entry, in ``a``'s dtype."""
    r = (a[perm] - l @ u).abs_()
    den = l.abs() @ u.abs()
    return (r / den.clamp_min_(torch.finfo(den.dtype).tiny)).max()


def blocked(a: torch.Tensor, block: int, tf32: bool):
    """``(LU, perm)`` of float32 ``a`` by a right-looking blocked LU that
    pivots within each ``block`` x ``block`` pivot block, its products with
    TF32 on or off."""
    a = a.clone()
    n = a.shape[0]
    perm = torch.arange(n, device=a.device)
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        for o in range(0, n, block):
            e = min(o + block, n)
            lu, pivots = torch.linalg.lu_factor(a[o:e, o:e])
            p = perm_from_pivots(pivots).to(a.device)
            a[o:e] = a[o:e][p]
            perm[o:e] = perm[o:e][p]
            a[o:e, o:e] = lu
            if e < n:
                l11 = torch.tril(lu, -1) + torch.eye(e - o, dtype=a.dtype,
                                                     device=a.device)
                u12 = torch.linalg.solve_triangular(l11, a[o:e, e:],
                                                    upper=False,
                                                    unitriangular=True)
                l21 = torch.linalg.solve_triangular(torch.triu(lu), a[e:, o:e],
                                                    upper=True, left=False)
                a[o:e, e:] = u12
                a[e:, o:e] = l21
                a[e:, e:] -= l21 @ u12
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
    return a, perm.cpu()
