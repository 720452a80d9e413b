"""Single-device block math (the reference's L2, SURVEY.md §2.2).

Counterpart of ``marlin_tpu/ops/local.py``. The reference's per-block hot
path is Breeze ``BDM * BDM`` → netlib dgemm (matrix/SubMatrix.scala:87-105);
the JAX package lowers it to the MXU through XLA, and here it goes to
``torch.matmul`` — or, with ``backend="pallas"``, to the hand-written kernel.

Sparse blocks are sparse COO tensors where the JAX package has BCOOs: sparse ×
dense and sparse × sparse are ``torch.sparse.mm`` on the operands' device.
The JAX package routes a large sparse × sparse product to scipy on the host
(``config.spsp_device_max_products``), past the nse_a × nse_b buffer XLA's
BCOO contraction would allocate; ``torch.sparse.mm`` allocates no such
buffer, so that route has no counterpart here, and neither have its
``jax.jit`` routes (``_spsp_host_jit`` through ``jax.pure_callback``,
``_is_tracing``): every call here runs eagerly, with an exact-sized result.

``precision`` follows ``config.TF32_BY_PRECISION``: the TF32 flag is set for
the one product and restored after it, so the process-wide setting is never
left changed. The flag is process-wide while the product runs, so concurrent
products from several threads with different precisions may see each other's
setting.
"""

from __future__ import annotations

import contextlib
from typing import Any

import numpy as np
import torch

from ..config import get_config, tf32_for


def _precision(precision: str | None) -> str:
    return precision or get_config().matmul_precision


@contextlib.contextmanager
def precision_scope(precision: str | None):
    """Set ``torch.backends.cuda.matmul.allow_tf32`` for ``precision`` and
    restore it on exit."""
    flags = torch.backends.cuda.matmul
    old = flags.allow_tf32
    flags.allow_tf32 = tf32_for(_precision(precision))
    try:
        yield
    finally:
        flags.allow_tf32 = old


def local_matmul(a: torch.Tensor, b: torch.Tensor, precision: str | None = None,
                 accum_dtype: Any = None) -> torch.Tensor:
    """``a @ b`` through ``torch.matmul`` at ``precision``. The result is in
    ``accum_dtype`` (default ``a.dtype``); a wider accumulation type than the
    operands' multiplies in that type, as ``preferred_element_type`` does."""
    accum_dtype = accum_dtype or a.dtype
    if accum_dtype != a.dtype or accum_dtype != b.dtype:
        a, b = a.to(accum_dtype), b.to(accum_dtype)
    with precision_scope(precision):
        return torch.matmul(a, b)


def gemm(a: torch.Tensor, b: torch.Tensor, precision: str | None = None,
         backend: str = "xla") -> torch.Tensor:
    """Dense block GEMM: the dgemm reached through Breeze ``BDM * BDM`` in the
    reference (SubMatrix.scala:92).

    ``backend="xla"`` (the name kept from the JAX package) is ``torch.matmul``;
    ``backend="pallas"`` routes through the hand-written tiled kernel
    (ops.pallas_kernels.pallas_matmul), which always accumulates in f32."""
    if backend == "pallas":
        from .pallas_kernels import pallas_matmul

        if precision is not None:
            raise ValueError(
                "backend='pallas' always accumulates in f32; the precision "
                "argument is not honored there — pass precision=None"
            )
        return pallas_matmul(a, b)
    if backend != "xla":
        raise ValueError(f"unknown gemm backend: {backend!r}")
    return local_matmul(a, b, precision)


def matvec(a: torch.Tensor, x: torch.Tensor,
           precision: str | None = None) -> torch.Tensor:
    """Dense mat-vec (SubMatrix.multiply(Vector), SubMatrix.scala:131-139)."""
    return local_matmul(a, x, precision)


def dspr(alpha: float, x: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """Symmetric rank-1 update ``A + alpha * x xᵀ`` on a full (not packed)
    matrix (the reference's BLAS dspr, DenseVecMatrix.scala:1691-1703)."""
    return a + alpha * torch.outer(x, x)


def syrk(a: torch.Tensor, precision: str | None = None) -> torch.Tensor:
    """Gramian block ``AᵀA`` (DenseVecMatrix.computeGramianMatrix,
    DenseVecMatrix.scala:1444-1486)."""
    return local_matmul(a.T, a, precision)


def axpy(a: float, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``y + a·x`` — the reference's vectMultiplyAdd (Vectors.scala)."""
    return y + a * x


def triu_to_full(u: torch.Tensor) -> torch.Tensor:
    """Mirror an upper-triangular matrix into a full symmetric one
    (DenseVecMatrix.triuToFull, DenseVecMatrix.scala:1705-1722)."""
    return torch.triu(u) + torch.triu(u, 1).T


def _to_bcoo(x: torch.Tensor) -> torch.Tensor:
    """``x`` as a sparse COO tensor (a dense one through ``to_sparse``)."""
    return x if x.is_sparse else x.to_sparse()


def _same_dtype(a: torch.Tensor, b: torch.Tensor):
    """Both operands in their promoted dtype (``torch.sparse.mm`` takes one
    dtype; the JAX package's BCOO products promote)."""
    dtype = torch.promote_types(a.dtype, b.dtype)
    return a.to(dtype), b.to(dtype)


def mult_sparse_dense(sp: torch.Tensor, dense: torch.Tensor) -> torch.Tensor:
    """Sparse × dense block multiply with dense output — the role of
    ``LibMatrixMult.multSparseDense`` (LibMatrixMult.scala:43-77)."""
    sp, dense = _same_dtype(_to_bcoo(sp), dense)
    return torch.sparse.mm(sp, dense)


def mult_dense_sparse(dense: torch.Tensor, sp: torch.Tensor) -> torch.Tensor:
    """Dense × sparse block multiply (``LibMatrixMult.multDenseSparse``,
    LibMatrixMult.scala:15-41), as ``(spᵀ @ denseᵀ)ᵀ``."""
    sp, dense = _same_dtype(_to_bcoo(sp), dense)
    return torch.sparse.mm(sp.t(), dense.t()).t()


def _triplets(x: torch.Tensor):
    """Host (rows, cols, vals) of a sparse COO tensor, duplicates kept."""
    idx = x._indices().cpu().numpy()
    return idx[0], idx[1], x._values().detach().cpu().numpy()


def mult_sparse_sparse_bound(a, b) -> int:
    """An upper bound on the nonzeros of :func:`mult_sparse_sparse`'s result
    — the classic SpGEMM product bound: result row i holds at most
    min(Σ_{k ∈ row i of A} nnz(B row k), n) nonzeros. Computed on the host
    from the index arrays (O(nse))."""
    a, b = _to_bcoo(a), _to_bcoo(b)
    m, n = int(a.shape[0]), int(b.shape[1])
    ar, ak, _ = _triplets(a)
    bk = _triplets(b)[0]
    # out-of-range (padding) entries contribute nothing
    a_live = ar < m
    b_live = bk < b.shape[0]
    rowcount_b = np.bincount(bk[b_live], minlength=int(a.shape[1]) + 1)
    prods = rowcount_b[np.minimum(ak[a_live], int(a.shape[1]))]
    per_row = np.bincount(ar[a_live], weights=prods, minlength=m)
    return int(max(1, np.minimum(per_row, n).sum()))


def mult_sparse_sparse(a, b, out_nse: int | None = None) -> torch.Tensor:
    """Sparse × sparse multiply with a coalesced (deduplicated, sorted)
    sparse result (CSC×CSC in the reference, Matrices.scala:129-152), by
    ``torch.sparse.mm`` on the operands' device. ``out_nse`` sizes the JAX
    package's result under ``jax.jit``; eagerly, there as here, it is
    accepted and ignored."""
    del out_nse
    a, b = _same_dtype(_to_bcoo(a), _to_bcoo(b))
    return torch.sparse.mm(a, b).coalesce()


def block_multiply(a: torch.Tensor, b: torch.Tensor,
                   precision: str | None = None) -> torch.Tensor:
    """Four-way dense/sparse dispatch, the analog of ``SubMatrix.multiply``
    (SubMatrix.scala:87-105)."""
    if a.is_sparse and b.is_sparse:
        return mult_sparse_sparse(a, b)
    if a.is_sparse:
        return mult_sparse_dense(a, b)
    if b.is_sparse:
        return mult_dense_sparse(a, b)
    return gemm(a, b, precision)
