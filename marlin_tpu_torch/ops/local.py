"""Single-device block math (the reference's L2, SURVEY.md §2.2), dense half.

Counterpart of the dense half of ``marlin_tpu/ops/local.py``. The reference's
per-block hot path is Breeze ``BDM * BDM`` → netlib dgemm
(matrix/SubMatrix.scala:87-105); the JAX package lowers it to the MXU through
XLA, and here it goes to ``torch.matmul`` — or, with ``backend="pallas"``, to
the hand-written kernel. The sparse kernels of that module wait for the
sparse slice.

``precision`` follows ``config.TF32_BY_PRECISION``: the TF32 flag is set for
the one product and restored after it, so the process-wide setting is never
left changed. The flag is process-wide while the product runs, so concurrent
products from several threads with different precisions may see each other's
setting.
"""

from __future__ import annotations

import contextlib
from typing import Any

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


def block_multiply(a: torch.Tensor, b: torch.Tensor,
                   precision: str | None = None) -> torch.Tensor:
    """Dense × dense block multiply, the dense quarter of
    ``SubMatrix.multiply``'s four-way dispatch (SubMatrix.scala:87-105); the
    sparse operands arrive with the sparse slice."""
    if a.is_sparse or b.is_sparse:
        raise TypeError("sparse block operands are not supported yet")
    return gemm(a, b, precision)
