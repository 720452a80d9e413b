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
left changed. The flag is process-wide (PyTorch reads it when a product is
dispatched), so :func:`precision_scope` is also a gate between threads: scopes
that want the same setting run together, and a scope that wants the other
one waits until every other thread has left its scope. The gate is fair
between the settings: while a thread waits for the other setting, new scopes
of the held one wait behind it, and when the last holder leaves, every thread
waiting for the other setting goes in at once. A thread that enters with
TF32 off (an inference entry point, the serving engine's worker) therefore
never dispatches a product while another thread has TF32 on, and a thread
that keeps TF32 scopes open back to back cannot hold it out.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any

import numpy as np
import torch

from ..config import get_config, tf32_for


def _precision(precision: str | None) -> str:
    return precision or get_config().matmul_precision


# The TF32 gate: the setting the open scopes hold, each holding thread's
# stack of the settings it entered, and the flag to restore when the last
# holder leaves; per setting, the threads waiting for it, those let in but
# not yet holding, and the count of times it was let in (a waiter's ticket).
_gate = threading.Condition()
_stacks: dict[int, list[bool]] = {}
_held: list = [None, None]  # [setting of the open scopes, flag before them]
_waiting = {False: 0, True: 0}
_granted = {False: 0, True: 0}
_rounds = {False: 0, True: 0}


def _busy() -> bool:
    return bool(_stacks) or any(_granted.values())


def _leave(me: int) -> list[bool]:
    """Take this thread out of the holders (under ``_gate``). When no holder
    is left, the gate goes to the threads waiting for the other setting,
    else to those waiting for this one, else the flag goes back to its
    outside value."""
    stack = _stacks.pop(me, [])
    if not _busy() and _held[0] is not None:
        cur = _held[0]
        for w in (not cur, cur):
            if _waiting[w]:
                _granted[w], _waiting[w] = _waiting[w], 0
                _rounds[w] += 1
                _held[0] = torch.backends.cuda.matmul.allow_tf32 = w
                break
        else:
            torch.backends.cuda.matmul.allow_tf32 = _held[1]
            _held[0] = None
    _gate.notify_all()
    return stack


def _hold(me: int, stack: list[bool]) -> None:
    """Make this thread a holder at ``stack[-1]`` (under ``_gate``). It goes
    in at once when the gate is empty, or holds that setting and no thread
    waits for the other; else it waits, holding nothing, until the gate is
    handed to its setting."""
    want = stack[-1]
    if not _busy():
        _held[1] = torch.backends.cuda.matmul.allow_tf32
        _held[0] = torch.backends.cuda.matmul.allow_tf32 = want
    elif _held[0] != want or _waiting[not want]:
        ticket = _rounds[want]
        _waiting[want] += 1
        try:
            while _rounds[want] == ticket:
                _gate.wait()
        except BaseException:  # interrupted: give back the place or the grant
            if _rounds[want] == ticket:
                _waiting[want] -= 1
            else:
                _granted[want] -= 1
                _leave(me)
            raise
        _granted[want] -= 1
    _stacks[me] = stack


@contextlib.contextmanager
def precision_scope(precision: str | None):
    """Set ``torch.backends.cuda.matmul.allow_tf32`` for ``precision`` and
    restore it on exit, through the gate the module docstring describes:
    entering waits while another thread holds a scope of the other setting,
    or waits for one. Scopes nest within a thread. A thread that must wait (entering, or
    leaving a nested scope for its outer one's setting) first stops holding
    its own scopes: it dispatches no product while it waits, and two threads
    that both switch cannot wait on each other.

    Inside a ``torch.compile`` trace (:func:`marlin_tpu_torch.lazy.fuse`)
    the scope is a no-op: a graph cannot hold a lock, and ``fuse`` enters
    one scope around the whole compiled call instead."""
    if torch.compiler.is_compiling():
        yield
        return
    want = tf32_for(_precision(precision))
    me = threading.get_ident()
    with _gate:
        stack = _leave(me)
        _hold(me, stack + [want])
    try:
        yield
    finally:
        with _gate:
            stack = _leave(me)[:-1]
            if stack:
                _hold(me, stack)


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
