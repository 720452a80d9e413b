"""Dense distributed matrices.

Counterpart of ``marlin_tpu/matrix/dense.py``. The reference has two dense
distributed types, row-partitioned ``DenseVecMatrix``
(matrix/DenseVecMatrix.scala:41-44) and 2-D block-partitioned ``BlockMatrix``
(matrix/BlockMatrix.scala:28); the JAX package makes both one global array
with a sharding ``("rows", None)`` or ``("rows", "cols")`` over a mesh. Here
the mesh is a world of one (mesh.py), so a matrix is one tensor on one device
and the spec is kept as the layout's name.

``data`` may be zero-padded beyond the logical ``shape`` (the JAX package
pads to the mesh grid; at world size 1 the grid divides everything, so
padding arises only from data built that way). The invariant *pad region is
always zero* holds as in the JAX package: ops that would break it (scalar
add, divides) re-mask.

The factorizations, ``compute_svd``, ``solve`` and ``lr`` delegate to
``marlin_tpu_torch.linalg`` and ``marlin_tpu_torch.ml``, as the JAX
package's methods do. Not here yet (they reach IO or pandas):
``to_dataframe`` and the ``save_*`` methods.
"""

from __future__ import annotations

import math
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from ..config import get_config
from ..interop import to_tensor
from ..mesh import COLS, ROWS, Mesh, default_mesh, pad_to_multiple
from ..ops.local import local_matmul, matvec
from ..random import random_array
from .base import DistributedMatrix

__all__ = ["DenseMatrix", "DenseVecMatrix", "BlockMatrix"]


def _grid_divisors(mesh: Mesh, spec: tuple) -> tuple[int, int]:
    """How many shards each of the two dims is cut into under ``spec``."""
    out = []
    for i in range(2):
        ax = spec[i] if i < len(spec) else None
        out.append(mesh.shape[ax] if ax is not None else 1)
    return tuple(out)


def _is_scalar(x) -> bool:
    return isinstance(x, (int, float)) or getattr(x, "ndim", None) == 0


class DenseMatrix(DistributedMatrix):
    """A dense matrix on the mesh's device. See module docstring."""

    _default_spec: tuple = (ROWS, COLS)

    def __init__(self, data: torch.Tensor, shape: tuple[int, int], mesh: Mesh,
                 spec: tuple):
        self.data = data  # padded
        self._shape = (int(shape[0]), int(shape[1]))
        self.mesh = mesh
        self.spec = tuple(spec)

    # ------------------------------------------------------------- factories
    @classmethod
    def from_array(
        cls,
        arr,
        mesh: Mesh | None = None,
        spec: tuple | None = None,
        dtype: Any = None,
    ) -> "DenseMatrix":
        mesh = mesh or default_mesh()
        spec = spec if spec is not None else cls._default_spec
        arr = to_tensor(arr, dtype, mesh.device)
        if arr.ndim != 2:
            raise ValueError(f"expected a 2-D array, got shape {tuple(arr.shape)}")
        m, n = arr.shape
        if m == 0 or n == 0:
            # parity with the reference's empty-RDD IllegalArgumentException
            # (DistributedMatrixSuite.scala:53-71)
            raise ValueError(f"cannot build a distributed matrix with shape "
                             f"{tuple(arr.shape)}")
        gr, gc = _grid_divisors(mesh, spec)
        mp, np_ = pad_to_multiple(m, gr), pad_to_multiple(n, gc)
        if (mp, np_) != (m, n):
            arr = F.pad(arr, (0, np_ - n, 0, mp - m))
        return cls(arr, (m, n), mesh, spec)

    @classmethod
    def random(
        cls,
        seed_or_key,
        rows: int,
        cols: int,
        dist: str = "uniform",
        mesh: Mesh | None = None,
        spec: tuple | None = None,
        dtype: Any = None,
        **kwargs,
    ) -> "DenseMatrix":
        """Random factory (MTUtils.randomDenVecMatrix / randomBlockMatrix,
        utils/MTUtils.scala:34-134): the data is generated on the device."""
        mesh = mesh or default_mesh()
        spec = spec if spec is not None else cls._default_spec
        gr, gc = _grid_divisors(mesh, spec)
        mp, np_ = pad_to_multiple(rows, gr), pad_to_multiple(cols, gc)
        data = random_array(seed_or_key, (mp, np_), dist=dist, dtype=dtype,
                            device=mesh.device, **kwargs)
        mat = cls(data, (rows, cols), mesh, spec)
        if (mp, np_) != (rows, cols):
            mat.data = mat._mask_padded(mat.data)
        return mat

    @classmethod
    def zeros(cls, rows: int, cols: int, mesh=None, spec=None, dtype=None):
        return cls.random(0, rows, cols, dist="zeros", mesh=mesh, spec=spec, dtype=dtype)

    @classmethod
    def ones(cls, rows: int, cols: int, mesh=None, spec=None, dtype=None):
        return cls.random(0, rows, cols, dist="ones", mesh=mesh, spec=spec, dtype=dtype)

    # ------------------------------------------------------------ structure
    def num_rows(self) -> int:
        return self._shape[0]

    def num_cols(self) -> int:
        return self._shape[1]

    @property
    def dtype(self) -> torch.dtype:
        return self.data.dtype

    @property
    def device(self) -> torch.device:
        return self.data.device

    @property
    def _padded(self) -> bool:
        return tuple(self.data.shape) != self._shape

    def logical(self) -> torch.Tensor:
        """The unpadded (m, n) view."""
        m, n = self._shape
        return self.data if not self._padded else self.data[:m, :n]

    def to_numpy(self) -> np.ndarray:
        """The logical matrix on the host (bf16 comes back as float32: numpy
        has no bf16 of its own)."""
        t = self.logical().detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    def _mask_padded(self, x: torch.Tensor) -> torch.Tensor:
        """Restore the zero-pad invariant on a padded-shape tensor."""
        m, n = self._shape
        if tuple(x.shape) == (m, n):
            return x
        r = torch.arange(x.shape[0], device=x.device)[:, None] < m
        c = torch.arange(x.shape[1], device=x.device)[None, :] < n
        return torch.where(r & c, x, torch.zeros((), dtype=x.dtype,
                                                 device=x.device))

    def _like(self, data: torch.Tensor) -> "DenseMatrix":
        return type(self)(data, self._shape, self.mesh, self.spec)

    def _wrap(self, arr: torch.Tensor, spec: tuple | None = None) -> "DenseMatrix":
        """Wrap a logical tensor produced by an op, choosing the class from
        the layout spec."""
        spec = spec if spec is not None else self.spec
        klass = BlockMatrix if (len(spec) > 1 and spec[1] is not None) else DenseVecMatrix
        return klass.from_array(arr, self.mesh, spec)

    def _operand_data(self, other: "DenseMatrix") -> torch.Tensor:
        """Other's data aligned to self's mesh/spec/padding."""
        if other.shape != self.shape:
            raise ValueError(f"dimension mismatch: {self.shape} vs {other.shape}")
        if (
            other.mesh == self.mesh
            and other.spec == self.spec
            and other.data.shape == self.data.shape
        ):
            return other.data
        aligned = type(self).from_array(other.logical(), self.mesh, self.spec)
        return aligned.data

    # ----------------------------------------------------------- arithmetic
    def _binary(self, other, fn, remask_scalar=False, remask_matrix=False):
        if isinstance(other, DenseMatrix):
            out = fn(self.data, self._operand_data(other))
            remask = remask_matrix
        elif _is_scalar(other):
            out = fn(self.data, other)
            remask = remask_scalar
        else:
            other_m = type(self).from_array(other, self.mesh, self.spec)
            out = fn(self.data, self._operand_data(other_m))
            remask = remask_matrix
        if remask:
            out = self._mask_padded(out)
        return self._like(out)

    def add(self, other):
        return self._binary(other, lambda a, b: a + b, remask_scalar=True)

    def subtract(self, other):
        return self._binary(other, lambda a, b: a - b, remask_scalar=True)

    def subtract_by(self, d):
        """``d - A`` (DistributedMatrix.subtractBy, DistributedMatrix.scala:30)."""
        return self._binary(d, lambda a, b: b - a, remask_scalar=True)

    def divide(self, other):
        return self._binary(other, lambda a, b: a / b, remask_scalar=False,
                            remask_matrix=True)

    def divide_by(self, d):
        """``d / A`` elementwise (DistributedMatrix.divideBy)."""
        return self._binary(d, lambda a, b: b / a, remask_scalar=True)

    def dot_product(self, other):
        """Elementwise (Hadamard) product — the reference's ``dotProduct``
        (DenseVecMatrix.scala:905-920)."""
        return self._binary(other, lambda a, b: a * b)

    element_multiply = dot_product  # BlockMatrix.elementMultiply (BlockMatrix.scala:673-680)

    def sum(self) -> torch.Tensor:
        # reductions mask explicitly rather than trusting the zero-pad
        # invariant, as the JAX package does
        return torch.sum(self._mask_padded(self.data))

    def elements_count(self) -> int:
        return self.num_rows()

    def norm(self, mode: str = "fro") -> torch.Tensor:
        """Matrix norms (DenseVecMatrix.norm, DenseVecMatrix.scala:975-999):
        "1" and "inf" (largest column/row sum), "fro", and "2" by power
        iteration."""
        m, n = self._shape
        data = self._mask_padded(self.data)  # see sum()
        if mode == "1":
            return torch.max(torch.sum(torch.abs(data), dim=0)[:n])
        if mode == "inf":
            return torch.max(torch.sum(torch.abs(data), dim=1)[:m])
        if mode == "fro":
            return torch.sqrt(torch.sum(data * data))
        if mode == "2":
            return _power_iteration_norm2(data)
        raise ValueError(f"unknown norm mode: {mode}")

    # -------------------------------------------------------------- matmul
    def multiply(
        self,
        other,
        strategy: str = "auto",
        split: tuple[int, int, int] | None = None,
        broadcast_threshold_mb: float | None = None,
        precision: str | None = None,
    ):
        """Adaptive distributed multiply (DenseVecMatrix.multiply with cores +
        broadcastThreshold, DenseVecMatrix.scala:196-231; BlockMatrix.multiply,
        BlockMatrix.scala:87-220). Scalars do elementwise scaling; vectors do
        mat-vec; matrices dispatch over the strategies of
        marlin_tpu_torch.parallel.matmul, each of which is one
        ``torch.matmul`` on one device."""
        from ..parallel.matmul import matmul as _matmul
        from ..parallel.matmul import matmul_padded
        from .vector import DistributedVector

        if isinstance(other, (int, float)):
            return self._like(self.data * other)
        if isinstance(other, DistributedVector):
            return self.multiply_vector(other)
        if getattr(other, "ndim", None) == 1:
            return self.multiply_vector(DistributedVector.from_array(other, self.mesh))
        if strategy == "tuned":
            # empirical dispatch: time the viable engines once per
            # configuration and use the cached winner (parallel.autotune)
            from ..parallel.autotune import best_strategy

            strategy = best_strategy(self, other, precision=precision)

        if isinstance(other, DenseMatrix):
            b_pad, (kb, n) = other.data.to(self.device), other.shape
        else:
            b_pad = to_tensor(other, device=self.device)
            kb, n = b_pad.shape
        m, k = self.shape
        if k != kb:
            raise ValueError(f"inner dim mismatch: {self.shape} @ {(kb, n)}")
        out_spec = (ROWS, COLS) if self.mesh.shape.get(COLS, 1) > 1 else (ROWS, None)
        gr, gc = _grid_divisors(self.mesh, out_spec)
        out_pad = (pad_to_multiple(m, gr), pad_to_multiple(n, gc))
        klass = BlockMatrix if out_spec[1] is not None else DenseVecMatrix

        c_pad = matmul_padded(
            self.data,
            b_pad,
            (m, k, n),
            self.mesh,
            out_pad,
            strategy=strategy,
            split=split,
            broadcast_threshold_mb=broadcast_threshold_mb,
            precision=precision,
        )
        if c_pad is not None:
            return klass(c_pad, (m, n), self.mesh, out_spec)

        # logical-tensor path (ring, or an RMM split that does not fill the mesh)
        c = _matmul(
            self.logical(),
            other.logical().to(self.device) if isinstance(other, DenseMatrix)
            else b_pad,
            mesh=self.mesh,
            strategy=strategy,
            split=split,
            broadcast_threshold_mb=broadcast_threshold_mb,
            precision=precision,
        )
        return self._wrap(c, out_spec)

    def multiply_broadcast(self, other, precision: str | None = None):
        """Force the small-operand broadcast path (DenseVecMatrix.scala:1660-1680,
        BlockMatrix.multiplyBroadcast, BlockMatrix.scala:280-335)."""
        return self.multiply(other, strategy="broadcast", precision=precision)

    def multiply_vector(self, vec):
        """Mat-vec (DenseVecMatrix.scala:149-184, BlockMatrix.scala:240-274)."""
        from .vector import DistributedVector

        v = (vec.logical() if isinstance(vec, DistributedVector)
             else to_tensor(vec, device=self.device))
        if v.shape[0] != self.num_cols():
            raise ValueError(f"mat-vec dim mismatch: {self.shape} @ {tuple(v.shape)}")
        v = F.pad(v.to(self.device), (0, self.data.shape[1] - v.shape[0]))
        y = matvec(self.data, v, "highest")
        return DistributedVector.from_array(y[: self.num_rows()], self.mesh)

    def multiply_gramian_by(self, v, precision: str | None = None):
        """Matrix-free ``v ↦ AᵀA·v`` — the operator the reference hands to
        ARPACK (DenseVecMatrix.multiplyGramianMatrixBy, DenseVecMatrix.scala:
        1444-1459)."""
        from .vector import DistributedVector

        vec = (v.logical() if isinstance(v, DistributedVector)
               else to_tensor(v, device=self.device))
        a = self.logical()
        p = precision or get_config().matmul_precision
        out = local_matmul(a.T, local_matmul(a, vec, p), p)
        return DistributedVector.from_array(out, self.mesh)

    def row_exchange(self, permutation):
        """Apply a row permutation (the reference's rowExchange used to apply
        accumulated LU pivots, DenseVecMatrix.scala:438-460)."""
        perm = np.asarray(permutation)
        if perm.shape[0] != self.num_rows():
            raise ValueError("permutation length must equal the row count")
        return self._wrap(self.logical()[torch.as_tensor(perm, device=self.device)])

    def gramian(self, precision: str | None = None):
        """``AᵀA`` as one contraction — replaces the treeAggregate-of-dspr
        formulation (DenseVecMatrix.computeGramianMatrix,
        DenseVecMatrix.scala:1444-1486)."""
        from ..parallel.matmul import gspmd_matmul

        g = gspmd_matmul(self.data.T, self.data, self.mesh, precision=precision)
        n = self.num_cols()
        return self._wrap(g[:n, :n])

    # ------------------------------------------------------------ structure ops
    def transpose(self):
        return self._wrap(self.logical().T)

    def _bind(self, other, axis: int, label: str):
        other_arr = (other.logical() if isinstance(other, DenseMatrix)
                     else to_tensor(other, device=self.device))
        if other_arr.shape[1 - axis] != self._shape[1 - axis]:
            raise ValueError(
                f"{label}: {'row' if axis == 1 else 'column'} count mismatch"
            )
        return self._wrap(torch.cat([self.logical(), other_arr.to(self.device)],
                                    dim=axis))

    def c_bind(self, other):
        """Column concatenation (DenseVecMatrix.cBind, DenseVecMatrix.scala:238-252)."""
        return self._bind(other, axis=1, label="cBind")

    def r_bind(self, other):
        """Row concatenation — the natural pair of cBind (the reference stops
        at cBind; DistributedMatrix.scala:62)."""
        return self._bind(other, axis=0, label="rBind")

    def slice_by_row(self, start_row: int, end_row: int):
        """Inclusive row range (DenseVecMatrix.sliceByRow, :928-939)."""
        self._check_range(start_row, end_row, self.num_rows())
        return self._wrap(self.logical()[start_row : end_row + 1, :])

    def slice_by_column(self, start_col: int, end_col: int):
        """Inclusive column range (DenseVecMatrix.sliceByColumn, :941-947)."""
        self._check_range(start_col, end_col, self.num_cols())
        return self._wrap(self.logical()[:, start_col : end_col + 1])

    def get_sub_matrix(self, start_row: int, end_row: int, start_col: int, end_col: int):
        """Inclusive submatrix (DenseVecMatrix.getSubMatrix, :956-964)."""
        self._check_range(start_row, end_row, self.num_rows())
        self._check_range(start_col, end_col, self.num_cols())
        return self._wrap(
            self.logical()[start_row : end_row + 1, start_col : end_col + 1]
        )

    @staticmethod
    def _check_range(start, end, limit):
        if not (0 <= start <= end < limit):
            raise ValueError(f"slice range [{start}, {end}] out of bounds for size {limit}")

    def repeat_by_row(self, times: int):
        """Repeat each row's content ``times`` times, widening the matrix to
        cols×times (MTUtils.repeatByRow, utils/MTUtils.scala:446-464)."""
        if times < 1:
            raise ValueError(f"repeat times: {times} illegal")
        return self._wrap(torch.tile(self.logical(), (1, times)))

    def repeat_by_column(self, times: int):
        """Stack the matrix vertically ``times`` times, growing rows×times
        (MTUtils.repeatByColumn, utils/MTUtils.scala:471-491)."""
        if times < 1:
            raise ValueError(f"repeat times: {times} illegal")
        return self._wrap(torch.tile(self.logical(), (times, 1)))

    # ------------------------------------------------------------ conversions
    def to_block_matrix(self, mesh: Mesh | None = None) -> "BlockMatrix":
        """The 2-D block layout (DenseVecMatrix.toBlockMatrix,
        DenseVecMatrix.scala:1226-1328)."""
        return BlockMatrix.from_array(self.logical(), mesh or self.mesh)

    def to_dense_vec_matrix(self, mesh: Mesh | None = None) -> "DenseVecMatrix":
        """The row layout (BlockMatrix.toDenseVecMatrix, BlockMatrix.scala:575-594)."""
        return DenseVecMatrix.from_array(self.logical(), mesh or self.mesh)

    def to_sparse_vec_matrix(self, tol: float = 0.0):
        """Dense → sparse conversion (DenseVecMatrix.toSparseVecMatrix,
        DenseVecMatrix.scala:1333-1353). Entries with |x| <= tol are
        dropped."""
        from .sparse import SparseVecMatrix

        arr = self.logical()
        if tol > 0.0:
            arr = torch.where(arr.abs() > tol, arr,
                              torch.zeros((), dtype=arr.dtype,
                                          device=arr.device))
        return SparseVecMatrix.from_dense(arr, self.mesh)

    def multiply_by(self, local_matrix, precision: str | None = None):
        """``local @ self`` with the local operand replicated — the mirror of
        ``multiply_broadcast`` (BlockMatrix.multiplyBy, BlockMatrix.scala:313-335)."""
        from ..parallel.matmul import broadcast_matmul

        local = to_tensor(
            local_matrix.logical() if hasattr(local_matrix, "logical") else local_matrix,
            device=self.device,
        )
        if local.shape[1] != self.num_rows():
            raise ValueError(f"inner dim mismatch: {tuple(local.shape)} @ {self.shape}")
        out = broadcast_matmul(local, self.logical(), self.mesh, "a", precision)
        return self._wrap(out)

    def reshard(self, spec: tuple, mesh: Mesh | None = None) -> "DenseMatrix":
        """General re-layout (the analog of BlockMatrix.toBlockMatrix(r, c)
        re-blocking, BlockMatrix.scala:610-665)."""
        return self._wrap(self.logical(), spec) if mesh is None else type(self).from_array(
            self.logical(), mesh, spec
        )

    # --------------------------------------------------------- factorizations
    def lu_decompose(self, mode: str = "auto", **kwargs):
        from ..linalg import lu_decompose

        return lu_decompose(self, mode=mode, **kwargs)

    def cholesky_decompose(self, mode: str = "auto", **kwargs):
        from ..linalg import cholesky_decompose

        return cholesky_decompose(self, mode=mode, **kwargs)

    def inverse(self, mode: str = "auto", **kwargs):
        from ..linalg import inverse

        return inverse(self, mode=mode, **kwargs)

    def compute_svd(self, k: int, mode: str = "auto", **kwargs):
        from ..linalg import compute_svd

        return compute_svd(self, k, mode=mode, **kwargs)

    def solve(self, b, mode: str = "auto", **kwargs):
        """Solve ``self @ x = b`` (marlin_tpu_torch.linalg.solve)."""
        from ..linalg import solve

        return solve(self, b, mode=mode, **kwargs)

    # --------------------------------------------------------------- training
    def lr(self, step_size: float, iters: int) -> np.ndarray:
        """Full-batch logistic-gradient descent over rows of (label,
        features) — parity with DenseVecMatrix.lr
        (DenseVecMatrix.scala:1005-1035): the first column is the label and
        is replaced by a 1-intercept. Delegates to
        marlin_tpu_torch.ml.logistic_regression."""
        from ..ml.logistic_regression import logistic_regression

        return logistic_regression(self, step_size=step_size,
                                   iterations=iters).weights

    # ----------------------------------------------------------------- print
    def print_matrix(self, max_rows: int = 10, max_cols: int = 10):
        """Truncated dump (DistributedMatrix.print, DenseVecMatrix.scala:1401-1408)."""
        arr = self.to_numpy()
        print(arr[: min(max_rows, arr.shape[0]), : min(max_cols, arr.shape[1])])

    def print_all(self):
        print(self.to_numpy())

    def __getitem__(self, key):
        """NumPy-style 2-D slicing returning a submatrix (no reference
        analog — sliceByRow/sliceByColumn cover inclusive ranges). Integer
        indices are bounds-checked."""
        if not isinstance(key, tuple) or len(key) != 2:
            raise TypeError("expected 2-D index like m[rows, cols]")
        for idx, limit in zip(key, self._shape):
            if isinstance(idx, (int, np.integer)) and not -limit <= idx < limit:
                raise IndexError(f"index {idx} out of bounds for size {limit}")
        out = self.logical()[key]
        if out.ndim != 2:
            return out  # scalar or 1-D row/column: plain tensor
        return self._wrap(out)

    def __repr__(self):
        return (
            f"{type(self).__name__}(shape={self._shape}, dtype={self.dtype}, "
            f"spec={self.spec}, mesh={self.mesh.shape}, device={self.device})"
        )


class DenseVecMatrix(DenseMatrix):
    """Row-partitioned dense matrix — layout ``("rows", None)``; the analog
    of the reference's richest type (matrix/DenseVecMatrix.scala)."""

    _default_spec = (ROWS, None)


class BlockMatrix(DenseMatrix):
    """2-D block-partitioned dense matrix — layout ``("rows", "cols")``
    (matrix/BlockMatrix.scala). The block grid is the mesh grid."""

    _default_spec = (ROWS, COLS)

    def elements_count(self) -> int:
        # the reference counts sub-blocks for BlockMatrix (BlockMatrix.scala:462-465)
        return math.prod(self.mesh.shape.get(ax, 1) for ax in (ROWS, COLS))

    @property
    def blocks_by_row(self) -> int:
        return self.mesh.shape.get(ROWS, 1)

    @property
    def blocks_by_col(self) -> int:
        return self.mesh.shape.get(COLS, 1)

    def to_dense_blocks(self) -> "BlockMatrix":
        """Parity shim for BlockMatrix.toDenseBlocks (BlockMatrix.scala:596-603):
        blocks here are always dense, so this is the identity."""
        return self


def _power_iteration_norm2(a: torch.Tensor) -> torch.Tensor:
    n = a.shape[1]
    v = torch.ones((n,), dtype=a.dtype, device=a.device) / math.sqrt(n)
    for _ in range(50):
        w = local_matmul(a.T, local_matmul(a, v, "highest"), "highest")
        v = w / (torch.linalg.vector_norm(w) + 1e-30)
    return torch.linalg.vector_norm(local_matmul(a, v, "highest"))
