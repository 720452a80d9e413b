"""MTUtils-parity factory facade.

Counterpart of ``marlin_tpu/utils/mtutils.py``, over the port's matrix
classes. The reference funnels all user-facing construction through the
``MTUtils`` object (utils/MTUtils.scala:34-134 factories, 402-438 array
converters, 446-491 repeat). These are thin wrappers over the matrix
classmethods so code ported from the reference reads one-to-one.
"""

from __future__ import annotations

import numpy as np

from ..matrix.dense import BlockMatrix, DenseVecMatrix
from ..matrix.sparse import SparseVecMatrix
from ..matrix.vector import DistributedVector


def random_den_vec_matrix(rows: int, cols: int, seed: int = 0,
                          dist: str = "uniform", mesh=None, **kw):
    """MTUtils.randomDenVecMatrix (utils/MTUtils.scala:63-73)."""
    return DenseVecMatrix.random(seed, rows, cols, dist=dist, mesh=mesh, **kw)


def random_block_matrix(rows: int, cols: int, seed: int = 0,
                        dist: str = "uniform", mesh=None, **kw):
    """MTUtils.randomBlockMatrix (utils/MTUtils.scala:96-116)."""
    return BlockMatrix.random(seed, rows, cols, dist=dist, mesh=mesh, **kw)


def random_dis_vector(length: int, seed: int = 0, dist: str = "uniform",
                      mesh=None, **kw):
    """MTUtils.randomDisVector (utils/MTUtils.scala:34-47)."""
    return DistributedVector.random(seed, length, dist=dist, mesh=mesh, **kw)


def random_spa_vec_matrix(rows: int, cols: int, density: float = 0.01,
                          seed: int = 0, mesh=None, **kw):
    """MTUtils.randomSpaVecMatrix (utils/MTUtils.scala:75-94)."""
    return SparseVecMatrix.random(seed, rows, cols, density=density,
                                  mesh=mesh, **kw)


def zeros_den_vec_matrix(rows: int, cols: int, mesh=None):
    return DenseVecMatrix.zeros(rows, cols, mesh=mesh)


def ones_den_vec_matrix(rows: int, cols: int, mesh=None):
    return DenseVecMatrix.ones(rows, cols, mesh=mesh)


def ones_dis_vector(length: int, mesh=None):
    return DistributedVector.ones(length, mesh=mesh)


def array_to_matrix(arr, kind: str = "dense_vec", mesh=None):
    """MTUtils array→matrix converters (utils/MTUtils.scala:402-438)."""
    arr = np.asarray(arr)
    if kind in ("dense_vec", "row"):
        return DenseVecMatrix.from_array(arr, mesh)
    if kind in ("block",):
        return BlockMatrix.from_array(arr, mesh)
    raise ValueError(f"unknown matrix kind: {kind}")


def matrix_to_array(mat) -> np.ndarray:
    return mat.to_numpy()


def repeat_by_row(mat, times: int):
    """MTUtils.repeatByRow (utils/MTUtils.scala:446-469)."""
    return mat.repeat_by_row(times)


def repeat_by_column(mat, times: int):
    """MTUtils.repeatByColumn (utils/MTUtils.scala:471-491)."""
    return mat.repeat_by_column(times)
