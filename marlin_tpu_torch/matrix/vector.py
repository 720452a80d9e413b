"""Distributed vectors.

Counterpart of ``marlin_tpu/matrix/vector.py``. The reference's
``DistributedVector`` is a chunked dense vector with a row/column-major
orientation flag (matrix/DistributedVector.scala:16-28);
``DistributedIntVector`` is its Int variant
(matrix/DistributedIntVector.scala). Here it is one 1-D tensor on the mesh's
device (zero-padded beyond ``length`` when built that way); ``transpose``
remains a pure orientation-flag flip (DistributedVector.scala:55-59).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..interop import to_tensor
from ..mesh import ROWS, Mesh, default_mesh, pad_to_multiple
from ..ops.local import local_matmul
from ..random import random_array

__all__ = ["DistributedVector", "DistributedIntVector"]


class DistributedVector:
    def __init__(self, data: torch.Tensor, length: int, mesh: Mesh,
                 column_major: bool = True):
        self.data = data  # padded
        self._length = int(length)
        self.mesh = mesh
        # column_major=True: a column vector (n×1); False: a row vector (1×n).
        self.column_major = column_major

    # ------------------------------------------------------------- factories
    @classmethod
    def from_array(cls, arr, mesh: Mesh | None = None, column_major: bool = True,
                   dtype=None):
        mesh = mesh or default_mesh()
        arr = to_tensor(arr, dtype, mesh.device)
        if arr.ndim != 1:
            raise ValueError(f"expected 1-D array, got shape {tuple(arr.shape)}")
        n = arr.shape[0]
        npad = pad_to_multiple(n, mesh.shape[ROWS])
        if npad != n:
            arr = F.pad(arr, (0, npad - n))
        return cls(arr, n, mesh, column_major)

    @classmethod
    def random(cls, seed_or_key, length: int, dist: str = "uniform", mesh=None,
               column_major: bool = True, dtype=None, **kwargs):
        """Random vector (MTUtils.randomDisVector → RandomDistVectorRDD,
        rdd/RandomRDD.scala:116-134), generated on the device."""
        mesh = mesh or default_mesh()
        npad = pad_to_multiple(length, mesh.shape[ROWS])
        data = random_array(seed_or_key, (npad,), dist=dist, dtype=dtype,
                            device=mesh.device, **kwargs)
        if npad != length:
            keep = torch.arange(npad, device=data.device) < length
            data = torch.where(keep, data, torch.zeros((), dtype=data.dtype,
                                                       device=data.device))
        return cls(data, length, mesh, column_major)

    @classmethod
    def zeros(cls, length: int, mesh=None, dtype=None):
        return cls.random(0, length, dist="zeros", mesh=mesh, dtype=dtype)

    @classmethod
    def ones(cls, length: int, mesh=None, dtype=None):
        return cls.random(0, length, dist="ones", mesh=mesh, dtype=dtype)

    # ------------------------------------------------------------- structure
    @property
    def length(self) -> int:
        return self._length

    @property
    def split_num(self) -> int:
        """Number of chunks (DistributedVector.splitNum,
        DistributedVector.scala:30-36): one per device of the mesh."""
        return self.mesh.size

    @property
    def dtype(self) -> torch.dtype:
        return self.data.dtype

    @property
    def _padded(self) -> bool:
        return self.data.shape[0] != self._length

    def logical(self) -> torch.Tensor:
        return self.data if not self._padded else self.data[: self._length]

    def to_numpy(self) -> np.ndarray:
        t = self.logical().detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    def _like(self, data) -> "DistributedVector":
        return type(self)(data, self._length, self.mesh, self.column_major)

    def _operand(self, other) -> torch.Tensor:
        if isinstance(other, DistributedVector):
            if other.length != self.length:
                raise ValueError(f"length mismatch: {self.length} vs {other.length}")
            if other.data.shape == self.data.shape and other.mesh == self.mesh:
                return other.data
            return type(self).from_array(other.logical(), self.mesh).data
        arr = to_tensor(other, device=self.data.device)
        if tuple(arr.shape) != (self._length,):
            raise ValueError(
                f"operand has shape {tuple(arr.shape)}, expected ({self._length},)"
            )
        return F.pad(arr, (0, self.data.shape[0] - arr.shape[0]))

    # ------------------------------------------------------------ arithmetic
    def add(self, other):
        return self._like(self.data + self._operand(other))

    def substract(self, other):
        """Reference spelling kept for parity (DistributedVector.substract,
        DistributedVector.scala:44-48)."""
        return self._like(self.data - self._operand(other))

    subtract = substract

    def scale(self, d: float):
        return self._like(self.data * d)

    def transpose(self) -> "DistributedVector":
        """Orientation-flag flip (DistributedVector.scala:55-59)."""
        return type(self)(self.data, self._length, self.mesh, not self.column_major)

    def dot(self, other) -> torch.Tensor:
        return local_matmul(self.data, self._operand(other), "highest")

    def multiply(self, other, mode: str = "dist"):
        """Vector-vector multiply (DistributedVector.multiply,
        DistributedVector.scala:146-180): column × row → outer-product
        BlockMatrix; row × column → inner-product scalar. ``mode`` ("dist" |
        "local") is kept for signature parity."""
        from .dense import BlockMatrix

        if not isinstance(other, DistributedVector):
            other = DistributedVector.from_array(other, self.mesh,
                                                 column_major=not self.column_major)
        if self.column_major and not other.column_major:
            out = torch.outer(self.logical(), other.logical())
            return BlockMatrix.from_array(out, self.mesh)
        if not self.column_major and other.column_major:
            return self.dot(other)
        raise ValueError(
            "vector multiply needs a column vector × row vector (outer) or "
            "row × column (inner); call .transpose() to flip orientation"
        )

    def to_dis_vector(self, num_splits: int | None = None, mesh: Mesh | None = None):
        """Re-chunk (DistributedVector.toDisVector, DistributedVector.scala:82-136):
        a move onto ``mesh``, or a no-op."""
        if mesh is None:
            return self
        return type(self).from_array(self.logical(), mesh, self.column_major)

    def sum(self) -> torch.Tensor:
        return torch.sum(self.logical())

    def norm(self, ord: int | float = 2) -> torch.Tensor:
        """Vector norm over the logical elements."""
        return torch.linalg.vector_norm(self.logical(), ord=ord)

    def __repr__(self):
        kind = "col" if self.column_major else "row"
        return f"{type(self).__name__}(length={self._length}, {kind}, dtype={self.dtype})"


class DistributedIntVector(DistributedVector):
    """Int-typed distributed vector (matrix/DistributedIntVector.scala:16-107);
    used for label vectors in the NN workload."""

    @classmethod
    def from_array(cls, arr, mesh=None, column_major=True, dtype=None):
        return super().from_array(arr, mesh, column_major, dtype=dtype or torch.int32)
