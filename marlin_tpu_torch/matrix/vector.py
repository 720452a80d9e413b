"""Distributed vectors.

Counterpart of ``marlin_tpu/matrix/vector.py``. The reference's
``DistributedVector`` is a chunked dense vector with a row/column-major
orientation flag (matrix/DistributedVector.scala:16-28);
``DistributedIntVector`` is its Int variant
(matrix/DistributedIntVector.scala). Here it is one 1-D tensor on the mesh's
device (zero-padded beyond ``length`` when built that way); ``transpose``
remains a pure orientation-flag flip (DistributedVector.scala:55-59).

On a mesh over ``torch.distributed`` ranks a vector holds only this rank's
block over the ``rows`` axis of the vector zero-padded to that axis (the JAX
package's ``P("rows")`` shard), whole along the other axes; ``dot``, ``sum``
and ``norm`` all-reduce over ``rows``, and the outer product is a rank-local
:class:`~marlin_tpu_torch.matrix.dense.BlockMatrix`. Every method is then
collective. A vector is small, so :meth:`logical` (one all-gather) is how a
vector meets another layout.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..interop import to_tensor
from ..mesh import ROWS, Mesh, Sharding, default_mesh, pad_to_multiple
from ..ops.local import local_matmul
from ..random import random_array, random_block

__all__ = ["DistributedVector", "DistributedIntVector"]


def _ranked(mesh) -> bool:
    return getattr(mesh, "ranks", None) is not None


def _col():
    from ..parallel import collectives

    return collectives


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
        if _ranked(mesh):
            if not isinstance(arr, torch.Tensor):
                arr = np.asarray(arr)
            if arr.ndim != 1:
                raise ValueError(f"expected 1-D array, got shape "
                                 f"{tuple(arr.shape)}")
            from .dense import _cut

            n = int(arr.shape[0])
            sh = Sharding(mesh, (ROWS,))
            block = _cut(arr, sh.bounds(sh.padded_shape((n,))))
            return cls(to_tensor(block, dtype, mesh.device).contiguous(), n,
                       mesh, column_major)
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
        lo = 0
        if _ranked(mesh):
            ((lo, hi),) = Sharding(mesh, (ROWS,)).bounds((npad,))
            data = random_block(seed_or_key, (npad,), ((lo, hi),), dist=dist,
                                dtype=dtype, device=mesh.device, **kwargs)
        else:
            data = random_array(seed_or_key, (npad,), dist=dist, dtype=dtype,
                                device=mesh.device, **kwargs)
        if npad != length:
            keep = torch.arange(lo, lo + data.shape[0],
                                device=data.device) < length
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

    @property
    def _over_ranks(self) -> bool:
        return _ranked(self.mesh)

    @property
    def sharding(self) -> Sharding:
        return Sharding(self.mesh, (ROWS,))

    @property
    def _padded_shape(self) -> tuple[int]:
        return (self.data.shape[0] * self.sharding.divisors(1)[0],)

    def logical(self) -> torch.Tensor:
        """The unpadded vector; over ranks gathered by one all-gather
        (collective)."""
        if self._over_ranks:
            return _col().gather_logical(self.data, self.sharding,
                                      (self._length,), self._padded_shape)
        return self.data if not self._padded else self.data[: self._length]

    def _sum_rows(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over the ``rows`` axis over ranks."""
        from .dense import _reduce

        return _reduce(x, self.mesh, (ROWS,))

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
            return type(self).from_array(other.logical(), self.mesh,
                                         dtype=self.dtype).data
        arr = to_tensor(other, device=self.data.device)
        if tuple(arr.shape) != (self._length,):
            raise ValueError(
                f"operand has shape {tuple(arr.shape)}, expected ({self._length},)"
            )
        if self._over_ranks:
            return type(self).from_array(arr, self.mesh, dtype=arr.dtype).data
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
        return self._sum_rows(local_matmul(self.data, self._operand(other),
                                           "highest"))

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
            if self._over_ranks:
                return self._outer_ranks(other)
            out = torch.outer(self.logical(), other.logical())
            return BlockMatrix.from_array(out, self.mesh)
        if not self.column_major and other.column_major:
            return self.dot(other)
        raise ValueError(
            "vector multiply needs a column vector × row vector (outer) or "
            "row × column (inner); call .transpose() to flip orientation"
        )

    def _outer_ranks(self, other) -> "BlockMatrix":
        """The outer product as this rank's block of a BlockMatrix: its rows
        are this vector's block, its columns a slice of ``other`` (small,
        gathered)."""
        from .dense import BlockMatrix

        m, n = self._length, other.length
        sh = Sharding(self.mesh, BlockMatrix._default_spec)
        (r0, r1), (c0, c1) = sh.bounds(sh.padded_shape((m, n)))
        v = F.pad(other.logical().to(self.data.device),
                  (0, sh.padded_shape((m, n))[1] - n))[c0:c1]
        u = self.data if self.data.shape[0] == r1 - r0 else \
            self.logical()[r0:r1]
        return BlockMatrix(torch.outer(u, v.to(u.dtype)), (m, n), self.mesh,
                           sh.spec)

    def to_dis_vector(self, num_splits: int | None = None, mesh: Mesh | None = None):
        """Re-chunk (DistributedVector.toDisVector, DistributedVector.scala:82-136):
        a move onto ``mesh``, or a no-op."""
        if mesh is None:
            return self
        return type(self).from_array(self.logical(), mesh, self.column_major)

    def sum(self) -> torch.Tensor:
        if self._over_ranks:
            return self._sum_rows(torch.sum(self.data))
        return torch.sum(self.logical())

    def norm(self, ord: int | float = 2) -> torch.Tensor:
        """Vector norm over the logical elements (over ranks: the blocks'
        powers summed, or their largest, over ``rows``)."""
        if not self._over_ranks:
            return torch.linalg.vector_norm(self.logical(), ord=ord)
        from .dense import _reduce

        x = self.data.abs()
        if ord == float("inf"):
            return _reduce(torch.max(x), self.mesh, (ROWS,), "max")
        if ord == 0:
            return self._sum_rows(torch.sum(x != 0).to(x.dtype))
        return self._sum_rows(torch.sum(x ** ord)) ** (1.0 / ord)

    def __repr__(self):
        kind = "col" if self.column_major else "row"
        return f"{type(self).__name__}(length={self._length}, {kind}, dtype={self.dtype})"


class DistributedIntVector(DistributedVector):
    """Int-typed distributed vector (matrix/DistributedIntVector.scala:16-107);
    used for label vectors in the NN workload."""

    @classmethod
    def from_array(cls, arr, mesh=None, column_major=True, dtype=None):
        return super().from_array(arr, mesh, column_major, dtype=dtype or torch.int32)
