"""Distributed matrix and vector types."""

from .base import DistributedMatrix  # noqa: F401
from .dense import BlockMatrix, DenseMatrix, DenseVecMatrix  # noqa: F401
from .sparse import CoordinateMatrix, SparseVecMatrix  # noqa: F401
from .vector import DistributedIntVector, DistributedVector  # noqa: F401
