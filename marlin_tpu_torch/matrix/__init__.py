"""Distributed matrix and vector types (dense half)."""

from .base import DistributedMatrix  # noqa: F401
from .dense import BlockMatrix, DenseMatrix, DenseVecMatrix  # noqa: F401
from .vector import DistributedIntVector, DistributedVector  # noqa: F401
