"""Distributed matrix and vector types, and the host-resident
``OutOfCoreMatrix`` whose operations stream through the card."""

from .base import DistributedMatrix  # noqa: F401
from .dense import BlockMatrix, DenseMatrix, DenseVecMatrix  # noqa: F401
from .out_of_core import OutOfCoreMatrix  # noqa: F401
from .sparse import CoordinateMatrix, SparseVecMatrix  # noqa: F401
from .vector import DistributedIntVector, DistributedVector  # noqa: F401
