"""Abstract distributed-matrix contract.

Counterpart of ``marlin_tpu/matrix/base.py``, mirroring the reference's
``DistributedMatrix`` trait (matrix/DistributedMatrix.scala:9-76): dims,
elementwise/scalar arithmetic, sum, dotProduct (elementwise product),
transpose, cBind, saveToFileSystem, print. ``toBreeze()`` — "collect to a
local dense matrix, for test only" — becomes :meth:`to_numpy`.
"""

from __future__ import annotations

import abc

import numpy as np


class DistributedMatrix(abc.ABC):
    @abc.abstractmethod
    def num_rows(self) -> int: ...

    @abc.abstractmethod
    def num_cols(self) -> int: ...

    @abc.abstractmethod
    def to_numpy(self) -> np.ndarray:
        """Collect and assemble a local dense matrix (toBreeze analog). On a
        mesh over ``torch.distributed`` ranks it is collective: every rank
        calls it, and each gets the whole matrix by one all-gather."""

    @abc.abstractmethod
    def add(self, other): ...

    @abc.abstractmethod
    def subtract(self, other): ...

    @abc.abstractmethod
    def multiply(self, other): ...

    @abc.abstractmethod
    def divide(self, other): ...

    @abc.abstractmethod
    def sum(self): ...

    @abc.abstractmethod
    def dot_product(self, other): ...

    @abc.abstractmethod
    def transpose(self): ...

    @abc.abstractmethod
    def c_bind(self, other): ...

    @abc.abstractmethod
    def save_to_file_system(self, path: str): ...

    @abc.abstractmethod
    def print_matrix(self): ...

    # pythonic operator sugar
    def __add__(self, other):
        return self.add(other)

    def __sub__(self, other):
        return self.subtract(other)

    def __matmul__(self, other):
        return self.multiply(other)

    @property
    def shape(self) -> tuple[int, int]:
        return (self.num_rows(), self.num_cols())
