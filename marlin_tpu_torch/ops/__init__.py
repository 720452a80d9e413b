"""Single-device math and the hand-written kernels."""

from .local import (  # noqa: F401
    axpy,
    block_multiply,
    dspr,
    gemm,
    matvec,
    syrk,
    triu_to_full,
)
from .pallas_kernels import masked_fill, pallas_matmul  # noqa: F401
