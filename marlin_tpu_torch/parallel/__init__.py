"""Multiply strategies, the CARMA split, the autotuner, ring and Ulysses
attention (world size 1), and the out-of-core streaming ops with their
prefetch pipeline."""

from .autotune import best_gemm, best_strategy, tune_gemm, tune_multiply  # noqa: F401
from .carma import split_method  # noqa: F401
from .matmul import (  # noqa: F401
    UnknownStrategyError,
    broadcast_matmul,
    gspmd_matmul,
    matmul,
    rmm_matmul,
)
from .ring_attention import attention_reference, ring_attention  # noqa: F401
from .ulysses import ulysses_attention  # noqa: F401
from .prefetch import ChunkPrefetcher, prefetch_chunks  # noqa: F401
from .streaming import streamed_gramian, streamed_matmul  # noqa: F401
