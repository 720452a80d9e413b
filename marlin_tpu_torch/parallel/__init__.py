"""Multiply strategies, the CARMA split and the autotuner."""

from .autotune import best_gemm, best_strategy, tune_gemm, tune_multiply  # noqa: F401
from .carma import split_method  # noqa: F401
from .matmul import (  # noqa: F401
    UnknownStrategyError,
    broadcast_matmul,
    gspmd_matmul,
    matmul,
    rmm_matmul,
)
