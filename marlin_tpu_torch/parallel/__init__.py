"""Multiply strategies, the CARMA split, the autotuner, the ring matmul,
ring and Ulysses attention and the GPipe pipeline (a world of one, or across
``torch.distributed`` ranks), and the out-of-core streaming ops with their
prefetch pipeline."""

from .autotune import best_gemm, best_strategy, tune_gemm, tune_multiply  # noqa: F401
from .carma import dim_to_split, split_method  # noqa: F401
from .matmul import (  # noqa: F401
    UnknownStrategyError,
    broadcast_matmul,
    gspmd_matmul,
    matmul,
    rmm_matmul,
)
from .ring import ring_matmul  # noqa: F401
from .ring_attention import attention_reference, ring_attention  # noqa: F401
from .ulysses import ulysses_attention  # noqa: F401
from .prefetch import ChunkPrefetcher, prefetch_chunks  # noqa: F401
from .streaming import streamed_gramian, streamed_matmul  # noqa: F401
from .pipeline import pipeline_apply, stack_stage_params  # noqa: F401
