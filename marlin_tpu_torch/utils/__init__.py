"""Timing, tracing, fault injection, retries, the MTUtils factories and
checkpoint-based recovery (counterpart of ``marlin_tpu/utils``)."""

from .profiling import timer, evaluate, StepTimer, StageTimes, trace  # noqa: F401
from .tracing import (  # noqa: F401
    annotate,
    EventLog,
    matmul_flops,
    effective_gflops,
    get_default_event_log,
    set_default_event_log,
)
from .retry import RetryPolicy, get_retry_policy, set_retry_policy  # noqa: F401
from . import faults  # noqa: F401
from .failure import NonFiniteLossError, ResilientLoop, heartbeat  # noqa: F401
from .mtutils import (  # noqa: F401
    random_den_vec_matrix,
    random_block_matrix,
    random_dis_vector,
    random_spa_vec_matrix,
    zeros_den_vec_matrix,
    ones_den_vec_matrix,
    ones_dis_vector,
    array_to_matrix,
    matrix_to_array,
    repeat_by_row,
    repeat_by_column,
)
