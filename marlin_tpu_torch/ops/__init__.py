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
from .paged_attention import paged_decode_attention  # noqa: F401
from .flash_attention import (  # noqa: F401
    flash_attention_bwd_dkv,
    flash_attention_bwd_dq,
    flash_attention_panel,
    flash_attention_panel_bwd,
)

# every wrapper that launches a hand-written kernel; each counts its launches
KERNEL_WRAPPERS = (pallas_matmul, masked_fill, paged_decode_attention,
                   flash_attention_panel, flash_attention_bwd_dkv,
                   flash_attention_bwd_dq)


def reset_launch_counts() -> None:
    """Set the launch count of every kernel wrapper to 0."""
    for w in KERNEL_WRAPPERS:
        w.launches = 0


def launch_counts() -> dict[str, int]:
    """Kernel launches per wrapper since the last reset."""
    return {w.__name__: w.launches for w in KERNEL_WRAPPERS}
