"""Single-device math and the hand-written kernels."""

from .local import (  # noqa: F401
    axpy,
    block_multiply,
    dspr,
    gemm,
    matvec,
    mult_dense_sparse,
    mult_sparse_dense,
    mult_sparse_sparse,
    syrk,
    triu_to_full,
)
from .pallas_kernels import masked_fill, pallas_matmul  # noqa: F401
from .paged_attention import align_page_len, paged_decode_attention  # noqa: F401
from .flash_attention import (  # noqa: F401
    flash_attention_bwd_dkv,
    flash_attention_bwd_dq,
    flash_attention_panel,
    flash_attention_panel_bwd,
)
from .sparse_bsr import (  # noqa: F401
    BsrMatrix,
    bsr_from_dense,
    bsr_spmm,
    bsr_spmm_pallas,
)
from .sparse_ell import EllMatrix, ell_from_coo, ell_spmm  # noqa: F401
from .tile_family import bsr_candidates, gemm_candidates  # noqa: F401

# every wrapper that launches a hand-written kernel; each counts its launches
KERNEL_WRAPPERS = (pallas_matmul, masked_fill, paged_decode_attention,
                   flash_attention_panel, flash_attention_bwd_dkv,
                   flash_attention_bwd_dq, bsr_spmm_pallas)


def reset_launch_counts() -> None:
    """Set the launch count of every kernel wrapper to 0."""
    for w in KERNEL_WRAPPERS:
        w.launches = 0


def launch_counts() -> dict[str, int]:
    """Kernel launches per wrapper since the last reset."""
    return {w.__name__: w.launches for w in KERNEL_WRAPPERS}
