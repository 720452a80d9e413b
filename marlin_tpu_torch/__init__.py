"""marlin_tpu_torch — marlin_tpu ported to PyTorch and CUDA on one NVIDIA H100.

The JAX package ``marlin_tpu`` stays beside this one as the reference. This
package keeps its module and public names so each counterpart is easy to
find, imports neither JAX nor ``marlin_tpu``, and runs its entry points on
``cuda`` unless the caller asks for the CPU (``config_context(device="cpu")``
or a ``device=`` argument). Ported so far: the dense distributed multiply,
end to end, with the hand-written CUDA GEMM and masked-fill kernels
(``ops/pallas_kernels.py``); the serving half of the transformer LM
(``models/``, ``serving/kvpool.py``) with the paged decode-attention and
flash forward kernels (``ops/paged_attention.py``,
``ops/flash_attention.py``); and its training half at world size 1
(``lm_loss``, ``lm_train_step``, ``TransformerLM.train``) through ring and
Ulysses attention (``parallel/``), with the flash backward kernels; and the
sparse × dense multiply (``SparseVecMatrix``, ``CoordinateMatrix``; the
ELL, BCOO and BSR formats) with the BSR SpMM kernel
(``ops/sparse_bsr.py``); and the dense factorizations, solves and truncated
SVD (``linalg/``) with logistic regression (``ml/``), which the
``DenseMatrix`` methods reach.

Quick start::

    import marlin_tpu_torch as mt

    a = mt.DenseVecMatrix.random(0, 8000, 8000)   # generated on the card
    b = mt.DenseVecMatrix.random(1, 8000, 8000)
    c = mt.evaluate(a.multiply(b))                # adaptive: broadcast vs RMM
"""

from .config import MarlinConfig, config_context, get_config, set_config  # noqa: F401
from .mesh import COLS, ROWS, create_mesh, default_mesh, set_default_mesh  # noqa: F401
from .matrix import (  # noqa: F401
    BlockMatrix,
    CoordinateMatrix,
    DenseMatrix,
    DenseVecMatrix,
    DistributedIntVector,
    DistributedMatrix,
    DistributedVector,
    SparseVecMatrix,
)
from .parallel import (  # noqa: F401
    attention_reference,
    matmul,
    ring_attention,
    rmm_matmul,
    split_method,
    tune_multiply,
    ulysses_attention,
)
from .linalg import cholesky_decompose, compute_svd, inverse, lanczos, lu_decompose  # noqa: F401
from .utils import evaluate, timer  # noqa: F401
from . import linalg, ml, random  # noqa: F401

__version__ = "0.1.0"
