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
``ops/flash_attention.py``); and its training half
(``lm_loss``, ``lm_train_step``, ``TransformerLM.train``) through ring and
Ulysses attention (``parallel/``), with the flash backward kernels; and the
sparse × dense multiply (``SparseVecMatrix``, ``CoordinateMatrix``; the
ELL, BCOO and BSR formats) with the BSR SpMM kernel
(``ops/sparse_bsr.py``); the dense factorizations, solves and truncated
SVD (``linalg/``), which the ``DenseMatrix`` methods reach; the serving
engine's paged path (``serving/``); and Marlin's own ML workloads
(``ml/``: ALS, the MLP trainer, logistic regression, PageRank) with the
ALS, PageRank and classification programs the engine serves beside the LM,
the utils (``utils/``: timing and ``torch.profiler`` traces, retries, fault
injection, the MTUtils factories, ``ResilientLoop`` and ``heartbeat``); and
the IO stack and out-of-core streaming: the text formats (``io/text.py``,
``io/fs.py``), the MarlinChunk data plane over the port's own C++ libraries
(``io/chunkstore.py``, ``native/``), MNIST idx files (``io/mnist.py``), the
pinned-buffer prefetcher and the streamed Gramian and multiply
(``parallel/{prefetch,streaming}.py``, ``matrix/out_of_core.py``), and
checkpoints with resume (``io/checkpoint.py``, ``io/orbax_ckpt.py``); the
mixture-of-experts LM family (``models/moe.py``) through training,
generation and both serving backends (the paged pool and the dense-slab
control); fused matrix expressions (``lazy.fuse`` over
``torch.compile``, ``lazy.grad``); host-offloaded remat residuals and the
long-context memory planner (``models/planner.py``); and the collectives
layer over ``torch.distributed`` (``initialize_distributed``, a mesh over
ranks, the ring, RMM and broadcast multiplies, ring and Ulysses attention
across ranks, the GPipe pipeline and the pipeline LM), with the workloads
on it: the LM trainer on the ranks' sequence shards, MoE experts across
ranks, the (dp, tp) MLP, blocked ALS and edge-sharded PageRank.

Quick start::

    import marlin_tpu_torch as mt

    a = mt.DenseVecMatrix.random(0, 8000, 8000)   # generated on the card
    b = mt.DenseVecMatrix.random(1, 8000, 8000)
    c = mt.evaluate(a.multiply(b))                # adaptive: broadcast vs RMM
"""

from .config import MarlinConfig, config_context, get_config, set_config  # noqa: F401
from .mesh import (  # noqa: F401
    COLS,
    ROWS,
    create_mesh,
    default_mesh,
    initialize_distributed,
    set_default_mesh,
)
from .matrix import (  # noqa: F401
    BlockMatrix,
    CoordinateMatrix,
    DenseMatrix,
    DenseVecMatrix,
    DistributedIntVector,
    DistributedMatrix,
    DistributedVector,
    OutOfCoreMatrix,
    SparseVecMatrix,
)
from .parallel import (  # noqa: F401
    ChunkPrefetcher,
    attention_reference,
    matmul,
    prefetch_chunks,
    ring_attention,
    ring_matmul,
    rmm_matmul,
    split_method,
    streamed_gramian,
    streamed_matmul,
    tune_multiply,
    ulysses_attention,
)
from .linalg import cholesky_decompose, compute_svd, inverse, lanczos, lu_decompose  # noqa: F401
from .io import (  # noqa: F401
    load_block_matrix_file,
    load_coordinate_matrix,
    load_matrix_file,
    load_svm_den_vec_matrix,
    save_matrix,
)
from .utils import evaluate, timer  # noqa: F401
from .lazy import fuse  # noqa: F401
from . import io, lazy, linalg, ml, obs, random  # noqa: F401

__version__ = "0.1.0"
