"""Dense factorizations, solves and the truncated SVD (counterpart of
``marlin_tpu/linalg``)."""

from .factorizations import lu_decompose, cholesky_decompose, inverse  # noqa: F401
from .solve import cholesky_solve, lu_solve, solve  # noqa: F401
from .svd import compute_svd, lanczos, symmetric_eigs, SVDResult  # noqa: F401
