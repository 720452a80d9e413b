"""Truncated SVD through the Gramian's eigendecomposition or Lanczos.

Counterpart of ``marlin_tpu/linalg/svd.py``. The reference's ``computeSVD``
(DenseVecMatrix.scala:1531-1652) picks between a local LAPACK SVD, local
eigs of the Gramian, and "dist-eigs": ARPACK's Lanczos loop in Spark's
coordinating process with each ``v ↦ AᵀA·v`` a distributed aggregate
(DenseVecMatrix.scala:1743-1834). The JAX package runs the Lanczos recurrence as a ``lax.scan``
over a jitted matvec. Here it is a loop on the device over a preallocated
``(iters + 1, n)`` basis: each step's matvec, both Gram-Schmidt passes and
the norm are device work, and nothing is read on the host until the Ritz
values are.

The start vector is the JAX package's own, ``jax.random.normal(key(seed),
(n,))``, drawn by :func:`marlin_tpu_torch.threefry.normal`, so a Lanczos run
here follows the reference's basis (to the last place of ``erfinv``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import get_config, resolve_device
from ..ops.local import precision_scope
from ..threefry import normal, prng_key

__all__ = ["compute_svd", "lanczos", "symmetric_eigs", "SVDResult"]


@dataclasses.dataclass
class SVDResult:
    """Mirror of the reference's SVD case class (U, s, V)."""

    u: object | None  # DenseVecMatrix | None (None when compute_u=False)
    s: np.ndarray  # singular values, descending
    v: np.ndarray  # right singular vectors, (n, k)


def _lanczos_scan(matvec, v0: torch.Tensor, iters: int):
    """The Lanczos recurrence with twice-iterated classical Gram-Schmidt
    reorthogonalisation against the whole basis. Returns (alphas, betas,
    basis), all on ``v0``'s device."""
    n = v0.shape[0]
    qs = torch.zeros((iters + 1, n), dtype=v0.dtype, device=v0.device)
    qs[0] = v0 / torch.linalg.vector_norm(v0)
    alphas = torch.zeros((iters,), dtype=v0.dtype, device=v0.device)
    betas = torch.zeros((iters,), dtype=v0.dtype, device=v0.device)
    for i in range(iters):
        q = qs[i]
        w = matvec(q)
        alpha = torch.dot(w, q)
        w = w - alpha * q
        if i > 0:
            w = w - betas[i - 1] * qs[i - 1]
        for _ in range(2):
            w = w - qs.T @ (qs @ w)
        beta = torch.linalg.vector_norm(w)
        qs[i + 1] = torch.where(beta > 1e-12, w / torch.clamp(beta, min=1e-30),
                                0.0)
        alphas[i] = alpha
        betas[i] = beta
    return alphas, betas, qs


def _ritz_topk(alphas, betas, qs, k: int, num_iters: int):
    t = (torch.diag(alphas) + torch.diag(betas[:-1], 1)
         + torch.diag(betas[:-1], -1))
    evals, evecs = torch.linalg.eigh(t)
    idx = torch.argsort(-evals)[:k]
    vecs = qs[:num_iters].T @ evecs[:, idx]
    vecs = vecs / torch.clamp(torch.linalg.vector_norm(vecs, dim=0, keepdim=True),
                              min=1e-30)
    return evals[idx], vecs


def _resolve_iters(n: int, k: int, num_iters: int | None) -> int:
    cfg = get_config()
    if num_iters is None:
        num_iters = min(n, max(2 * k + 1, min(n, k * cfg.lanczos_max_iter_factor)))
    return min(num_iters, n)


def symmetric_eigs(matvec, n: int, k: int, num_iters: int | None = None,
                   seed: int = 0, dtype=torch.float32):
    """Top-k eigenpairs of a symmetric operator given only ``v ↦ A·v`` (any
    tensor-to-tensor callable) — the contract of the reference's ARPACK
    wrapper (EigenValueDecomposition.symmetricEigs,
    DenseVecMatrix.scala:1743-1834). The start vector lies on the configured
    device. Returns (eigenvalues descending, vectors (n, k)), tensors
    there."""
    num_iters = _resolve_iters(n, k, num_iters)
    v0 = normal(prng_key(seed, resolve_device()), (n,), dtype)
    with precision_scope("highest"):
        alphas, betas, qs = _lanczos_scan(matvec, v0, num_iters)
        return _ritz_topk(alphas, betas, qs, k, num_iters)


def lanczos(a: torch.Tensor, k: int, num_iters: int | None = None,
            seed: int = 0):
    """Top-k eigenpairs of AᵀA — the specialisation the SVD path uses (the
    role of ARPACK ``dsaupd``/``dseupd`` in the reference), on ``a``'s
    device."""
    n = a.shape[1]
    num_iters = _resolve_iters(n, k, num_iters)
    v0 = normal(prng_key(seed, a.device), (n,), a.dtype)
    with precision_scope("highest"):
        alphas, betas, qs = _lanczos_scan(lambda v: a.T @ (a @ v), v0,
                                          num_iters)
        return _ritz_topk(alphas, betas, qs, k, num_iters)


def compute_svd(mat, k: int, mode: str = "auto", compute_u: bool = True,
                rcond: float = 1e-9, seed: int = 0) -> SVDResult:
    """Truncated SVD (DenseVecMatrix.computeSVD, DenseVecMatrix.scala:1531-1652).

    Modes, matching the reference's auto-selection (:1569-1588):
      - "local-svd": full SVD of the matrix (small n and m)
      - "local-eigs": eigh of the n×n Gramian (small n)
      - "dist-eigs": matrix-free Lanczos (large n)
    ``s`` and ``v`` come back as numpy arrays, as in the JAX package, and
    ``u`` as a dense matrix on the input's device.
    """
    m, n = mat.shape
    if k < 1 or k > n:
        raise ValueError(f"requested k={k} singular values for n={n}")
    cfg = get_config()
    if mode == "auto":
        if n < 100 or (k > n / 2 and n <= cfg.svd_local_dim):
            mode = "local-svd" if m <= cfg.svd_local_dim else "local-eigs"
        elif n <= cfg.svd_local_dim:
            mode = "local-eigs"
        else:
            mode = "dist-eigs"

    a = mat.logical()
    with precision_scope("highest"):
        if mode == "local-svd":
            u_full, s_full, vt = torch.linalg.svd(a, full_matrices=False)
            s, v = s_full[:k], vt[:k].T
            u = mat._wrap(u_full[:, :k]) if compute_u else None
            return SVDResult(u, s.cpu().numpy(), v.cpu().numpy())
        if mode == "local-eigs":
            evals, evecs = torch.linalg.eigh(a.T @ a)
            idx = torch.argsort(-evals)[:k]
            evals_k, v = evals[idx], evecs[:, idx]
        elif mode == "dist-eigs":
            evals_k, v = lanczos(a, k, seed=seed)
        else:
            raise ValueError(f"unknown SVD mode: {mode}")

        s = torch.sqrt(torch.clamp(evals_k, min=0.0))
        # drop numerically-zero singular values like the reference's sigma
        # threshold (DenseVecMatrix.scala:1598-1617); reading the count waits
        # for the device, as in the JAX package
        keep = int(torch.sum(s > (s[0] * rcond)))
        s, v = s[:keep], v[:, :keep]
        u = None
        if compute_u:
            # U = A V Σ^{-1} (DenseVecMatrix.scala:1632-1650)
            u = mat._wrap((a @ v) / torch.clamp(s, min=1e-30)[None, :])
    return SVDResult(u, s.cpu().numpy(), v.cpu().numpy())
