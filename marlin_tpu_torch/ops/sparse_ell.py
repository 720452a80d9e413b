"""ELL-format SpMM for very sparse × dense products.

Counterpart of ``marlin_tpu/ops/sparse_ell.py``. For the BASELINE.md config-5
regime (10⁻⁴ density, ~100 nonzeros a row) every row's nonzeros are padded to
a fixed width K, giving dense ``(rows, K)`` index and value arrays. SpMM is
then a row-chunked gather and contract, ``einsum('rk,rkn->rn', vals,
B[cols])``, whose cost is one read of a B row per stored entry. Entries past
K (rows of higher degree) go to an exact sparse COO residual instead of
widening every row.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import resolve_device
from ..interop import to_host, to_tensor

__all__ = ["ell_from_coo", "ell_spmm", "EllMatrix"]


class EllMatrix:
    """ELL storage: ``cols``/``vals`` of shape (rows, K); padding slots have
    col=0, val=0 (contributing exactly zero). ``residual`` holds overflow
    entries (rows with more than K nonzeros) as a sparse COO tensor, or
    None."""

    def __init__(self, cols, vals, shape, residual=None):
        self.cols = cols
        self.vals = vals
        self.shape = tuple(int(s) for s in shape)
        self.residual = residual

    @property
    def k_width(self) -> int:
        return self.cols.shape[1]

    @property
    def nnz(self) -> int:
        n = int((self.vals != 0).sum())
        return n + (self.residual._nnz() if self.residual is not None else 0)


def ell_from_coo(rows, cols, vals, shape, k_width: int | None = None,
                 device=None) -> EllMatrix:
    """Pack COO triplets into ELL on the host; the arrays land on ``device``
    (default: the configured one). ``k_width=None`` uses the max row
    degree."""
    rows = to_host(rows)[0]
    cols = to_host(cols)[0]
    vals, dtype = to_host(vals)
    m, n = shape
    order = np.argsort(rows, kind="stable")
    rows, cols, vals = rows[order], cols[order], vals[order]
    counts = np.bincount(rows, minlength=m)
    max_deg = int(counts.max()) if counts.size else 0
    k = max(1, max_deg if k_width is None else k_width)

    # slot position of each entry within its row
    starts = np.zeros(m + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    slot = np.arange(len(rows)) - starts[rows]

    in_ell = slot < k
    ell_cols = np.zeros((m, k), np.int32)
    ell_vals = np.zeros((m, k), vals.dtype)
    ell_cols[rows[in_ell], slot[in_ell]] = cols[in_ell]
    ell_vals[rows[in_ell], slot[in_ell]] = vals[in_ell]

    dev = resolve_device(device)
    residual = None
    if (~in_ell).any():
        idx = np.stack([rows[~in_ell], cols[~in_ell]]).astype(np.int64)
        residual = torch.sparse_coo_tensor(
            to_tensor(idx, device=dev), to_tensor(vals[~in_ell], dtype, dev),
            (m, n), check_invariants=True)
    return EllMatrix(to_tensor(ell_cols, device=dev),
                     to_tensor(ell_vals, dtype, dev), shape, residual)


def ell_spmm(ell: EllMatrix, b, chunk: int = 512) -> torch.Tensor:
    """``ell @ b`` with dense result, in ``promote(vals, b)``. ``chunk``
    rows at a time bound the gather buffer to chunk × K × n_cols elements
    (512 is the JAX package's choice)."""
    b = b.logical() if hasattr(b, "logical") else b
    b = b if isinstance(b, torch.Tensor) else to_tensor(b)
    m, kdim = ell.shape
    if b.ndim != 2 or b.shape[0] != kdim:
        raise ValueError(f"inner dim mismatch: {ell.shape} @ {tuple(b.shape)}")
    dtype = torch.promote_types(ell.vals.dtype, b.dtype)
    bt, vals = b.to(dtype), ell.vals.to(dtype)
    cols = ell.cols.long()
    out = torch.empty((m, b.shape[1]), dtype=dtype, device=b.device)
    chunk = min(chunk, max(1, m))
    for s in range(0, m, chunk):
        out[s:s + chunk] = torch.einsum("rk,rkn->rn", vals[s:s + chunk],
                                        bt[cols[s:s + chunk]])
    if ell.residual is not None:
        out += torch.sparse.mm(ell.residual.to(dtype), bt)
    return out
