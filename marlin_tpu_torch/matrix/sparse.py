"""Sparse distributed matrices.

Counterpart of ``marlin_tpu/matrix/sparse.py``. Reference types:
``SparseVecMatrix`` — row-partitioned sparse rows with an outer-product
shuffle multiply (matrix/SparseVecMatrix.scala:22-50) — and
``CoordinateMatrix`` — COO entries, the ALS entry point
(matrix/CoordinateMatrix.scala).

Where the JAX package holds a BCOO, this package holds a coalesced sparse COO
tensor (``SparseVecMatrix.bcoo``, the name kept): indices sorted row-major,
duplicates summed. Sparse × dense goes through one of three formats
(``multiply(format=...)``): ``"bcoo"`` (``torch.sparse.mm``), ``"ell"``
(ops/sparse_ell.py) or ``"bsr"`` (ops/sparse_bsr.py, whose backend — the
CUDA kernel or the chunked formulation — the autotune ranking picks).

``CoordinateMatrix.als`` runs ``ml/als.py``; ``save_to_file_system`` writes
``i j v`` text through the port's native writer.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import threefry
from ..config import get_config
from ..interop import to_host, to_tensor
from ..mesh import Mesh, default_mesh
from ..ops.local import mult_sparse_dense, mult_sparse_sparse
from ..ops.sparse_ell import ell_from_coo, ell_spmm

__all__ = ["SparseVecMatrix", "CoordinateMatrix"]


class CoordinateMatrix:
    """COO matrix: parallel (rows, cols, values) tensors on the mesh's device
    (matrix/CoordinateMatrix.scala:14-100)."""

    def __init__(self, row_indices, col_indices, values,
                 shape: tuple[int, int] | None = None, mesh: Mesh | None = None):
        self.mesh = mesh or default_mesh()
        dev = self.mesh.device
        self.row_indices = to_tensor(row_indices, torch.int32, dev)
        self.col_indices = to_tensor(col_indices, torch.int32, dev)
        self.values = to_tensor(values, device=dev)
        if shape is None:
            # dims via max-index reduce (CoordinateMatrix.scala:67-75)
            shape = (int(self.row_indices.max()) + 1,
                     int(self.col_indices.max()) + 1)
        self._shape = (int(shape[0]), int(shape[1]))

    @classmethod
    def from_entries(cls, entries, shape=None, mesh=None):
        """Build from an iterable of (i, j, v) triplets; the values take the
        configured default dtype."""
        arr = np.asarray(list(entries))
        return cls(arr[:, 0].astype(np.int64), arr[:, 1].astype(np.int64),
                   to_tensor(arr[:, 2], get_config().default_dtype, "cpu"),
                   shape=shape, mesh=mesh)

    def num_rows(self) -> int:
        return self._shape[0]

    def num_cols(self) -> int:
        return self._shape[1]

    @property
    def shape(self) -> tuple[int, int]:
        return self._shape

    @property
    def nnz(self) -> int:
        return int(self.values.shape[0])

    def to_bcoo(self) -> torch.Tensor:
        """The entries as a sparse COO tensor (duplicates not yet summed)."""
        r, c, v = self._live()
        return torch.sparse_coo_tensor(torch.stack([r, c]).long(), v,
                                       self._shape, check_invariants=True)

    def to_dense(self) -> torch.Tensor:
        r, c, v = self._live()
        z = torch.zeros(self._shape, dtype=v.dtype, device=v.device)
        return z.index_put_((r.long(), c.long()), v, accumulate=True)

    def to_dense_vec_matrix(self, mesh: Mesh | None = None):
        """Densify to a row-sharded matrix (CoordinateMatrix.toDenseVecMatrix,
        CoordinateMatrix.scala:51-64)."""
        from .dense import DenseVecMatrix

        return DenseVecMatrix.from_array(self.to_dense(), mesh or self.mesh)

    def to_sparse_vec_matrix(self, mesh: Mesh | None = None
                             ) -> "SparseVecMatrix":
        return SparseVecMatrix(self.to_bcoo(), self._shape, mesh or self.mesh)

    def to_block_matrix(self, mesh: Mesh | None = None):
        """Densify straight into the 2-D block layout
        (DenseVecMatrix.toBlockMatrixFromCoordinate,
        DenseVecMatrix.scala:1355-1379)."""
        from .dense import BlockMatrix

        return BlockMatrix.from_array(self.to_dense(), mesh or self.mesh)

    def to_numpy(self) -> np.ndarray:
        """The dense matrix on the host (bf16 comes back as float32)."""
        return to_host(self.to_dense())[0]

    def _live(self):
        """(rows, cols, vals) tensors without out-of-range (padding)
        entries."""
        r, c, v = self.row_indices, self.col_indices, self.values
        keep = (r < self._shape[0]) & (c < self._shape[1])
        if bool(keep.all()):
            return r, c, v
        return r[keep], c[keep], v[keep]

    def triplets(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Host (rows, cols, vals) with padding entries (indices == shape,
        which a CoordinateMatrix carried over from the JAX package's jit may
        hold) filtered out. bf16 values come back as float32."""
        return tuple(to_host(x)[0] for x in self._live())

    def compact(self) -> "CoordinateMatrix":
        """A padding-free copy (no-op when nothing is padded)."""
        ri, ci, vals = self._live()
        if len(ri) == self.nnz:
            return self
        return CoordinateMatrix(ri, ci, vals, shape=self._shape,
                                mesh=self.mesh)

    def save_to_file_system(self, path: str):
        """Write ``i j v`` COO text — the format load_coordinate_matrix
        parses (the reference ships a loader but no writer) — through the
        native writer (textio.cpp ``mt_save_coo``), with a Python fallback
        when the library is not built. Padding entries are never written."""
        import os

        from .. import native

        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        ri, ci, vals = self.triplets()
        if native.save_coo_text(path, ri, ci, vals):
            return
        with open(path, "w") as f:
            for i, j, v in zip(ri, ci, vals):
                f.write(f"{int(i)} {int(j)} {float(v)!r}\n")

    def als(self, rank: int, iterations: int = 10, lam: float = 0.01,
            seed: int = 0, **kwargs):
        """Alternating least squares on these ratings (CoordinateMatrix.ALS,
        CoordinateMatrix.scala:89-98 → ml/ALSHelp.scala)."""
        from ..ml.als import als_run

        return als_run(self, rank, iterations=iterations, lam=lam, seed=seed,
                       **kwargs)

    def __repr__(self):
        return f"CoordinateMatrix(shape={self._shape}, nnz={self.nnz})"


class SparseVecMatrix:
    """Sparse matrix held as a coalesced sparse COO tensor, the analog of the
    row-partitioned sparse type (matrix/SparseVecMatrix.scala:14-71)."""

    def __init__(self, bcoo: torch.Tensor, shape: tuple[int, int] | None = None,
                 mesh: Mesh | None = None):
        self.mesh = mesh or default_mesh()
        self.bcoo = bcoo.to(self.mesh.device).coalesce()
        self._shape = tuple(int(s) for s in (shape or bcoo.shape))
        self._triplets = None
        self._bsr_cache: dict = {}
        self._ell_cache: dict = {}

    @classmethod
    def from_dense(cls, arr, mesh=None):
        mesh = mesh or default_mesh()
        arr = to_tensor(arr, device=mesh.device)
        return cls(arr.to_sparse(), tuple(arr.shape), mesh)

    @classmethod
    def random(cls, seed: int, rows: int, cols: int, density: float = 0.01,
               mesh=None, dtype=None):
        """Random sparse matrix (MTUtils.randomSpaVecMatrix → RandomSpaVecRDD,
        rdd/RandomRDD.scala:136-159): the JAX package's draws bit for bit —
        ``split(key(seed), 3)``, two ``randint`` for the indices and one
        ``uniform`` for the values, duplicates summed. Only float32 draws are
        ported."""
        dtype = dtype or get_config().default_dtype
        if dtype != torch.float32:
            raise ValueError(f"SparseVecMatrix.random draws float32 only, "
                             f"got {dtype}")
        mesh = mesh or default_mesh()
        nnz = max(1, int(rows * cols * density))
        k1, k2, k3 = threefry.split(threefry.prng_key(seed, mesh.device), 3)
        ri = threefry.randint(k1, (nnz,), 0, rows)
        ci = threefry.randint(k2, (nnz,), 0, cols)
        vals = threefry.uniform(k3, (nnz,))
        idx = torch.stack([ri, ci]).long()
        return cls(torch.sparse_coo_tensor(idx, vals, (rows, cols),
                                           check_invariants=False),
                   (rows, cols), mesh)

    def num_rows(self) -> int:
        return self._shape[0]

    def num_cols(self) -> int:
        return self._shape[1]

    @property
    def shape(self):
        return self._shape

    @property
    def nnz(self) -> int:
        return self.bcoo._nnz()

    def _coo_triplets(self):
        """(rows, cols, vals) numpy triplets, row-major and deduplicated,
        computed once — shared by the ELL/BSR/COO conversion paths. bf16
        values come back as float32."""
        if self._triplets is None:
            idx = self.bcoo.indices().cpu().numpy()
            self._triplets = (idx[0], idx[1],
                              to_host(self.bcoo.values())[0])
        return self._triplets

    def multiply_sparse(self, other: "SparseVecMatrix",
                        out_nse: int | None = None) -> CoordinateMatrix:
        """Sparse × sparse with sparse (COO) result — the role of the
        outer-product shuffle multiply (SparseVecMatrix.multiplySparse,
        SparseVecMatrix.scala:22-50). ``out_nse`` is accepted for the JAX
        package's signature and ignored (see
        :func:`marlin_tpu_torch.ops.local.mult_sparse_sparse`)."""
        out = mult_sparse_sparse(self.bcoo, other.bcoo, out_nse=out_nse)
        idx = out.indices()
        return CoordinateMatrix(idx[0], idx[1], out.values(),
                                shape=(self.num_rows(), other.num_cols()),
                                mesh=self.mesh)

    def multiply(self, other, format: str = "auto"):
        """Sparse × dense → dense distributed matrix; sparse × sparse →
        :meth:`multiply_sparse`.

        ``format``: "bcoo" uses ``torch.sparse.mm``; "ell" the chunked gather
        SpMM (the config-5 low-density path); "bsr" the block-sparse path
        (right when the nonzeros cluster in dense blocks), whose backend the
        autotune ranking picks; "auto" picks ELL below 1 % density, else
        "bcoo"."""
        from .dense import BlockMatrix, DenseMatrix

        if isinstance(other, SparseVecMatrix):
            return self.multiply_sparse(other)
        dense = other.logical() if isinstance(other, DenseMatrix) \
            else to_tensor(other, device=self.mesh.device)
        if format == "auto":
            density = self.nnz / max(1, self._shape[0] * self._shape[1])
            format = "ell" if density < 0.01 else "bcoo"
        if format == "ell":
            out = ell_spmm(self.to_ell(), dense)
        elif format == "bcoo":
            out = mult_sparse_dense(self.bcoo, dense)
        elif format == "bsr":
            out = self.to_bsr().multiply(dense, backend="auto")
        else:
            raise ValueError(f"unknown SpMM format: {format}")
        return BlockMatrix.from_array(out, self.mesh)

    def to_bsr(self, block_size: int = 128):
        """Convert to block-sparse storage (cached per block size), straight
        from the COO triplets — never densified."""
        from ..ops.sparse_bsr import bsr_from_coo

        if block_size not in self._bsr_cache:
            rows, cols, _ = self._coo_triplets()
            self._bsr_cache[block_size] = bsr_from_coo(
                rows, cols, self.bcoo.values(), self._shape,
                block_size=block_size, device=self.mesh.device)
        return self._bsr_cache[block_size]

    def to_ell(self, k_width: int | None = None):
        """Convert to ELL storage, cached per k_width. ``k_width=None`` caps
        the padded row width at 4× the mean degree (min 8): a dense hub row
        must not inflate the (rows × K) arrays to dense-matrix size — its
        overflow goes to the exact sparse residual instead."""
        if k_width is None:
            mean_deg = self.nnz / max(1, self._shape[0])
            k_width = max(8, int(4 * mean_deg) + 1)
        if k_width not in self._ell_cache:
            rows, cols, _ = self._coo_triplets()
            self._ell_cache[k_width] = ell_from_coo(
                rows, cols, self.bcoo.values(), self._shape,
                k_width=k_width, device=self.mesh.device)
        return self._ell_cache[k_width]

    def to_dense_vec_matrix(self, mesh: Mesh | None = None):
        """Densify (SparseVecMatrix.toDenseVecMatrix,
        SparseVecMatrix.scala:56-65)."""
        from .dense import DenseVecMatrix

        return DenseVecMatrix.from_array(self.bcoo.to_dense(),
                                         mesh or self.mesh)

    def to_coordinate_matrix(self) -> CoordinateMatrix:
        idx = self.bcoo.indices()
        return CoordinateMatrix(idx[0], idx[1], self.bcoo.values(),
                                shape=self._shape, mesh=self.mesh)

    def to_numpy(self) -> np.ndarray:
        """The dense matrix on the host (bf16 comes back as float32)."""
        return to_host(self.bcoo.to_dense())[0]

    def __repr__(self):
        return f"SparseVecMatrix(shape={self._shape}, nnz={self.nnz})"
