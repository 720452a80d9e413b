"""Host-resident matrices bigger than device memory.

Counterpart of ``marlin_tpu/matrix/out_of_core.py``. The reference handles
oversized matrices by letting Spark spill RDD partitions to disk
(MEMORY_AND_DISK persistence). Here an explicit host-resident type streams
row chunks through the card (:mod:`marlin_tpu_torch.parallel.streaming`):
``OutOfCoreMatrix`` wraps a numpy array, ``np.memmap``, a chunk store or a
chunk-producing callable and exposes the subset of the DenseMatrix API whose
algorithms admit a streaming form — multiply by a device-resident right-hand
side, Gramian, sum, row slicing, and conversion to an on-card matrix when it
fits.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

from ..parallel.streaming import iter_row_chunks, streamed_gramian, streamed_matmul

__all__ = ["OutOfCoreMatrix"]


def _host(c) -> np.ndarray:
    """A host chunk as numpy (bf16 tensors widened to f32)."""
    if isinstance(c, torch.Tensor):
        return (c.float() if c.dtype == torch.bfloat16 else c).numpy()
    return np.asarray(c)


def _sum64(c) -> float:
    if isinstance(c, torch.Tensor):
        return float(c.sum(dtype=torch.float64))
    return float(np.sum(c, dtype=np.float64))


class OutOfCoreMatrix:
    def __init__(self, source, shape: tuple[int, int] | None = None,
                 chunk_rows: int = 1 << 18):
        """``source``: a 2-D ndarray/memmap, or a zero-arg callable returning a
        fresh iterator of row-chunk ndarrays (callables must be re-iterable so
        multiple operations can each make a full pass)."""
        self._store = None
        if hasattr(source, "iter_chunks") and hasattr(source, "read_rows"):
            # a ChunkStore (io/chunkstore.py): the native data plane. Reads
            # happen at THIS matrix's chunk_rows (native scatter/gather —
            # on-disk chunk size is a file property, not a streaming one),
            # and slice_rows becomes a true random access instead of a scan.
            if shape is not None and tuple(shape) != tuple(source.shape):
                raise ValueError(
                    f"shape {tuple(shape)} contradicts the store's "
                    f"{tuple(source.shape)}")
            self._store = source
            self._source = lambda: self._store.iter_chunks(self.chunk_rows)
            self._shape = tuple(source.shape)
        elif callable(source):
            if shape is None:
                raise ValueError("shape is required for a callable chunk source")
            self._source = source
            self._shape = tuple(shape)
        else:
            arr = source
            if arr.ndim != 2:
                raise ValueError(f"expected 2-D source, got shape {arr.shape}")
            if shape is not None and tuple(shape) != tuple(arr.shape):
                raise ValueError(
                    f"shape {tuple(shape)} contradicts the array's {tuple(arr.shape)}"
                )
            self._source = None
            self._array = arr
            self._shape = tuple(arr.shape)
        self.chunk_rows = chunk_rows

    # ------------------------------------------------------------- structure
    def num_rows(self) -> int:
        return self._shape[0]

    def num_cols(self) -> int:
        return self._shape[1]

    @property
    def shape(self) -> tuple[int, int]:
        return self._shape

    def _chunks(self) -> Iterator[np.ndarray]:
        if self._source is not None:
            return iter(self._source())
        return iter_row_chunks(self._array, self.chunk_rows)

    # ------------------------------------------------------------ operations
    def multiply(self, other, out: np.ndarray | None = None,
                 precision: str | None = None, prefetch: bool | None = None,
                 stats=None) -> np.ndarray | None:
        """``self @ other`` with ``other`` resident on device; the result
        streams back to host (or into ``out``, e.g. a writable memmap).
        Chunk production/upload runs on the async prefetch pipeline by default
        (``prefetch``/``stats`` as in :func:`streamed_matmul`)."""
        other_arr = other.logical() if hasattr(other, "logical") else other
        if other_arr.shape[0] != self.num_cols():
            raise ValueError(
                f"inner dim mismatch: {self.shape} @ {tuple(other_arr.shape)}"
            )
        # _chunks() already yields chunk_rows-sized pieces; streamed_* consume
        # the iterator as-is
        return streamed_matmul(self._chunks(), other_arr, out=out,
                               precision=precision, prefetch=prefetch,
                               stats=stats)

    def gramian(self, precision: str | None = None,
                prefetch: bool | None = None, stats=None) -> np.ndarray:
        """``AᵀA`` with the n×n accumulator on device."""
        return streamed_gramian(self._chunks(), precision=precision,
                                prefetch=prefetch, stats=stats)

    def sum(self, prefetch: bool | None = None) -> float:
        """Host-side total. Chunk production still overlaps the summation via
        a host-only prefetcher (no device upload) — callable sources that
        parse/generate are the cost here, not the adds."""
        from ..config import get_config
        from ..parallel.prefetch import ChunkPrefetcher

        enabled = get_config().prefetch_enabled if prefetch is None else prefetch
        chunks = self._chunks()
        if not enabled:
            return float(sum(_sum64(c) for c in chunks))
        with ChunkPrefetcher(chunks, device_put=False) as pf:
            return float(sum(_sum64(c) for c in pf))

    def slice_rows(self, start: int, stop: int) -> np.ndarray:
        """Materialize a host row range [start, stop)."""
        if self._store is not None:
            start = max(start, 0)
            stop = min(stop, self._shape[0])
            if stop <= start:
                return np.zeros((0, self.num_cols()))
            return _host(self._store.read_rows(start, stop - start))
        if self._source is None:
            return np.asarray(self._array[start:stop])
        out, pos = [], 0
        for c in self._chunks():
            lo, hi = max(start - pos, 0), min(stop - pos, c.shape[0])
            if lo < hi:
                out.append(_host(c[lo:hi]))
            pos += c.shape[0]
            if pos >= stop:
                break
        return np.concatenate(out, axis=0) if out else np.zeros((0, self.num_cols()))

    def to_dense_vec_matrix(self, mesh=None):
        """Load fully onto the card (only when it fits). float64 data lands
        in the configured default dtype, as the JAX package's float64 host
        arrays land in float32. On a mesh over ranks each rank reads only
        its rows."""
        from ..config import get_config
        from ..interop import torch_dtype
        from .dense import DenseVecMatrix

        def wrap(data):
            dt = data.dtype if isinstance(data, torch.Tensor) \
                else torch_dtype(np.asarray(data).dtype)
            return DenseVecMatrix.from_array(
                data, mesh, dtype=get_config().default_dtype
                if dt == torch.float64 else None)

        if getattr(mesh, "ranks", None) is not None:
            return self._rank_rows(mesh)
        if self._source is None:
            return wrap(self._array)
        # fill a single preallocated buffer — buffering all chunks and
        # concatenating would need 2x the matrix in host RAM
        first = next(iter(self._chunks()))
        buf = torch.empty(self._shape, dtype=first.dtype
                          if isinstance(first, torch.Tensor)
                          else torch_dtype(np.asarray(first).dtype))
        pos = 0
        for c in self._chunks():
            dst = buf[pos : pos + c.shape[0]]
            if isinstance(c, torch.Tensor):
                dst.copy_(c)
            else:
                np.copyto(dst.numpy(), c)
            pos += c.shape[0]
        if pos != self._shape[0]:
            raise ValueError(f"chunk source yielded {pos} rows, expected {self._shape[0]}")
        return wrap(buf)

    def _rank_rows(self, mesh):
        """Over ranks: this rank's block of the rows, read alone
        (:meth:`slice_rows`: a chunk store's ``read_rows`` window)."""
        from ..config import get_config
        from ..interop import to_tensor
        from ..mesh import Sharding
        from .dense import DenseVecMatrix

        m, n = self._shape
        spec = DenseVecMatrix._default_spec
        sh = Sharding(mesh, spec)
        (r0, r1), _ = sh.bounds(sh.padded_shape((m, n)))
        rows = self.slice_rows(min(r0, m), min(r1, m))
        block = np.zeros((r1 - r0, n), dtype=rows.dtype)
        block[:rows.shape[0]] = rows
        dtype = get_config().default_dtype if block.dtype == np.float64 \
            else None
        return DenseVecMatrix(to_tensor(block, dtype, mesh.device), (m, n),
                              mesh, spec)

    def __repr__(self):
        if self._store is not None:
            kind = "chunkstore"
        elif self._source is not None:
            kind = "callable"
        else:
            kind = type(self._array).__name__
        return f"OutOfCoreMatrix(shape={self._shape}, source={kind}, chunk_rows={self.chunk_rows})"
