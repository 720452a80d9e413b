"""MNIST loading for the NeuralNetwork workload.

Counterpart of ``marlin_tpu/io/mnist.py``, copied (numpy only): the idx
readers, the out-of-core image stream and the synthetic stand-in.

The reference's loader (examples/NeuralNetwork.scala:32-84) reads MNIST from
HDFS text with a two-pass partition-size collection, then re-blocks into a
BlockMatrix plus co-partitioned label chunks. Here: read the standard idx
(ubyte, optionally gzipped) files directly into one sharded data matrix and an
int label vector — same sharding, so data/label co-location (the reference's
NeuralNetworkPartitioner) holds by construction. A synthetic fallback generates
a classifiable dataset when no files are available.
"""

from __future__ import annotations

import gzip
import os
import struct

import numpy as np

__all__ = ["load_mnist_images", "load_mnist_labels", "synthetic_mnist",
           "iter_mnist_image_chunks", "mnist_images_out_of_core"]


def _open(path: str):
    return gzip.open(path, "rb") if path.endswith(".gz") else open(path, "rb")


def _read_idx3_header(f, path: str) -> tuple[int, int]:
    magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
    if magic != 2051:
        raise ValueError(f"{path}: bad idx3 magic {magic}")
    return n, rows * cols


def iter_mnist_image_chunks(path: str, chunk_rows: int = 1 << 14):
    """idx3-ubyte images streamed as ``(≤chunk_rows, dim)`` float32 chunks in
    [0, 1] without ever materializing the full file — the out-of-core feed
    for datasets bigger than host RAM. Streamed consumers pull this through
    the async prefetch pipeline, so the file read + ``/255`` normalization
    happen on producer threads, off the device's critical path."""
    with _open(path) as f:
        n, dim = _read_idx3_header(f, path)
        remaining = n
        while remaining:
            take = min(chunk_rows, remaining)
            buf = f.read(take * dim)
            if len(buf) != take * dim:
                raise ValueError(
                    f"{path}: truncated idx3 file ({remaining} of {n} rows "
                    "unread at EOF)")
            yield (np.frombuffer(buf, np.uint8).reshape(take, dim)
                   / 255.0).astype(np.float32)
            remaining -= take


def mnist_images_out_of_core(path: str, chunk_rows: int = 1 << 14,
                             chunkstore: bool | None = None):
    """:class:`~marlin_tpu_torch.matrix.out_of_core.OutOfCoreMatrix` over an idx3
    images file. The source is a re-iterable callable, so every streamed op
    (multiply/gramian/sum) makes its own chunked pass over the file.

    ``chunkstore`` as in :func:`~marlin_tpu_torch.io.text.
    load_matrix_file_out_of_core`: None auto-selects a fresh
    ``<path>.mchunk`` sidecar (native binary reads, no per-pass idx decode +
    ``/255`` normalization), True builds-and-requires it, False forces the
    idx path. The sidecar stores the normalized float32 rows, bit-identical
    to :func:`iter_mnist_image_chunks`."""
    from ..matrix.out_of_core import OutOfCoreMatrix

    if chunkstore is not False:
        from .chunkstore import open_sidecar, transcode_idx

        store = open_sidecar(path)
        if store is None and chunkstore is True:
            # just built -> fresh by construction (see text.py counterpart)
            from .chunkstore import ChunkStore

            store = ChunkStore(transcode_idx(path, chunk_rows=chunk_rows))
        if store is not None:
            return OutOfCoreMatrix(store, chunk_rows=chunk_rows)

    with _open(path) as f:
        n, dim = _read_idx3_header(f, path)
    return OutOfCoreMatrix(lambda: iter_mnist_image_chunks(path, chunk_rows),
                           shape=(n, dim), chunk_rows=chunk_rows)


def load_mnist_images(path: str) -> np.ndarray:
    """idx3-ubyte images → (n, 784) float32 in [0, 1]."""
    with _open(path) as f:
        n, dim = _read_idx3_header(f, path)
        data = np.frombuffer(f.read(n * dim), np.uint8)
    return (data.reshape(n, dim) / 255.0).astype(np.float32)


def load_mnist_labels(path: str) -> np.ndarray:
    """idx1-ubyte labels → (n,) int32."""
    with _open(path) as f:
        magic, n = struct.unpack(">II", f.read(8))
        if magic != 2049:
            raise ValueError(f"{path}: bad idx1 magic {magic}")
        return np.frombuffer(f.read(n), np.uint8).astype(np.int32)


def synthetic_mnist(n: int = 4096, dim: int = 784, classes: int = 10,
                    seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Classifiable stand-in: class-dependent means + noise."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, classes, n).astype(np.int32)
    centers = rng.standard_normal((classes, dim)).astype(np.float32)
    x = centers[labels] + 0.5 * rng.standard_normal((n, dim)).astype(np.float32)
    return ((x - x.min()) / (x.max() - x.min())).astype(np.float32), labels


def load_or_synthesize(images_path: str | None, labels_path: str | None,
                       n_synthetic: int = 4096):
    """Load real MNIST when paths are given; synthesize only when *no* images
    path was requested. A given-but-missing or partial path is an error — never
    silently substitute synthetic data for what the user asked for."""
    if images_path is None:
        return synthetic_mnist(n_synthetic)
    if labels_path is None:
        raise ValueError("images path given without a labels path")
    for p in (images_path, labels_path):
        if not os.path.exists(p):
            raise FileNotFoundError(f"MNIST file not found: {p}")
    return load_mnist_images(images_path), load_mnist_labels(labels_path)
