"""Out-of-core streaming for matrices bigger than device memory.

Counterpart of ``marlin_tpu/parallel/streaming.py``. The reference spills
oversized matrices through Spark's disk-backed RDDs; this layer streams the
tall operand of the tall-skinny workloads (BASELINE.md config 4: 10⁷×512 ·
512×512) from the host (numpy array, memmap, chunk store or a chunk
generator) through the card in row chunks, and either

- :func:`streamed_matmul` — multiplies each chunk by a resident right-hand
  side and streams the result back to the host, or
- :func:`streamed_gramian` — accumulates AᵀA *on the card* (the reference's
  Gramian aggregate, DenseVecMatrix.scala:1444-1486) in an f32 accumulator
  that alone leaves at the end.

The chunk product and the rank update are ``torch.matmul`` products under
:func:`~marlin_tpu_torch.ops.local.precision_scope` (the JAX package's
``jnp.dot`` outside any Pallas kernel). Chunk production (source read, dtype
conversion, ``_compress_for_transfer``, the pinned staging and the
host-to-device copy) runs on background threads through
:class:`~marlin_tpu_torch.parallel.prefetch.ChunkPrefetcher` by default
(``config.prefetch_enabled``); ``prefetch=False`` runs the same steps on the
caller's thread. Results are bit-identical either way — the prefetcher
reorders *work*, never *math*. The JAX package records each chunk program's
XLA cost model; here the costs are analytic (``2·rows·k·n`` operations and
the chunk's bytes) in :func:`~marlin_tpu_torch.obs.perf.get_program_costs`.
"""

from __future__ import annotations

import collections
import time
from typing import Iterable, Iterator

import numpy as np
import torch

from ..config import get_config, resolve_device
from ..interop import torch_dtype
from ..obs import perf, trace as obs_trace
from ..ops.local import precision_scope
from ..utils.profiling import StageTimes
from .prefetch import ChunkPrefetcher

__all__ = ["streamed_matmul", "streamed_gramian", "iter_row_chunks"]


def iter_row_chunks(a, chunk_rows: int) -> Iterator:
    """Yield row chunks from an ndarray/memmap/tensor (zero-copy views)."""
    for start in range(0, a.shape[0], chunk_rows):
        yield a[start : start + chunk_rows]


def _as_chunks(a_source, chunk_rows: int) -> Iterable:
    if hasattr(a_source, "iter_chunks"):
        # a ChunkStore (io/chunkstore.py): native mmap'd reads at the
        # STREAMING chunk size. Checked before the array duck-type: a store
        # also has .shape, but slicing it per chunk would lose the native
        # window gather.
        return a_source.iter_chunks(chunk_rows)
    if hasattr(a_source, "shape") and hasattr(a_source, "__getitem__"):
        return iter_row_chunks(a_source, chunk_rows)
    return a_source  # already an iterable of chunks


def _compress_for_transfer(chunk, transfer_dtype):
    """Cast on the *host* before the copy — the point is fewer bytes over
    PCIe, so the cast must not happen on the card. numpy chunks stay numpy
    where no cast is asked or numpy has the type; bfloat16 goes through torch
    (round to nearest even, as ``ml_dtypes`` rounds)."""
    if isinstance(chunk, torch.Tensor):
        chunk = chunk.detach().cpu()
    else:
        chunk = np.asarray(chunk)
    if transfer_dtype is None:
        return chunk
    want = torch_dtype(transfer_dtype)
    if isinstance(chunk, torch.Tensor):
        return chunk if chunk.dtype == want else chunk.to(want)
    if want == torch.bfloat16:
        if not chunk.flags.writeable:
            chunk = chunk.copy()  # torch wraps writable arrays only
        return torch.from_numpy(chunk).to(want)
    np_dtype = torch.empty(0, dtype=want).numpy().dtype
    return chunk if chunk.dtype == np_dtype else chunk.astype(np_dtype)


def _chunk_stream(a_source, chunk_rows: int, transfer_dtype, prefetch,
                  stats: StageTimes, device: torch.device):
    """The shared front half of both streamed ops: an iterator of device
    chunks, prefetched on background threads when enabled. Returns
    ``(iterator, closer)`` — ``closer()`` must run on every exit path (the
    prefetcher owns threads)."""
    chunks = _as_chunks(a_source, chunk_rows)

    def transform(c):
        return _compress_for_transfer(c, transfer_dtype)

    enabled = get_config().prefetch_enabled if prefetch is None else prefetch
    if enabled:
        pf = ChunkPrefetcher(chunks, transform, stats=stats, device=device)
        return pf, pf.close

    # synchronous: the same read + transform + copy on the caller's thread
    # ("produce" covers the source read too, as in the prefetcher, so the
    # on/off stage breakdowns compare)
    def sync_stream():
        it = iter(chunks)
        while True:
            t0 = time.perf_counter()
            try:
                c = next(it)
            except StopIteration:
                return
            c = transform(c)
            stats.add("produce", time.perf_counter() - t0)
            with stats.timed("transfer"):
                if not isinstance(c, torch.Tensor):
                    c = torch.from_numpy(np.array(c, copy=True))
                c = c.to(device)
            yield c

    return sync_stream(), (lambda: None)


def _name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def _to_host(y: torch.Tensor) -> np.ndarray:
    """A host tensor as numpy (bf16 widened to f32: numpy has no bf16)."""
    return (y.float() if y.dtype == torch.bfloat16 else y).numpy()


def streamed_matmul(
    a_source,
    b,
    chunk_rows: int = 1 << 18,
    out: np.ndarray | None = None,
    precision: str | None = None,
    transfer_dtype=None,
    prefetch: bool | None = None,
    stats: StageTimes | None = None,
    device=None,
) -> np.ndarray | None:
    """``A @ B`` where A streams through the card in row chunks.

    ``a_source``: ndarray/memmap/chunk store, or an iterable of row-chunk
    arrays. ``b``: (k, n) array, tensor or DenseMatrix, resident on
    ``device`` (default: ``b``'s when it is a tensor, else the configured
    one). ``out``: optional preallocated (m, n) host array (e.g. a writable
    memmap) filled in place; otherwise the chunks are stacked (only sensible
    when the result fits host RAM). ``transfer_dtype="bfloat16"`` halves the
    H2D bytes (host-side cast). ``prefetch``: None follows
    ``config.prefetch_enabled``; True/False force the pipeline on/off
    (results are identical either way). ``stats``: optional
    :class:`StageTimes` receiving the produce/transfer/stall/compute/drain
    breakdown. One result stays in flight: its device-to-host copy goes into
    pinned memory, so draining it overlaps the next chunk's product. bf16
    results come back as float32.
    """
    precision = precision or get_config().matmul_precision
    stats = stats if stats is not None else StageTimes()
    b_t = b.logical() if hasattr(b, "logical") else b
    if isinstance(b_t, torch.Tensor) and device is None:
        device = b_t.device
    dev = resolve_device(device)
    if not isinstance(b_t, torch.Tensor):
        b_np = np.asarray(b_t)
        b_t = torch.from_numpy(b_np.copy() if not b_np.flags.writeable
                               else b_np)
    b_dev = b_t.to(dev)
    cuda = dev.type == "cuda"

    results, offset, turn = [], 0, [0]
    pending: collections.deque = collections.deque()  # (event, host rows)
    pinned: list[torch.Tensor] = []  # two result buffers, used in turn

    def drain(limit: int):
        nonlocal offset
        while len(pending) > limit:
            event, host = pending.popleft()
            with stats.timed("drain"):
                if event is not None:
                    event.synchronize()
                y_np = _to_host(host)
                if out is not None:
                    out[offset : offset + y_np.shape[0]] = y_np
                else:
                    results.append(y_np.copy() if cuda else y_np)
            offset += y_np.shape[0]

    def land(y: torch.Tensor):
        """Start the copy of one chunk's result to the host."""
        if not cuda:
            pending.append((None, y))
            return
        if not pinned or pinned[0].numel() < y.numel():
            pinned[:] = [torch.empty(y.numel(), dtype=y.dtype,
                                     pin_memory=True) for _ in range(2)]
        buf = pinned[turn[0] % 2]
        turn[0] += 1
        host = buf[:y.numel()].view(y.shape)
        host.copy_(y, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        pending.append((event, host))

    n_chunks, prog_key, t_op = 0, None, time.perf_counter()
    # one span per streamed op: the prefetcher's producer threads inherit it
    with obs_trace.span("streamed_matmul"):
        stream, closer = _chunk_stream(a_source, chunk_rows, transfer_dtype,
                                       prefetch, stats, dev)
        try:
            for x in stream:
                # widen compressed uploads, never narrow: the wider of the
                # chunk's and b's dtypes
                ct = torch.promote_types(x.dtype, b_dev.dtype)
                if prog_key is None:
                    prog_key = perf.program_key(
                        chunk=f"{x.shape[0]}x{x.shape[1]}",
                        n=b_dev.shape[1], dtype=_name(x.dtype))
                    k, n = b_dev.shape
                    perf.get_program_costs().capture(
                        "streamed_matmul", prog_key, cost={
                            "flops": 2.0 * x.shape[0] * k * n,
                            "bytes accessed": float(
                                x.numel() * x.element_size()
                                + b_dev.numel() * b_dev.element_size()
                                + x.shape[0] * n
                                * torch.empty(0, dtype=ct).element_size())})
                n_chunks += 1
                with stats.timed("compute"), precision_scope(precision):
                    y = torch.matmul(x.to(ct), b_dev.to(ct))
                land(y)
                drain(1)  # one result in flight: compute overlaps the D2H
            if n_chunks == 0:
                raise ValueError("empty input stream")
            drain(0)
        finally:
            closer()
        if prog_key is not None:
            # end-to-end wall against the per-chunk cost model
            costs = perf.get_program_costs()
            costs.observe("streamed_matmul", prog_key,
                          time.perf_counter() - t_op, calls=n_chunks)
            costs.emit("streamed_matmul")
    return out if out is not None else np.concatenate(results, axis=0)


def streamed_gramian(
    a_source,
    n_cols: int | None = None,
    chunk_rows: int = 1 << 18,
    precision: str | None = None,
    dtype=torch.float32,
    transfer_dtype=None,
    prefetch: bool | None = None,
    stats: StageTimes | None = None,
    device=None,
) -> np.ndarray:
    """``AᵀA`` with A streamed in row chunks and the n×n accumulator resident
    on ``device`` (default: the configured one) — one rank-chunk update per
    chunk, no host reduction.

    ``transfer_dtype="bfloat16"`` casts chunks on the host before the copy,
    halving the H2D bytes at bf16 input precision; the accumulation stays in
    ``dtype`` (f32). With no transfer dtype the chunks travel in ``dtype``.
    ``prefetch``/``stats`` as in :func:`streamed_matmul`."""
    precision = precision or get_config().matmul_precision
    stats = stats if stats is not None else StageTimes()
    dev = resolve_device(device)
    acc = torch_dtype(dtype)
    g = None
    effective_transfer = transfer_dtype if transfer_dtype is not None else acc
    n_chunks, prog_key, t_op = 0, None, time.perf_counter()
    with obs_trace.span("streamed_gramian"):
        stream, closer = _chunk_stream(a_source, chunk_rows,
                                       effective_transfer, prefetch, stats,
                                       dev)
        try:
            for x in stream:
                if n_cols is not None and x.shape[1] != n_cols:
                    raise ValueError(
                        f"chunk has {x.shape[1]} cols, expected {n_cols}")
                if g is None:
                    n_cols = x.shape[1]
                    g = torch.zeros((n_cols, n_cols), dtype=acc, device=dev)
                    prog_key = perf.program_key(
                        chunk=f"{x.shape[0]}x{x.shape[1]}",
                        dtype=_name(x.dtype), acc=_name(acc))
                    perf.get_program_costs().capture(
                        "streamed_gramian", prog_key, cost={
                            "flops": 2.0 * x.shape[0] * n_cols * n_cols,
                            "bytes accessed": float(
                                x.numel() * x.element_size()
                                + 2 * g.numel() * g.element_size())})
                n_chunks += 1
                with stats.timed("compute"), precision_scope(precision):
                    x = x.to(acc)
                    g.addmm_(x.mT, x)
        finally:
            closer()
        if g is None:
            raise ValueError("empty input stream")
        with stats.timed("drain"):
            out = _to_host(g.cpu())
        if prog_key is not None:
            costs = perf.get_program_costs()
            costs.observe("streamed_gramian", prog_key,
                          time.perf_counter() - t_op, calls=n_chunks)
            costs.emit("streamed_gramian")
        return out
