"""MarlinChunk binary container — the native out-of-core data plane.

Counterpart of ``marlin_tpu/io/chunkstore.py`` over the port's own copy of
the C++ library (:mod:`marlin_tpu_torch.native`). The on-disk format is the
C++ one, so a store written by either package reads equal in the other.
Reads fill CPU tensors (or any caller buffer of the right dtype, a pinned
staging tensor included): numpy has no bfloat16 without ``ml_dtypes``, so
dtype code 3 is read as raw 16-bit words viewed as ``torch.bfloat16``, and
host casts to it go through torch (round to nearest even, the bits
``ml_dtypes`` gives).

The tall-skinny Gramian of BASELINE.md config 4 streams its rows from the
host, where a text parser cannot keep up with the card. The prefetch
pipeline (parallel/prefetch.py) overlaps production with device compute;
this module replaces the production itself. A ``.mchunk`` file is a fixed-layout
sequence of CRC32C-checksummed row-major chunks behind a 64-byte header
(format spec in native/chunkstore.cpp), read via mmap so the OS page cache
does the buffering, with parse/verify/dtype-convert running in C outside the
GIL (ctypes releases it; the reader additionally fans chunks over a
std::thread pool). The reader fills caller-provided buffers — no
per-chunk Python allocation.

Layering:

- :class:`ChunkStore` — open reader: random-access :meth:`read_rows` windows
  (disk chunk size decouples from streaming chunk size) and re-iterable
  :meth:`iter_chunks` streams that plug straight into
  :class:`~marlin_tpu_torch.parallel.prefetch.ChunkPrefetcher` /
  ``streamed_matmul`` / ``streamed_gramian`` / ``OutOfCoreMatrix``.
- :class:`ChunkStoreWriter` / :func:`write_chunkstore` — build stores from
  arrays or row streams.
- :func:`transcode_text` / :func:`transcode_idx` — native converters from
  the existing row-text / idx3-ubyte formats (the textio parser, reused).
- :func:`sidecar_path` / :func:`open_sidecar` — the auto-selection contract:
  loaders use ``<file>.mchunk`` when it exists and is newer than its source.
- CLI: ``python -m marlin_tpu_torch.io.chunkstore build|info|verify``.

Config knobs (marlin_tpu_torch.config): ``data_plane_threads`` (reader pool),
``data_plane_dtype`` (staging dtype — ``"bfloat16"`` makes chunks surface
already-compressed so ``_compress_for_transfer`` is a no-op and H2D bytes
halve), ``data_plane_verify`` (per-chunk CRC validation on read).

Observability/chaos: every read passes the ``dataplane.read`` fault point
(ctx path ``<name>@<row>``), counts land in
``marlin_dataplane_{chunks,bytes,checksum_failures}_total``, and each chunk
batch reads inside a ``dataplane.read`` span so store reads join the
streamed op's trace.
"""

from __future__ import annotations

import errno
import os
import threading

import numpy as np
import torch

from ..obs import trace as obs_trace
from ..obs.metrics import get_registry
from ..utils import faults

__all__ = [
    "ChunkStore", "ChunkStoreWriter", "ChunkstoreError",
    "ChunkstoreCorruptError", "write_chunkstore", "transcode_text",
    "transcode_idx", "sidecar_path", "open_sidecar", "SUFFIX",
]

#: sidecar suffix: ``matrix.txt`` -> ``matrix.txt.mchunk``
SUFFIX = ".mchunk"

#: dtype code <-> torch dtype (codes are the on-disk enum, chunkstore.cpp)
_CODE_TO_DTYPE = {1: torch.float32, 2: torch.float64, 3: torch.bfloat16}
_DTYPE_TO_CODE = {v: k for k, v in _CODE_TO_DTYPE.items()}
#: numpy buffers a read may fill, by code (bf16 as its raw 16-bit words)
_CODE_TO_NUMPY = {1: np.dtype(np.float32), 2: np.dtype(np.float64),
                  3: np.dtype(np.uint16)}


def _dtype_code(dtype) -> int:
    """The on-disk code of ``dtype``: a name (``"float32"``, ``"float64"``,
    ``"bfloat16"``), a torch dtype or a numpy dtype."""
    if isinstance(dtype, torch.dtype):
        code = _DTYPE_TO_CODE.get(dtype)
    else:
        name = str(dtype)
        if name not in ("float32", "float64", "bfloat16"):
            try:
                name = np.dtype(dtype).name
            except TypeError:
                name = None
        code = {"float32": 1, "float64": 2, "bfloat16": 3}.get(name)
    if code is None:
        raise ValueError(
            f"unsupported chunk-store dtype {dtype!r} "
            f"(supported: float32, float64, bfloat16)")
    return code


def _buffer(out, code: int, shape: tuple[int, int]) -> int:
    """The data pointer of a caller's ``out`` buffer after checking it: a
    CPU tensor of the read's dtype, or a numpy array of its width (bf16 as
    ``uint16``), C-contiguous and writable."""
    if isinstance(out, torch.Tensor):
        if out.device.type != "cpu" or out.dtype != _CODE_TO_DTYPE[code] \
                or tuple(out.shape) != shape:
            raise ValueError(
                f"out buffer is {out.dtype}{tuple(out.shape)} on "
                f"{out.device}, need {_CODE_TO_DTYPE[code]}{shape} on cpu")
        if not out.is_contiguous():
            raise ValueError("out buffer must be contiguous")
        return out.data_ptr()
    if out.shape != shape or out.dtype != _CODE_TO_NUMPY[code]:
        raise ValueError(f"out buffer is {out.dtype}{out.shape}, need "
                         f"{_CODE_TO_NUMPY[code]}{shape}")
    if not out.flags.c_contiguous or not out.flags.writeable:
        raise ValueError("out buffer must be C-contiguous writable")
    return out.ctypes.data


class ChunkstoreError(RuntimeError):
    """Malformed chunk store (bad magic/version/layout, format violation)."""


class ChunkstoreCorruptError(ChunkstoreError):
    """Data damage detected: checksum mismatch, truncated/torn file."""


def _lib():
    from .. import native

    lib = native._load_chunkstore()
    if lib is None:
        raise ChunkstoreError(
            "native chunk-store library unavailable"
            + (f" (build failed: {native.build_error()})"
               if native.build_error() else ""))
    return lib


def _raise_rc(rc: int, path: str, what: str):
    if -rc == errno.EBADMSG:
        raise ChunkstoreCorruptError(
            f"{path}: chunk checksum mismatch during {what} — the file is "
            "corrupt; rebuild it from its source")
    if -rc == errno.EIO:
        raise ChunkstoreCorruptError(
            f"{path}: truncated or torn chunk store detected during {what}")
    if -rc == errno.EINVAL:
        raise ChunkstoreError(f"{path}: not a valid chunk store ({what})")
    raise OSError(-rc, f"{what} failed for {path}")


_metrics = None  # lazy singleton, as in parallel/prefetch.py


def _metric_families():
    """(chunks, bytes, checksum-failures) counters — one set per process,
    shared by every store (the scrape sees the aggregate data-plane flow)."""
    global _metrics
    if _metrics is None:
        reg = get_registry()
        _metrics = (
            reg.counter("marlin_dataplane_chunks_total",
                        "Disk chunks read (and CRC-validated when "
                        "data_plane_verify) by the native data plane"),
            reg.counter("marlin_dataplane_bytes_total",
                        "Bytes delivered into caller buffers by the native "
                        "data plane"),
            reg.counter("marlin_dataplane_checksum_failures_total",
                        "Chunk CRC32C validation failures (corrupt stores "
                        "detected)"),
        )
    return _metrics


class ChunkStore:
    """Open reader over one ``.mchunk`` file.

    The native handle is an mmap + header — stateless per read, so one store
    serves concurrent iterators/threads (the prefetcher's producers). Windows
    are arbitrary: ``read_rows(start, n)`` gathers any row range regardless
    of the on-disk ``chunk_rows``, filling a caller-provided (or freshly
    allocated) row-major buffer.
    """

    def __init__(self, path: str):
        self._path = path
        self._name = os.path.basename(path)
        self._lib = _lib()
        import ctypes

        err = ctypes.c_int32(0)
        self._h = self._lib.mcs_open(os.fspath(path).encode(),
                                     ctypes.byref(err))
        if not self._h:
            _raise_rc(err.value, path, "open")
        dt = ctypes.c_int32()
        nr, nc, cr, nk = (ctypes.c_int64() for _ in range(4))
        self._lib.mcs_info(self._h, ctypes.byref(dt), ctypes.byref(nr),
                           ctypes.byref(nc), ctypes.byref(cr),
                           ctypes.byref(nk))
        self._dtype = _CODE_TO_DTYPE[dt.value]
        self._shape = (nr.value, nc.value)
        self.chunk_rows = cr.value
        self.nchunks = nk.value
        self._lock = threading.Lock()  # guards close vs in-flight reads

    # ------------------------------------------------------------- structure
    @property
    def path(self) -> str:
        return self._path

    @property
    def shape(self) -> tuple[int, int]:
        return self._shape

    @property
    def dtype(self) -> torch.dtype:
        """The stored dtype (reads may request any supported dtype)."""
        return self._dtype

    def num_rows(self) -> int:
        return self._shape[0]

    def num_cols(self) -> int:
        return self._shape[1]

    # ------------------------------------------------------------------ read
    def _resolve_code(self, dtype) -> int:
        if dtype is None:
            from ..config import get_config

            dtype = get_config().data_plane_dtype
        return _DTYPE_TO_CODE[self._dtype] if dtype is None \
            else _dtype_code(dtype)

    def read_rows(self, start: int, nrows: int, out=None, dtype=None,
                  threads: int | None = None,
                  verify: bool | None = None) -> torch.Tensor:
        """Gather rows ``[start, start+nrows)`` into ``out`` (a CPU tensor,
        allocated when None), converting to ``dtype`` natively. ``out`` may
        also be a numpy array of the dtype's width (bf16 as ``uint16``), and
        is then returned as it is. ``dtype``/``threads``/``verify`` default
        from config (``data_plane_dtype`` — None keeps the stored dtype — /
        ``data_plane_threads`` / ``data_plane_verify``). Raises
        :class:`ChunkstoreCorruptError` on any checksum mismatch in a
        touched chunk (the CRC covers whole chunks, so corruption is
        detected even when the window misses the damaged byte)."""
        from ..config import get_config

        cfg = get_config()
        code = self._resolve_code(dtype)
        threads = cfg.data_plane_threads if threads is None else threads
        verify = cfg.data_plane_verify if verify is None else verify
        if not 0 <= start <= start + nrows <= self._shape[0]:
            raise IndexError(
                f"row window [{start}, {start + nrows}) outside "
                f"{self._shape[0]} rows")
        shape = (nrows, self._shape[1])
        if out is None:
            out = torch.empty(shape, dtype=_CODE_TO_DTYPE[code])
        ptr = _buffer(out, code, shape)
        faults.fire("dataplane.read", path=f"{self._name}@{start}",
                    index=start)
        chunks_m, bytes_m, bad_m = _metric_families()
        with self._lock:
            if self._h is None:
                raise ChunkstoreError(f"{self._path}: store is closed")
            with obs_trace.span("dataplane.read"):
                rc = self._lib.mcs_read(
                    self._h, start, nrows, ptr if nrows else None, code,
                    threads, 1 if verify else 0)
        if rc != 0:
            if -rc == errno.EBADMSG:
                bad_m.inc()
            _raise_rc(rc, self._path, f"read rows [{start}, {start + nrows})")
        if nrows:
            first = start // self.chunk_rows
            last = (start + nrows - 1) // self.chunk_rows
            chunks_m.inc(last - first + 1)
            bytes_m.inc(nrows * self._shape[1]
                        * _CODE_TO_NUMPY[code].itemsize)
        return out

    def iter_chunks(self, chunk_rows: int | None = None, dtype=None,
                    threads: int | None = None, verify: bool | None = None):
        """Yield row-major windows of ``chunk_rows`` rows (default: the
        on-disk chunk size) — the streaming source shape the prefetcher and
        ``streamed_*`` consume. Generator, re-invocable: each call is an
        independent pass (``lambda: store.iter_chunks(...)`` satisfies
        ``OutOfCoreMatrix``'s re-iterable contract)."""
        step = self.chunk_rows if chunk_rows is None else int(chunk_rows)
        if step < 1:
            raise ValueError(f"chunk_rows must be >= 1, got {step}")
        for start in range(0, self._shape[0], step):
            n = min(step, self._shape[0] - start)
            yield self.read_rows(start, n, dtype=dtype, threads=threads,
                                 verify=verify)

    # ------------------------------------------------------------- lifecycle
    def close(self) -> None:
        with self._lock:
            if self._h is not None:
                self._lib.mcs_close(self._h)
                self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def __repr__(self):
        return (f"ChunkStore({self._path!r}, shape={self._shape}, "
                f"dtype={self._dtype}, chunk_rows={self.chunk_rows}, "
                f"nchunks={self.nchunks})")


class ChunkStoreWriter:
    """Append-streaming writer: rows in (f32/f64, any batch granularity),
    chunk-sized CRC'd chunks out. As a context manager it commits on clean
    exit and aborts + unlinks the partial file on exception — a torn store
    must never be left where :func:`open_sidecar` would pick it up."""

    def __init__(self, path: str, ncols: int, chunk_rows: int = 4096,
                 dtype="float32"):
        import ctypes

        self._path = path
        self._lib = _lib()
        err = ctypes.c_int32(0)
        self._h = self._lib.mcs_writer_open(
            os.fspath(path).encode(), _dtype_code(dtype), int(ncols),
            int(chunk_rows), ctypes.byref(err))
        if not self._h:
            _raise_rc(err.value, path, "create")
        self.rows_appended = 0
        self._ncols = int(ncols)

    def append(self, rows) -> None:
        """Append a batch of rows (numpy or a tensor): f32 goes to the
        native writer as it is, everything else through f64 (exact for bf16
        and f32-width ints)."""
        if isinstance(rows, torch.Tensor):
            rows = rows.detach().cpu()
            rows = (rows if rows.dtype == torch.float32
                    else rows.to(torch.float64)).numpy()
        arr = np.asarray(rows)
        if arr.ndim == 1:
            arr = arr[None, :]
        if arr.ndim != 2 or arr.shape[1] != self._ncols:
            raise ValueError(
                f"expected (n, {self._ncols}) rows, got {arr.shape}")
        if arr.dtype == np.float32:
            code = 1
        else:
            arr = np.ascontiguousarray(arr, np.float64)
            code = 2
        arr = np.ascontiguousarray(arr)
        rc = self._lib.mcs_writer_append(self._h, arr.ctypes.data,
                                         arr.shape[0], code)
        if rc != 0:
            _raise_rc(rc, self._path, "append")
        self.rows_appended += arr.shape[0]

    def close(self) -> None:
        """Flush the tail chunk, finalize the header; the store is unreadable
        until this runs."""
        if self._h is None:
            return
        h, self._h = self._h, None
        rc = self._lib.mcs_writer_close(h)
        if rc != 0:
            _raise_rc(rc, self._path, "finalize")

    def abort(self) -> None:
        """Drop the writer and unlink the partial file."""
        if self._h is not None:
            h, self._h = self._h, None
            self._lib.mcs_writer_abort(h)
        try:
            os.unlink(self._path)
        except OSError:
            pass

    def __enter__(self):
        return self

    def __exit__(self, exc_type, *exc):
        if exc_type is None:
            self.close()
        else:
            self.abort()


def write_chunkstore(path: str, array, chunk_rows: int = 4096,
                     dtype=None) -> str:
    """Write a 2-D array or tensor as a chunk store (dtype defaults to its
    own when float32 or float64, else float32). Returns ``path``."""
    if dtype is None:
        dtype = {"float64": "float64"}.get(
            str(array.dtype).replace("torch.", ""), "float32")
    if len(array.shape) != 2:
        raise ValueError(f"expected a 2-D array, got shape "
                         f"{tuple(array.shape)}")
    with ChunkStoreWriter(path, array.shape[1], chunk_rows, dtype) as w:
        for start in range(0, array.shape[0], chunk_rows):
            w.append(array[start:start + chunk_rows])
    return path


# --------------------------------------------------------------- converters
def transcode_text(src: str, dst: str | None = None, chunk_rows: int = 4096,
                   dtype="float64") -> str:
    """Transcode a row-text matrix file (``rowIdx:v,v,...``) into a chunk
    store, entirely in C (the textio parser feeding the chunk writer —
    the file never surfaces in Python). Default storage dtype is float64:
    the text values' exact parse, so chunk-loaded results are bit-identical
    to :func:`~marlin_tpu_torch.io.text.load_matrix_file`. The output is written
    to a temp name and renamed into place, so a crash never leaves a torn
    sidecar where :func:`open_sidecar` would find it."""
    import ctypes

    dst = sidecar_path(src) if dst is None else dst
    lib = _lib()
    tmp = dst + ".tmp"
    rows, cols = ctypes.c_int64(0), ctypes.c_int64(0)
    rc = lib.mcs_from_text(os.fspath(src).encode(), os.fspath(tmp).encode(),
                           int(chunk_rows), _dtype_code(dtype),
                           ctypes.byref(rows), ctypes.byref(cols))
    if rc != 0:
        if -rc == errno.EINVAL:
            raise ValueError(
                f"{src}: not transcodable row-text (needs contiguous "
                "in-order rectangular rows, like the streaming loader)")
        raise OSError(-rc, f"transcode failed for {src}")
    os.replace(tmp, dst)
    return dst


def transcode_idx(src: str, dst: str | None = None, chunk_rows: int = 1 << 14,
                  dtype="float32") -> str:
    """Transcode an idx3-ubyte images file into a chunk store holding the
    same ``uint8/255`` float32 rows :func:`~marlin_tpu_torch.io.mnist.
    iter_mnist_image_chunks` yields — stored f32 is that value exactly, so
    the chunk path is bit-identical to the idx path."""
    from .mnist import iter_mnist_image_chunks

    dst = sidecar_path(src) if dst is None else dst
    tmp = dst + ".tmp"
    ncols = None
    w = None
    try:
        for chunk in iter_mnist_image_chunks(src, chunk_rows):
            if w is None:
                ncols = chunk.shape[1]
                w = ChunkStoreWriter(tmp, ncols, chunk_rows, dtype)
            w.append(chunk)
        if w is None:
            raise ValueError(f"{src}: empty idx3 file, nothing to store")
        w.close()
    except BaseException:
        if w is not None:
            w.abort()
        else:
            try:
                os.unlink(tmp)
            except OSError:
                pass
        raise
    os.replace(tmp, dst)
    return dst


# ------------------------------------------------------------ auto-selection
def sidecar_path(path: str) -> str:
    """The chunk-store sidecar name for a source file."""
    return os.fspath(path) + SUFFIX


def open_sidecar(path: str) -> "ChunkStore | None":
    """Open ``path``'s sidecar store if it is usable: present, native library
    built, and not older than its source (a stale sidecar silently shadowing
    an edited source file would be a wrong-answer bug, so it is skipped, not
    trusted). Returns None when any of that fails — callers fall back to the
    text/idx path."""
    sc = sidecar_path(path)
    try:
        if not os.path.isfile(sc):
            return None
        if os.path.isfile(path) and os.path.getmtime(sc) < os.path.getmtime(path):
            return None
        return ChunkStore(sc)
    except (ChunkstoreError, OSError):
        return None


# -------------------------------------------------------------------- CLI
def _main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m marlin_tpu_torch.io.chunkstore",
        description="build / inspect / verify MarlinChunk stores")
    sub = ap.add_subparsers(dest="cmd", required=True)
    b = sub.add_parser("build", help="transcode a source file into a "
                                     "sidecar chunk store")
    b.add_argument("src", help="row-text or idx3-ubyte source file")
    b.add_argument("--out", default=None,
                   help=f"output path (default: <src>{SUFFIX})")
    b.add_argument("--format", choices=("auto", "text", "idx"),
                   default="auto")
    b.add_argument("--chunk-rows", type=int, default=4096)
    b.add_argument("--dtype", default=None,
                   choices=("float32", "float64", "bfloat16"),
                   help="storage dtype (default: float64 for text — exact "
                        "parse — / float32 for idx)")
    i = sub.add_parser("info", help="print a store's header")
    i.add_argument("store")
    v = sub.add_parser("verify", help="CRC-validate every chunk")
    v.add_argument("store")
    args = ap.parse_args(argv)

    if args.cmd == "build":
        fmt = args.format
        if fmt == "auto":
            low = args.src.lower()
            fmt = "idx" if ("idx3" in low or "-ubyte" in low
                            or low.endswith(".gz")) else "text"
        if fmt == "idx":
            out = transcode_idx(args.src, args.out, args.chunk_rows,
                                args.dtype or "float32")
        else:
            out = transcode_text(args.src, args.out, args.chunk_rows,
                                 args.dtype or "float64")
        with ChunkStore(out) as s:
            print(f"{out}: {s.shape[0]}x{s.shape[1]} {s.dtype} "
                  f"({s.nchunks} chunks of {s.chunk_rows} rows)")
        return 0
    if args.cmd == "info":
        with ChunkStore(args.store) as s:
            print(f"{args.store}: {s.shape[0]}x{s.shape[1]} {s.dtype} "
                  f"({s.nchunks} chunks of {s.chunk_rows} rows)")
        return 0
    # verify: a full read with CRC on; corruption raises
    with ChunkStore(args.store) as s:
        for _ in s.iter_chunks(verify=True):
            pass
        print(f"{args.store}: OK ({s.nchunks} chunks verified)")
    return 0


if __name__ == "__main__":
    raise SystemExit(_main())
