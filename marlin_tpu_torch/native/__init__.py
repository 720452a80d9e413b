"""ctypes bindings for the native IO libraries, built at first use.

Counterpart of ``marlin_tpu/native/__init__.py``, with the port's own copy of
the C++ sources beside this file. Two libraries:

- ``libmarlin_textio.so`` — row-text parser/writer (``textio.cpp``);
- ``libmarlin_chunkstore.so`` — the MarlinChunk binary container
  (``chunkstore.cpp``), the mmap'd data plane behind
  :mod:`marlin_tpu_torch.io.chunkstore`.

At first use each source is compiled by ``$CXX`` (else ``g++``, else ``c++``)
with the JAX package's Makefile flags (``-O3 -std=c++17 -fPIC -shared``, plus
``-pthread`` for the chunk store) into
``build/marlin_tpu_torch/native/<hash>/`` at the repository root, keyed by a
hash of the sources, the header and the flags, under a file lock so several
processes building at once take turns. Nothing is built at import.

When a library cannot be built, the text loaders fall back to the Python
parser, as the JAX package does — never silently: a one-time
``RuntimeWarning`` carries the compiler's output and :func:`build_error`
exposes it, so a caller can assert which path ran.
"""

from __future__ import annotations

import ctypes
import errno
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import warnings
from pathlib import Path

import numpy as np

__all__ = ["available", "chunkstore_available", "build_error", "build_dir",
           "load_matrix_text", "save_matrix_text", "save_coo_text"]

SRC = Path(__file__).resolve().parent
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / \
    "marlin_tpu_torch" / "native"
CXX_FLAGS = ("-O3", "-std=c++17", "-Wall", "-fPIC", "-shared")
# library -> (source, extra flags)
LIBS = {"libmarlin_textio.so": ("textio.cpp", ()),
        "libmarlin_chunkstore.so": ("chunkstore.cpp", ("-pthread",))}

_lock = threading.Lock()
_lib = None
_chunk_lib = None
_tried_build = False
_build_error: str | None = None
_warned = False


def _compiler() -> str | None:
    for cand in (os.environ.get("CXX"), "g++", "c++"):
        if cand and shutil.which(cand):
            return shutil.which(cand)
    return None


def build_dir() -> Path:
    """Where the libraries of the current sources and flags live."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(repr(sorted(LIBS.items())).encode())
    for name in sorted(p.name for p in SRC.glob("*.cpp")) + ["parse_common.h"]:
        h.update(name.encode())
        h.update((SRC / name).read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def _build() -> None:
    """Compile both libraries once per process (a no-op when the build
    directory already holds them); failure text lands in ``_build_error``."""
    global _tried_build, _build_error
    if _tried_build:
        return
    _tried_build = True
    out = build_dir()
    try:
        out.mkdir(parents=True, exist_ok=True)
        with open(out / "lock", "w") as lock_f:
            fcntl.flock(lock_f, fcntl.LOCK_EX)
            missing = [n for n in LIBS if not (out / n).exists()]
            if not missing:
                return
            cxx = _compiler()
            if cxx is None:
                _build_error = "no C++ compiler ($CXX, g++ or c++) on PATH"
                return
            procs = []
            for name in missing:
                src, extra = LIBS[name]
                tmp = out / (name + ".tmp")
                procs.append((name, tmp, subprocess.Popen(
                    [cxx, *CXX_FLAGS, *extra, "-o", str(tmp), str(SRC / src)],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True)))
            errors = []
            for name, tmp, p in procs:
                text, _ = p.communicate(timeout=300)
                if p.returncode != 0:
                    errors.append(f"{name}: {cxx} exited {p.returncode}: "
                                  f"{text.strip() or '(no output)'}")
                else:
                    os.replace(tmp, out / name)
            if errors:
                _build_error = "; ".join(errors)
    except Exception as e:  # compiler missing, timeout, unwritable tree
        _build_error = f"{type(e).__name__}: {e}"


def build_error() -> str | None:
    """Why the last native build failed, or None (built, or not tried yet)."""
    return _build_error


def _warn_once(missing: str) -> None:
    global _warned
    if _warned or _build_error is None:
        return
    _warned = True
    warnings.warn(
        f"marlin_tpu_torch native build failed ({missing} unavailable; "
        f"falling back to the pure-Python data plane, expect ~100x slower "
        f"IO): {_build_error}", RuntimeWarning, stacklevel=3)


def _open(name: str):
    _build()
    path = build_dir() / name
    if not path.exists():
        _warn_once(name)
        return None
    return ctypes.CDLL(str(path))


def _load():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = _open("libmarlin_textio.so")
        if lib is None:
            return None
        f64 = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
        i64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        f32 = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        ll, p64 = ctypes.c_int64, ctypes.POINTER(ctypes.c_int64)
        lib.mt_count_matrix.argtypes = [ctypes.c_char_p, p64, p64]
        lib.mt_load_matrix.argtypes = [ctypes.c_char_p, f64, ll, ll]
        lib.mt_save_matrix.argtypes = [ctypes.c_char_p, f64, ll, ll]
        lib.mt_save_coo.argtypes = [ctypes.c_char_p, i64, i64, f64, ll]
        lib.mt_save_coo_f32.argtypes = [ctypes.c_char_p, i64, i64, f32, ll]
        for fn in (lib.mt_count_matrix, lib.mt_load_matrix, lib.mt_save_matrix,
                   lib.mt_save_coo, lib.mt_save_coo_f32):
            fn.restype = ctypes.c_int
        _lib = lib
        return _lib


def _load_chunkstore():
    """Bind libmarlin_chunkstore.so; None (with the one-time warning) if the
    build failed. ctypes releases the GIL for every call, so ``mcs_read``'s
    parse/verify/convert runs in parallel with Python."""
    global _chunk_lib
    with _lock:
        if _chunk_lib is not None:
            return _chunk_lib
        lib = _open("libmarlin_chunkstore.so")
        if lib is None:
            return None
        p, i32, i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
        pi32, pi64 = ctypes.POINTER(i32), ctypes.POINTER(i64)
        sigs = {
            "mcs_crc32c": ([p, i64], ctypes.c_uint32),
            "mcs_writer_open": ([ctypes.c_char_p, i32, i64, i64, pi32], p),
            "mcs_writer_append": ([p, p, i64, i32], ctypes.c_int),
            "mcs_writer_close": ([p], ctypes.c_int),
            "mcs_writer_abort": ([p], None),
            "mcs_open": ([ctypes.c_char_p, pi32], p),
            "mcs_info": ([p, pi32, pi64, pi64, pi64, pi64], ctypes.c_int),
            "mcs_read": ([p, i64, i64, p, i32, i32, i32], ctypes.c_int),
            "mcs_close": ([p], None),
            "mcs_from_text": ([ctypes.c_char_p, ctypes.c_char_p, i64, i32,
                               pi64, pi64], ctypes.c_int),
        }
        for fname, (args, res) in sigs.items():
            fn = getattr(lib, fname)
            fn.argtypes, fn.restype = args, res
        _chunk_lib = lib
        return _chunk_lib


def available() -> bool:
    return _load() is not None


def chunkstore_available() -> bool:
    return _load_chunkstore() is not None


def _check(rc: int, path: str, what: str) -> None:
    if -rc == errno.EINVAL:
        raise ValueError(f"unparseable numeric token in {path}")
    if rc != 0:
        raise OSError(-rc, f"native {what} failed for {path}")


def load_matrix_text(path: str) -> np.ndarray | None:
    """Parse a row-text matrix file natively; None if the library is absent."""
    lib = _load()
    if lib is None:
        return None
    rows, cols = ctypes.c_int64(), ctypes.c_int64()
    _check(lib.mt_count_matrix(path.encode(), ctypes.byref(rows),
                               ctypes.byref(cols)), path, "count")
    out = np.zeros((rows.value, cols.value), np.float64)
    _check(lib.mt_load_matrix(path.encode(), out, rows.value, cols.value),
           path, "load")
    return out


def save_matrix_text(path: str, data: np.ndarray) -> bool:
    """Write a row-text matrix file natively; False if the library is absent."""
    lib = _load()
    if lib is None:
        return False
    arr = np.ascontiguousarray(data, np.float64)
    rc = lib.mt_save_matrix(path.encode(), arr, arr.shape[0], arr.shape[1])
    if rc != 0:
        raise OSError(-rc, f"native save failed for {path}")
    return True


def save_coo_text(path: str, rows, cols, vals) -> bool:
    """Write ``i j v`` COO lines natively; False if the library is absent.
    f32 values take the shortest-f32 formatter (exact for them); anything
    else is written as shortest-f64."""
    lib = _load()
    if lib is None:
        return False
    r = np.ascontiguousarray(rows, np.int64)
    c = np.ascontiguousarray(cols, np.int64)
    vals = np.asarray(vals)
    if not (r.shape == c.shape == vals.shape and r.ndim == 1):
        raise ValueError(f"COO arrays must be equal-length 1-D, got "
                         f"{r.shape}/{c.shape}/{vals.shape}")
    if vals.dtype == np.float32:
        rc = lib.mt_save_coo_f32(path.encode(), r, c,
                                 np.ascontiguousarray(vals), r.shape[0])
    else:
        rc = lib.mt_save_coo(path.encode(), r, c,
                             np.ascontiguousarray(vals, np.float64),
                             r.shape[0])
    if rc != 0:
        raise OSError(-rc, f"native COO save failed for {path}")
    return True
