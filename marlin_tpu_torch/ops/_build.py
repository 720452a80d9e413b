"""Build and bind the hand-written CUDA kernels.

The sources in ``marlin_tpu_torch/csrc/`` have a plain C interface. At first
use each ``.cu`` is compiled by its own ``nvcc`` (all started together) for
``sm_90a`` and the objects are linked into one shared library, which is loaded
with ``ctypes``. The library lands in ``build/marlin_tpu_torch/<hash>/`` at the
repository root, keyed by a hash of the sources, the headers they include
(``*.cuh``) and the flags, so an edited file rebuilds and an unchanged tree
loads at once. Nothing is built at import.

``nvcc`` is taken from ``$CUDA_HOME/bin``, ``/usr/local/cuda/bin`` or ``PATH``.
A failed build raises :class:`KernelBuildError` with the compiler's output.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "marlin_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LIB_NAME = "libmarlin_kernels.so"
# Flags for one source on top of NVCC_FLAGS. At ptxas's default -O3 the
# backward kernels' schedule holds so many loads in flight that some
# instances spill past their 255 registers; -O1 keeps all sixteen in 162-238
# registers with no spill, at the same speed on an H100.
SOURCE_FLAGS = {"flash_attention_bwd.cu": ("-Xptxas", "-O1")}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a source."""


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    """A hash of the flags, the sources and the headers they include, so an
    edited header rebuilds too."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update(repr(sorted(SOURCE_FLAGS.items())).encode())
    for src in _sources() + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    found = shutil.which("nvcc")
    if found is None:
        raise KernelBuildError("nvcc not found (looked in $CUDA_HOME/bin, "
                               "/usr/local/cuda/bin and PATH)")
    return found


def build_dir() -> Path:
    return BUILD_ROOT / _digest()


def _compile(out_dir: Path) -> None:
    """One nvcc per source, all running at once, then one link. The compiler's
    ``-Xptxas -v`` report (registers, shared memory, spills per kernel) is kept
    in ``ptxas.log`` beside the library."""
    nvcc = _nvcc()
    procs = []
    for src in _sources():
        obj = out_dir / (src.stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, *SOURCE_FLAGS.get(src.name, ()), "-c", str(src),
               "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs, failed = [], []
    for src, _, p in procs:
        out, _ = p.communicate()
        logs.append(f"== {src.name}\n{out}")
        if p.returncode != 0:
            failed.append(src.name)
    (out_dir / "ptxas.log").write_text("\n".join(logs))
    if failed:
        raise KernelBuildError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
    tmp = out_dir / (LIB_NAME + ".tmp")
    link = subprocess.run(
        [nvcc, "-shared", "-o", str(tmp), *(str(o) for _, o, _ in procs)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise KernelBuildError(f"nvcc link failed:\n{link.stdout}")
    os.replace(tmp, out_dir / LIB_NAME)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    # every pointer and the stream as c_void_p: left to ctypes' default they
    # would be passed as 32-bit ints and cut
    p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.marlin_gemm.argtypes = [i, i, i, i, p, p, p, ll, ll, ll, p]
    lib.marlin_gemm.restype = i
    lib.marlin_masked_fill.argtypes = [p, p, ll, ll, ll, ll, i, p]
    lib.marlin_masked_fill.restype = i
    f = ctypes.c_float
    lib.marlin_paged_attention.argtypes = [i, p, p, p, p, p, p, i, i, i, i, i,
                                           i, f, p]
    lib.marlin_paged_attention.restype = i
    lib.marlin_flash_fwd.argtypes = [i, p, p, p, p, p, p, p, p, p, i, i, i, i,
                                     ll, ll, ll, ll, ll, ll, i, i, i, i, f, p]
    lib.marlin_flash_fwd.restype = i
    # dtype, q, k, v, dout, lse, delta, outputs..., then the shared tail
    bwd_tail = [i, i, i, i, ll, ll, ll, ll, ll, ll, ll, ll, i, i, i, i, f, p]
    lib.marlin_flash_bwd_dkv.argtypes = [i] + [p] * 8 + bwd_tail
    lib.marlin_flash_bwd_dkv.restype = i
    lib.marlin_flash_bwd_dq.argtypes = [i] + [p] * 7 + bwd_tail
    lib.marlin_flash_bwd_dq.restype = i
    # dtype, blocks, bcols, row_ptr, b, out, m, n, p, bs, n_block_rows, stream
    lib.marlin_bsr_spmm.argtypes = [i, p, p, p, p, p, ll, ll, ll, i, ll, p]
    lib.marlin_bsr_spmm.restype = i
    lib.marlin_error_string.argtypes = [i]
    lib.marlin_error_string.restype = ctypes.c_char_p
    return lib


def load_library() -> ctypes.CDLL:
    """The kernel library, built on first use. Concurrent processes serialise
    on a lock file in the build directory; threads on a lock here."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        out_dir = build_dir()
        out_dir.mkdir(parents=True, exist_ok=True)
        with open(out_dir / "lock", "w") as lock_f:
            fcntl.flock(lock_f, fcntl.LOCK_EX)
            if not (out_dir / LIB_NAME).exists():
                _compile(out_dir)
        _lib = _bind(ctypes.CDLL(str(out_dir / LIB_NAME)))
        return _lib


def ptxas_report() -> str:
    """The ``-Xptxas -v`` output of the current build ("" before a build)."""
    log = build_dir() / "ptxas.log"
    return log.read_text() if log.exists() else ""


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise when a launch returned a CUDA error (a refused launch never runs,
    and a later synchronize would not report it)."""
    if err != 0:
        msg = lib.marlin_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
