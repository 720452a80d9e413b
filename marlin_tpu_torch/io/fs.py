"""Remote-filesystem hook for the matrix IO paths.

Counterpart of ``marlin_tpu/io/fs.py``, copied (the module is stdlib-only)
over the port's own retry policy and fault registry.

The reference's loaders accept any Hadoop ``FileSystem`` URI — ``hdfs://``,
``tachyon://``, ``file://`` — because Spark resolves the scheme for them
(utils/MTUtils.scala:350-392 reads whole directories off HDFS). The rebuild's
analog: a path with a URL scheme routes through ``fsspec`` (or any filesystem
object registered for that scheme via :func:`register_filesystem`), while
bare paths stay on the local-OS fast path — including the native C++ parser,
which needs a real file descriptor.

A "filesystem" here is anything with the small fsspec surface the loaders
use: ``open(path, mode)``, ``ls(path)``, ``isdir(path)``, ``isfile(path)``,
``makedirs(path, exist_ok=True)``. Deletion (``rm``) is optional — helpers
that delete degrade to no-ops on filesystems without it.

Remote opens and listings are transient-failure territory (object stores,
network filesystems), so they run through the process
:class:`~marlin_tpu_torch.utils.retry.RetryPolicy`; local paths keep the direct
syscall fast path. Both routes pass the ``fs.open``/``fs.list`` fault points
(:mod:`marlin_tpu_torch.utils.faults`) so chaos tests can exercise exactly these
seams.
"""

from __future__ import annotations

import os
import re
import shutil
from typing import Iterator

from ..utils import faults as _faults
from ..utils.retry import get_retry_policy

__all__ = ["register_filesystem", "get_filesystem", "split_scheme",
           "local_path", "open_path", "iter_lines", "make_parent_dirs",
           "join_path", "ensure_dir", "list_names", "remove_path"]

_SCHEME = re.compile(r"^([a-zA-Z][a-zA-Z0-9+.-]*)://")
_REGISTRY: dict[str, object] = {}


def register_filesystem(scheme: str, fs) -> None:
    """Route ``scheme://...`` paths through ``fs`` (fsspec-like). Overrides
    the default fsspec resolution for that scheme; pass ``None`` to drop the
    override."""
    if fs is None:
        _REGISTRY.pop(scheme, None)
    else:
        _REGISTRY[scheme] = fs


def split_scheme(path: str) -> str | None:
    """The URL scheme of ``path``, or None for a plain local path."""
    m = _SCHEME.match(path)
    return m.group(1) if m else None


def get_filesystem(path: str):
    """(fs, is_remote) for ``path``. Local paths return (None, False) so
    callers can keep using plain ``open``/``os`` (and the native parser)."""
    scheme = split_scheme(path)
    if scheme is None or scheme == "file":
        return None, False
    if scheme in _REGISTRY:
        return _REGISTRY[scheme], True
    try:
        import fsspec
    except ImportError as e:
        raise ValueError(
            f"path {path!r} has scheme {scheme!r} but fsspec is not "
            "available and no filesystem is registered for it — call "
            "marlin_tpu_torch.io.fs.register_filesystem"
        ) from e
    return fsspec.filesystem(scheme), True


def _strip_file_scheme(path: str) -> str:
    """The OS path of a local path that may carry a ``file://`` scheme.

    A ``file://`` URI whose remainder doesn't start with ``/`` has an
    authority component (``file://host/path``); silently treating that as the
    cwd-relative path ``host/path`` would read/write the wrong location, so it
    is rejected instead."""
    if not path.startswith("file://"):
        return path
    rest = path[len("file://"):]
    if not rest.startswith("/"):
        raise ValueError(
            f"file:// URI {path!r} has an authority component "
            f"({rest.split('/', 1)[0]!r}) — only local files are supported; "
            "use file:///absolute/path (empty authority) or a plain OS path"
        )
    return rest


def local_path(path: str) -> str | None:
    """The OS path when ``path`` is local (bare or ``file://``), else None —
    the one is-this-local test every IO call site should use."""
    return None if get_filesystem(path)[1] else _strip_file_scheme(path)


def open_path(path: str, mode: str = "r"):
    """Open a local or remote path for reading/writing. Remote opens retry
    through the process :class:`~marlin_tpu_torch.utils.retry.RetryPolicy`
    (transient object-store errors must not kill a checkpoint); write handles
    pass through the ``fs.open`` fault point so torn-write chaos tests can
    truncate them."""
    fs, remote = get_filesystem(path)
    if not remote:
        _faults.fire("fs.open", path=path, mode=mode)
        f = open(_strip_file_scheme(path), mode)
    else:
        def _attempt():
            _faults.fire("fs.open", path=path, mode=mode)
            return fs.open(path, mode)

        f = get_retry_policy().call(_attempt, describe=f"open {path}")
    if "w" in mode or "a" in mode or "+" in mode:
        f = _faults.wrap_file("fs.open", f, path=path, mode=mode)
    return f


def iter_lines(path: str) -> Iterator[str]:
    """Yield text lines from a file, or from every regular non-underscore
    file of a directory (the reference's ``wholeTextFiles`` behavior,
    MTUtils.scala:350-368) — local or remote."""
    fs, remote = get_filesystem(path)
    if not remote:
        local = _strip_file_scheme(path)
        if os.path.isdir(local):
            for name in sorted(os.listdir(local)):
                full = os.path.join(local, name)
                if os.path.isfile(full) and not name.startswith("_"):
                    with open(full) as f:
                        yield from f
        else:
            with open(local) as f:
                yield from f
        return
    if fs.isdir(path):
        listing = fs.ls(path, detail=False)
        for full in sorted(str(p) for p in listing):
            name = full.rsplit("/", 1)[-1]
            if fs.isfile(full) and not name.startswith("_"):
                with fs.open(full, "r") as f:
                    yield from f
    else:
        with fs.open(path, "r") as f:
            yield from f


def join_path(base: str, name: str) -> str:
    """Join a child name onto a local or remote base path."""
    if split_scheme(base):
        return base.rstrip("/") + "/" + name
    return os.path.join(base, name)


def ensure_dir(path: str) -> None:
    """mkdir -p ``path`` itself (local or remote)."""
    fs, remote = get_filesystem(path)
    if not remote:
        os.makedirs(_strip_file_scheme(path), exist_ok=True)
    else:
        fs.makedirs(path, exist_ok=True)


def list_names(path: str) -> list[str]:
    """Sorted base names of a directory's entries (local or remote). Remote
    listings retry through the process RetryPolicy."""
    fs, remote = get_filesystem(path)
    if not remote:
        _faults.fire("fs.list", path=path)
        return sorted(os.listdir(_strip_file_scheme(path)))

    def _attempt():
        _faults.fire("fs.list", path=path)
        return fs.ls(path, detail=False)

    listing = get_retry_policy().call(_attempt, describe=f"list {path}")
    return sorted(str(p).rstrip("/").rsplit("/", 1)[-1] for p in listing)


def remove_path(path: str, recursive: bool = False) -> bool:
    """Best-effort delete of a file or (with ``recursive``) a tree; returns
    whether anything was removed. Remote filesystems without ``rm`` support —
    the registered-filesystem contract makes deletion optional — return
    False instead of raising, so retention/cleanup degrades to keeping extra
    data rather than failing a save."""
    fs, remote = get_filesystem(path)
    if not remote:
        p = _strip_file_scheme(path)
        try:
            if os.path.isdir(p):
                if recursive:
                    shutil.rmtree(p)
                else:
                    os.rmdir(p)
            else:
                os.remove(p)
        except OSError:  # missing, non-empty, permission-denied: all "kept"
            return False
        return True
    try:
        fs.rm(path, recursive=recursive)
        return True
    except (OSError, AttributeError, NotImplementedError):
        return False


def make_parent_dirs(path: str) -> str:
    """mkdir -p the parent of ``path`` (local or remote); returns the parent."""
    fs, remote = get_filesystem(path)
    if not remote:
        parent = os.path.dirname(_strip_file_scheme(path)) or "."
        os.makedirs(parent, exist_ok=True)
        return parent
    parent = path.rsplit("/", 1)[0]
    fs.makedirs(parent, exist_ok=True)
    return parent
