"""Text-format matrix IO, wire-compatible with the reference.

Counterpart of ``marlin_tpu/io/text.py``: the same parsers and writers (the
files either package writes are byte-equal), building the port's matrices in
the configured default dtype on the configured device. Single local files go
through the port's native parser (:mod:`marlin_tpu_torch.native`).

Formats (all parsed with the reference's separator rule ``",\\s?|\\s+"``):

- row format ``rowIdx:v,v,...`` — written by DenseVecMatrix.saveToFileSystem
  (DenseVecMatrix.scala:1042-1046), read by MTUtils.loadMatrixFile
  (MTUtils.scala:286-300) and produced by tools/generateMatrix.cpp (our
  ``tools/genmat.cpp`` emits the same).
- block format ``blkRow-blkCol-rows-cols:colMajorData`` — BlockMatrix.save
  (BlockMatrix.scala:538-559), MTUtils.loadBlockMatrixFile (:324-340).
- COO ``i j v`` / ``i,j,v`` (optional trailing timestamp, MovieLens-style) —
  MTUtils.loadCoordinateMatrix (:228-243).
- SVM-ish ``rowIdx idx:val idx:val ...`` with 1-based feature indices —
  MTUtils.loadSVMDenVecMatrix (:253-276).
- ``_description`` sidecar with matrix name/size —
  DenseVecMatrix.saveWithDescription (:1055-1064).

Directory variants mirror the reference's ``wholeTextFiles`` loaders
(MTUtils.scala:350-392): every regular file in the directory is concatenated.

Paths may carry a URL scheme (``memory://``, ``s3://``, ``hdfs://`` — the
reference's loaders take Hadoop FileSystem URIs); they route through the
:mod:`marlin_tpu_torch.io.fs` hook (fsspec by default).

On a mesh over ``torch.distributed`` ranks the dense loaders keep only this
rank's block: each format is read twice, once for the shape (the row
indices and widths, or the block headers) and once parsing only the rows or
blocks that overlap this rank's block. :func:`save_matrix` gathers to the
first rank, which alone writes (the JAX package's save also collects the
whole matrix), then every rank meets at a barrier.
"""

from __future__ import annotations

import os
import re

import numpy as np

import torch

from .fs import iter_lines as _iter_lines
from .fs import local_path, make_parent_dirs, open_path

_SEP = re.compile(r",\s?|\s+")


def _dtype():
    """The element dtype loaded matrices take: the configured default
    (float32, as the JAX package's float64 parse lands in float32)."""
    from ..config import get_config

    return get_config().default_dtype


def _check_dims(shape, rows, cols):
    if rows is not None and cols is not None:
        return (rows, cols)
    return shape


def _rows_from_lines(lines):
    entries = {}
    ncols = 0
    for line in lines:
        line = line.strip()
        if not line:
            continue
        idx_part, vals_part = line.split(":", 1)
        vals = np.array([float(x) for x in _SEP.split(vals_part.strip()) if x])
        entries[int(idx_part)] = vals
        ncols = max(ncols, len(vals))
    nrows = max(entries) + 1 if entries else 0
    out = np.zeros((nrows, ncols))
    for i, v in entries.items():
        out[i, : len(v)] = v
    return out


def _ranked(mesh) -> bool:
    return getattr(mesh, "ranks", None) is not None


def _values(text: str) -> list[str]:
    return [x for x in _SEP.split(text.strip()) if x]


def _rank_rows(path, mesh, parse_row, width=None):
    """This rank's block of a row-per-line file over ``mesh``'s ``rows``
    axis: a first pass reads each line's row index (and its value count,
    for the width, unless ``width`` is given), a second parses the lines of
    this rank's rows only (``parse_row(line, width)`` → (index, values)).
    Returns the DenseVecMatrix."""
    from ..interop import to_tensor
    from ..matrix.dense import DenseVecMatrix
    from ..mesh import Sharding

    nrows, ncols = 0, width or 0
    for line in _iter_lines(path):
        line = line.strip()
        if not line:
            continue
        head, _, rest = line.partition(":") if width is None \
            else line.partition(" ")
        nrows = max(nrows, int(head) + 1)
        if width is None:
            ncols = max(ncols, len(_values(rest)))
    spec = DenseVecMatrix._default_spec
    sh = Sharding(mesh, spec)
    (r0, r1), (c0, c1) = sh.bounds(sh.padded_shape((nrows, ncols)))
    block = np.zeros((r1 - r0, c1 - c0))
    for line in _iter_lines(path):
        line = line.strip()
        if not line:
            continue
        idx, vals = parse_row(line, ncols)
        if r0 <= idx < r1:
            block[idx - r0] = 0.0
            block[idx - r0, :len(vals)] = vals
    DenseVecMatrix._check_2d((nrows, ncols))
    return DenseVecMatrix(to_tensor(block, _dtype(), mesh.device),
                          (nrows, ncols), mesh, spec)


def _row_line(line, ncols):
    head, vals = line.split(":", 1)
    return int(head), np.array([float(x) for x in _values(vals)])


def load_matrix_file(path: str, mesh=None):
    """``rowIdx:v,v,...`` → DenseVecMatrix (MTUtils.loadMatrixFile). Single
    files go through the native C++ parser when built (marlin_tpu_torch.native);
    directories and fallback use the Python parser. Over ranks each rank
    parses only its rows."""
    from ..matrix.dense import DenseVecMatrix
    from ..mesh import default_mesh

    mesh = mesh or default_mesh()
    if _ranked(mesh):
        return _rank_rows(path, mesh, _row_line)
    local = local_path(path)
    if local is not None and os.path.isfile(local):
        # the native parser needs a real file descriptor — local only
        # (file:// URIs qualify, scheme stripped)
        from .. import native

        arr = native.load_matrix_text(local)
        if arr is not None:
            return DenseVecMatrix.from_array(arr, mesh, dtype=_dtype())
    return DenseVecMatrix.from_array(_rows_from_lines(_iter_lines(path)), mesh,
                                     dtype=_dtype())


def load_matrix_files(path: str, mesh=None):
    """Directory variant (MTUtils.loadMatrixFiles, MTUtils.scala:350-368)."""
    return load_matrix_file(path, mesh)


def iter_matrix_file_chunks(path: str, chunk_rows: int = 4096):
    """Row-format text streamed as dense ``(≤chunk_rows, n)`` float chunks,
    never materializing the whole matrix — the out-of-core feed for files
    bigger than host RAM. Each line's row index must equal its position
    (contiguous 0..m-1, the order the reference's writers emit): streaming
    cannot recover a shuffled or gapped file the way the buffering
    :func:`load_matrix_file` can (it zero-fills gaps and reorders), so those
    are rejected loudly rather than silently yielding a different matrix.
    Streamed consumers pull this through the async prefetch pipeline, so
    parsing happens on producer threads, overlapped with device compute."""
    buf: list[np.ndarray] = []
    ncols = None
    row = 0  # parsed-row counter (blank lines skipped)
    for lineno, line in enumerate(_iter_lines(path), start=1):
        line = line.strip()
        if not line:
            continue
        idx_part, sep, vals_part = line.partition(":")
        if not sep:
            raise ValueError(
                f"{path}: line {lineno} is not row format (no ':'): "
                f"{line[:60]!r}")
        try:
            idx = int(idx_part)
        except ValueError:
            raise ValueError(
                f"{path}: line {lineno} has a non-integer row index "
                f"{idx_part[:60]!r}") from None
        if idx != row:
            raise ValueError(
                f"{path}: line {lineno} carries row index {idx}, expected "
                f"{row} — chunked streaming needs contiguous in-order rows; "
                "use load_matrix_file for gapped/shuffled files")
        vals = np.array([float(x) for x in _SEP.split(vals_part.strip()) if x])
        if ncols is None:
            ncols = len(vals)
        elif len(vals) != ncols:
            raise ValueError(
                f"{path}: line {lineno} (row {row}) has {len(vals)} values "
                f"(expected {ncols}) — chunked streaming needs rectangular "
                "rows")
        buf.append(vals)
        row += 1
        if len(buf) >= chunk_rows:
            yield np.stack(buf)
            buf = []
    if buf:
        yield np.stack(buf)


def load_matrix_file_out_of_core(path: str, chunk_rows: int = 4096,
                                 chunkstore: bool | None = None):
    """:class:`~marlin_tpu_torch.matrix.out_of_core.OutOfCoreMatrix` over a
    row-format text file: one cheap line-counting pass for the shape, then
    each streamed op makes its own chunked parsing pass (re-iterable
    callable source).

    ``chunkstore`` — the native data plane (io/chunkstore.py). None (the
    default) auto-selects: when a fresh ``<path>.mchunk`` sidecar exists and
    the native library is built, streamed ops read mmap'd CRC'd binary
    chunks instead of re-parsing text every pass (build the sidecar with
    ``python -m marlin_tpu_torch.io.chunkstore build``). True requires the
    sidecar (built on the spot when missing); False forces the text path."""
    from ..matrix.out_of_core import OutOfCoreMatrix

    if chunkstore is not False:
        from .chunkstore import open_sidecar, transcode_text

        local = local_path(path)
        store = open_sidecar(local) if local is not None else None
        if store is None and chunkstore is True:
            if local is None:
                raise ValueError(
                    f"chunkstore path needs a local file, got {path!r}")
            # just built -> fresh by construction; open directly rather than
            # through open_sidecar's mtime heuristic (which is for trusting
            # a PRE-existing sidecar, and would re-reject under clock skew)
            from .chunkstore import ChunkStore

            store = ChunkStore(transcode_text(local, chunk_rows=chunk_rows))
        if store is not None:
            return OutOfCoreMatrix(store, chunk_rows=chunk_rows)

    nrows, ncols = 0, 0
    for lineno, line in enumerate(_iter_lines(path), start=1):
        line = line.strip()
        if not line:
            continue
        if ncols == 0:
            _idx, sep, vals_part = line.partition(":")
            if not sep:
                raise ValueError(f"{path}: line {lineno} is not row format "
                                 f"(no ':'): {line[:60]!r}")
            ncols = len([x for x in _SEP.split(vals_part.strip()) if x])
        nrows += 1
    return OutOfCoreMatrix(lambda: iter_matrix_file_chunks(path, chunk_rows),
                           shape=(nrows, ncols), chunk_rows=chunk_rows)


def _blocks_from_lines(lines):
    blocks = {}
    for line in lines:
        line = line.strip()
        if not line:
            continue
        head, vals_part = line.split(":", 1)
        info = head.split("-")
        br, bc, r, c = (int(x) for x in info[:4])
        vals = np.array([float(x) for x in _SEP.split(vals_part.strip()) if x])
        # column-major, like Breeze BDM.create (MTUtils.scala:336-338)
        blocks[(br, bc)] = vals.reshape((c, r)).T
    if not blocks:
        return np.zeros((0, 0))
    nbr = max(k[0] for k in blocks) + 1
    nbc = max(k[1] for k in blocks) + 1
    # derive extents from ANY present block in each grid row/column (a writer
    # may omit interior all-zero blocks), and fail descriptively when a whole
    # grid row or column is absent rather than KeyError-ing on (i, 0)/(0, j).
    # Caveat: a TRAILING all-zero grid row/column is indistinguishable from a
    # smaller matrix (the format carries no global shape), so writers must
    # emit at least one block in the last grid row and column.
    row_heights = [None] * nbr
    col_widths = [None] * nbc
    for (i, j), b in blocks.items():
        row_heights[i] = b.shape[0]
        col_widths[j] = b.shape[1]
    missing_r = [i for i, h in enumerate(row_heights) if h is None]
    missing_c = [j for j, w in enumerate(col_widths) if w is None]
    if missing_r or missing_c:
        raise ValueError(
            "block text file has no blocks at all in grid "
            f"row(s) {missing_r} / column(s) {missing_c} — extents are "
            "unrecoverable; the file is truncated or not block-text format"
        )
    out = np.zeros((sum(row_heights), sum(col_widths)))
    row_offs = np.concatenate([[0], np.cumsum(row_heights)])
    col_offs = np.concatenate([[0], np.cumsum(col_widths)])
    for (i, j), b in blocks.items():
        if b.shape != (row_heights[i], col_widths[j]):
            raise ValueError(
                f"block ({i},{j}) has shape {b.shape}, inconsistent with grid "
                f"extents ({row_heights[i]}, {col_widths[j]})"
            )
        out[row_offs[i] : row_offs[i] + b.shape[0],
            col_offs[j] : col_offs[j] + b.shape[1]] = b
    return out


def _rank_blocks(path, mesh):
    """This rank's block of a block-text file over ``mesh``: a first pass
    reads the block headers for the grid's extents, a second parses only
    the blocks that overlap this rank's block. Returns the BlockMatrix."""
    from ..interop import to_tensor
    from ..matrix.dense import BlockMatrix
    from ..mesh import Sharding

    heights, widths = {}, {}
    for line in _iter_lines(path):
        line = line.strip()
        if line:
            br, bc, r, c = (int(x) for x in line.split(":", 1)[0]
                            .split("-")[:4])
            heights[br], widths[bc] = r, c
    if not heights:
        return BlockMatrix.from_array(np.zeros((0, 0)), mesh)
    missing_r = [i for i in range(max(heights) + 1) if i not in heights]
    missing_c = [j for j in range(max(widths) + 1) if j not in widths]
    if missing_r or missing_c:
        raise ValueError(
            "block text file has no blocks at all in grid "
            f"row(s) {missing_r} / column(s) {missing_c} — extents are "
            "unrecoverable; the file is truncated or not block-text format")
    row_offs = np.concatenate([[0], np.cumsum(
        [heights[i] for i in range(len(heights))])])
    col_offs = np.concatenate([[0], np.cumsum(
        [widths[j] for j in range(len(widths))])])
    shape = (int(row_offs[-1]), int(col_offs[-1]))
    spec = BlockMatrix._default_spec
    sh = Sharding(mesh, spec)
    (r0, r1), (c0, c1) = sh.bounds(sh.padded_shape(shape))
    block = np.zeros((r1 - r0, c1 - c0))
    for line in _iter_lines(path):
        line = line.strip()
        if not line:
            continue
        head, vals = line.split(":", 1)
        br, bc, r, c = (int(x) for x in head.split("-")[:4])
        top, left = int(row_offs[br]), int(col_offs[bc])
        if top >= r1 or top + r <= r0 or left >= c1 or left + c <= c0:
            continue
        blk = np.array([float(x) for x in _values(vals)]).reshape((c, r)).T
        y0, y1 = max(top, r0), min(top + r, r1)
        x0, x1 = max(left, c0), min(left + c, c1)
        block[y0 - r0:y1 - r0, x0 - c0:x1 - c0] = \
            blk[y0 - top:y1 - top, x0 - left:x1 - left]
    BlockMatrix._check_2d(shape)
    return BlockMatrix(to_tensor(block, _dtype(), mesh.device), shape, mesh,
                       spec)


def load_block_matrix_file(path: str, mesh=None):
    """Block text format → BlockMatrix (MTUtils.loadBlockMatrixFile). Over
    ranks each rank parses only the blocks that overlap its own."""
    from ..matrix.dense import BlockMatrix
    from ..mesh import default_mesh

    mesh = mesh or default_mesh()
    if _ranked(mesh):
        return _rank_blocks(path, mesh)
    return BlockMatrix.from_array(_blocks_from_lines(_iter_lines(path)), mesh,
                                  dtype=_dtype())


def load_block_matrix_files(path: str, mesh=None):
    return load_block_matrix_file(path, mesh)


def load_coordinate_matrix(path: str, shape=None, mesh=None):
    """COO text → CoordinateMatrix (MTUtils.loadCoordinateMatrix). Accepts
    3-field ``i j v`` / ``i,j,v`` lines and 4-field MovieLens lines whose
    trailing timestamp is dropped."""
    from ..matrix.sparse import CoordinateMatrix

    ri, ci, vals = [], [], []
    for line in _iter_lines(path):
        line = line.strip()
        if not line:
            continue
        parts = [x for x in _SEP.split(line) if x]
        if len(parts) not in (3, 4):
            raise ValueError(f"bad COO line: {line!r}")
        ri.append(int(parts[0]))
        ci.append(int(parts[1]))
        vals.append(float(parts[2]))
    return CoordinateMatrix(np.array(ri, np.int64), np.array(ci, np.int64),
                            np.array(vals, np.float32), shape=shape, mesh=mesh)


def load_svm_den_vec_matrix(path: str, vector_len: int, mesh=None):
    """SVM-like rows with 1-based sparse features → dense DenseVecMatrix
    (MTUtils.loadSVMDenVecMatrix; the head item is the row index, not a
    label). Over ranks each rank parses only its rows."""
    from ..matrix.dense import DenseVecMatrix
    from ..mesh import default_mesh

    mesh = mesh or default_mesh()
    if _ranked(mesh):
        def parse(line, ncols):
            items = line.split(" ")
            arr = np.zeros(ncols)
            for item in items[1:]:
                i, v = item.split(":")
                arr[int(i) - 1] = float(v)
            return int(items[0]), arr

        return _rank_rows(path, mesh, parse, width=vector_len)
    rows = {}
    for line in _iter_lines(path):
        line = line.strip()
        if not line:
            continue
        items = line.split(" ")
        idx = int(items[0])
        arr = np.zeros(vector_len)
        for item in items[1:]:
            i, v = item.split(":")
            arr[int(i) - 1] = float(v)
        rows[idx] = arr
    nrows = max(rows) + 1 if rows else 0
    out = np.zeros((nrows, vector_len))
    for i, v in rows.items():
        out[i] = v
    return DenseVecMatrix.from_array(out, mesh, dtype=_dtype())


def save_matrix(mat, path: str, fmt: str = "text", description: bool = False):
    """Save in row-text or block-text format (DenseVecMatrix.saveToFileSystem /
    BlockMatrix.save). ``description=True`` writes the ``_description`` sidecar
    (DenseVecMatrix.saveWithDescription). Over ranks the matrix gathers to
    the mesh's first rank, which alone writes; every rank returns after a
    barrier."""
    if _ranked(getattr(mat, "mesh", None)):
        import torch.distributed as dist

        from ..parallel import collectives

        first = mat.mesh.ranks[0]
        whole = collectives.gather_logical(mat.data, mat.sharding, mat.shape,
                                           mat._padded_shape, dst=first)
        if dist.get_rank() == first:
            t = whole.detach().cpu()
            _write_matrix(mat, t.float().numpy() if t.dtype ==
                          torch.bfloat16 else t.numpy(), path, fmt,
                          description)
        dist.barrier()
        return
    _write_matrix(mat, mat.to_numpy(), path, fmt, description)


def _write_matrix(mat, arr, path, fmt, description):
    lp = local_path(path)  # file:// counts as local
    remote = lp is None
    parent = make_parent_dirs(path)
    if fmt == "text":
        from .. import native

        if remote or not native.save_matrix_text(lp, arr):
            with open_path(path, "w") as f:
                for i in range(arr.shape[0]):
                    f.write(f"{i}:" + ",".join(repr(float(x)) for x in arr[i]) + "\n")
    elif fmt == "block":
        # one block per mesh tile, column-major payload
        from ..matrix.dense import BlockMatrix

        nbr = mat.mesh.shape.get("rows", 1) if isinstance(mat, BlockMatrix) else 1
        nbc = mat.mesh.shape.get("cols", 1) if isinstance(mat, BlockMatrix) else 1
        m, n = arr.shape
        rsz, csz = -(-m // nbr), -(-n // nbc)
        with open_path(path, "w") as f:
            for bi in range(nbr):
                for bj in range(nbc):
                    blk = arr[bi * rsz : min((bi + 1) * rsz, m),
                              bj * csz : min((bj + 1) * csz, n)]
                    if blk.size == 0:
                        continue
                    payload = ",".join(repr(float(x)) for x in blk.T.ravel())
                    f.write(f"{bi}-{bj}-{blk.shape[0]}-{blk.shape[1]}:{payload}\n")
    else:
        raise ValueError(f"unknown save format: {fmt}")
    if description:
        sep = "/" if remote else os.sep
        with open_path(f"{parent}{sep}_description", "w") as f:
            f.write(f"name: {path.rsplit('/', 1)[-1] if remote else os.path.basename(path)}\n")
            f.write(f"rows: {arr.shape[0]}\ncols: {arr.shape[1]}\n")
