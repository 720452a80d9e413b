"""The port's IO stack against the JAX package's, on the CPU.

The same seeded numpy inputs, or files written to ``tmp_path``, go through
``marlin_tpu.io`` and ``marlin_tpu_torch.io`` (under
``config_context(device="cpu")``). Every check here is exact:

- each text format's loaders give equal arrays, and the writers (native and
  Python, row text, block text, COO, the ``_description`` sidecar) write
  equal bytes;
- a ``.mchunk`` store written by either package reads equal in the other,
  bfloat16 included, and the port's host bf16 casts give the bits
  ``ml_dtypes`` gives on the JAX side;
- CRC damage and truncation raise alike, at the same windows;
- ``memory://`` paths round-trip alike under the same seeded retry faults.

The port's native libraries are built from ``marlin_tpu_torch/native/`` into
``build/marlin_tpu_torch/native/``, never loaded from ``marlin_tpu/native/``.
"""

import os
import struct

import ml_dtypes
import numpy as np
import pytest
import torch

import marlin_tpu as jm
import marlin_tpu_torch as tm
from marlin_tpu.io import chunkstore as jcs
from marlin_tpu.io import text as jtext
from marlin_tpu.utils import faults as jfaults
from marlin_tpu.utils import retry as jretry
from marlin_tpu_torch import native
from marlin_tpu_torch.io import chunkstore as tcs
from marlin_tpu_torch.io import text as ttext
from marlin_tpu_torch.utils import faults as tfaults
from marlin_tpu_torch.utils import retry as tretry


@pytest.fixture(autouse=True)
def _cpu():
    with tm.config_context(device="cpu"):
        yield


@pytest.fixture(scope="module")
def mesh1():
    return jm.create_mesh((1, 1))


def _bits_j(a) -> np.ndarray:
    """The JAX side's bf16 array as its 16-bit words."""
    return np.asarray(a).view(np.uint16)


def _bits_t(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16).numpy().view(np.uint16)


def _host_t(x) -> np.ndarray:
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ------------------------------------------------------------------ native
def test_native_built_from_port_sources():
    assert native.available() and native.chunkstore_available(), \
        native.build_error()
    root = os.path.dirname(os.path.dirname(os.path.abspath(tm.__file__)))
    built = native.build_dir()
    assert str(built).startswith(os.path.join(root, "build",
                                              "marlin_tpu_torch", "native"))
    for lib in (native._load(), native._load_chunkstore()):
        assert lib._name.startswith(str(built))
        assert "marlin_tpu/native" not in lib._name
    assert native.build_error() is None


# ------------------------------------------------------------- text formats
def _rows(seed, m=13, n=7):
    return np.random.default_rng(seed).standard_normal((m, n))


@pytest.mark.parametrize("fmt", ["text", "block"])
@pytest.mark.parametrize("description", [False, True])
def test_writers_write_equal_bytes(tmp_path, mesh1, fmt, description):
    a = _rows(0).astype(np.float32)
    jdir, tdir = tmp_path / "j", tmp_path / "t"
    jm_ = (jm.BlockMatrix if fmt == "block" else jm.DenseVecMatrix
           ).from_array(a, mesh1)
    tm_ = (tm.BlockMatrix if fmt == "block" else tm.DenseVecMatrix
           ).from_array(a)
    jtext.save_matrix(jm_, str(jdir / "m.txt"), fmt=fmt,
                      description=description)
    ttext.save_matrix(tm_, str(tdir / "m.txt"), fmt=fmt,
                      description=description)
    names = sorted(os.listdir(jdir))
    assert names == sorted(os.listdir(tdir))
    for name in names:
        assert (jdir / name).read_bytes() == (tdir / name).read_bytes(), name


def test_dense_and_coo_methods_write_equal_bytes(tmp_path, mesh1):
    a = _rows(1).astype(np.float32)
    jm.DenseVecMatrix.from_array(a, mesh1).save_with_description(
        str(tmp_path / "j" / "m.txt"))
    tm.DenseVecMatrix.from_array(a).save_with_description(
        str(tmp_path / "t" / "m.txt"))
    jm.DenseVecMatrix.from_array(a, mesh1).save_to_file_system(
        str(tmp_path / "j" / "n.txt"))
    tm.DenseVecMatrix.from_array(a).save_to_file_system(
        str(tmp_path / "t" / "n.txt"))
    for name in ("m.txt", "n.txt", "_description"):
        assert (tmp_path / "j" / name).read_bytes() == \
            (tmp_path / "t" / name).read_bytes()
    rng = np.random.default_rng(2)
    ri, ci = rng.integers(0, 50, 40), rng.integers(0, 30, 40)
    vals = rng.standard_normal(40).astype(np.float32)
    jm.CoordinateMatrix(ri, ci, vals, shape=(50, 30), mesh=mesh1) \
        .save_to_file_system(str(tmp_path / "j" / "c.txt"))
    tm.CoordinateMatrix(ri, ci, vals, shape=(50, 30)).save_to_file_system(
        str(tmp_path / "t" / "c.txt"))
    assert (tmp_path / "j" / "c.txt").read_bytes() == \
        (tmp_path / "t" / "c.txt").read_bytes()


def test_to_dataframe():
    pd = pytest.importorskip("pandas")
    a = _rows(3)
    df = tm.DenseVecMatrix.from_array(a, dtype=torch.float64).to_dataframe()
    assert isinstance(df, pd.DataFrame) and df.shape == a.shape
    assert np.array_equal(df.to_numpy(), a)


def _write_formats(d, seed):
    """One file of each text format, with the quirks the parsers take."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((9, 5))
    with open(d / "rows.txt", "w") as f:  # shuffled, ", " and " " separators
        for i in rng.permutation(9):
            sep = [",", ", ", " "][i % 3]
            f.write(f"{i}:" + sep.join(repr(float(v)) for v in a[i]) + "\n")
        f.write("\n")
    blk = np.zeros((6, 7))
    blk[:4, :3] = rng.standard_normal((4, 3))
    blk[4:, 3:] = rng.standard_normal((2, 4))
    with open(d / "blocks.txt", "w") as f:
        for bi, bj, r0, r1, c0, c1 in ((0, 0, 0, 4, 0, 3), (1, 1, 4, 6, 3, 7),
                                       (0, 1, 0, 4, 3, 7)):
            b = blk[r0:r1, c0:c1]
            f.write(f"{bi}-{bj}-{b.shape[0]}-{b.shape[1]}:"
                    + ",".join(repr(float(v)) for v in b.T.ravel()) + "\n")
    with open(d / "coo.txt", "w") as f:
        for k in range(20):
            i, j, v = rng.integers(0, 8), rng.integers(0, 6), rng.random()
            f.write([f"{i} {j} {v!r}\n", f"{i},{j},{v!r}\n",
                     f"{i}\t{j}\t{v!r}\t{k}\n"][k % 3])
    with open(d / "svm.txt", "w") as f:
        for i in range(5):
            feats = sorted(rng.choice(np.arange(1, 9), 3, replace=False))
            f.write(f"{i} " + " ".join(f"{c}:{rng.random()!r}" for c in feats)
                    + "\n")
    os.makedirs(d / "dir")
    for part in range(3):
        with open(d / "dir" / f"part{part}", "w") as f:
            for i in range(part * 2, part * 2 + 2):
                f.write(f"{i}:" + ",".join(repr(float(v)) for v in a[i])
                        + "\n")
    with open(d / "dir" / "_SUCCESS", "w") as f:
        f.write("ignored\n")


@pytest.mark.parametrize("loader", ["rows", "rows_python", "blocks", "coo",
                                    "svm", "dir"])
def test_loaders_give_equal_arrays(tmp_path, mesh1, loader, monkeypatch):
    _write_formats(tmp_path, 4)

    def load(pkg, mesh):
        io = pkg.io
        kw = {} if mesh is None else {"mesh": mesh}
        if loader in ("rows", "rows_python"):
            return io.load_matrix_file(str(tmp_path / "rows.txt"), **kw)
        if loader == "blocks":
            return io.load_block_matrix_file(str(tmp_path / "blocks.txt"),
                                             **kw)
        if loader == "coo":
            return io.load_coordinate_matrix(str(tmp_path / "coo.txt"),
                                             shape=(8, 6), **kw)
        if loader == "svm":
            return io.load_svm_den_vec_matrix(str(tmp_path / "svm.txt"), 8,
                                              **kw)
        return io.load_matrix_files(str(tmp_path / "dir"), **kw)

    if loader == "rows_python":  # the fallback parser on both sides
        from marlin_tpu import native as jnative

        monkeypatch.setattr(jnative, "load_matrix_text", lambda p: None)
        monkeypatch.setattr(native, "load_matrix_text", lambda p: None)
    got_j = load(jm, mesh1).to_numpy()
    got_t = load(tm, None)
    assert got_t.to_numpy().dtype == got_j.dtype == np.float32
    assert np.array_equal(got_t.to_numpy(), got_j)


def test_streaming_text_chunks_equal(tmp_path):
    a = _rows(5, 37, 6)
    p = str(tmp_path / "m.txt")
    native.save_matrix_text(p, a)
    got_j = list(jtext.iter_matrix_file_chunks(p, 8))
    got_t = list(ttext.iter_matrix_file_chunks(p, 8))
    assert len(got_j) == len(got_t) == 5
    for x, y in zip(got_j, got_t):
        assert np.array_equal(x, y)
    with open(p, "a") as f:
        f.write("40:1.0,2.0,3.0,4.0,5.0,6.0\n")  # a gap
    for mod in (jtext, ttext):
        with pytest.raises(ValueError, match="contiguous"):
            list(mod.iter_matrix_file_chunks(p, 8))


class _DirFS:
    """A registered 'remote' filesystem backed by a local directory."""

    def __init__(self, root):
        self.root = root

    def _real(self, p):
        return str(self.root / p.split("://", 1)[-1].lstrip("/"))

    def open(self, p, mode="r", **kw):
        return open(self._real(p), mode)

    def isdir(self, p):
        return os.path.isdir(self._real(p))

    def isfile(self, p):
        return os.path.isfile(self._real(p))

    def ls(self, p, **kw):
        return [p.rstrip("/") + "/" + n for n in os.listdir(self._real(p))]

    def makedirs(self, p, exist_ok=False):
        os.makedirs(self._real(p), exist_ok=exist_ok)


@pytest.mark.parametrize("scheme", ["memory", "registered"])
def test_remote_roundtrip_under_seeded_faults(tmp_path, mesh1, scheme):
    """``memory://`` (fsspec) and a registered scheme: each open fails by the
    same seeded schedule in both packages, retried by a policy that never
    sleeps; the files, the loaded arrays and the retry counts agree."""
    import fsspec

    mem = fsspec.filesystem("memory")
    a = _rows(6).astype(np.float32)
    out = {}
    for name, pkg, faults, retry in (("j", jm, jfaults, jretry),
                                     ("t", tm, tfaults, tretry)):
        if scheme == "memory":
            base = f"memory://marlin_io_{name}"
            read = lambda rel: mem.cat(f"/marlin_io_{name}/{rel}")  # noqa: E731
        else:
            base = f"tfs{name}://box"
            pkg.io.register_filesystem(f"tfs{name}", _DirFS(tmp_path / name))
            read = lambda rel: (tmp_path / name / "box" / rel).read_bytes()  # noqa: E731
        policy = retry.RetryPolicy(max_attempts=8, sleep=lambda s: None,
                                   seed=0)
        old = retry.set_retry_policy(policy)
        fault = faults.RaiseFault(OSError("flaky store"), times=-1,
                                  schedule=faults.Schedule(seed=7, rate=0.4))
        try:
            with faults.injected("fs.open", fault):
                m = (jm.DenseVecMatrix.from_array(a, mesh1) if name == "j"
                     else tm.DenseVecMatrix.from_array(a))
                pkg.io.save_matrix(m, f"{base}/d/a.txt", description=True)
                back = (pkg.io.load_matrix_file(f"{base}/d/a.txt", mesh1)
                        if name == "j"
                        else pkg.io.load_matrix_file(f"{base}/d/a.txt"))
        finally:
            retry.set_retry_policy(old)
            if scheme != "memory":
                pkg.io.register_filesystem(f"tfs{name}", None)
        out[name] = (back.to_numpy(), fault.fired, policy.retries,
                     read("d/a.txt"), read("d/_description"))
        if scheme == "memory":
            mem.rm(f"/marlin_io_{name}", recursive=True)
    assert out["t"][1] == out["j"][1] > 0
    assert out["t"][2] == out["j"][2]
    assert np.array_equal(out["t"][0], out["j"][0])
    assert out["t"][3] == out["j"][3] and out["t"][4] == out["j"][4]


def test_file_uri_with_authority_rejected():
    for pkg in (jm, tm):
        with pytest.raises(ValueError, match="authority"):
            pkg.io.load_matrix_file("file://host/x.txt")


# --------------------------------------------------------------- chunk store
@pytest.mark.parametrize("dtype", ["float32", "float64", "bfloat16"])
@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("shape,chunk_rows", [((1, 1), 1), ((101, 5), 7),
                                              ((64, 8), 64)])
def test_chunkstore_reads_equal_across_packages(tmp_path, dtype, writer,
                                                shape, chunk_rows):
    a = np.random.default_rng(7).standard_normal(shape)
    p = str(tmp_path / "s.mchunk")
    (jcs if writer == "jax" else tcs).write_chunkstore(
        p, a, chunk_rows=chunk_rows, dtype=dtype)
    with jcs.ChunkStore(p) as sj, tcs.ChunkStore(p) as st:
        assert st.shape == sj.shape == shape
        assert st.chunk_rows == sj.chunk_rows and st.nchunks == sj.nchunks
        assert str(st.dtype) == f"torch.{dtype}"
        got_j, got_t = sj.read_rows(0, shape[0]), st.read_rows(0, shape[0])
        if dtype == "bfloat16":
            assert np.array_equal(_bits_t(got_t), _bits_j(got_j))
        else:
            assert np.array_equal(got_t.numpy(), got_j)
        # windows that straddle chunks, converted on read
        lo, n = shape[0] // 3, max(shape[0] // 2, 1)
        for read_as in ("float32", "bfloat16"):
            wj, wt = (sj.read_rows(lo, n, dtype=read_as),
                      st.read_rows(lo, n, dtype=read_as))
            if read_as == "bfloat16":
                assert np.array_equal(_bits_t(wt), _bits_j(wj))
            else:
                assert np.array_equal(wt.numpy(), wj)


def test_chunkstore_files_equal_bytes(tmp_path):
    a = np.random.default_rng(8).standard_normal((50, 6))
    for dtype in ("float32", "float64", "bfloat16"):
        jp, tp = str(tmp_path / f"j{dtype}"), str(tmp_path / f"t{dtype}")
        jcs.write_chunkstore(jp, a, chunk_rows=16, dtype=dtype)
        tcs.write_chunkstore(tp, a, chunk_rows=16, dtype=dtype)
        assert open(jp, "rb").read() == open(tp, "rb").read(), dtype
    # the default dtype: float64 and float32 stay, anything else is f32
    for arr in (a, a.astype(np.float32), a.astype(ml_dtypes.bfloat16)):
        jp, tp = str(tmp_path / "jd"), str(tmp_path / "td")
        jcs.write_chunkstore(jp, arr, chunk_rows=16)
        tcs.write_chunkstore(tp, arr if arr.dtype != ml_dtypes.bfloat16
                             else torch.from_numpy(arr.view(np.uint16)
                                                   .view(np.int16))
                             .view(torch.bfloat16), chunk_rows=16)
        assert open(jp, "rb").read() == open(tp, "rb").read()


def test_bf16_host_casts_match_ml_dtypes():
    """The port's float→bfloat16 host casts (torch, round to nearest even)
    give the bits ml_dtypes gives: random values, ties, subnormals, inf and
    NaN, from f32 and from f64."""
    from marlin_tpu.parallel.streaming import _compress_for_transfer as jc
    from marlin_tpu_torch.parallel.streaming import _compress_for_transfer \
        as tc

    rng = np.random.default_rng(9)
    f32 = np.concatenate([
        rng.standard_normal(20000).astype(np.float32),
        # exact ties between two bf16 values, either parity
        (np.arange(1, 2001, dtype=np.uint32) << 16 | 0x8000).view(np.float32),
        np.array([1e-40, -1e-42, 3.4e38, np.inf, -np.inf, 0.0, -0.0],
                 np.float32)])
    for src in (f32, f32.astype(np.float64) * (1 + 2.0 ** -30)):
        assert np.array_equal(_bits_t(tc(src, "bfloat16")),
                              _bits_j(jc(src, "bfloat16")))
    nan = tc(np.array([np.nan], np.float32), "bfloat16")
    assert torch.isnan(nan).all()


def test_crc_damage_raises_alike(tmp_path):
    a = np.random.default_rng(10).standard_normal((64, 8))
    p = str(tmp_path / "c.mchunk")
    tcs.write_chunkstore(p, a, chunk_rows=16, dtype="float64")
    blob = bytearray(open(p, "rb").read())
    stride = 32 + 16 * 8 * 8
    blob[64 + stride + 32 + 5] ^= 0x01  # a byte in chunk 1's body
    open(p, "wb").write(bytes(blob))
    bad_before = tcs._metric_families()[2].value
    with jcs.ChunkStore(p) as sj, tcs.ChunkStore(p) as st:
        for start, n in [(0, 64), (16, 16), (20, 2), (0, 17)]:
            with pytest.raises(jcs.ChunkstoreCorruptError, match="checksum"):
                sj.read_rows(start, n)
            with pytest.raises(tcs.ChunkstoreCorruptError, match="checksum"):
                st.read_rows(start, n)
        for start, n in [(0, 16), (32, 32)]:
            assert np.array_equal(st.read_rows(start, n).numpy(),
                                  sj.read_rows(start, n))
        assert st.read_rows(16, 16, verify=False).shape == (16, 8)
    assert tcs._metric_families()[2].value == bad_before + 4


@pytest.mark.parametrize("cut", ["short", "header", "garbage", "magic"])
def test_truncation_raises_alike(tmp_path, cut):
    p = str(tmp_path / "t.mchunk")
    tcs.write_chunkstore(p, np.ones((64, 8)), chunk_rows=16)
    blob = open(p, "rb").read()
    data = {"short": blob[:-7], "header": blob[:40], "garbage": blob + b"xx",
            "magic": b"NOTACHUNKSTORE!!" * 8}[cut]
    open(p, "wb").write(data)
    with pytest.raises(jcs.ChunkstoreError) as ej:
        jcs.ChunkStore(p)
    with pytest.raises(tcs.ChunkstoreError) as et:
        tcs.ChunkStore(p)
    assert type(et.value).__name__ == type(ej.value).__name__


def test_read_into_caller_buffers(tmp_path):
    a = np.random.default_rng(12).standard_normal((40, 6))
    p = str(tmp_path / "b.mchunk")
    tcs.write_chunkstore(p, a, chunk_rows=9, dtype="float64")
    with tcs.ChunkStore(p) as s:
        out = np.empty((10, 6), np.float32)
        assert s.read_rows(5, 10, out=out, dtype="float32") is out
        assert np.array_equal(out, a[5:15].astype(np.float32))
        t = torch.empty((10, 6), dtype=torch.bfloat16)
        s.read_rows(5, 10, out=t, dtype="bfloat16")
        assert np.array_equal(
            _bits_t(t), _bits_j(a[5:15].astype(ml_dtypes.bfloat16)))
        with pytest.raises(ValueError, match="out buffer"):
            s.read_rows(5, 10, out=np.empty((10, 6), np.float64),
                        dtype="float32")
        with pytest.raises(IndexError):
            s.read_rows(35, 10)


def test_transcode_text_bit_exact_across_packages(tmp_path):
    a = np.random.default_rng(13).standard_normal((37, 5))
    src = str(tmp_path / "m.txt")
    native.save_matrix_text(src, a)
    jdst = jcs.transcode_text(src, str(tmp_path / "j.mchunk"), chunk_rows=8)
    tdst = tcs.transcode_text(src, str(tmp_path / "t.mchunk"), chunk_rows=8)
    assert open(jdst, "rb").read() == open(tdst, "rb").read()
    with tcs.ChunkStore(tdst) as s:
        assert np.array_equal(s.read_rows(0, 37).numpy(),
                              native.load_matrix_text(src))
    with open(src, "a") as f:
        f.write("99:1,2,3,4,5\n")
    for mod in (jcs, tcs):
        with pytest.raises(ValueError, match="transcodable"):
            mod.transcode_text(src, str(tmp_path / "x.mchunk"))


def _idx_file(path, n=50, rows=4, cols=3, seed=14):
    raw = np.random.default_rng(seed).integers(0, 256, (n, rows, cols),
                                               dtype=np.uint8)
    with open(path, "wb") as f:
        f.write(struct.pack(">IIII", 2051, n, rows, cols))
        f.write(raw.tobytes())
    return raw


def test_mnist_idx_and_sidecar(tmp_path):
    from marlin_tpu.io import mnist as jmnist
    from marlin_tpu_torch.io import mnist as tmnist

    idx = str(tmp_path / "images-idx3-ubyte")
    raw = _idx_file(idx)
    for cj, ct in zip(jmnist.iter_mnist_image_chunks(idx, 16),
                      tmnist.iter_mnist_image_chunks(idx, 16)):
        assert np.array_equal(cj, ct)
    ref = tmnist.mnist_images_out_of_core(idx, chunk_rows=16,
                                          chunkstore=False)
    assert "callable" in repr(ref)
    jside = jcs.transcode_idx(idx, str(tmp_path / "j.mchunk"), chunk_rows=16)
    tcs.transcode_idx(idx, chunk_rows=16)
    assert open(jside, "rb").read() == open(tcs.sidecar_path(idx), "rb").read()
    ooc = tmnist.mnist_images_out_of_core(idx, chunk_rows=16)
    assert "chunkstore" in repr(ooc) and ooc.shape == (50, 12)
    want = (raw.reshape(50, 12) / 255.0).astype(np.float32)
    assert np.array_equal(ooc.slice_rows(0, 50), want)
    assert np.array_equal(ref.slice_rows(3, 40), want[3:40])
    with open(idx, "r+b") as f:
        f.truncate(16 + 12 * 20)
    with pytest.raises(ValueError, match="truncated"):
        list(tmnist.iter_mnist_image_chunks(idx, 16))


def test_sidecar_selection(tmp_path):
    """A fresh sidecar is picked up, a stale one skipped, and
    ``chunkstore=True`` builds one on the spot."""
    a = np.random.default_rng(15).standard_normal((20, 4))
    txt = str(tmp_path / "m.txt")
    native.save_matrix_text(txt, a)
    assert tcs.open_sidecar(txt) is None
    ooc = tm.io.load_matrix_file_out_of_core(txt, chunk_rows=8,
                                             chunkstore=True)
    assert "chunkstore" in repr(ooc)
    assert np.array_equal(ooc.slice_rows(0, 20), a)
    assert "chunkstore" in repr(
        tm.io.load_matrix_file_out_of_core(txt, chunk_rows=8))
    old = os.path.getmtime(txt) - 100
    os.utime(tcs.sidecar_path(txt), (old, old))
    assert tcs.open_sidecar(txt) is None
    assert "callable" in repr(
        tm.io.load_matrix_file_out_of_core(txt, chunk_rows=8))


def test_dataplane_fault_surfaces_at_position(tmp_path):
    from marlin_tpu.parallel.prefetch import ChunkPrefetcher as JPf
    from marlin_tpu_torch.parallel.prefetch import ChunkPrefetcher as TPf

    a = np.random.default_rng(16).standard_normal((80, 4))
    p = str(tmp_path / "chaos.mchunk")
    tcs.write_chunkstore(p, a, chunk_rows=8, dtype="float64")
    got = {}
    for name, mod, faults, pf in (("j", jcs, jfaults, JPf),
                                  ("t", tcs, tfaults, TPf)):
        with mod.ChunkStore(p) as s:
            with faults.injected("dataplane.read",
                                 faults.RaiseFault(match="@24")):
                seen = []
                with pf(s.iter_chunks(8), device_put=False) as it:
                    with pytest.raises(faults.FaultInjected):
                        for c in it:
                            seen.append(_host_t(c))
            got[name] = np.concatenate(seen)
            assert np.array_equal(_host_t(s.read_rows(24, 8)), a[24:32])
    assert np.array_equal(got["t"], got["j"])
    assert np.array_equal(got["t"], a[:24])


def test_cli_build_info_verify(tmp_path, capsys):
    a = np.random.default_rng(17).standard_normal((30, 3))
    txt = str(tmp_path / "m.txt")
    native.save_matrix_text(txt, a)
    assert tcs._main(["build", txt, "--chunk-rows", "8"]) == 0
    assert tcs._main(["info", tcs.sidecar_path(txt)]) == 0
    assert tcs._main(["verify", tcs.sidecar_path(txt)]) == 0
    out = capsys.readouterr().out
    assert "30x3" in out and "OK (4 chunks verified)" in out
