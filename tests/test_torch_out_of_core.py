"""The port's prefetcher, streamed ops and OutOfCoreMatrix against the JAX
package's, on the CPU.

The same seeded numpy chunks go through ``marlin_tpu.parallel`` /
``marlin_tpu.matrix.out_of_core`` and the port's counterparts (under
``config_context(device="cpu")``). Tolerances:

- ``streamed_gramian`` and ``streamed_matmul`` in f32 at ``"highest"``:
  within ``REL`` (1e-5) of the JAX package's result, relative to its largest
  |entry| (both sum the same f32 products in other orders);
- with ``transfer_dtype="bfloat16"`` the chunks the two packages upload are
  equal bit for bit, and the results agree within ``REL`` too;
- prefetch on and off give the same bits in the port (the pipeline reorders
  work, never math), as do the text and chunk-store legs of one file;
- the prefetcher's order, depth, budget, close-on-error and fault events
  match the JAX package's exactly.

The pinned staging buffers and the side stream exist only on a CUDA device;
those tests carry the ``cuda`` marker and skip here.
"""

import threading
import time

import numpy as np
import pytest
import torch

import marlin_tpu_torch as tm
from marlin_tpu.matrix.out_of_core import OutOfCoreMatrix as JOoc
from marlin_tpu.parallel import prefetch as jpf
from marlin_tpu.parallel import streaming as jst
from marlin_tpu.utils import faults as jfaults
from marlin_tpu_torch.io import chunkstore as tcs
from marlin_tpu_torch.matrix.out_of_core import OutOfCoreMatrix as TOoc
from marlin_tpu_torch.parallel import prefetch as tpf
from marlin_tpu_torch.parallel import streaming as tst
from marlin_tpu_torch.utils import faults as tfaults
from marlin_tpu_torch.utils.profiling import StageTimes
from marlin_tpu_torch.utils.tracing import EventLog

REL = 1e-5


@pytest.fixture(autouse=True)
def _cpu():
    with tm.config_context(device="cpu"):
        yield


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is false)")
    return torch.device("cuda")


def _chunks(n=8, rows=16, cols=4, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((rows, cols)).astype(np.float32)
            for _ in range(n)]


def _host(x) -> np.ndarray:
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _alive_workers():
    return [t for t in threading.enumerate()
            if t.name.startswith("marlin-prefetch") and t.is_alive()]


def _close(got, want):
    scale = float(np.abs(want).max())
    assert float(np.abs(got - want).max()) <= REL * scale


# ------------------------------------------------------------ the prefetcher
@pytest.mark.parametrize("workers,depth", [(1, 1), (1, 2), (4, 6)])
@pytest.mark.parametrize("device_put", [True, False])
def test_order_matches_jax(workers, depth, device_put):
    cs = _chunks(24)
    kw = dict(workers=workers, depth=depth, device_put=device_put)
    got_j = [np.asarray(c) for c in jpf.ChunkPrefetcher(iter(cs), **kw)]
    got_t = list(tpf.ChunkPrefetcher(iter(cs), **kw))
    assert len(got_t) == len(got_j) == 24
    for t, j, c in zip(got_t, got_j, cs):
        assert isinstance(t, torch.Tensor) == device_put
        assert np.array_equal(_host(t), j) and np.array_equal(j, c)


def test_transform_runs_on_producer():
    tids = set()

    def transform(c):
        tids.add(threading.get_ident())
        return c * 2.0

    cs = _chunks(6)
    got = list(tpf.ChunkPrefetcher(iter(cs), transform, workers=2))
    for g, c in zip(got, cs):
        assert np.array_equal(_host(g), c * 2.0)
    assert threading.get_ident() not in tids


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_depth_bounds_reads(pkg):
    """With depth 3 and an idle consumer, exactly 3 chunks are read; one
    consumed chunk admits exactly one more read — in both packages."""
    produced = []

    def source():
        for c in _chunks(20):
            produced.append(len(produced))
            yield c

    pf = (jpf if pkg == "jax" else tpf).ChunkPrefetcher(source(), depth=3,
                                                        workers=2)
    try:
        for want in (3, 4):
            deadline = time.monotonic() + 2.0
            while len(produced) < want and time.monotonic() < deadline:
                time.sleep(0.01)
            time.sleep(0.2)  # every chance to overshoot
            assert len(produced) == want
            if want == 3:
                next(pf)
    finally:
        pf.close()


@pytest.mark.parametrize("budget", [1, 16 * 4 * 4 * 2])
def test_budget_admission_is_stream_ordered(budget):
    for rep in range(3):
        cs = _chunks(30, rows=16, seed=rep)
        got = list(tpf.ChunkPrefetcher(iter(cs), depth=6, workers=4,
                                       hbm_budget_bytes=budget))
        assert len(got) == len(cs)
        for g, c in zip(got, cs):
            assert np.array_equal(_host(g), c)
    assert not _alive_workers()
    assert tpf._metric_families()[3].value == 0  # every byte refunded


def _fault_trace(pkg, make_source, transform=None, **kw):
    """(chunks delivered before the error, error type and text) of one run."""
    mod = jpf if pkg == "jax" else tpf
    pf = mod.ChunkPrefetcher(make_source(), transform, **kw)
    got = []
    try:
        for c in pf:
            got.append(_host(c))
    except Exception as e:  # noqa: BLE001
        err = (type(e).__name__, str(e))
    else:
        err = None
    assert pf._closed
    return got, err


@pytest.mark.parametrize("where", ["source", "transform"])
def test_close_on_error_matches_jax(where):
    cs = _chunks(10)

    def source():
        for i, c in enumerate(cs):
            if where == "source" and i == 3:
                raise ValueError("disk on fire")
            yield c

    def transform(c):
        if where == "transform" and c is cs[5]:
            raise RuntimeError("bad chunk")
        return c

    out = {pkg: _fault_trace(pkg, source, transform, workers=2, depth=4)
           for pkg in ("jax", "port")}
    (gj, ej), (gt, et) = out["jax"], out["port"]
    assert et == ej and ej is not None
    assert len(gt) == len(gj) == (3 if where == "source" else 5)
    for t, j in zip(gt, gj):
        assert np.array_equal(t, j)
    assert not _alive_workers()


@pytest.mark.parametrize("fault", ["raise", "delay"])
def test_produce_fault_events_match_jax(fault):
    """The ``prefetch.produce`` point: a raise at chunk 4 surfaces after 4
    intact chunks, a delay changes nothing but time — in both packages."""
    cs = _chunks(8)
    out = {}
    for pkg, faults in (("jax", jfaults), ("port", tfaults)):
        f = (faults.RaiseFault(match="chunk-4") if fault == "raise"
             else faults.DelayFault(0.01, times=-1))
        with faults.injected("prefetch.produce", f):
            out[pkg] = _fault_trace(pkg, lambda: iter(cs), workers=2)
        out[pkg] += (f.fired,)
    (gj, ej, fj), (gt, et, ft) = out["jax"], out["port"]
    assert (et, ft) == (ej, fj)
    assert len(gt) == len(gj) == (4 if fault == "raise" else 8)
    if fault == "raise":
        assert et[0] == "FaultInjected"


def test_close_midstream_joins_threads():
    pf = tpf.ChunkPrefetcher(iter(_chunks(50)), depth=2, workers=3)
    next(pf)
    pf.close()
    pf.close()  # idempotent
    assert not _alive_workers()
    with pytest.raises(StopIteration):
        next(pf)
    with tpf.ChunkPrefetcher(iter(_chunks(50)), depth=2) as pf2:
        next(pf2)
    assert not _alive_workers()


@pytest.mark.parametrize("kw", [dict(depth=0), dict(workers=0)])
def test_bad_knobs_rejected(kw):
    for mod in (jpf, tpf):
        with pytest.raises(ValueError, match="must be >= 1"):
            mod.ChunkPrefetcher(iter([]), **kw)


def test_stage_times_and_summary_event(tmp_path):
    log = EventLog(str(tmp_path / "ev.jsonl"))
    stats = StageTimes()
    cs = _chunks(5)
    got = list(tpf.ChunkPrefetcher(iter(cs), stats=stats))
    assert len(got) == 5
    assert stats.counts["produce"] == 5 and stats.counts["transfer"] == 5
    assert stats.counts["stall"] == 6  # one per chunk and the final wait
    pf = tpf.ChunkPrefetcher(iter(cs), stats=StageTimes())
    from marlin_tpu_torch.utils.tracing import set_default_event_log

    set_default_event_log(log)
    try:
        list(pf)
    finally:
        set_default_event_log(None)
    (ev,) = [e for e in log.read() if e["kind"] == "prefetch"]
    assert ev["chunks"] == 5 and ev["depth"] == 2 and ev["workers"] == 1
    assert "produce_s" in ev and "stall_s" in ev


def test_metric_families_registered_by_collectors():
    from marlin_tpu_torch.obs import collectors, metrics

    collectors.install_default_collectors()
    text = metrics.get_registry().render()
    for fam in ("marlin_prefetch_chunks_total",
                "marlin_prefetch_stall_seconds_total",
                "marlin_prefetch_ready_depth",
                "marlin_prefetch_inflight_bytes"):
        assert fam in text
    before = tpf._metric_families()[0].value
    list(tpf.ChunkPrefetcher(iter(_chunks(3))))
    assert tpf._metric_families()[0].value == before + 3


# --------------------------------------------------------------- streamed ops
def _sources(a, tmp_path, kind):
    """(JAX source, port source) of one kind over the same rows."""
    if kind == "ndarray":
        return a, a
    if kind == "memmap":
        p = str(tmp_path / "a.bin")
        mm = np.memmap(p, np.float32, "w+", shape=a.shape)
        mm[:] = a
        mm.flush()
        ro = np.memmap(p, np.float32, "r", shape=a.shape)
        return ro, ro
    if kind == "generator":
        return ([a[i:i + 50] for i in range(0, len(a), 50)],
                [a[i:i + 50] for i in range(0, len(a), 50)])
    p = str(tmp_path / "a.mchunk")
    tcs.write_chunkstore(p, a, chunk_rows=33)
    from marlin_tpu.io.chunkstore import ChunkStore as JStore

    return JStore(p), tcs.ChunkStore(p)


@pytest.mark.parametrize("kind", ["ndarray", "memmap", "generator",
                                  "chunkstore"])
def test_streamed_gramian_matches_jax(tmp_path, kind):
    a = np.random.default_rng(1).standard_normal((317, 24)).astype(np.float32)
    sj, st = _sources(a, tmp_path, kind)
    want = jst.streamed_gramian(sj, chunk_rows=64, precision="highest")
    got_on = tst.streamed_gramian(st, chunk_rows=64, precision="highest",
                                  prefetch=True)
    if kind == "generator":
        st = [a[i:i + 50] for i in range(0, len(a), 50)]
    got_off = tst.streamed_gramian(st, chunk_rows=64, precision="highest",
                                   prefetch=False)
    assert got_on.dtype == np.float32 and got_on.shape == (24, 24)
    assert np.array_equal(got_on, got_off)
    _close(got_on, np.asarray(want))
    _close(got_on, a.astype(np.float64).T @ a)


@pytest.mark.parametrize("into", ["stack", "memmap"])
def test_streamed_matmul_matches_jax(tmp_path, into):
    rng = np.random.default_rng(2)
    a = rng.standard_normal((301, 32)).astype(np.float32)
    b = rng.standard_normal((32, 12)).astype(np.float32)
    want = np.asarray(jst.streamed_matmul(a, b, chunk_rows=64,
                                          precision="highest"))
    outs = []
    for prefetch in (True, False):
        out = None
        if into == "memmap":
            out = np.memmap(str(tmp_path / f"o{prefetch}.bin"), np.float32,
                            "w+", shape=(301, 12))
        got = tst.streamed_matmul(a, b, chunk_rows=64, precision="highest",
                                  out=out, prefetch=prefetch)
        assert got is out if out is not None else got.shape == (301, 12)
        outs.append(np.array(got))
    assert np.array_equal(outs[0], outs[1])
    _close(outs[0], want)
    with pytest.raises(ValueError, match="empty"):
        tst.streamed_matmul(iter([]), b)


@pytest.mark.parametrize("op", ["gramian", "matmul"])
def test_bf16_transfer_matches_jax(op):
    """The chunks the two packages upload are equal bit for bit, so their
    results agree as closely as the f32 ones."""
    rng = np.random.default_rng(3)
    a = rng.standard_normal((200, 16)).astype(np.float32)
    b = rng.standard_normal((16, 8)).astype(np.float32)
    kw = dict(chunk_rows=64, precision="highest", transfer_dtype="bfloat16")
    if op == "gramian":
        want = jst.streamed_gramian(a, **kw)
        got = tst.streamed_gramian(a, **kw)
        a16 = tst._compress_for_transfer(a, "bfloat16").float().numpy()
        ref = a16.astype(np.float64).T @ a16
    else:
        want = jst.streamed_matmul(a, b, **kw)
        got = tst.streamed_matmul(a, b, **kw)
        ref = (tst._compress_for_transfer(a, "bfloat16").float().numpy()
               .astype(np.float64) @ b)
    _close(got, np.asarray(want).astype(np.float32))
    _close(got, ref)
    assert np.array_equal(got, tst.streamed_gramian(a, **kw, prefetch=False)
                          if op == "gramian" else
                          tst.streamed_matmul(a, b, **kw, prefetch=False))


def test_streamed_costs_recorded():
    from marlin_tpu_torch.obs import perf

    a = np.ones((100, 8), np.float32)
    tst.streamed_gramian(a, chunk_rows=50)
    tst.streamed_matmul(a, np.ones((8, 3), np.float32), chunk_rows=50)
    rows = {r["program"]: r for r in perf.get_program_costs().rows()
            if r["key"] in ("chunk=50x8 dtype=float32 acc=float32",
                            "chunk=50x8 n=3 dtype=float32")}
    assert rows["streamed_gramian"]["flops"] == 2.0 * 50 * 8 * 8
    assert rows["streamed_matmul"]["flops"] == 2.0 * 50 * 8 * 3
    assert rows["streamed_gramian"]["calls"] >= 2


def test_chaos_through_streamed_gramian():
    a = np.ones((64, 4), np.float32)
    with tfaults.injected("prefetch.produce",
                          tfaults.RaiseFault(match="chunk-2")):
        with pytest.raises(tfaults.FaultInjected):
            tst.streamed_gramian(a, chunk_rows=16)
    assert not _alive_workers()


# ---------------------------------------------------------- OutOfCoreMatrix
@pytest.fixture
def big():
    return np.random.default_rng(4).standard_normal((203, 12)) \
        .astype(np.float32)


@pytest.mark.parametrize("kind", ["array", "callable"])
def test_out_of_core_ops_match_jax(big, kind):
    def src():
        return (big[i:i + 40] for i in range(0, len(big), 40))

    if kind == "array":
        oj, ot = JOoc(big, chunk_rows=40), TOoc(big, chunk_rows=40)
    else:
        oj = JOoc(src, shape=big.shape, chunk_rows=40)
        ot = TOoc(src, shape=big.shape, chunk_rows=40)
    b = np.random.default_rng(5).standard_normal((12, 5)).astype(np.float32)
    _close(ot.multiply(b, precision="highest"),
           np.asarray(oj.multiply(b, precision="highest")))
    _close(ot.gramian(precision="highest"),
           np.asarray(oj.gramian(precision="highest")))
    assert ot.sum() == oj.sum() == ot.sum(prefetch=False)
    assert np.array_equal(ot.slice_rows(30, 130), oj.slice_rows(30, 130))
    dense = ot.to_dense_vec_matrix()
    assert dense.shape == big.shape and dense.dtype == torch.float32
    assert np.array_equal(dense.to_numpy(), oj.to_dense_vec_matrix()
                          .to_numpy())
    assert repr(ot) == repr(oj)
    assert ot.shape == (203, 12) and ot.num_rows() == 203
    with pytest.raises(ValueError, match="inner dim"):
        ot.multiply(np.ones((5, 2), np.float32))
    assert ot.multiply(tm.DenseVecMatrix.from_array(b)).shape == (203, 5)


def test_out_of_core_constructor_checks(big):
    with pytest.raises(ValueError, match="shape is required"):
        TOoc(lambda: iter([]))
    with pytest.raises(ValueError, match="contradicts"):
        TOoc(big, shape=(5, 5))
    with pytest.raises(ValueError, match="2-D"):
        TOoc(np.ones(3))


def test_text_and_chunkstore_legs_agree(tmp_path):
    """One row-text file streamed by the Python parser and by its
    ``transcode_text`` sidecar: the same Gramian bit for bit, and the JAX
    package's within REL."""
    from marlin_tpu.io.text import load_matrix_file_out_of_core as jload
    from marlin_tpu_torch import native
    from marlin_tpu_torch.io.text import load_matrix_file_out_of_core as tload

    a = np.random.default_rng(6).standard_normal((150, 10))
    p = str(tmp_path / "m.txt")
    native.save_matrix_text(p, a)
    text_leg = tload(p, chunk_rows=32, chunkstore=False)
    g_text = text_leg.gramian(precision="highest")
    tcs.transcode_text(p, chunk_rows=32)
    store_leg = tload(p, chunk_rows=32)
    assert "chunkstore" in repr(store_leg) and "callable" in repr(text_leg)
    g_store = store_leg.gramian(precision="highest")
    assert np.array_equal(g_text, g_store)
    _close(g_text, np.asarray(jload(p, chunk_rows=32, chunkstore=False)
                              .gramian(precision="highest")))
    _close(g_text, a.T @ a)
    assert store_leg.slice_rows(140, 200).shape == (10, 10)


def test_mnist_out_of_core_gramian_matches_jax(tmp_path):
    import struct

    from marlin_tpu.io.mnist import mnist_images_out_of_core as jm_ooc
    from marlin_tpu_torch.io.mnist import mnist_images_out_of_core as tm_ooc

    raw = np.random.default_rng(7).integers(0, 256, (60, 5, 5),
                                            dtype=np.uint8)
    idx = str(tmp_path / "t10k-images-idx3-ubyte")
    with open(idx, "wb") as f:
        f.write(struct.pack(">IIII", 2051, 60, 5, 5))
        f.write(raw.tobytes())
    gt = tm_ooc(idx, chunk_rows=16).gramian(precision="highest")
    _close(gt, np.asarray(jm_ooc(idx, chunk_rows=16)
                          .gramian(precision="highest")))


# ------------------------------------------------- on the card (skip here)
@pytest.mark.cuda
def test_pinned_staging_on_side_stream(cuda):
    cs = _chunks(6, rows=1024, cols=64)
    tpf.reset_staging_counts()
    with tm.config_context(device="cuda"):
        pf = tpf.ChunkPrefetcher(iter(cs), depth=2, workers=2)
        got = list(pf)
    staged = tpf.staging_counts()
    assert (staged["pinned"], staged["unpinned"]) == (6, 0)
    assert staged["bytes"] == sum(c.nbytes for c in cs)
    assert staged["copy_s"] > 0
    assert pf._side != torch.cuda.current_stream()
    assert len(pf._pool._free) + len(pf._pool._busy) <= 4
    for g, c in zip(got, cs):
        assert g.device.type == "cuda"
        assert np.array_equal(g.cpu().numpy(), c)
    nbytes, seconds = pf.copy_seconds()
    assert nbytes == sum(c.nbytes for c in cs) and seconds > 0


@pytest.mark.cuda
def test_streamed_ops_on_card_match_cpu(cuda):
    a = np.random.default_rng(8).standard_normal((5000, 64)) \
        .astype(np.float32)
    b = np.random.default_rng(9).standard_normal((64, 32)).astype(np.float32)
    with tm.config_context(device="cuda"):
        g_on = tst.streamed_gramian(a, chunk_rows=1000, prefetch=True)
        g_off = tst.streamed_gramian(a, chunk_rows=1000, prefetch=False)
        y = tst.streamed_matmul(a, b, chunk_rows=1000)
    assert np.array_equal(g_on, g_off)
    _close(g_on, a.astype(np.float64).T @ a)
    _close(y, a.astype(np.float64) @ b)
