"""Cross-engine migration in the port against the JAX package's.

The MGRT blob (``serving/kvpool.py``'s export/import) is the JAX package's
wire format, byte for byte, so every check here crosses the packages:

- **Wire format.** Two pools of the tiny LM of tests/test_torch_serving.py
  (vocab 32, d_model 16, 2 heads, 2 layers, seed 9), filled with the same
  seeded page contents (f32, and bf16 as the same 16-bit words), export
  the same row set to the SAME bytes; each package's blob imports into the
  other's pool with the page bodies byte-equal; a flipped byte, a
  truncation and an empty blob raise each package's
  ``MigrationCorruptError`` with the same message, and a failed import
  leaks no page. Shared prompt prefixes re-deduplicate on import alike; a
  wrong geometry is refused alike.
- **Freeze and adopt across the packages.** Rows frozen mid-decode on a
  JAX engine adopt into a port engine, and rows frozen on a port engine
  adopt into a JAX engine: greedy tokens equal JAX's ``lm_generate``,
  sampled tokens equal the JAX engine serving the same requests
  uninterrupted — exact, no tolerance. The manifests (meta chunk) equal as
  parsed dicts less ``trace``, ``ttft_s`` and ``rid``, which differ between
  the packages by nature.
- **Cache warm across the packages**: one package's ``export_prefixes``
  warms the other's ``import_prefixes``, and the warmed engine's first
  shared-prompt request hits its prefix cache.
- **Faults**: ``serve.migrate`` at export, import and adopt during a port
  rolling restart each fall back to exactly one OK Result per request.

Every wait has a timeout; engines and routers are closed by ``with``.
"""

import json
import random
import threading

import numpy as np
import pytest
import torch

import jax

from marlin_tpu.models import TransformerLM as JaxLM
from marlin_tpu.models import transformer as jt
from marlin_tpu.serving import PagedKVPool as JPool
from marlin_tpu.serving import Request as JRequest
from marlin_tpu.serving import ServeEngine as JEngine
from marlin_tpu.serving import engine as jengine
from marlin_tpu.serving.kvpool import MigrationCorruptError as JCorrupt
from marlin_tpu.serving.request import ResultHandle as JHandle
from marlin_tpu.utils import faults as jfaults
from marlin_tpu_torch import config_context, interop
from marlin_tpu_torch.obs import memledger as tmemledger
from marlin_tpu_torch.serving import (STATUS_OK, MigrationCorruptError,
                                      MigrationError, PagedKVPool)
from marlin_tpu_torch.serving import Request as TRequest
from marlin_tpu_torch.serving import Router as TRouter
from marlin_tpu_torch.serving import ServeEngine as TEngine
from marlin_tpu_torch.serving import engine as tengine
from marlin_tpu_torch.serving.kvpool import _MIG_HDR
from marlin_tpu_torch.serving.request import ResultHandle as THandle
from marlin_tpu_torch.utils import faults as tfaults
from marlin_tpu_torch.utils.faults import DelayFault, RaiseFault

HEADS = 2
BUCKETS = ((8, 8), (16, 8))
PAGE_LEN = 4
WAIT_S = 60.0


@pytest.fixture(autouse=True)
def _no_port_fault_leaks():
    yield
    leaked = tfaults.active()
    tfaults.clear()
    assert not leaked, f"port fault(s) leaked across tests: {leaked}"


@pytest.fixture(scope="module")
def jparams():
    return JaxLM(vocab=32, d_model=16, heads=HEADS, layers=2,
                 seed=9).init_params()


@pytest.fixture(scope="module")
def tparams(jparams):
    return interop.lm_params_from_numpy(jax.tree.map(np.asarray, jparams),
                                        device="cpu")


@pytest.fixture
def cpu():
    with config_context(device="cpu"):
        yield


def _jref(jparams, prompt, steps):
    prompt = np.asarray(prompt, np.int32)
    return np.asarray(jt.lm_generate(
        jparams, prompt, jax.random.key(0), heads=HEADS,
        max_len=len(prompt) + steps, steps=steps)).tolist()


def _engine_kw(**kw):
    kw.setdefault("buckets", BUCKETS)
    kw.setdefault("max_batch", 4)
    kw.setdefault("queue_depth", 64)
    kw.setdefault("page_len", PAGE_LEN)
    kw.setdefault("num_pages", 256)
    return kw


# ------------------------------------------------------------- wire format


def _bits(rng, shape, dtype):
    """Seeded page contents as raw words: f32 normals, or their top 16
    bits as bf16 (exact in both packages, no rounding involved)."""
    x = rng.standard_normal(shape).astype(np.float32)
    if dtype == "bfloat16":
        return (x.view(np.uint32) >> 16).astype(np.uint16)
    return x.view(np.uint32)


def _fill(jpool, tpool, pages, seed, dtype):
    """Write the same seeded contents into ``pages`` of both pools."""
    rng = np.random.default_rng(seed)
    host = jpool._host_pages()
    for name in sorted(host, key=lambda s: int(s[1:])):
        for half in (0, 1):
            arr = host[name][half]
            words = _bits(rng, (len(pages),) + arr.shape[1:], dtype)
            arr[pages] = words.view(arr.dtype)
            t = tpool.pages[name][half]
            t[pages] = torch.from_numpy(
                words.astype(np.int16 if dtype == "bfloat16" else np.int32)
            ).view(t.dtype)
    jpool._flush_host(host)


def _jbytes(pool, pages):
    host = pool._host_pages()
    return b"".join(np.ascontiguousarray(host[n][h][list(pages)]).tobytes()
                    for n in sorted(host, key=lambda s: int(s[1:]))
                    for h in (0, 1))


def _tbytes(pool, pages):
    return b"".join(part.tobytes() for part in pool._host_pages(pages))


def _pools(jparams, tparams, n=32, dtype=None, page_len=PAGE_LEN):
    return (JPool(jparams, HEADS, num_pages=n, page_len=page_len,
                  compute_dtype=dtype),
            PagedKVPool(tparams, HEADS, num_pages=n, page_len=page_len,
                        compute_dtype=dtype))


def _corrupt_message(pool, blob, exc):
    with pytest.raises(exc) as err:
        pool.import_rows(blob)
    return str(err.value)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_blob_bytes_equal_and_cross_import(jparams, tparams, cpu, dtype):
    """Tolerance: none. The same row set over the same page contents
    exports to identical bytes in both packages; either blob imports into
    the other package's pool with byte-equal page bodies; corruption
    raises the same message in both."""
    jsrc, tsrc = _pools(jparams, tparams, dtype=dtype)
    jpages, tpages = jsrc.alloc(3), tsrc.alloc(3)
    assert jpages == tpages
    _fill(jsrc, tsrc, jpages, seed=42, dtype=dtype)
    assert _jbytes(jsrc, jpages) == _tbytes(tsrc, tpages)
    row = {"rid": 7, "prompt": list(range(1, 13)), "pages": jpages,
           "pf_next": -1, "steps_done": 3, "temperature": 0.5}
    jblob, tblob = jsrc.export_rows([row]), tsrc.export_rows([row])
    assert jblob == tblob
    jdst, tdst = _pools(jparams, tparams, dtype=dtype)
    tout = tdst.import_rows(jblob)
    jout = jdst.import_rows(tblob)
    assert tout == jout and tout[0]["rid"] == 7
    assert _tbytes(tdst, tout[0]["pages"]) == _jbytes(jsrc, jpages)
    assert _jbytes(jdst, jout[0]["pages"]) == _tbytes(tsrc, tpages)
    # re-exporting the adopted rows gives the same page bodies
    assert tdst.export_rows(tout) == jdst.export_rows(jout)
    assert tdst.audit()["ok"] and jdst.audit()["ok"]

    jfresh, tfresh = _pools(jparams, tparams, dtype=dtype)
    variants = []
    for cut in (len(jblob) // 2, 40):
        bad = bytearray(jblob)
        bad[cut] ^= 0xFF
        variants.append(bytes(bad))
    variants += [jblob[:-7], b"", jblob[:_MIG_HDR.size - 3]]
    for bad in variants:
        assert (_corrupt_message(tfresh, bad, MigrationCorruptError)
                == _corrupt_message(jfresh, bad, JCorrupt))
    audit = tfresh.audit()
    assert audit["ok"], audit["errors"]
    assert tfresh.used_count() == jfresh.used_count() == 0


def test_import_rededuplicates_shared_prefix_alike(jparams, tparams, cpu):
    """Two rows sharing two full prompt pages collapse back onto shared
    pages on import, in both packages, with equal manifests."""
    jsrc, tsrc = _pools(jparams, tparams)
    shared = list(range(1, 9))
    rows = []
    for rid, tail in enumerate(([9, 10, 11, 12], [13, 14, 15, 16])):
        jp, tp = jsrc.alloc(3), tsrc.alloc(3)
        assert jp == tp
        _fill(jsrc, tsrc, jp, seed=rid, dtype="float32")
        rows.append({"rid": rid, "prompt": shared + tail, "pages": jp,
                     "pf_next": -1})
    blob = tsrc.export_rows(rows)
    assert blob == jsrc.export_rows(rows)
    jdst, tdst = _pools(jparams, tparams)
    tout, jout = tdst.import_rows(blob), jdst.import_rows(blob)
    assert tout == jout
    assert tout[0]["n_shared"] == 0 and tout[1]["n_shared"] == 2
    assert tout[0]["pages"][:2] == tout[1]["pages"][:2]
    assert tdst.hits == jdst.hits > 0
    assert tdst.stats() == jdst.stats()
    assert tdst.audit()["ok"]


def test_wrong_geometry_refused_alike(jparams, tparams, cpu):
    """A blob from a pool of another page length or dtype is refused by
    both packages with the same message, and by the port's engine as a
    MigrationError."""
    jsrc, tsrc = _pools(jparams, tparams, page_len=8)
    row = {"rid": 1, "prompt": [1, 2, 3], "pages": jsrc.alloc(1),
           "pf_next": -1}
    tsrc.alloc(1)
    blob = tsrc.export_rows([row])
    jdst, tdst = _pools(jparams, tparams)
    msg = _corrupt_message(tdst, blob, MigrationCorruptError)
    assert msg == _corrupt_message(jdst, blob, JCorrupt)
    assert "geometry mismatch on 'page_len'" in msg
    jb, tb = _pools(jparams, tparams, dtype="bfloat16")
    assert (_corrupt_message(tb, jsrc.export_rows([row]),
                             MigrationCorruptError)
            == _corrupt_message(jb, jsrc.export_rows([row]), JCorrupt))
    req = TRequest(prompt=[1, 2, 3], steps=2, rid=1)
    entry = tengine._Entry(req, THandle(req), (8, 8), 1, 0.0)
    with TEngine(tparams, HEADS, **_engine_kw()) as eng:
        with pytest.raises(MigrationError, match="geometry mismatch"):
            eng.adopt_rows({"blob": blob, "entries": {1: entry}},
                           timeout=WAIT_S)
        assert eng.pending() == 0 and not entry.handle.done()
        assert eng.kvpool_audit()["ok"]


# ------------------------------------------------- freeze / adopt crossing


def _specs():
    """Six rows that fit the two buckets at once: greedy and sampled,
    short and long prompts, 8 steps each."""
    return [dict(prompt=[3, 1, 2], steps=8),
            dict(prompt=[5, 2, 7, 1], steps=8),
            dict(prompt=[4, 4, 1], steps=8, temperature=0.8, seed=11,
                 top_k=8),
            dict(prompt=[9, 8, 7, 6, 5], steps=8),
            dict(prompt=[2, 4, 6, 1, 3, 5, 2, 4, 6, 1], steps=8),
            dict(prompt=[7, 3, 5, 2, 6, 1, 4, 2, 9], steps=8,
                 temperature=0.8, seed=12, top_p=0.9)]


def _hold(faults_mod, gate, release):
    class Hold(faults_mod.Fault):
        def on_fire(self, point, ctx):
            gate.set()
            release.wait(timeout=WAIT_S)

    # the third decode step: rows frozen there have real progress behind
    # them and steps left to run on the adopting engine
    return Hold(times=1, schedule=faults_mod.Schedule(fire_on=[2]))


def _freeze_midstream(eng, faults_mod, req_cls, specs):
    """Stage ``specs`` on an unstarted, warmed engine, hold its third
    decode step, and freeze it there. Returns (frozen, handles)."""
    eng.warmup()
    hs = [eng.submit(req_cls(**s)) for s in specs]
    gate, release = threading.Event(), threading.Event()
    faults_mod.inject("serve.decode_step", _hold(faults_mod, gate, release))
    try:
        eng.start()
        assert gate.wait(timeout=WAIT_S)
        # released only after freeze_rows has set "freezing": the worker
        # finishes the held step and parks at its next iteration top
        threading.Timer(0.2, release.set).start()
        frozen = eng.freeze_rows()
    finally:
        release.set()
        faults_mod.clear("serve.decode_step")
    return frozen, hs


def _rebind(frozen, entry_mod, req_cls, handle_cls):
    """The frozen entries as the OTHER package's: same rid, prompt, steps
    and sampling knobs, a fresh handle — what a cross-process adopt
    rebuilds from its own front door."""
    out = {}
    for rid, e in frozen["entries"].items():
        r = e.request
        req = req_cls(prompt=np.asarray(r.prompt), steps=r.steps,
                      temperature=r.temperature, top_p=r.top_p,
                      top_k=r.top_k, seed=r.seed, eos=r.eos, rid=rid)
        out[rid] = entry_mod._Entry(req, handle_cls(req), tuple(e.bucket),
                                    e.cost, 0.0)
    return out


def _manifests(blob):
    """The meta chunk's row manifests less the keys that differ between
    packages by nature (trace ids, TTFT, and the rids each package's own
    counter hands out)."""
    meta_len = _MIG_HDR.unpack_from(blob, 0)[3]
    meta = json.loads(blob[_MIG_HDR.size:_MIG_HDR.size + meta_len])
    rows = [{k: v for k, v in r.items()
             if k not in ("trace", "ttft_s", "rid")} for r in meta["rows"]]
    return {k: v for k, v in meta.items() if k != "rows"}, rows


def test_freeze_adopt_across_packages(jparams, tparams, cpu):
    """Tolerance: none. A JAX blob frozen mid-decode adopts into the port's
    engine, and a port blob into JAX's; every row resumes where it was
    frozen and finishes with the tokens of JAX's ``lm_generate`` (greedy)
    and of the uninterrupted JAX engine (sampled). Both freezes capture
    the same manifests and page bodies."""
    tmemledger.reset_ledger()
    specs = _specs()
    with JEngine(jparams, HEADS, start=False, **_engine_kw()) as jsrc, \
            JEngine(jparams, HEADS, **_engine_kw()) as jdst, \
            TEngine(tparams, HEADS, start=False, **_engine_kw()) as tsrc, \
            TEngine(tparams, HEADS, **_engine_kw()) as tdst:
        # the uninterrupted JAX reference, served by the engine that will
        # adopt the port's rows (it is idle again before they arrive)
        ref = [h.result(timeout=WAIT_S).tokens.tolist() for h in
               [jdst.submit(JRequest(**s)) for s in specs]]
        for s, toks in zip(specs, ref):
            if not s.get("temperature"):
                assert toks == _jref(jparams, s["prompt"], s["steps"])
        jfrozen, jhs = _freeze_midstream(jsrc, jfaults, JRequest, specs)
        tfrozen, ths = _freeze_midstream(tsrc, tfaults, TRequest, specs)
        for fr in (jfrozen, tfrozen):
            assert not fr["queued"] and not fr["fallback"]
            assert len(fr["entries"]) == len(specs)
        assert _manifests(jfrozen["blob"]) == _manifests(tfrozen["blob"])
        # (the two freezes' page bodies are each framework's own K/V
        # arithmetic, equal only to rounding; the byte-level contract is
        # test_blob_bytes_equal_and_cross_import's)
        assert all(1 < r["steps_done"] < 8
                   for r in _manifests(jfrozen["blob"])[1])

        # JAX -> port
        tentries = _rebind(jfrozen, tengine, TRequest, THandle)
        res = tdst.adopt_rows({"blob": jfrozen["blob"],
                               "entries": tentries}, timeout=WAIT_S)
        assert sorted(res["adopted"]) == sorted(tentries)
        assert not res["fallback"]
        # port -> JAX
        jentries = _rebind(tfrozen, jengine, JRequest, JHandle)
        res = jdst.adopt_rows({"blob": tfrozen["blob"],
                               "entries": jentries}, timeout=WAIT_S)
        assert sorted(res["adopted"]) == sorted(jentries)
        spec_of = {tuple(s["prompt"]): i for i, s in enumerate(specs)}
        for entries in (tentries, jentries):
            for e in entries.values():
                r = e.handle.result(timeout=WAIT_S)
                assert r.status == STATUS_OK, (r.status, r.reason)
                i = spec_of[tuple(e.request.prompt.tolist())]
                assert r.tokens.tolist() == ref[i]
        assert tdst.metrics.snapshot()["migrated_in"] == len(specs)
        assert tdst.metrics.snapshot()["retries"] == 0
        # the handles the sources held never resolve: their rows moved
        assert not any(h.done() for h in jhs + ths)
        for e in list(jfrozen["entries"].values()):
            jsrc._queue.release(e.cost)
        for e in list(tfrozen["entries"].values()):
            tsrc._queue.release(e.cost)
        tdst.drain()
        audit = tdst.kvpool_audit()
        assert audit["ok"], audit["errors"]
    # the port blob JAX adopted stays the port source's ledger entry until
    # that engine closes and sweeps it: nothing lingers
    led = tmemledger.get_ledger()
    assert led.totals().get("migration", 0) == 0 and led.audit()["ok"]


def test_freeze_adopt_within_port_bit_identical(tparams, jparams, cpu):
    """Port to port, with the queued backlog moving as-is: every request
    one OK Result equal to JAX's ``lm_generate``, no token-0 restart, the
    reservation released on the source, the adopted rows' re-export equal
    to the frozen pages."""
    specs = [dict(prompt=[3, 1 + i % 4, 2], steps=8) for i in range(10)]
    with TEngine(tparams, HEADS, start=False, **_engine_kw()) as a, \
            TEngine(tparams, HEADS, **_engine_kw()) as b:
        frozen, hs = _freeze_midstream(a, tfaults, TRequest, specs)
        assert frozen["queued"] and frozen["entries"]
        res = b.adopt_rows(frozen, timeout=WAIT_S)
        assert not res["fallback"]
        for rid in res["adopted"]:
            a._queue.release(frozen["entries"][rid].cost)
        assert b.adopt_entries(frozen["queued"])
        for e in frozen["queued"]:
            a._queue.release(e.cost)
        for h in hs:
            r = h.result(timeout=WAIT_S)
            assert r.status == STATUS_OK, (r.status, r.reason)
            assert r.tokens.tolist() == _jref(jparams, h.request.prompt, 8)
        assert a._queue.count == 0 and a._queue.bytes_in_flight == 0
        assert b.metrics.snapshot()["retries"] == 0
        assert b.metrics.snapshot()["migrated_in"] == len(res["adopted"])
    assert a.freeze_rows() is None      # terminal: nothing left to freeze


def test_adopt_rows_rejects_wrong_target(tparams, jparams, cpu):
    """adopt_rows on an engine that is not running raises MigrationError;
    the frozen work is intact for a fresh target."""
    specs = [dict(prompt=[3, 1], steps=8) for _ in range(3)]
    with TEngine(tparams, HEADS, start=False, **_engine_kw()) as a, \
            TEngine(tparams, HEADS, **_engine_kw()) as b, \
            TEngine(tparams, HEADS, **_engine_kw()) as c:
        frozen, hs = _freeze_midstream(a, tfaults, TRequest, specs)
        assert frozen["entries"]
        b.drain()
        with pytest.raises(MigrationError, match="not accepting"):
            b.adopt_rows(frozen)
        res = c.adopt_rows(frozen, timeout=WAIT_S)
        for rid in res["adopted"]:
            a._queue.release(frozen["entries"][rid].cost)
        assert c.adopt_entries(frozen["queued"] + res["fallback"])
        for e in frozen["queued"] + res["fallback"]:
            a._queue.release(e.cost)
        for h in hs:
            assert h.result(timeout=WAIT_S).tokens.tolist() == _jref(
                jparams, [3, 1], 8)


def test_freeze_rows_on_unstarted_engine_alike(jparams, tparams, cpu):
    """An engine that never started freezes to the same empty handoff in
    both packages."""
    out = []
    for cls, params in ((JEngine, jparams), (TEngine, tparams)):
        with cls(params, HEADS, start=False, **_engine_kw()) as eng:
            fr = eng.freeze_rows()
            out.append((fr["engine"] is eng, fr["blob"], fr["entries"],
                        fr["queued"], fr["fallback"], fr["ledger_token"],
                        eng._state, eng.freeze_rows()))
    assert out[0] == out[1] == (True, None, {}, [], [], None, "frozen",
                                None)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_prefix_cache_warm_across_packages(jparams, tparams, cpu, direction):
    """One package's hottest prefix chains warm the other's cache: the
    warmed engine's first shared-prompt request hits, and its tokens equal
    JAX's ``lm_generate``."""
    shared = [7, 3, 5, 2, 6, 1, 4, 2]
    jeng = JEngine(jparams, HEADS, **_engine_kw())
    teng = TEngine(tparams, HEADS, **_engine_kw())
    with jeng, teng:
        src, dst, req = ((jeng, teng, TRequest) if direction == "jax_to_port"
                         else (teng, jeng, JRequest))
        src_req = JRequest if src is jeng else TRequest
        assert src.submit(src_req(prompt=shared + [9, 8], steps=2)).result(
            timeout=WAIT_S).ok
        blob = src.export_prefixes(8)
        assert blob is not None
        assert dst.import_prefixes(blob) == 2
        r = dst.submit(req(prompt=shared + [11, 10], steps=2)).result(
            timeout=WAIT_S)
        assert r.ok and r.tokens.tolist() == _jref(jparams,
                                                   shared + [11, 10], 2)
        assert dst.metrics.snapshot()["prefix_hits"] > 0
        assert dst.kvpool_audit()["ok"]
        # the warmed pages equal the source's byte for byte
        assert (teng.export_prefixes(8) == jeng.export_prefixes(8))


# ------------------------------------------------------------------ chaos


def _factory(tparams, **kw):
    def make():
        eng = TEngine(tparams, HEADS, **_engine_kw(**kw))
        eng.warmup()
        return eng
    return make


@pytest.mark.parametrize("leg", ["export:", "import@", "adopt:"])
def test_kill_mid_migration_falls_back_to_retry(tparams, jparams, cpu, leg):
    """A fault on one serve.migrate leg mid-rotation degrades those rows
    to the retry path: every request one OK Result equal to JAX's
    ``lm_generate``, every pool audits clean, the ledger holds no
    migration bytes."""
    tmemledger.reset_ledger()
    router = TRouter(_factory(tparams, max_batch=8), replicas=2,
                     supervisor_kw=dict(backoff_s=0.005, poll_s=0.02),
                     rng=random.Random(11))
    with router:
        with tfaults.injected("serve.decode_step",
                              DelayFault(seconds=0.5, times=2)):
            hs = [router.submit(TRequest(prompt=[3, 1 + i % 4], steps=8))
                  for i in range(6)]
            threading.Event().wait(0.05)          # rows live mid-decode
            with tfaults.injected("serve.migrate",
                                  RaiseFault(times=1, match=leg)):
                rotated = router.rolling_restart()
        assert set(rotated) == {0, 1}
        router.drain()
        for h in hs:
            r = h.result(timeout=WAIT_S)
            assert r.status == STATUS_OK, (r.status, r.reason)
            assert r.tokens.tolist() == _jref(jparams, h.request.prompt, 8)
        for rep in router._replicas:
            audit = rep.engine.kvpool_audit()
            assert audit["ok"], audit["errors"]
        assert router.pending() == 0
        led = tmemledger.get_ledger()
        assert led.audit()["ok"]
        assert led.totals().get("migration", 0) == 0


def test_cache_warm_fault_is_best_effort(tparams, cpu):
    """A serve.migrate fault on the warm leg leaves the cache cold and the
    engine serving: import_prefixes returns 0, never raises."""
    with TEngine(tparams, HEADS, **_engine_kw()) as a, \
            TEngine(tparams, HEADS, **_engine_kw()) as b:
        assert a.submit(TRequest(prompt=[7, 3, 5, 2, 6, 1, 4, 2, 9],
                                 steps=2)).result(timeout=WAIT_S).ok
        blob = a.export_prefixes(4)
        with tfaults.injected("serve.migrate", RaiseFault(times=1,
                                                          match="warm@")):
            assert b.import_prefixes(blob) == 0
        assert b.import_prefixes(blob) == 2
        assert b.import_prefixes(None) == 0 and b.export_prefixes(0) is None


# ------------------------------------------------------------- on the card


def _cuda_params(tparams):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is false)")
    return jax.tree.map(lambda t: t.to("cuda"), tparams)


def _tref(params, prompt, steps):
    from marlin_tpu_torch.models import transformer as tt

    prompt = np.asarray(prompt, np.int32)
    return tt.lm_generate(params, prompt, 0, heads=HEADS,
                          max_len=len(prompt) + steps, steps=steps).tolist()


@pytest.mark.cuda
def test_cuda_rolling_restart_adopts_midstream(tparams):
    """chip_smoke.py phase 25 leg (a) at this width: two replicas on the
    card behind a router, rotated while rows decode; every request one OK
    Result equal to ``lm_generate`` on the card, rows adopted mid-stream,
    the paged kernel launched, clean audits."""
    from marlin_tpu_torch.obs.metrics import get_registry
    from marlin_tpu_torch.ops.paged_attention import paged_decode_attention

    params = _cuda_params(tparams)

    def adopted():
        fam = get_registry()._families.get("marlin_serve_migrations_total")
        return fam.labels(leg="adopt").value if fam is not None else 0.0

    def make():
        eng = TEngine(params, HEADS, **_engine_kw(max_batch=8))
        assert eng._decode_kernel == "pallas"
        eng.warmup()
        return eng

    with config_context(device="cuda"):
        a0, l0 = adopted(), paged_decode_attention.launches
        specs = [dict(prompt=[3, 1 + i % 4, 2, 5 + i % 3], steps=8)
                 for i in range(24)]
        with TRouter(make, replicas=2, rng=random.Random(7),
                     supervisor_kw=dict(backoff_s=0.005,
                                        poll_s=0.02)) as router:
            hs = [router.submit(TRequest(**s)) for s in specs]
            # long rows on the first-rotated replica, its (16, 8) bucket's
            # decode held so they are mid-stream when the rotation freezes
            first = router._replicas[0].engine
            with tfaults.injected("serve.decode_step",
                                  DelayFault(seconds=0.5, times=1,
                                             match="16x8")):
                hs += [first.submit(TRequest(
                    prompt=[2, 4, 6, 1, 3, 5, 2, 4, 6], steps=8))
                    for _ in range(4)]
                threading.Event().wait(0.05)
                assert sorted(router.rolling_restart()) == [0, 1]
            for h in hs:
                r = h.result(timeout=WAIT_S)
                assert r.status == STATUS_OK, (r.status, r.reason)
                assert r.tokens.tolist() == _tref(params, h.request.prompt,
                                                  8)
            router.drain()
            for rep in router._replicas:
                assert rep.engine.kvpool_audit()["ok"]
        assert adopted() > a0
        assert paged_decode_attention.launches > l0


@pytest.mark.cuda
def test_cuda_freeze_adopt_blob_roundtrip(tparams):
    """Phase 25 leg (b) at this width: rows frozen on the card resume on a
    fresh engine with ``lm_generate``'s tokens; the blob imported and
    re-exported through a pool on the card gives the same page bodies; a
    flipped byte is refused."""
    from marlin_tpu_torch.serving import kvpool

    params = _cuda_params(tparams)
    specs = [dict(prompt=[3, 1 + i % 4, 2], steps=8) for i in range(6)]
    with config_context(device="cuda"):
        with TEngine(params, HEADS, start=False, **_engine_kw()) as a, \
                TEngine(params, HEADS, **_engine_kw()) as b:
            frozen, hs = _freeze_midstream(a, tfaults, TRequest, specs)
            blob = frozen["blob"]
            pool = PagedKVPool(params, HEADS, num_pages=64,
                               page_len=PAGE_LEN)
            back = pool.export_rows(pool.import_rows(blob))
            assert ([x for k, x in kvpool._mig_chunks(back)
                     if k == kvpool._MIG_ROW]
                    == [x for k, x in kvpool._mig_chunks(blob)
                        if k == kvpool._MIG_ROW])
            bad = bytearray(blob)
            bad[len(blob) // 2] ^= 0xFF
            with pytest.raises(MigrationCorruptError):
                pool.import_rows(bytes(bad))
            res = b.adopt_rows(frozen, timeout=WAIT_S)
            assert res["adopted"] and not res["fallback"]
            assert b.adopt_entries(frozen["queued"])
            for h in hs:
                r = h.result(timeout=WAIT_S)
                assert r.status == STATUS_OK, (r.status, r.reason)
                assert r.tokens.tolist() == _tref(params, h.request.prompt,
                                                  8)
