"""The port's one-shot serving programs (ALS scoring, PageRank queries,
classification) against the JAX package's, on the CPU.

Engines of both packages are built as ``tests/test_programs.py`` builds
them (``max_wait_ms=0.0`` included) over one tiny LM (vocab 32, d_model 16,
2 heads, 2 layers, seed 9) whose params reach the port through
``interop.lm_params_from_numpy``; the port runs under
``config_context(device="cpu")``. Tolerances: ALS scores and classification
probabilities within 1e-6 of the JAX package's (the same f32 products in
other orders); PageRank ranks within 1e-6. ``torch.topk`` orders tied
scores apart from ``lax.top_k``, so top-k results compare as item sets, as
the reference's own oracle does; LM tokens compare exactly.

The JAX package's ``compile_count`` check has no counterpart in eager
torch; the swap test instead holds that ``swap_model`` keeps every resident
tensor's shape and device and that every result reads one model whole.
Every wait has a timeout and every engine is closed.
"""

import importlib
import threading

import numpy as np
import pytest
import torch

import jax

from marlin_tpu.models import TransformerLM as JaxLM
from marlin_tpu.models import transformer as jt
from marlin_tpu.serving import ALSScoreProgram as JALS
from marlin_tpu.serving import ClassifyProgram as JClassify
from marlin_tpu.serving import PROGRAM_REGISTRY as JREGISTRY
from marlin_tpu.serving import PageRankQueryProgram as JPageRank
from marlin_tpu.serving import Request as JRequest
from marlin_tpu.serving import ServeEngine as JEngine
from marlin_tpu_torch import config_context, interop
from marlin_tpu_torch.models import transformer as tt
from marlin_tpu_torch.serving import (
    PROGRAM_REGISTRY,
    STATUS_ERROR,
    STATUS_OK,
    STATUS_REJECTED,
    STATUS_SHUTTING_DOWN,
    ALSScoreProgram,
    ClassifyProgram,
    PageRankQueryProgram,
    Request,
    ServeEngine,
    available_programs,
)
from marlin_tpu_torch.utils import EventLog, faults
from marlin_tpu_torch.utils.faults import RaiseFault

jnn = importlib.import_module("marlin_tpu.ml.neural_network")
tnn = importlib.import_module("marlin_tpu_torch.ml.neural_network")

HEADS = 2
BUCKETS = ((8, 4),)
WAIT_S = 60.0
TOL = 1e-6

#: node 3 has the highest in-degree, node 0 the next
EDGES = [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 0), (2, 3), (3, 0),
         (3, 1), (4, 3), (4, 0)]


@pytest.fixture(autouse=True)
def _cpu():
    with config_context(device="cpu"):
        yield


@pytest.fixture(autouse=True)
def _no_port_fault_leaks():
    yield
    leaked = faults.active()
    faults.clear()
    assert not leaked, f"port fault(s) leaked across tests: {leaked}"


@pytest.fixture(scope="module")
def jparams():
    return JaxLM(vocab=32, d_model=16, heads=HEADS, layers=2,
                 seed=9).init_params()


@pytest.fixture(scope="module")
def tparams(jparams):
    return interop.lm_params_from_numpy(jax.tree.map(np.asarray, jparams),
                                        device="cpu")


@pytest.fixture()
def factors():
    rng = np.random.default_rng(0)
    uf = rng.normal(size=(20, 4)).astype(np.float32)
    pf = rng.normal(size=(15, 4)).astype(np.float32)
    return uf, pf


def _engine(cls, params, **kw):
    kw.setdefault("buckets", BUCKETS)
    kw.setdefault("max_batch", 4)
    kw.setdefault("max_wait_ms", 0.0)
    kw.setdefault("queue_depth", 64)
    kw.setdefault("page_len", 4)
    kw.setdefault("num_pages", 1024)
    return cls(params, HEADS, **kw)


def _both(jparams, tparams, jprogs, tprogs, **kw):
    return (_engine(JEngine, jparams, programs=jprogs, **kw),
            _engine(ServeEngine, tparams, programs=tprogs, **kw))


def _serve(engines, requests):
    """Warm up and start each engine, submit ``requests`` (keyword dicts) to
    each, and return the Results per engine; closes the engines."""
    out = []
    for eng, req in zip(engines, (JRequest, Request)):
        try:
            eng.warmup()
            eng.start()
            hs = [eng.submit(req(**r)) for r in requests]
            out.append([h.result(timeout=WAIT_S) for h in hs])
        finally:
            eng.close()
    return out


def _tref(params, prompt, steps):
    return tt.lm_generate(params, np.asarray(prompt, np.int32), 0,
                          heads=HEADS, max_len=len(prompt) + steps,
                          steps=steps).tolist()


def _jref(params, prompt, steps):
    return np.asarray(jt.lm_generate(
        params, np.asarray(prompt, np.int32), jax.random.key(0), heads=HEADS,
        max_len=len(prompt) + steps, steps=steps)).tolist()


def _als_oracle(uf, pf, user, k):
    return set(np.argsort(-(uf[user] @ pf.T), kind="stable")[:k].tolist())


# ------------------------------------------------------------------ registry


def test_registry_lists_builtin_programs():
    assert set(available_programs()) == set(JREGISTRY)
    for name in ("als", "classify", "pagerank", "lm"):
        assert PROGRAM_REGISTRY[name].name == name


def test_duplicate_program_name_rejected(tparams, factors):
    with pytest.raises(ValueError, match="duplicate program"):
        _engine(ServeEngine, tparams, start=False,
                programs=[ALSScoreProgram(factors), ALSScoreProgram(factors)])


# ---------------------------------------------------------------- programs


def test_als_results_match_jax(jparams, tparams, factors):
    uf, pf = factors
    reqs = [dict(program="als", payload={"user": u, "k": k})
            for u in range(6) for k in (1, 3, 8)]
    jr, tr = _serve(_both(jparams, tparams, [JALS((uf, pf))],
                          [ALSScoreProgram((uf, pf))]), reqs)
    for q, a, b in zip(reqs, jr, tr):
        assert a.status == b.status == STATUS_OK, (b.status, b.reason)
        u, k = q["payload"]["user"], q["payload"]["k"]
        assert len(b.value["items"]) == k
        assert set(b.value["items"].tolist()) == _als_oracle(uf, pf, u, k)
        assert set(b.value["items"].tolist()) == set(a.value["items"].tolist())
        np.testing.assert_allclose(b.value["scores"], a.value["scores"],
                                   atol=TOL)
        assert list(b.value["scores"]) == sorted(b.value["scores"],
                                                 reverse=True)


def test_program_rejections_are_clean(jparams, tparams, factors):
    cases = [
        (dict(program="nosuch", payload={}), "unknown program"),
        (dict(program="als", payload={"user": 999}), "out of range"),
        (dict(program="als", payload={"user": 0, "k": 999}),
         "no bucket fits"),
        (dict(program="als", payload={"user": 0, "k": 0}), "k must be"),
        (dict(program="als", payload=[1]), "needs payload"),
        (dict(program="classify", payload={"x": np.ones(3)}),
         "feature vector has 3 dims"),
        (dict(program="pagerank", payload={"node": 7}), "out of range"),
    ]
    w = np.ones(6, np.float32)
    engines = _both(jparams, tparams,
                    [JALS(factors), JClassify(w), JPageRank(EDGES, n=5)],
                    [ALSScoreProgram(factors), ClassifyProgram(w),
                     PageRankQueryProgram(EDGES, n=5)])
    jr, tr = _serve(engines, [c for c, _ in cases])
    for (_, needle), a, b in zip(cases, jr, tr):
        assert b.status == a.status == STATUS_REJECTED, (needle, b.reason)
        assert needle in b.reason and b.reason == a.reason


def test_classify_logreg_matches_jax(jparams, tparams):
    rng = np.random.default_rng(3)
    w = rng.normal(size=(6,)).astype(np.float32)   # intercept + 5 features
    xs = rng.normal(size=(5, 5)).astype(np.float32)
    from marlin_tpu_torch.ml import LogisticRegressionModel

    reqs = [dict(program="classify", payload={"x": x}) for x in xs]
    jr, tr = _serve(_both(jparams, tparams, [JClassify(w)],
                          [ClassifyProgram(LogisticRegressionModel(w))]),
                    reqs)
    for x, a, b in zip(xs, jr, tr):
        assert b.status == STATUS_OK, b.reason
        want = 1.0 / (1.0 + np.exp(-(w[0] + x @ w[1:])))
        assert abs(b.value["proba"] - want) < 1e-5
        assert abs(b.value["proba"] - a.value["proba"]) < TOL
        assert b.value["label"] == a.value["label"] == int(want >= 0.5)


def test_classify_mlp_multiclass_matches_jax(jparams, tparams):
    jmlp = jnn.mlp_init(jax.random.key(1), (4, 8, 3))
    tmlp = tnn.mlp_init(1, (4, 8, 3))
    rng = np.random.default_rng(4)
    reqs = [dict(program="classify", payload={"x": rng.normal(size=4)})
            for _ in range(6)]
    jr, tr = _serve(_both(jparams, tparams,
                          [JClassify(jmlp, activation="relu")],
                          [ClassifyProgram(tmlp, activation="relu")]), reqs)
    for a, b in zip(jr, tr):
        assert b.status == STATUS_OK, b.reason
        assert b.value["proba"].shape == (3,)
        np.testing.assert_allclose(b.value["proba"], a.value["proba"],
                                   atol=TOL)
        assert b.value["label"] == a.value["label"] == int(
            np.argmax(b.value["proba"]))
    for cls in (JClassify, ClassifyProgram):
        with pytest.raises(ValueError, match="w0"):
            cls({"w1": np.ones((4, 3), np.float32)})
        with pytest.raises(ValueError, match="unknown activation"):
            cls({"w0": np.ones((4, 3), np.float32)}, activation="sigmod")
        with pytest.raises(ValueError, match="intercept"):
            cls(np.ones(1, np.float32))


def test_pagerank_refresh_changes_rankings(jparams, tparams):
    jpr, tpr = JPageRank(EDGES, n=5), PageRankQueryProgram(EDGES, n=5)
    q = dict(program="pagerank", payload={"node": 0, "k": 2})
    tops = []
    for eng, prog, req in zip(_both(jparams, tparams, [jpr], [tpr]),
                              (jpr, tpr), (JRequest, Request)):
        try:
            eng.warmup()
            eng.start()
            before = eng.submit(req(**q)).result(timeout=WAIT_S)
            assert before.status == STATUS_OK, before.reason
            assert set(before.value["items"].tolist()) <= {1, 2, 3}
            np.testing.assert_allclose(prog.ranks(), np.full(5, 0.2),
                                       atol=1e-6)
            ranks = prog.refresh(iterations=20)
            assert prog.refresh_count == 1 and ranks[3] > ranks[1]
            after = eng.submit(req(**q)).result(timeout=WAIT_S)
            tops.append((ranks, after.value))
        finally:
            eng.close()
    (jranks, jv), (tranks, tv) = tops
    np.testing.assert_allclose(tranks, jranks, atol=TOL)
    assert tv["items"][0] == jv["items"][0] == 3
    assert set(tv["items"].tolist()) == set(jv["items"].tolist()) == {
        3, int(np.argmax(np.where(np.isin(np.arange(5), [1, 2]), tranks,
                                  -np.inf)))}
    np.testing.assert_allclose(tv["scores"], jv["scores"], atol=TOL)


def test_pagerank_fewer_neighbors_than_k(tparams):
    prog = PageRankQueryProgram(EDGES, n=6)  # node 5: no out-edges
    with _engine(ServeEngine, tparams, programs=[prog]) as eng:
        eng.warmup()
        r = eng.submit(Request(program="pagerank",
                               payload={"node": 5, "k": 3})).result(
                                   timeout=WAIT_S)
        one = eng.submit(Request(program="pagerank",
                                 payload={"node": 2, "k": 8})).result(
                                     timeout=WAIT_S)
    assert r.status == STATUS_OK and len(r.value["items"]) == 0
    assert sorted(one.value["items"].tolist()) == [0, 3]


# ------------------------------------------------------------- mixed traffic


def test_mixed_traffic_exactly_once_and_lm_equal(jparams, tparams, factors,
                                                 tmp_path):
    """Four request types through one engine of each package: every handle
    reaches exactly one ok Result, LM greedy tokens equal ``lm_generate``
    (both packages'), program values match their oracles and each other,
    and the port's event stream and metrics carry the program labels."""
    rng = np.random.default_rng(7)
    uf, pf = factors
    w = rng.normal(size=(6,)).astype(np.float32)
    reqs, kinds = [], []
    for i in range(4):
        reqs.append(dict(prompt=rng.integers(1, 30, size=5).astype(np.int32),
                         steps=3))
        kinds.append("lm")
    for i in range(6):
        reqs.append(dict(program="als", payload={"user": i, "k": 3}))
        kinds.append("als")
    for i in range(4):
        reqs.append(dict(program="pagerank", payload={"node": i, "k": 2}))
        kinds.append("pagerank")
    for i in range(4):
        reqs.append(dict(program="classify",
                         payload={"x": rng.normal(size=5)}))
        kinds.append("classify")
    log = EventLog(str(tmp_path / "serve.jsonl"))
    jeng = _engine(JEngine, jparams, programs=[
        JALS((uf, pf)), JPageRank(EDGES, n=5), JClassify(w)])
    teng = _engine(ServeEngine, tparams, log=log, programs=[
        ALSScoreProgram((uf, pf)), PageRankQueryProgram(EDGES, n=5),
        ClassifyProgram(w)])
    snap = {}
    jr, tr = [], []
    for eng, req, out in ((jeng, JRequest, jr), (teng, Request, tr)):
        try:
            eng.warmup()
            eng.start()
            hs = [eng.submit(req(**r)) for r in reqs]
            out.extend(h.result(timeout=120) for h in hs)
            snap = eng.metrics.snapshot()
        finally:
            eng.close()
    for kind, q, a, b in zip(kinds, reqs, jr, tr):
        assert a.status == b.status == STATUS_OK, (kind, b.status, b.reason)
        if kind == "lm":
            assert b.tokens.tolist() == _tref(tparams, q["prompt"], 3) == \
                _jref(jparams, q["prompt"], 3) == a.tokens.tolist()
        elif kind == "als":
            assert set(b.value["items"].tolist()) == _als_oracle(
                uf, pf, q["payload"]["user"], 3)
        elif kind == "pagerank":
            assert set(b.value["items"].tolist()) == set(
                a.value["items"].tolist())
            assert len(b.value["items"]) == 2
        else:
            assert abs(b.value["proba"] - a.value["proba"]) < TOL
    assert snap["completed"] == len(reqs)
    assert snap["program_steps"] >= 3
    assert snap["program_rows"] == 14
    recs = [r for r in log.read() if r["kind"] == "serve"]
    by_rid = {r["rid"]: r for r in recs if r.get("ev") == "result"}
    progs = [r.get("program") for r in by_rid.values()]
    assert progs.count(None) == 4
    assert sorted(p for p in progs if p) == \
        ["als"] * 6 + ["classify"] * 4 + ["pagerank"] * 4
    steps = [r for r in recs if r.get("ev") == "step" and r.get("program")]
    assert steps and all(r["new_tokens"] == 0 for r in steps)


def test_mixed_concurrent_submitters_exactly_once(tparams, factors):
    uf, pf = factors
    eng = _engine(ServeEngine, tparams, programs=[ALSScoreProgram((uf, pf))])
    eng.warmup()
    handles, lock = [], threading.Lock()

    def pump_lm():
        for i in range(8):
            h = eng.submit(Request(prompt=[3, 1 + i % 4], steps=2))
            with lock:
                handles.append(("lm", [3, 1 + i % 4], h))

    def pump_als():
        for i in range(8):
            h = eng.submit(Request(program="als",
                                   payload={"user": i % 5, "k": 3}))
            with lock:
                handles.append(("als", i % 5, h))

    try:
        eng.start()
        threads = [threading.Thread(target=pump_lm),
                   threading.Thread(target=pump_als)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(WAIT_S)
        assert len(handles) == 16
        for kind, arg, h in handles:
            r = h.result(timeout=120)
            assert r.status == STATUS_OK, (kind, r.status, r.reason)
            if kind == "lm":
                assert r.tokens.tolist() == _tref(tparams, arg, 2)
            else:
                assert set(r.value["items"].tolist()) == _als_oracle(
                    uf, pf, arg, 3)
    finally:
        eng.close()
    assert eng.pending() == 0
    assert eng.kvpool_audit().get("leaked_pages", 0) == 0


# -------------------------------------------------------------------- swap


def test_swap_model_keeps_shapes_and_is_atomic(tparams, factors):
    uf, pf = factors
    als = ALSScoreProgram((uf, pf))
    mlp = ClassifyProgram(tnn.mlp_init(1, (4, 8, 3)))
    eng = _engine(ServeEngine, tparams, programs=[als, mlp])
    old = {u: _als_oracle(uf, pf, u, 3) for u in range(20)}
    new = {u: _als_oracle(-uf, pf, u, 3) for u in range(20)}
    try:
        eng.warmup()
        eng.start()
        r = eng.submit(Request(program="als", payload={"user": 0, "k": 3}))
        assert set(r.result(timeout=WAIT_S).value["items"].tolist()) == old[0]
        shapes = (als._uf.shape, als._pf.shape, als._uf.device)
        # requests in flight across the swap read one model whole
        during = [(u, eng.submit(Request(program="als",
                                         payload={"user": u, "k": 3})))
                  for u in range(20)]
        eng.swap_model("als", (uf * -1.0, pf))
        after = [(u, eng.submit(Request(program="als",
                                        payload={"user": u, "k": 3})))
                 for u in range(20)]
        assert (als._uf.shape, als._pf.shape, als._uf.device) == shapes
        for u, h in during:
            got = set(h.result(timeout=WAIT_S).value["items"].tolist())
            assert got in (old[u], new[u]), u
        for u, h in after:
            got = set(h.result(timeout=WAIT_S).value["items"].tolist())
            assert got == new[u], u
        assert als.swap_count == 1
        mshapes = {k: v.shape for k, v in mlp._params.items()}
        eng.swap_model("classify", tnn.mlp_init(2, (4, 8, 3)))
        assert {k: v.shape for k, v in mlp._params.items()} == mshapes
        assert mlp.swap_count == 1
        assert eng.metrics.snapshot()["swaps"] == 2
        with pytest.raises(ValueError, match="unknown program"):
            eng.swap_model("nosuch", (uf, pf))
        with pytest.raises(ValueError, match="no swap_model hook"):
            eng.swap_model("lm", tparams)
        with pytest.raises(ValueError, match="shape"):
            eng.swap_model("als", (uf[:3], pf))
        with pytest.raises(ValueError, match="shape"):
            eng.swap_model("classify", tnn.mlp_init(2, (4, 8, 2)))
    finally:
        eng.close()


# --------------------------------------------------------------- lifecycle


def test_close_retires_queued_program_rows_shutting_down(tparams, factors):
    eng = _engine(ServeEngine, tparams, start=False,
                  programs=[ALSScoreProgram(factors)])
    hs = [eng.submit(Request(program="als", payload={"user": i, "k": 3}))
          for i in range(3)]
    eng.close()
    for h in hs:
        r = h.result(timeout=5)
        assert r.status == STATUS_SHUTTING_DOWN and "closed" in r.reason
    assert eng.pending() == 0
    r = eng.submit(Request(program="als",
                           payload={"user": 0, "k": 3})).result(timeout=5)
    assert r.status == STATUS_SHUTTING_DOWN


def test_drain_completes_accepted_program_rows(tparams, factors):
    uf, pf = factors
    eng = _engine(ServeEngine, tparams, programs=[ALSScoreProgram((uf, pf))])
    try:
        eng.warmup()
        eng.start()
        hs = [eng.submit(Request(program="als", payload={"user": i, "k": 3}))
              for i in range(5)]
        eng.drain()
        for i, h in enumerate(hs):
            r = h.result(timeout=WAIT_S)
            assert r.status == STATUS_OK, (i, r.status, r.reason)
            assert set(r.value["items"].tolist()) == _als_oracle(uf, pf, i, 3)
        r = eng.submit(Request(program="als",
                               payload={"user": 0, "k": 3})).result(timeout=5)
        assert r.status == STATUS_SHUTTING_DOWN and "draining" in r.reason
    finally:
        eng.close()


# -------------------------------------------------------------------- chaos


def test_program_step_fault_retries_within_budget(tparams, factors):
    uf, pf = factors
    eng = _engine(ServeEngine, tparams, programs=[ALSScoreProgram((uf, pf))])
    try:
        eng.warmup()
        with faults.injected("serve.program_step", RaiseFault(times=1)):
            hs = [eng.submit(Request(program="als", max_attempts=3,
                                     payload={"user": i, "k": 3}))
                  for i in range(3)]
            lm = eng.submit(Request(prompt=[3, 1], steps=2))
            eng.start()
            for i, h in enumerate(hs):
                r = h.result(timeout=120)
                assert r.status == STATUS_OK, (i, r.status, r.reason)
                assert set(r.value["items"].tolist()) == _als_oracle(
                    uf, pf, i, 3)
            assert lm.result(timeout=120).status == STATUS_OK
        assert eng.metrics.snapshot()["retries"] >= 1
    finally:
        eng.close()
    assert eng.kvpool_audit().get("leaked_pages", 0) == 0


def test_program_step_fault_exhausted_budget_is_clean_error(tparams, factors):
    eng = _engine(ServeEngine, tparams, programs=[ALSScoreProgram(factors)])
    try:
        eng.warmup()
        with faults.injected("serve.program_step", RaiseFault(times=8)):
            h = eng.submit(Request(program="als", max_attempts=1,
                                   payload={"user": 0, "k": 3}))
            eng.start()
            r = h.result(timeout=120)
        assert r.status == STATUS_ERROR
        assert "program step failed" in r.reason
        ok = eng.submit(Request(program="als", payload={"user": 1, "k": 3}))
        assert ok.result(timeout=WAIT_S).status == STATUS_OK
    finally:
        eng.close()


# ------------------------------------------------------------- on the card


@pytest.mark.cuda
def test_cuda_programs_beside_lm(tparams, factors):
    """The three programs on the card beside LM rows: values equal the
    numpy oracles, LM tokens equal ``lm_generate`` on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is false)")
    uf, pf = factors
    params = jax.tree.map(lambda t: t.to("cuda"), tparams)
    w = np.linspace(-1, 1, 6).astype(np.float32)
    with config_context(device="cuda"):
        progs = [ALSScoreProgram((uf, pf)), PageRankQueryProgram(EDGES, n=5),
                 ClassifyProgram(w)]
        assert all(p._device.type == "cuda" for p in progs[2:])
        with _engine(ServeEngine, params, programs=progs) as eng:
            eng.warmup()
            hs = [eng.submit(Request(program="als",
                                     payload={"user": u, "k": 3}))
                  for u in range(6)]
            x = np.ones(5, np.float32)
            hc = eng.submit(Request(program="classify", payload={"x": x}))
            lm = eng.submit(Request(prompt=[3, 1, 4], steps=3))
            for u, h in enumerate(hs):
                assert set(h.result(timeout=WAIT_S).value["items"].tolist()) \
                    == _als_oracle(uf, pf, u, 3)
            want = 1.0 / (1.0 + np.exp(-(w[0] + x @ w[1:])))
            assert abs(hc.result(timeout=WAIT_S).value["proba"] - want) < 1e-5
            assert lm.result(timeout=WAIT_S).tokens.tolist() == _tref(
                params, [3, 1, 4], 3)
