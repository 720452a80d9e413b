"""The port's ServeEngine against the JAX package's, on the CPU.

One tiny LM (tests/test_paging.py's: vocab 32, d_model 16, 2 heads, 2
layers, seed 9) serves through ``marlin_tpu.serving.ServeEngine`` and, with
its parameters carried across by ``interop.lm_params_from_numpy``, through
``marlin_tpu_torch.serving.ServeEngine`` under ``config_context(device=
"cpu")``, both at buckets ((8, 4), (16, 4)), page_len 4 and max_batch 4. The
same seeded request set — greedy and sampled rows, ragged prompts, an
``eos``, a shared system prompt — is staged on an engine that has not
started (``start=False``), so both schedulers see the same queue, and must
give, exactly:

- every Result's status and tokens equal across the packages;
- greedy tokens equal to each package's ``lm_generate``;
- equal prefix-cache hit counts, and clean ``kvpool_audit()``s;
- the same rejection reason over ``queue_depth``, and ``shutting_down``
  for requests still queued at ``close()``;
- the same tokens, one Result per request, after an injected
  ``serve.prefill`` or ``serve.decode_step`` fault with ``max_attempts=2``;
- equal ``marlin_serve_*`` family names on ``/metrics``;
- no compile in the port over a serve.

Every wait has a timeout and every engine is closed by ``with``, so a hang
fails a test instead of stalling the run.
"""

import numpy as np
import pytest
import torch

import jax

from marlin_tpu.models import TransformerLM as JaxLM
from marlin_tpu.models import transformer as jt
from marlin_tpu.obs import metrics as jmetrics
from marlin_tpu.serving import Request as JRequest
from marlin_tpu.serving import ServeEngine as JEngine
from marlin_tpu.utils import faults as jfaults
from marlin_tpu_torch import config_context, interop
from marlin_tpu_torch.models import transformer as tt
from marlin_tpu_torch.obs import collectors as tcollectors
from marlin_tpu_torch.obs import metrics as tmetrics
from marlin_tpu_torch.serving import Request as TRequest
from marlin_tpu_torch.serving import ServeEngine as TEngine
from marlin_tpu_torch.utils import faults as tfaults

HEADS = 2
BUCKETS = ((8, 4), (16, 4))
PAGE_LEN = 4
VOCAB = 32
WAIT_S = 60.0


@pytest.fixture(autouse=True)
def _no_port_fault_leaks():
    """The port's fault registry is its own (tests/conftest.py checks only
    the JAX package's): nothing injected may outlive a test."""
    yield
    leaked = tfaults.active()
    tfaults.clear()
    assert not leaked, f"port fault(s) leaked across tests: {leaked}"


@pytest.fixture(scope="module")
def jparams():
    return JaxLM(vocab=VOCAB, d_model=16, heads=HEADS, layers=2,
                 seed=9).init_params()


@pytest.fixture(scope="module")
def tparams(jparams):
    return interop.lm_params_from_numpy(jax.tree.map(np.asarray, jparams),
                                        device="cpu")


@pytest.fixture
def cpu():
    with config_context(device="cpu"):
        yield


def _jref(params, prompt, steps):
    return np.asarray(jt.lm_generate(
        params, np.asarray(prompt, np.int32), jax.random.key(0),
        heads=HEADS, max_len=len(prompt) + steps, steps=steps)).tolist()


def _tref(params, prompt, steps):
    return tt.lm_generate(params, np.asarray(prompt, np.int32), 0,
                          heads=HEADS, max_len=len(prompt) + steps,
                          steps=steps).tolist()


def _specs(ref, seed=0):
    """The seeded request set as keyword dicts: 6 ragged greedy rows, 4
    sampled rows (their own seeds, temperature/top_k/top_p mixed), one
    greedy row whose ``eos`` is its own second generated token (so it stops
    early), and 6 rows of the 16-token bucket sharing an 8-token system
    prompt (two full pages) — the later ones admit after the first wave's
    prefill and hit the prefix cache. ``ref(prompt, steps)`` is the greedy
    reference that picks the eos."""
    rng = np.random.default_rng(seed)
    specs = []
    for _ in range(6):
        n = int(rng.integers(1, 15))
        specs.append(dict(prompt=rng.integers(0, VOCAB, n).astype(np.int32),
                          steps=int(rng.integers(1, 5))))
    for i in range(4):
        n = int(rng.integers(2, 15))
        specs.append(dict(prompt=rng.integers(0, VOCAB, n).astype(np.int32),
                          steps=4, temperature=0.8, seed=100 + i,
                          top_k=(None, 8)[i % 2],
                          top_p=(None, 0.9)[i // 2 % 2]))
    p = rng.integers(0, VOCAB, 6).astype(np.int32)
    specs.append(dict(prompt=p, steps=4,
                      eos=int(ref(p, 4)[len(p) + 1])))
    system = rng.integers(0, VOCAB, 8).astype(np.int32)
    for _ in range(6):
        tail = rng.integers(0, VOCAB, int(rng.integers(1, 8)))
        specs.append(dict(prompt=np.concatenate([system, tail]).astype(
            np.int32), steps=int(rng.integers(2, 5))))
    return specs


def _engine_kw(**kw):
    kw.setdefault("buckets", BUCKETS)
    kw.setdefault("max_batch", 4)
    kw.setdefault("queue_depth", 64)
    kw.setdefault("page_len", PAGE_LEN)
    return kw


def _serve(engine_cls, request_cls, params, specs, **kw):
    """Stage ``specs`` on a fresh engine before its worker starts, then
    serve them; returns (results, engine) with the engine closed."""
    with engine_cls(params, HEADS, start=False, **_engine_kw(**kw)) as eng:
        hs = [eng.submit(request_cls(**s)) for s in specs]
        eng.start()
        rs = [h.result(timeout=WAIT_S) for h in hs]
    return rs, eng


def _both(jparams, tparams, specs, **kw):
    jr, je = _serve(JEngine, JRequest, jparams, specs, **kw)
    with config_context(device="cpu"):
        tr, te = _serve(TEngine, TRequest, tparams, specs, **kw)
    return jr, je, tr, te


def _outcomes(results):
    return [(r.status, None if r.tokens is None else r.tokens.tolist())
            for r in results]


@pytest.mark.parametrize("prefill_chunk", [4, 8])
def test_serve_matches_jax_engine(jparams, tparams, prefill_chunk):
    specs = _specs(lambda p, n: _jref(jparams, p, n))
    before = tcollectors.compile_count()
    jr, je, tr, te = _both(jparams, tparams, specs,
                           prefill_chunk=prefill_chunk)
    assert tcollectors.compile_count() == before
    assert _outcomes(tr) == _outcomes(jr)
    assert all(r.status == "ok" for r in tr)
    with config_context(device="cpu"):
        for s, a, b in zip(specs, jr, tr):
            if s.get("temperature"):
                continue
            n, steps = len(s["prompt"]), s["steps"]
            if s.get("eos") is not None:
                assert a.tokens.tolist()[-1] == s["eos"]
                steps = len(a.tokens) - n
            assert a.tokens.tolist() == _jref(jparams, s["prompt"], steps)
            assert b.tokens.tolist() == _tref(tparams, s["prompt"], steps)
    assert te.metrics.prefix_hits == je.metrics.prefix_hits > 0
    assert te.metrics.prefix_misses == je.metrics.prefix_misses
    ja, ta = je.kvpool_audit(), te.kvpool_audit()
    assert ja["ok"] and ta["ok"], (ja["errors"], ta["errors"])
    assert {k: ta[k] for k in ("used", "cached", "hits", "misses")} == \
        {k: ja[k] for k in ("used", "cached", "hits", "misses")}


def test_queue_depth_rejects_alike(jparams, tparams):
    specs = [dict(prompt=np.arange(1, 4 + i, dtype=np.int32), steps=2)
             for i in range(3)]
    reasons = []
    for cls, req, params in ((JEngine, JRequest, jparams),
                             (TEngine, TRequest, tparams)):
        with config_context(device="cpu"):
            with cls(params, HEADS, start=False,
                     **_engine_kw(queue_depth=2)) as eng:
                hs = [eng.submit(req(**s)) for s in specs]
                third = hs[2].result(timeout=WAIT_S)
                eng.start()
                done = [h.result(timeout=WAIT_S) for h in hs[:2]]
        assert third.status == "rejected"
        assert [r.status for r in done] == ["ok", "ok"]
        reasons.append(third.reason)
    assert reasons[0] == reasons[1]


def test_close_retires_queued_alike(jparams, tparams):
    specs = [dict(prompt=np.arange(1, 6, dtype=np.int32), steps=3)
             for _ in range(3)]
    got = []
    for cls, req, params in ((JEngine, JRequest, jparams),
                             (TEngine, TRequest, tparams)):
        with config_context(device="cpu"):
            eng = cls(params, HEADS, start=False, **_engine_kw())
            try:
                hs = [eng.submit(req(**s)) for s in specs]
            finally:
                eng.close()
            rs = [h.result(timeout=WAIT_S) for h in hs]
            late = eng.submit(req(**specs[0])).result(timeout=WAIT_S)
        got.append(([(r.status, r.reason) for r in rs],
                    (late.status, late.reason)))
    assert got[0] == got[1]
    assert {s for s, _ in got[1][0]} == {"shutting_down"}


@pytest.mark.parametrize("point", ["serve.prefill", "serve.decode_step"])
def test_fault_retry_keeps_tokens(jparams, tparams, point):
    specs = [dict(s, max_attempts=2)
             for s in _specs(lambda p, n: _jref(jparams, p, n), seed=1)[:8]]
    clean = _outcomes(_serve(JEngine, JRequest, jparams, specs,
                             prefill_chunk=4)[0])
    with jfaults.injected(point, jfaults.RaiseFault(times=1)):
        jr, je = _serve(JEngine, JRequest, jparams, specs, prefill_chunk=4)
    with config_context(device="cpu"), \
            tfaults.injected(point, tfaults.RaiseFault(times=1)):
        tr, te = _serve(TEngine, TRequest, tparams, specs, prefill_chunk=4)
    assert _outcomes(tr) == _outcomes(jr) == clean
    assert te.metrics.retries == je.metrics.retries >= 1
    assert te.metrics.completed == je.metrics.completed == len(specs)
    assert te.kvpool_audit()["ok"] and je.kvpool_audit()["ok"]


def _families(engine, registry):
    """The families an engine's ServeMetrics records into, each checked to
    render on the package's ``/metrics`` text (the registry is process-wide,
    so families other code registered are left out of the comparison)."""
    names = sorted(f.name for f in vars(engine.metrics).values()
                   if hasattr(f, "labelnames"))
    text = registry.render()
    missing = [n for n in names if f"# TYPE {n} " not in text]
    assert not missing, missing
    return names


def test_serve_metric_families_match(jparams, tparams):
    specs = _specs(lambda p, n: _jref(jparams, p, n))[:4]
    _, je, _, te = _both(jparams, tparams, specs)
    fams = _families(te, tmetrics.get_registry())
    assert fams == _families(je, jmetrics.get_registry())
    assert "marlin_serve_kv_pages_used" in fams
    assert "marlin_serve_prefix_cache_total" in fams


@pytest.mark.parametrize("wait_ms", [0.0, 1.0])
def test_max_wait_ms_accepted_alike(jparams, tparams, wait_ms):
    """``ServeEngine(max_wait_ms=...)`` reaches each package's batcher as
    seconds, and row-level scheduling serves the same tokens whatever its
    value."""
    specs = [dict(prompt=np.arange(1, 6, dtype=np.int32), steps=3)]
    jr, je, tr, te = _both(jparams, tparams, specs, max_wait_ms=wait_ms)
    assert je._former.max_wait == te._former.max_wait == wait_ms / 1e3
    assert _outcomes(tr) == _outcomes(jr)
    assert tr[0].tokens.tolist() == _tref(tparams, specs[0]["prompt"], 3)


def test_max_wait_ms_knob_and_refusal_alike(jparams, tparams):
    """The ``serve_max_wait_ms`` knob (default 10 ms in both) fills an
    unset ``max_wait_ms``; a negative wait is refused by both engines and
    both batchers, with the same message."""
    import marlin_tpu as jm
    from marlin_tpu.serving import BatchFormer as JFormer
    from marlin_tpu_torch.config import MarlinConfig
    from marlin_tpu_torch.serving import BatchFormer as TFormer

    assert MarlinConfig().serve_max_wait_ms == \
        jm.config.MarlinConfig().serve_max_wait_ms == 10.0
    waits = []
    for cls, params, ctx in ((JEngine, jparams, jm.config_context),
                             (TEngine, tparams, config_context)):
        with config_context(device="cpu"), ctx(serve_max_wait_ms=2.5):
            with cls(params, HEADS, start=False, **_engine_kw()) as eng:
                waits.append(eng._former.max_wait)
    assert waits == [2.5e-3, 2.5e-3]
    msgs = []
    for cls, params in ((JEngine, jparams), (TEngine, tparams)):
        with config_context(device="cpu"):
            with pytest.raises(ValueError, match="max_wait must be >= 0") \
                    as err:
                cls(params, HEADS, start=False, max_wait_ms=-1.0,
                    **_engine_kw())
        msgs.append(str(err.value))
    for former in (JFormer, TFormer):
        assert former(BUCKETS, 8, max_wait=0.0).max_wait == 0.0
        assert former(BUCKETS, 8).max_wait == 0.0
        with pytest.raises(ValueError, match="max_wait must be >= 0") as err:
            former(BUCKETS, 8, max_wait=-0.5)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1] and msgs[2] == msgs[3]


def test_port_engine_refuses_what_is_not_ported(tparams, cpu):
    for kw, item in ((dict(paged=False), "item 7"),
                     (dict(moe=(2, 1)), "item 12")):
        with pytest.raises(NotImplementedError, match=item):
            TEngine(tparams, HEADS, start=False, **_engine_kw(**kw))
    with config_context(serve_slo=({"name": "x"},)):
        with pytest.raises(NotImplementedError, match="item 9"):
            TEngine(tparams, HEADS, start=False, **_engine_kw())
    with TEngine(tparams, HEADS, start=False, **_engine_kw()) as eng:
        with pytest.raises(NotImplementedError, match="item 8"):
            eng.freeze_rows()
        assert eng._decode_kernel == "gather"


# ------------------------------------------------------------- on the card


@pytest.mark.cuda
def test_cuda_engine_serves_mixed_load(tparams):
    """Leg (a) of chip_smoke.py's phase 18 at this width: the engine on the
    card with the CUDA decode kernel; greedy rows equal lm_generate on the
    card, sampled rows equal the same request served alone."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is false)")
    from marlin_tpu_torch.ops.paged_attention import paged_decode_attention

    params = jax.tree.map(lambda t: t.to("cuda"), tparams)
    with config_context(device="cuda"):
        specs = _specs(lambda p, n: _tref(params, p, n))
        launches = paged_decode_attention.launches
        rs, eng = _serve(TEngine, TRequest, params, specs)
        assert eng._decode_kernel == "pallas"
        assert paged_decode_attention.launches > launches
        assert eng.kvpool_audit()["ok"]
        for s, r in zip(specs, rs):
            assert r.status == "ok", r.reason
            if s.get("temperature"):
                solo, _ = _serve(TEngine, TRequest, params, [s])
                assert r.tokens.tolist() == solo[0].tokens.tolist()
            elif s.get("eos") is None:
                assert r.tokens.tolist() == _tref(params, s["prompt"],
                                                  s["steps"])



def test_tf32_gate_keeps_other_threads_out():
    """ops.local.precision_scope is a gate between threads: while one thread
    holds a TF32-off scope (the engine's worker in a decode step), a thread
    asking for TF32 waits, and the flag reads as each holder set it."""
    import threading

    from marlin_tpu_torch.ops.local import precision_scope

    flags = torch.backends.cuda.matmul
    start = flags.allow_tf32
    inside, release, entered = (threading.Event() for _ in range(3))
    seen = []

    def holder():
        with precision_scope("highest"):
            inside.set()
            release.wait(10)
            seen.append(("holder", flags.allow_tf32))

    def asker():
        with precision_scope("default"):
            entered.set()
            seen.append(("asker", flags.allow_tf32))
            with precision_scope("highest"):  # nested switch, sole holder
                seen.append(("nested", flags.allow_tf32))
            seen.append(("asker", flags.allow_tf32))

    a = threading.Thread(target=holder)
    a.start()
    assert inside.wait(10)
    b = threading.Thread(target=asker)
    b.start()
    assert not entered.wait(0.2)  # held out while the holder is inside
    release.set()
    a.join(10)
    b.join(10)
    assert not a.is_alive() and not b.is_alive()
    assert seen == [("holder", False), ("asker", True), ("nested", False),
                    ("asker", True)]
    assert flags.allow_tf32 == start


def test_tf32_gate_under_thread_stress():
    """More threads than cores enter scopes of both settings, nested and
    not, with a tiny switch interval: inside every scope the flag is that
    scope's setting, and after all leave it is back where it started."""
    import os
    import sys
    import threading

    from marlin_tpu_torch.ops.local import precision_scope

    flags = torch.backends.cuda.matmul
    start = flags.allow_tf32
    wrong = []

    def worker(k):
        for i in range(60):
            outer = ("highest", "default")[(i + k) % 2]
            with precision_scope(outer):
                if flags.allow_tf32 != (outer == "default"):
                    wrong.append((k, i, outer))
                if i % 3 == 0:
                    inner = ("default", "highest")[(i + k) % 2]
                    with precision_scope(inner):
                        if flags.allow_tf32 != (inner == "default"):
                            wrong.append((k, i, inner))
                    if flags.allow_tf32 != (outer == "default"):
                        wrong.append((k, i, outer, "after"))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(k,))
                   for k in range(min(64, (os.cpu_count() or 4) + 4))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not wrong, wrong[:5]
    assert flags.allow_tf32 == start


def test_tf32_gate_lets_a_waiting_setting_in():
    """Threads that keep TF32 scopes open back to back, overlapping, so that
    some one of them always holds the gate, cannot hold out a thread that
    wants TF32 off (the engine's worker beside a training loop): new TF32
    scopes wait behind it, and it goes in within a bound."""
    import threading
    import time

    from marlin_tpu_torch.ops.local import precision_scope

    flags = torch.backends.cuda.matmul
    start = flags.allow_tf32
    stop = threading.Event()
    t_end = time.monotonic() + 20.0
    held = [0]
    seen = []

    def looper():
        while not stop.is_set() and time.monotonic() < t_end:
            with precision_scope("default"):
                held[0] += 1
                time.sleep(0.002)

    def switcher():
        for _ in range(20):
            with precision_scope("highest"):
                seen.append(flags.allow_tf32)

    loopers = [threading.Thread(target=looper) for _ in range(3)]
    for t in loopers:
        t.start()
    while held[0] < 10:
        time.sleep(0.001)
    s = threading.Thread(target=switcher)
    s.start()
    s.join(5.0)
    in_time = not s.is_alive()
    still_looping = all(t.is_alive() for t in loopers)
    stop.set()
    for t in loopers + [s]:
        t.join(30)
    assert not any(t.is_alive() for t in loopers + [s])
    assert in_time and still_looping, (in_time, still_looping)
    assert seen == [False] * 20
    assert flags.allow_tf32 == start


def test_one_shot_program_serves_beside_lm(tparams, cpu):
    """A one-shot BucketProgram registered through ``programs=`` serves next
    to LM traffic: each step pads its live rows to the smallest of the
    ``serve_program_batches`` widths that covers them, every program request
    gets its value, and the LM rows still equal ``lm_generate``."""
    from marlin_tpu_torch.serving.programs import BucketProgram

    class Doubler(BucketProgram):
        name = cost_program = "double"

        def __init__(self):
            super().__init__()
            self.steps = []

        def buckets(self):
            return ((4,),)

        def pick_bucket(self, request):
            return (4,) if len(request.payload) <= 4 else None

        def admission_cost(self, request, bucket):
            return 0

        def program_key(self, bucket, width=None):
            return f"double/{bucket[0]}/w{width}"

        def warmup(self):
            return 0

        def step(self, bucket, requests):
            self.steps.append((len(requests), self.step_width(len(requests))))
            return [2 * np.asarray(r.payload) for r in requests]

    with config_context(serve_program_batches=(2, 4)):
        prog = Doubler()
    lm = [dict(prompt=np.arange(1, 6, dtype=np.int32), steps=3),
          dict(prompt=np.arange(3, 12, dtype=np.int32), steps=2)]
    payloads = [np.arange(i, i + 3) for i in range(5)]
    with TEngine(tparams, HEADS, start=False, programs=[prog],
                 **_engine_kw()) as eng:
        hs = [eng.submit(TRequest(program="double", payload=p))
              for p in payloads]
        hs += [eng.submit(TRequest(**s)) for s in lm]
        too_big = eng.submit(TRequest(program="double",
                                      payload=np.arange(5))).result(
                                          timeout=WAIT_S)
        eng.start()
        rs = [h.result(timeout=WAIT_S) for h in hs]
        assert eng.kvpool_audit()["ok"]
    assert too_big.status == "rejected" and "no bucket" in too_big.reason
    assert [r.status for r in rs] == ["ok"] * len(rs)
    for p, r in zip(payloads, rs):
        assert r.value.tolist() == (2 * p).tolist()
    for s, r in zip(lm, rs[len(payloads):]):
        assert r.tokens.tolist() == _tref(tparams, s["prompt"], s["steps"])
    assert sorted(prog.steps) == [(1, 2), (4, 4)]
