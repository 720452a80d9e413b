"""The port's supervisor and router against the JAX package's behaviour.

The tiny LM of tests/test_torch_serving.py (vocab 32, d_model 16, 2 heads,
2 layers, seed 9) serves through the port's engines under
``config_context(device="cpu")``, its weights carried over from the JAX
package by ``interop.lm_params_from_numpy``. The reference for every
greedy stream is JAX's ``lm_generate`` on the same weights, exact:

- the supervisor's crash recovery (one OK Result per request, greedy ==
  ``lm_generate``, a ``restart`` event), its watchdog on a stuck worker
  (recovery beats the wedge), and its breaker (the restart budget, then
  the engine failed with clean terminal Results, and a shutdown that never
  joins a wedged thread);
- the router's routing, failover on rejection and on a ``serve.router_route``
  fault, a deterministic Result with no ready replica, one aggregated
  ``/healthz`` target with ``marlin_serve_replica_state``, the merged
  snapshot, and a rolling restart under load with rows adopted mid-stream
  (``migrations_total{leg="adopt"}`` > 0, no token-0 restart);
- program traffic under the supervisor and the router (the JAX package's
  tests/test_programs.py:481-605): ALS answers as item sets against a
  numpy oracle, LM streams exact.
- the rendezvous scores equal the JAX package's on a fixed key set.

Every wait has a timeout; engines, supervisors and routers are closed by
``with``.
"""

import random
import threading
import time

import numpy as np
import pytest

import jax

from marlin_tpu.models import TransformerLM as JaxLM
from marlin_tpu.models import transformer as jt
from marlin_tpu.serving import router as jrouter
from marlin_tpu_torch import config_context, interop
from marlin_tpu_torch.obs.exposition import health_payload
from marlin_tpu_torch.obs.metrics import get_registry
from marlin_tpu_torch.serving import (STATUS_ERROR, STATUS_OK,
                                      STATUS_REJECTED, STATUS_SHUTTING_DOWN,
                                      ALSScoreProgram, Request, Router,
                                      ServeEngine, Supervisor)
from marlin_tpu_torch.serving import router as trouter
from marlin_tpu_torch.utils import faults
from marlin_tpu_torch.utils.faults import DelayFault, RaiseFault
from marlin_tpu_torch.utils.tracing import EventLog

HEADS = 2
BUCKETS = ((8, 4), (16, 4))
WAIT_S = 60.0


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
def params(jparams):
    return interop.lm_params_from_numpy(jax.tree.map(np.asarray, jparams),
                                        device="cpu")


@pytest.fixture(autouse=True)
def cpu():
    with config_context(device="cpu"):
        yield


@pytest.fixture(scope="module")
def factors():
    rng = np.random.default_rng(0)
    uf = rng.normal(size=(20, 4)).astype(np.float32)
    pf = rng.normal(size=(15, 4)).astype(np.float32)
    return uf, pf


_REFS: dict = {}


@pytest.fixture(scope="module")
def ref(jparams):
    """JAX's ``lm_generate`` on the shared weights (memoized)."""
    def run(prompt, steps):
        key = (tuple(int(t) for t in prompt), steps)
        if key not in _REFS:
            p = np.asarray(prompt, np.int32)
            _REFS[key] = np.asarray(jt.lm_generate(
                jparams, p, jax.random.key(0), heads=HEADS,
                max_len=len(p) + steps, steps=steps)).tolist()
        return _REFS[key]
    return run


def _als_oracle(uf, pf, user, k):
    return set(np.argsort(-(uf[user] @ pf.T), kind="stable")[:k].tolist())


def _engine(params, **kw):
    kw.setdefault("buckets", BUCKETS)
    kw.setdefault("max_batch", 4)
    kw.setdefault("max_wait_ms", 0.0)
    kw.setdefault("queue_depth", 512)
    kw.setdefault("page_len", 4)
    kw.setdefault("num_pages", 512)
    return ServeEngine(params, HEADS, **kw)


def _factory(params, **kw):
    def make():
        eng = _engine(params, **kw)
        eng.warmup()
        return eng
    return make


def _wait_threads_gone(prefix="marlin-serve", seconds=3.0):
    deadline = time.monotonic() + seconds
    while time.monotonic() < deadline and any(
            t.name.startswith(prefix) for t in threading.enumerate()):
        time.sleep(0.02)


# --------------------------------------------------------------- supervisor


def test_supervisor_recovers_worker_crash(params, ref, tmp_path):
    log = EventLog(str(tmp_path / "serve.jsonl"))
    eng = _engine(params, log=log)
    eng.warmup()
    with eng, Supervisor(eng, backoff_s=0.005, poll_s=0.02, log=log) as sup:
        with faults.injected("serve.worker_crash", RaiseFault(times=1)):
            hs = [eng.submit(Request(prompt=[3, 1 + i % 4], steps=3,
                                     max_attempts=3)) for i in range(6)]
            results = [h.result(timeout=WAIT_S) for h in hs]
        for h, r in zip(hs, results):
            assert r.status == STATUS_OK, (r.status, r.reason)
            assert r.tokens.tolist() == ref(h.request.prompt, 3)
        assert sup.restart_count >= 1 and not sup.breaker_open
        assert sup.info()["breaker"] == "closed"
        assert eng._decode_kernel == "gather"   # a restart keeps the backend
        again = eng.submit(Request(prompt=[5, 6], steps=2))
        assert again.result(timeout=WAIT_S).status == STATUS_OK
    restarts = [r for r in log.read()
                if r["kind"] == "serve" and r.get("ev") == "restart"]
    assert restarts and restarts[0]["reason"].startswith("worker crashed")
    assert restarts[0]["gen"] >= 1
    assert eng.pending() == 0 and eng._queue.bytes_in_flight == 0


def test_supervisor_watchdog_recovers_stuck_worker(params, ref):
    eng = _engine(params, max_batch=2)
    eng.warmup()
    try:
        with eng, Supervisor(eng, watchdog_s=0.3, backoff_s=0.0,
                             poll_s=0.05) as sup:
            with faults.injected("serve.decode_step",
                                 DelayFault(seconds=2.0, times=1)):
                hs = [eng.submit(Request(prompt=[1, 2], steps=3,
                                         max_attempts=3)) for _ in range(2)]
                t0 = time.monotonic()
                for h in hs:
                    r = h.result(timeout=WAIT_S)
                    assert r.status == STATUS_OK, (r.status, r.reason)
                    assert r.tokens.tolist() == ref([1, 2], 3)
                took = time.monotonic() - t0
            assert sup.restart_count >= 1
            assert took < 1.8, f"recovery did not beat the wedge ({took:.2f}s)"
    finally:
        _wait_threads_gone()   # the stale generation wakes and exits


def test_supervisor_watchdog_exempts_warmup(params, ref):
    """A warmup in progress (the kernels' first build on the card) is never
    declared stuck; the same stale heartbeat outside warmup is."""
    gate, release = threading.Event(), threading.Event()

    class Hold(faults.Fault):
        def on_fire(self, point, ctx):
            gate.set()
            release.wait(timeout=WAIT_S)

    eng = _engine(params)
    with eng, Supervisor(eng, watchdog_s=0.05, backoff_s=0.0,
                         start=False) as sup:
        with faults.injected("serve.prefill", Hold(times=1)):
            h = eng.submit(Request(prompt=[1, 2], steps=2, max_attempts=2))
            assert gate.wait(timeout=WAIT_S)     # work pending, worker held
            eng._heartbeat = time.monotonic() - 10.0
            eng._warming = True
            assert sup.check() and sup.restart_count == 0
            eng._warming = False
            assert sup.check() and sup.restart_count == 1
            release.set()
            r = h.result(timeout=WAIT_S)
        assert r.status == STATUS_OK and r.tokens.tolist() == ref([1, 2], 2)


def test_supervisor_breaker_opens_after_restart_budget(params):
    reg = get_registry()
    eng = _engine(params, max_batch=2, start=False)
    eng.warmup()
    with eng, Supervisor(eng, restart_max=2, restart_window_s=60.0,
                         backoff_s=0.0, poll_s=0.02) as sup:
        with faults.injected("serve.worker_crash", RaiseFault(times=-1)):
            hs = [eng.submit(Request(prompt=[1, 2], steps=3,
                                     max_attempts=10)) for _ in range(3)]
            eng.start()
            statuses = [h.result(timeout=WAIT_S).status for h in hs]
        assert sup.breaker_open and sup.restart_count == 2
        assert all(s in (STATUS_ERROR, STATUS_SHUTTING_DOWN)
                   for s in statuses), statuses
        assert eng._state == "closed"
        r = eng.submit(Request(prompt=[1], steps=1)).result(timeout=5)
        assert r.status == STATUS_SHUTTING_DOWN
        fam = reg._families.get("marlin_serve_breaker_state")
        assert fam.labels(engine=eng._name).value == 1.0
    assert eng._queue.bytes_in_flight == 0


def test_breaker_on_stuck_worker_does_not_hang_shutdown(params):
    eng = _engine(params, max_batch=2)
    eng.warmup()
    try:
        with eng, Supervisor(eng, watchdog_s=0.2, restart_max=1,
                             restart_window_s=60.0, backoff_s=0.0,
                             poll_s=0.02) as sup:
            with faults.injected("serve.decode_step",
                                 DelayFault(seconds=1.2, times=2)):
                h = eng.submit(Request(prompt=[1, 2], steps=3,
                                       max_attempts=5))
                r = h.result(timeout=30)
                assert r.status == STATUS_ERROR, (r.status, r.reason)
                assert "breaker open" in r.reason and sup.breaker_open
                t0 = time.monotonic()
                eng.close()
                assert time.monotonic() - t0 < 1.0, "close() hung"
                assert eng._state == "closed"
    finally:
        _wait_threads_gone()


def test_supervisor_recovers_worker_crash_under_mixed_load(
        params, ref, factors):
    uf, pf = factors
    eng = _engine(params, programs=[ALSScoreProgram((uf, pf))])
    eng.warmup()
    with eng, Supervisor(eng, backoff_s=0.005, poll_s=0.02) as sup:
        with faults.injected("serve.worker_crash", RaiseFault(times=1)):
            hs = []
            for i in range(4):
                hs.append(("lm", [3, 1 + i % 4], eng.submit(
                    Request(prompt=[3, 1 + i % 4], steps=3,
                            max_attempts=3))))
                hs.append(("als", i, eng.submit(
                    Request(program="als", max_attempts=3,
                            payload={"user": i, "k": 3}))))
            for kind, arg, h in hs:
                r = h.result(timeout=WAIT_S)
                assert r.status == STATUS_OK, (kind, r.status, r.reason)
                if kind == "lm":
                    assert r.tokens.tolist() == ref(arg, 3)
                else:
                    assert set(r.value["items"].tolist()) == _als_oracle(
                        uf, pf, arg, 3)
        assert sup.restart_count >= 1 and not sup.breaker_open
    assert eng.pending() == 0 and eng.kvpool_audit()["ok"]


# ------------------------------------------------------------------ router


def test_rendezvous_scores_equal_jax():
    """Tolerance: none. The affinity hash and the weighted rendezvous
    score are the JAX package's on a fixed key set; a request's route key
    too."""
    rng = np.random.default_rng(0)
    keys = [bytes(rng.integers(0, 256, 16, dtype=np.uint8))
            for _ in range(32)]
    for key in keys:
        for idx in (0, 1, 2, 7, 1000):
            assert (trouter._rendezvous_score(key, idx)
                    == jrouter._rendezvous_score(key, idx))
            for w in (1.0, 0.5, 0.05, 0.0):
                assert (trouter._weighted_score(key, idx, w)
                        == jrouter._weighted_score(key, idx, w))
    assert trouter._SEEN_PREFIX_CAP == jrouter._SEEN_PREFIX_CAP
    assert trouter.REPLICA_STATES == jrouter.REPLICA_STATES
    assert trouter._COUNTER_KEYS == jrouter._COUNTER_KEYS


def test_route_key_equal_jax(params, jparams):
    """The first-full-page affinity key of the same prompts is the JAX
    router's, and None for short prompts and program requests."""
    from marlin_tpu.serving import Request as JRequest
    from marlin_tpu.serving import ServeEngine as JEngine

    with _engine(params, start=False) as teng, \
            JEngine(jparams, HEADS, buckets=BUCKETS, max_batch=4,
                    page_len=4, start=False) as jeng:
        tready = [trouter._Replica(0, teng, None)]
        jready = [jrouter._Replica(0, jeng, None)]
        for prompt in ([1, 2, 3], [1, 2, 3, 4], list(range(1, 12)),
                       [7, 3, 5, 2, 9]):
            assert (trouter._prefix_route_key(Request(prompt=prompt,
                                                      steps=1), tready)
                    == jrouter._prefix_route_key(JRequest(prompt=prompt,
                                                          steps=1), jready))
        assert trouter._prefix_route_key(
            Request(program="als", payload={}), tready) is None


def test_router_routes_and_fails_over_on_rejection(params, ref):
    full = _engine(params, queue_depth=1, start=False)
    stuffed = full.submit(Request(prompt=[9], steps=1))
    ok_eng = _engine(params)
    with Router(engines=[full, ok_eng], supervise=False,
                rng=random.Random(0)) as router:
        hs = [router.submit(Request(prompt=[1, 2], steps=2))
              for _ in range(4)]
        for h in hs:
            r = h.result(timeout=WAIT_S)
            assert r.status == STATUS_OK, (r.status, r.reason)
            assert r.tokens.tolist() == ref([1, 2], 2)
    assert stuffed.result(timeout=5).status == STATUS_SHUTTING_DOWN


def test_router_route_fault_fails_over(params):
    with Router(_factory(params), replicas=2, supervise=False,
                rng=random.Random(1)) as router:
        with faults.injected("serve.router_route", RaiseFault(times=1)):
            h = router.submit(Request(prompt=[1, 2], steps=2))
            assert h.result(timeout=WAIT_S).status == STATUS_OK


def test_router_no_ready_replica_is_deterministic(params):
    with Router(_factory(params), replicas=2, supervise=False) as router:
        router.drain()
        r = router.submit(Request(prompt=[1], steps=1)).result(timeout=1)
        assert r.status == STATUS_REJECTED
        assert "no ready replica" in r.reason
    with pytest.raises(ValueError, match="factory or engines"):
        Router()


def test_router_health_and_replica_state_metric(params):
    reg = get_registry()
    with Router(_factory(params), replicas=2, supervise=False) as router:
        code, payload = health_payload()
        names = [e["name"] for e in payload["engines"]]
        assert router._name in names
        for rep in router._replicas:
            assert rep.engine._name not in names
        assert code == 200
        mine = next(e for e in payload["engines"]
                    if e["name"] == router._name)
        assert mine["state"] == "accepting" and len(mine["replicas"]) == 2
        fam = reg._families.get("marlin_serve_replica_state")
        states = {k: c.value for k, c in fam.children().items()
                  if k[0] == router._name}
        assert set(states.values()) == {0.0}
        router._replicas[0].routable = False
        router._publish_states()
        assert health_payload()[0] == 200
        states = {k: c.value for k, c in fam.children().items()
                  if k[0] == router._name}
        assert sorted(states.values()) == [0.0, 2.0]
        router._replicas[0].routable = True
    assert router._name not in [e["name"] for e in health_payload()[1]
                                ["engines"]]


def test_router_snapshot_aggregates(params):
    with Router(_factory(params), replicas=2, supervise=False) as router:
        hs = [router.submit(Request(prompt=[1, 2], steps=2))
              for _ in range(6)]
        for h in hs:
            assert h.result(timeout=WAIT_S).status == STATUS_OK
        snap = router.snapshot()
        assert snap["completed"] == 6 and set(snap["replicas"]) == {0, 1}
        assert sum(s["completed"] for s in snap["replicas"].values()) == 6


def test_router_rolling_restart_adopts_midstream(params, ref):
    """A rotation under continuous load: every handle one OK Result equal
    to ``lm_generate``, rows adopted mid-stream on the peer
    (``marlin_serve_migrations_total{leg="adopt"}`` rises, no retry), and
    every rebuilt replica audits clean."""
    fam = get_registry()._families.get("marlin_serve_migrations_total")
    before = fam.labels(leg="adopt").value if fam is not None else 0.0
    router = Router(_factory(params, max_batch=8, buckets=((8, 4), (16, 8))),
                    replicas=2,
                    supervisor_kw=dict(backoff_s=0.005, poll_s=0.02),
                    rng=random.Random(7))
    handles, lock = [], threading.Lock()
    stop = threading.Event()

    def pump():
        i = 0
        while not stop.is_set():
            h = router.submit(Request(prompt=[5, 1 + i % 4], steps=2))
            with lock:
                handles.append(h)
            i += 1
            stop.wait(0.004)

    threads = [threading.Thread(target=pump) for _ in range(2)]
    with router:
        for t in threads:
            t.start()
        stop.wait(0.1)
        first = router._replicas[0].engine
        # pin long rows on the first-rotated replica: the match-gated delay
        # wedges only the worker decoding the (16, 8) bucket, so the rows
        # are live mid-stream when the rotation freezes it
        with faults.injected("serve.decode_step",
                             DelayFault(seconds=0.5, times=1, match="16x8")):
            with lock:
                handles.extend(first.submit(
                    Request(prompt=[2, 4, 6, 1, 3, 5, 2, 4, 6], steps=8))
                    for _ in range(4))
            stop.wait(0.05)
            rotated = router.rolling_restart()
        stop.set()
        for t in threads:
            t.join(timeout=WAIT_S)
            assert not t.is_alive()
        router.drain()
        assert set(rotated) == {0, 1}
        results = [h.result(timeout=WAIT_S) for h in handles]
        snap = router.snapshot()
        for rep in router._replicas:
            audit = rep.engine.kvpool_audit()
            assert audit["ok"], audit["errors"]
            assert rep.restarts == 1
    assert len(results) >= 20
    for h, r in zip(handles, results):
        assert r.status == STATUS_OK, (r.status, r.reason)
        assert r.tokens.tolist() == ref(h.request.prompt, h.request.steps)
    assert snap["migrated_in"] >= 1 and snap["retries"] == 0
    fam = get_registry()._families.get("marlin_serve_migrations_total")
    assert fam.labels(leg="adopt").value > before


def test_router_program_requests_skip_prefix_affinity(params, factors):
    uf, pf = factors
    with Router(lambda: _engine(params, programs=[ALSScoreProgram((uf, pf))]),
                replicas=2, supervise=False, rng=random.Random(7)) as router:
        ready = router._replicas
        lm_req = Request(prompt=list(range(1, 9)), steps=2)
        als_req = Request(program="als", payload={"user": 0, "k": 3})
        assert trouter._prefix_route_key(lm_req, ready) is not None
        assert trouter._prefix_route_key(als_req, ready) is None
        hs = [router.submit(Request(prompt=list(range(1, 9)), steps=2))
              for _ in range(4)]
        hs += [router.submit(Request(program="als",
                                     payload={"user": u, "k": 3}))
               for u in range(4)]
        for h in hs:
            assert h.result(timeout=WAIT_S).status == STATUS_OK
        assert router.snapshot()["program_rows"] >= 4


def test_router_rolling_restart_mixed_load_zero_dropped(params, ref,
                                                        factors):
    uf, pf = factors
    router = Router(lambda: _engine(params,
                                    programs=[ALSScoreProgram((uf, pf))]),
                    replicas=2,
                    supervisor_kw=dict(backoff_s=0.005, poll_s=0.02),
                    rng=random.Random(7))
    handles, lock = [], threading.Lock()
    stop = threading.Event()

    def pump():
        i = 0
        while not stop.is_set():
            if i % 2:
                h = router.submit(Request(program="als", max_attempts=3,
                                          payload={"user": i % 5, "k": 3}))
                kind, arg = "als", i % 5
            else:
                h = router.submit(Request(prompt=[5, 1 + i % 4], steps=2,
                                          max_attempts=3))
                kind, arg = "lm", [5, 1 + i % 4]
            with lock:
                handles.append((kind, arg, h))
            i += 1
            stop.wait(0.004)

    threads = [threading.Thread(target=pump) for _ in range(2)]
    with router:
        for t in threads:
            t.start()
        stop.wait(0.1)
        rotated = router.rolling_restart()
        stop.wait(0.1)
        stop.set()
        for t in threads:
            t.join(timeout=WAIT_S)
        router.drain()
        assert set(rotated) == {0, 1}
        results = [(kind, arg, h.result(timeout=WAIT_S))
                   for kind, arg, h in handles]
    assert len(results) >= 20
    assert any(kind == "als" for kind, _, _ in results)
    for kind, arg, r in results:
        assert r.status == STATUS_OK, (kind, r.status, r.reason)
        if kind == "lm":
            assert r.tokens.tolist() == ref(arg, 2)
        else:
            assert set(r.value["items"].tolist()) == _als_oracle(uf, pf,
                                                                 arg, 3)
