"""The port's elastic fleet against the JAX package's.

``serving/fleet.py`` is a copy of the JAX package's controller, so its
decisions are held EQUAL to the JAX controller's (exact, no tolerance):
both drive the same scripted fake router — burn and queue depths per
evaluation, actions that may fail — on the same injected clock, and must
give the same decision records, the same actions on the router and the
same ``/debug/fleet`` payloads (less the process-local names). The
threaded single-flight/timeout accounting runs on the port alone.

The router's elastic membership runs on the tiny LM of
tests/test_torch_serving.py (vocab 32, d_model 16, 2 heads, 2 layers,
seed 9; weights from the JAX package through ``interop``), under
``config_context(device="cpu")``, with JAX's ``lm_generate`` as the
reference for every greedy stream: weighted rendezvous churn, a retired
replica leaving the candidates before its rows move, the last replica
kept, a scale-out replica with a fresh breaker window serving at once, a
lossless scale-in under load (rows adopted mid-stream, no token-0
restart), ``serve.fleet`` faults on every leg, a donor killed mid-scale-in,
and a controller rebuilt mid-fleet.

Every wait has a timeout; routers and controllers are closed by ``with``.
"""

import itertools
import random
import threading
import time

import numpy as np
import pytest

import jax

from marlin_tpu.models import TransformerLM as JaxLM
from marlin_tpu.models import transformer as jt
from marlin_tpu.serving import FleetController as JController
from marlin_tpu_torch import config_context, interop
from marlin_tpu_torch.obs import console
from marlin_tpu_torch.obs import memledger
from marlin_tpu_torch.obs.exposition import fleet_payload
from marlin_tpu_torch.serving import (STATUS_OK, FleetController, Request,
                                      Router, ServeEngine)
from marlin_tpu_torch.serving.router import _rendezvous_score, _weighted_score
from marlin_tpu_torch.utils import faults
from marlin_tpu_torch.utils.faults import DelayFault, RaiseFault

HEADS = 2
BUCKETS = ((8, 8), (16, 8))
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


_REFS: dict = {}


@pytest.fixture(scope="module")
def ref(jparams):
    def run(prompt, steps):
        key = (tuple(int(t) for t in prompt), steps)
        if key not in _REFS:
            p = np.asarray(prompt, np.int32)
            _REFS[key] = np.asarray(jt.lm_generate(
                jparams, p, jax.random.key(0), heads=HEADS,
                max_len=len(p) + steps, steps=steps)).tolist()
        return _REFS[key]
    return run


def _engine(params, **kw):
    kw.setdefault("buckets", BUCKETS)
    kw.setdefault("max_batch", 4)
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


class FakeClock:
    def __init__(self, t=0.0):
        self.t = float(t)

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


_fake_ids = itertools.count()


class FakeRouter:
    """The controller's whole contract surface, with scripted burn and
    queue depths."""

    def __init__(self, n=1, burn=0.0, loads=None):
        # not tests/test_fleet.py's "fake-router-N": the JAX registry's
        # per-router counters would carry that file's replica-seconds over
        # when both files run in one process
        self._name = f"torch-fake-router-{next(_fake_ids)}"
        self.n = n
        self.burn = burn
        self.loads = loads
        self.weights = {}
        self.calls = []
        self.fail = None

    def replica_count(self):
        return self.n

    def replica_view(self):
        loads = self.loads if self.loads is not None else [0] * self.n
        return [{"replica": i, "state": "accepting",
                 "load": loads[i] if i < len(loads) else 0,
                 "weight": self.weights.get(i, 1.0), "restarts": 0}
                for i in range(self.n)]

    def _fleet_slo(self):
        if self.burn is None:
            return None
        return {"objectives": [{"burn_rate": self.burn}]}

    def add_replica(self):
        self.calls.append("scale_out")
        if self.fail is not None:
            raise self.fail
        self.n += 1
        return self.n - 1

    def retire_replica(self, idx=None):
        self.calls.append("scale_in")
        if self.fail is not None:
            raise self.fail
        self.n -= 1
        return self.n

    def shed_weight(self, idx=None, frac=0.5):
        self.calls.append("rebalance")
        if self.fail is not None:
            raise self.fail
        i = 0 if idx is None else idx
        self.weights[i] = self.weights.get(i, 1.0) * (1.0 - frac)
        return i, self.weights[i]


class _CaptureLog:
    def __init__(self):
        self.records = []

    def event(self, kind, **fields):
        self.records.append(dict(fields, kind=kind))


_CTL_KW = dict(min_replicas=1, max_replicas=4, eval_interval_s=1.0,
               out_burn=1.0, in_burn=0.1, hysteresis=2, cooldown_s=0.0,
               flap_window_s=0.0, threaded=False)


def _ctl(cls, router, clock, **kw):
    return cls(router, clock=clock, **dict(_CTL_KW, **kw))


def _strip(payload):
    """A /debug/fleet payload less its process-local names."""
    return {k: v for k, v in payload.items()
            if k not in ("controller", "router")}


# Each scenario: controller overrides, the fake router's start, and a script
# of (clock advance, burn, loads, failure) per tick.
_SCENARIOS = {
    "hysteresis": (dict(hysteresis=3), dict(n=1, burn=5.0),
                   [(1.0, 5.0, None, None)] * 5),
    "burn_dip": (dict(hysteresis=2), dict(n=1, burn=5.0),
                 [(1.0, 5.0, None, None), (1.0, 0.5, None, None),
                  (1.0, 5.0, None, None), (1.0, 5.0, None, None)]),
    "bounds": (dict(hysteresis=1, max_replicas=2, min_replicas=2),
               dict(n=2, burn=5.0),
               [(1.0, 5.0, None, None), (1.0, 0.0, None, None)]),
    "cooldown": (dict(hysteresis=1, cooldown_s=5.0), dict(n=1, burn=5.0),
                 [(1.0, 5.0, None, None)] * 8),
    "flap": (dict(hysteresis=1, flap_window_s=30.0), dict(n=1, burn=5.0),
             [(1.0, 5.0, None, None), (1.0, 0.0, None, None),
              (60.0, 0.0, None, None), (1.0, 0.0, None, None)]),
    "rebalance": (dict(hysteresis=2, shed_frac=0.5),
                  dict(n=3, burn=0.5, loads=[20, 1, 1]),
                  [(1.0, 0.5, [20, 1, 1], None)] * 4
                  + [(1.0, 0.5, [3, 0, 0], None)] * 2),
    "error": (dict(hysteresis=1), dict(n=1, burn=5.0),
              [(1.0, 5.0, None, RuntimeError("spawn exploded")),
               (1.0, 5.0, None, None), (1.0, 5.0, None, None)]),
    "no_slo": (dict(hysteresis=1), dict(n=2, burn=None),
               [(1.0, None, None, None)] * 3),
    "interval": (dict(hysteresis=1, eval_interval_s=5.0),
                 dict(n=1, burn=5.0),
                 [(1.0, 5.0, None, None)] * 8),
}


def _run_scenario(cls, name):
    kw, start, script = _SCENARIOS[name]
    router = FakeRouter(**start)
    clk = FakeClock()
    log = _CaptureLog()
    decisions, payloads = [], []
    with _ctl(cls, router, clk, log=log, **kw) as ctl:
        for i, (dt, burn, loads, fail) in enumerate(script):
            if i:
                clk.advance(dt)
            router.burn, router.fail = burn, fail
            if loads is not None:
                router.loads = loads
            decisions.append(ctl.tick())
            payloads.append(_strip(ctl.payload()))
    events = [{k: v for k, v in r.items() if k not in ("controller",
                                                        "router")}
              for r in log.records]
    return (decisions, payloads, router.calls, router.n,
            dict(router.weights), events)


@pytest.mark.parametrize("name", sorted(_SCENARIOS))
def test_controller_decisions_equal_jax(name):
    """Tolerance: none. The same script through both controllers gives the
    same decisions, router actions, payloads and fleet events."""
    jout = _run_scenario(JController, name)
    tout = _run_scenario(FleetController, name)
    assert jout == tout
    decisions = tout[0]
    assert any(d.get("evaluated") for d in decisions)


def test_controller_decisions_cover_every_outcome():
    """The scenarios reach each decision the controller can take."""
    reasons, actions = set(), set()
    for name in _SCENARIOS:
        for d in _run_scenario(FleetController, name)[0]:
            reasons.add(d.get("reason"))
            if d.get("action"):
                actions.add((d["action"], d.get("outcome")))
    assert {"steady", "at-max", "at-min", "cooldown", "interval"} <= reasons
    assert {("scale_out", None), ("scale_in", None), ("rebalance", None),
            ("scale_in", "damped")} <= actions


def test_single_flight_busy_then_timeout_accounting():
    r = FakeRouter(n=1, burn=5.0)
    release = threading.Event()

    def slow_add():
        release.wait(10.0)
        r.n += 1
        return r.n - 1

    r.add_replica = slow_add
    clk = FakeClock()
    with _ctl(FleetController, r, clk, hysteresis=1, threaded=True,
              action_timeout_s=5.0) as ctl:
        try:
            assert ctl.tick()["action"] == "scale_out"
            clk.advance(1.0)
            d = ctl.tick()
            assert d["action"] is None and d["reason"] == "busy"
            clk.advance(10.0)
            assert ctl.tick()["reason"] == "busy"
            assert ctl._action is not None and ctl._action["timed_out"]
            release.set()
            deadline = time.monotonic() + 5.0
            while ctl._action is not None and time.monotonic() < deadline:
                time.sleep(0.01)
            assert ctl._action is None
            assert ctl._last_action["outcome"] == "timeout"
            clk.advance(1.0)
            assert ctl.tick()["action"] == "scale_out"
        finally:
            release.set()


def test_poll_thread_starts_and_joins():
    r = FakeRouter(n=2, burn=0.5)
    with _ctl(FleetController, r, FakeClock(), hysteresis=99) as ctl:
        ctl.start(poll_s=0.01)
        ctl.start(poll_s=0.01)            # idempotent
        assert ctl._thread.name.startswith("marlin-fleet-")
        time.sleep(0.05)
    assert not ctl._thread.is_alive()
    assert ctl.tick() == {"evaluated": False, "reason": "closed"}


def test_payload_debug_fleet_and_console_panel():
    r = FakeRouter(n=1, burn=5.0, loads=[1])
    clk = FakeClock()
    with _ctl(FleetController, r, clk, hysteresis=1) as ctl:
        ctl.tick()
        body = ctl.payload()
        assert body["replicas"] == 2 and body["bounds"] == {"min": 1,
                                                            "max": 4}
        code, payload = fleet_payload()
        assert code == 200 and payload["status"] == "ok"
        mine = [f for f in payload["fleets"]
                if f.get("controller") == ctl._name]
        assert mine and mine[0]["replicas"] == 2
        frame = console.render({}, {"scopes": []},
                               fleet={"fleets": [ctl.payload()]})
        assert f"fleet {r._name}" in frame
        assert "replicas=2 [1..4]" in frame
        assert "scale_out  -> ok" in frame
    code, payload = fleet_payload()
    assert all(f.get("controller") != ctl._name for f in payload["fleets"])


def test_replica_seconds_accumulate_on_the_injected_clock():
    r = FakeRouter(n=3, burn=0.5)
    clk = FakeClock()
    with _ctl(FleetController, r, clk, hysteresis=99) as ctl:
        start = ctl.replica_seconds()
        ctl.tick()
        clk.advance(10.0)
        ctl.tick()
        assert ctl.replica_seconds() - start == pytest.approx(30.0)


# --------------------------------------------------------- routing math


def _owner(key, members, weights=None):
    weights = weights or {}
    return max(members,
               key=lambda i: _weighted_score(key, i, weights.get(i, 1.0)))


def test_weighted_hrw_matches_classic_and_moves_only_owned_keys():
    members = [0, 1, 2, 3]
    keys = [f"prefix-{i}".encode() for i in range(400)]
    for key in keys[:60]:
        assert _owner(key, members) == max(
            members, key=lambda m: _rendezvous_score(key, m))
    before = {k: _owner(k, members) for k in keys}
    owned = [k for k in keys if before[k] == 2]
    assert owned
    after = {k: _owner(k, [0, 1, 3]) for k in keys}
    assert all(after[k] == before[k] for k in keys if before[k] != 2)
    shed = {k: _owner(k, members, {2: 0.5}) for k in keys}
    moved = [k for k in keys if shed[k] != before[k]]
    assert moved and all(before[k] == 2 for k in moved)
    assert 0.2 < len(moved) / len(owned) < 0.8


# ----------------------------------------------------- router membership


def test_retired_replica_leaves_candidates_before_rows_move(params):
    with Router(_factory(params), replicas=3, supervise=False,
                rng=random.Random(5)) as router:
        seen = {}
        orig = router._migrate_out

        def spy(rep):
            seen["candidates"] = [r.idx for r in router._candidates()]
            return orig(rep)

        router._migrate_out = spy
        assert router.retire_replica(1) == 1
        assert 1 not in seen["candidates"]
        assert [v["replica"] for v in router.replica_view()] == [0, 2]
        assert router.add_replica() == 3      # indices are never reused
        with pytest.raises(ValueError, match="no replica with index"):
            router.retire_replica(1)


def test_retire_refuses_last_replica(params):
    with Router(_factory(params), replicas=1, supervise=False) as router:
        with pytest.raises(RuntimeError, match="last replica"):
            router.retire_replica()
        assert router.replica_count() == 1


def test_scale_out_replica_fresh_breaker_window(params, ref):
    with Router(_factory(params), replicas=1,
                supervisor_kw=dict(backoff_s=0.005, poll_s=0.02)) as router:
        sup0 = router._replicas[0].supervisor
        sup0._restarts.extend([time.monotonic()] * 2)
        sup0.restart_count = 2
        idx = router.add_replica()
        rep = next(r for r in router._replicas if r.idx == idx)
        assert rep.supervisor is not None and rep.supervisor is not sup0
        assert len(rep.supervisor._restarts) == 0
        assert rep.supervisor.restart_count == 0
        assert not rep.supervisor.breaker_open and rep.restarts == 0
        h = rep.engine.submit(Request(prompt=[1, 2, 3], steps=4))
        r = h.result(timeout=WAIT_S)
        assert r.status == STATUS_OK and r.tokens.tolist() == ref([1, 2, 3],
                                                                  4)


def test_shed_weight_reroutes_and_floors(params):
    with Router(_factory(params), replicas=2, supervise=False,
                rng=random.Random(1)) as router:
        idx, w = router.shed_weight(idx=0, frac=0.5)
        assert idx == 0 and w == pytest.approx(0.5)
        view = {v["replica"]: v["weight"] for v in router.replica_view()}
        assert view[0] == pytest.approx(0.5) and view[1] == 1.0
        for _ in range(20):
            _, w = router.shed_weight(idx=0, frac=0.9)
        assert w >= 0.05 and 0 in [r.idx for r in router._candidates()]


def test_scale_events_emit_and_merge_counters(params):
    log = _CaptureLog()
    with Router(_factory(params), replicas=2, supervise=False,
                rng=random.Random(2), log=log) as router:
        hs = [router.submit(Request(prompt=[3, i % 4 + 1], steps=3))
              for i in range(6)]
        router.drain()
        assert all(h.result(timeout=WAIT_S).status == STATUS_OK for h in hs)
        steps_before = router.snapshot()["steps"]
        router.add_replica()
        router.shed_weight(idx=0, frac=0.25)
        router.retire_replica(0)
        assert router.snapshot()["steps"] >= steps_before
        evs = [r.get("ev") for r in log.records if r["kind"] == "serve"]
        assert {"replica_add", "rebalance", "replica_retire"} <= set(evs)


def test_scale_in_lossless_under_load(params, ref):
    """Retiring a replica with live mid-stream rows and a queued backlog
    drops nothing and restarts nothing from token 0."""
    router = Router(_factory(params, max_batch=8), replicas=2,
                    supervisor_kw=dict(backoff_s=0.005, poll_s=0.02),
                    rng=random.Random(7))
    handles, lock = [], threading.Lock()
    stop = threading.Event()

    def pump():
        i = 0
        while not stop.is_set():
            h = router.submit(Request(prompt=[5, 1 + i % 4], steps=4))
            with lock:
                handles.append(h)
            i += 1
            stop.wait(0.015)

    thread = threading.Thread(target=pump)
    with router:
        thread.start()
        stop.wait(0.1)
        first = router._replicas[0].engine
        with faults.injected("serve.decode_step",
                             DelayFault(seconds=0.5, times=1, match="16x8")):
            with lock:
                handles.extend(first.submit(
                    Request(prompt=[2, 4, 6, 1, 3, 5, 2, 4, 6], steps=8))
                    for _ in range(4))
            stop.wait(0.05)
            retired = router.retire_replica(0)
        stop.set()
        thread.join(timeout=WAIT_S)
        router.drain()
        assert retired == 0 and router.replica_count() == 1
        results = [h.result(timeout=WAIT_S) for h in handles]
        snap = router.snapshot()
        for rep in router._replicas:
            audit = rep.engine.kvpool_audit()
            assert audit["ok"], audit["errors"]
    assert len(results) >= 8
    for h, r in zip(handles, results):
        assert r.status == STATUS_OK, (r.status, r.reason)
        assert r.tokens.tolist() == ref(h.request.prompt, h.request.steps)
    assert snap["migrated_in"] >= 1 and snap["retries"] == 0


def test_scale_out_serves_immediately(params, ref):
    with Router(_factory(params), replicas=1,
                supervisor_kw=dict(backoff_s=0.005, poll_s=0.02),
                rng=random.Random(4)) as router:
        hs = [router.submit(Request(prompt=[1 + i % 6, 2], steps=3))
              for i in range(4)]
        assert router.add_replica() == 1 and router.replica_count() == 2
        assert all(r.ready() for r in router._replicas)
        hs += [router.submit(Request(prompt=[2, 1 + i % 6], steps=3))
               for i in range(12)]
        router.drain()
        for h in hs:
            r = h.result(timeout=WAIT_S)
            assert r.status == STATUS_OK, (r.status, r.reason)
            assert r.tokens.tolist() == ref(h.request.prompt, 3)
        for rep in router._replicas:
            assert rep.engine.kvpool_audit()["ok"]


# ----------------------------------------------------------------- chaos


@pytest.mark.parametrize("leg", ["spawn-", "join-"])
def test_kill_fresh_replica_before_join(params, leg):
    with Router(_factory(params), replicas=1, supervise=False,
                rng=random.Random(3)) as router:
        hs = [router.submit(Request(prompt=[1 + i % 5, 2], steps=3))
              for i in range(4)]
        with faults.injected("serve.fleet", RaiseFault(times=1, match=leg)):
            with pytest.raises(faults.FaultInjected):
                router.add_replica()
        assert router.replica_count() == 1
        hs += [router.submit(Request(prompt=[2, 1 + i % 5], steps=3))
               for i in range(4)]
        router.drain()
        for h in hs:
            assert h.result(timeout=WAIT_S).status == STATUS_OK
        assert router.add_replica() >= 1 and router.replica_count() == 2
        for rep in router._replicas:
            assert rep.engine.kvpool_audit()["ok"]


def test_kill_retire_leg_aborts_atomically(params):
    with Router(_factory(params), replicas=2, supervise=False,
                rng=random.Random(6)) as router:
        with faults.injected("serve.fleet",
                             RaiseFault(times=1, match="retire-")):
            with pytest.raises(faults.FaultInjected):
                router.retire_replica(0)
        assert router.replica_count() == 2
        assert sorted(r.idx for r in router._candidates()) == [0, 1]
        hs = [router.submit(Request(prompt=[4, 1 + i % 4], steps=3))
              for i in range(6)]
        router.drain()
        assert all(h.result(timeout=WAIT_S).status == STATUS_OK for h in hs)
        assert router.retire_replica(0) == 0
        assert router.replica_count() == 1


def test_kill_shed_leg_leaves_weights(params):
    with Router(_factory(params), replicas=2, supervise=False,
                rng=random.Random(8)) as router:
        with faults.injected("serve.fleet",
                             RaiseFault(times=1, match="shed-")):
            with pytest.raises(faults.FaultInjected):
                router.shed_weight(idx=0, frac=0.5)
        assert all(v["weight"] == 1.0 for v in router.replica_view())
        assert router.shed_weight(idx=0, frac=0.5) == (0, 0.5)


@pytest.mark.parametrize("leg", ["export:", "adopt:"])
def test_kill_donor_mid_scale_in_stays_lossless(params, ref, leg):
    memledger.reset_ledger()
    with Router(_factory(params, max_batch=8), replicas=2,
                supervisor_kw=dict(backoff_s=0.005, poll_s=0.02),
                rng=random.Random(11)) as router:
        with faults.injected("serve.decode_step",
                             DelayFault(seconds=0.5, times=2)):
            hs = [router.submit(Request(prompt=[3, 1 + i % 4], steps=8))
                  for i in range(6)]
            threading.Event().wait(0.05)
            with faults.injected("serve.migrate",
                                 RaiseFault(times=1, match=leg)):
                retired = router.retire_replica(0)
        assert retired == 0 and router.replica_count() == 1
        router.drain()
        for h in hs:
            r = h.result(timeout=WAIT_S)
            assert r.status == STATUS_OK, (leg, r.status, r.reason)
            assert r.tokens.tolist() == ref(h.request.prompt, 8)
        for rep in router._replicas:
            audit = rep.engine.kvpool_audit()
            assert audit["ok"], (leg, audit["errors"])
        assert router.pending() == 0
        led = memledger.get_ledger()
        assert led.audit()["ok"]
        assert led.totals().get("migration", 0) == 0
        live = {rep.engine._name for rep in router._replicas}
        for e in led.entries():
            if e["component"] in ("kvpool", "migration"):
                assert e["owner"] in live, (leg, e)


def test_controller_rebuild_mid_fleet_resumes_from_router(params):
    clk = FakeClock()
    with Router(_factory(params), replicas=2, supervise=False,
                rng=random.Random(9)) as router:
        with _ctl(FleetController, router, clk, hysteresis=1,
                  max_replicas=3) as ctl:
            ctl._burn_signal = lambda: 9.0
            assert ctl.tick()["action"] == "scale_out"
            assert router.replica_count() == 3
        assert router.replica_count() == 3
        with _ctl(FleetController, router, clk, hysteresis=1,
                  max_replicas=3) as ctl2:
            ctl2._burn_signal = lambda: 0.0
            clk.advance(1.0)
            d = ctl2.tick()
            assert d["action"] == "scale_in" and d["replicas"] == 3
            assert router.replica_count() == 2
        hs = [router.submit(Request(prompt=[2, 1 + i % 4], steps=3))
              for i in range(6)]
        router.drain()
        assert all(h.result(timeout=WAIT_S).status == STATUS_OK for h in hs)
