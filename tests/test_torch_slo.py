"""The port's SLO engine and time-series store against the JAX package's.

``marlin_tpu_torch.obs.{timeseries,slo}`` are copies of the JAX package's
stdlib modules, so every check here drives both packages through the same
calls on the same injected clock and holds the outputs EQUAL (exact: no
float tolerance — the arithmetic is the same Python on the same inputs):

- ``TimeSeriesStore`` reducers (delta/rate/values/pct/mean/last/snapshot)
  over a seeded write stream, and ``record_cum``'s reset and
  ``first_counts`` rules;
- ``pump_registry`` over a seeded registry of each package, with and
  without ``only=``;
- ``parse_objective`` on valid specs, and the refusal messages of
  malformed ones;
- ``SloEngine.evaluate`` lists, breach-hook events and payloads under one
  sample stream;
- ``fleet_merge``;
- the engine's breach → shed → recover on the tiny LM of
  tests/test_torch_serving.py (vocab 32, d_model 16, 2 heads, 2 layers,
  seed 9; the port's weights carried over by ``interop.lm_params_from_numpy``
  and served under ``config_context(device="cpu")``): the same statuses, shed
  reasons and SLO records in both packages;
- ``/debug/slo`` scopes of an engine and of a router.

Every wait has a timeout; engines and routers are closed by ``with``.
"""

import threading
from types import SimpleNamespace

import numpy as np
import pytest

import jax

import marlin_tpu as jm
from marlin_tpu.models import TransformerLM as JaxLM
from marlin_tpu.obs import exposition as jexpo
from marlin_tpu.obs import metrics as jmetrics
from marlin_tpu.obs import slo as jslo
from marlin_tpu.obs import timeseries as jts
from marlin_tpu.serving import Request as JRequest
from marlin_tpu.serving import Router as JRouter
from marlin_tpu.serving import ServeEngine as JEngine
from marlin_tpu.serving import request as jrequest
from marlin_tpu.utils import faults as jfaults
from marlin_tpu_torch import config_context, interop
from marlin_tpu_torch.obs import exposition as texpo
from marlin_tpu_torch.obs import metrics as tmetrics
from marlin_tpu_torch.obs import slo as tslo
from marlin_tpu_torch.obs import timeseries as tts
from marlin_tpu_torch.serving import Request as TRequest
from marlin_tpu_torch.serving import Router as TRouter
from marlin_tpu_torch.serving import ServeEngine as TEngine
from marlin_tpu_torch.serving import request as trequest
from marlin_tpu_torch.utils import faults as tfaults

HEADS = 2
WAIT_S = 60.0

JAX = SimpleNamespace(ts=jts, slo=jslo, metrics=jmetrics, expo=jexpo,
                      Engine=JEngine, Request=JRequest, Router=JRouter,
                      request=jrequest, faults=jfaults,
                      config_context=jm.config_context)
TORCH = SimpleNamespace(ts=tts, slo=tslo, metrics=tmetrics, expo=texpo,
                        Engine=TEngine, Request=TRequest, Router=TRouter,
                        request=trequest, faults=tfaults,
                        config_context=config_context)
PKGS = (JAX, TORCH)


class FakeClock:
    """Deterministic clock: only advances when the test says so."""

    def __init__(self, t: float = 1000.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


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


def _both(fn):
    """Run ``fn(pkg)`` for each package; assert the results equal and
    return the port's."""
    out = [fn(p) for p in PKGS]
    assert out[0] == out[1], out
    return out[1]


# ------------------------------------------------------------- time series


def _write_stream(pkg, seed):
    """A seeded mixed write stream over 40 s of a 1 s-bucket store: every
    reducer read back at several windows."""
    rng = np.random.default_rng(seed)
    clk = FakeClock(100.0)
    st = pkg.ts.TimeSeriesStore(window_s=30.0, bucket_s=1.0, clock=clk,
                                max_series=6, samples_per_bucket=5)
    reads = []
    for step in range(80):
        clk.advance(float(rng.choice([0.25, 0.5, 1.0, 3.0])))
        kind = int(rng.integers(0, 4))
        name = f"s{int(rng.integers(0, 8))}"
        val = float(np.round(rng.standard_normal(), 3))
        if kind == 0:
            st.add(name + "_c", abs(val))
        elif kind == 1:
            st.set(name + "_g", val)
        elif kind == 2:
            st.observe(name + "_h", val)
        else:
            st.record_cum(name + "_c", float(step % 7))
        if step % 10 == 9:
            for w in (1.0, 5.0, 30.0, 100.0):
                for n in st.names():
                    reads.append((n, w, st.delta(n, w), st.rate(n, w),
                                  st.values(n, w), st.pct(n, 90, w),
                                  st.mean(n, w), st.last(n, w)))
            reads.append(st.snapshot(10.0))
    return reads, st.dropped_series, sorted(st.names())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_store_reducers_equal_jax(seed):
    reads, dropped, names = _both(lambda p: _write_stream(p, seed))
    assert reads and names


def test_store_record_cum_reset_and_first_counts_equal_jax():
    def run(pkg):
        clk = FakeClock(10.0)
        st = pkg.ts.TimeSeriesStore(window_s=60.0, bucket_s=1.0, clock=clk)
        out = []
        st.record_cum("c", 5.0)            # baseline only
        out.append(st.delta("c", 60.0))
        clk.advance(1.0)
        st.record_cum("c", 8.0)
        st.record_cum("c", 2.0)            # reset: counts 2 from zero
        out.append(st.delta("c", 60.0))
        st.record_cum("d", 4.0, first_counts=True)
        out.append((st.delta("d", 60.0), st.watched("d"),
                    st.watched("e")))
        with pytest.raises(ValueError) as err:
            pkg.ts.TimeSeriesStore(window_s=1.0, bucket_s=2.0)
        out.append(str(err.value))
        return out

    out = _both(run)
    assert out[:2] == [0.0, 5.0]


def _seeded_registry(pkg):
    reg = pkg.metrics.MetricsRegistry()
    c = reg.counter("req_total", "h", labelnames=("status",))
    g = reg.gauge("depth", "h")
    h = reg.histogram("lat_seconds", "h", buckets=(0.1, 1.0))
    reg.counter("noise_total", "h", labelnames=("scope",))
    return reg, c, g, h


def test_pump_registry_equal_jax():
    def run(pkg, only=None):
        clk = FakeClock(10.0)
        st = pkg.ts.TimeSeriesStore(window_s=60.0, bucket_s=1.0, clock=clk,
                                    max_series=8)
        reg, c, g, h = _seeded_registry(pkg)
        noise = reg.counter("noise_total", "h", labelnames=("scope",))
        for i in range(12):
            noise.labels(scope=f"eng-{i}").inc()
        c.labels(status="ok").inc(3)
        g.set(5.0)
        h.observe(0.5)
        pkg.ts.pump_registry(st, reg, clk(), only=only)
        clk.advance(2.0)
        c.labels(status="ok").inc(4)
        c.labels(status="err").inc(2)
        g.set(8.0)
        h.observe(2.0)
        pkg.ts.pump_registry(st, reg, clk(), only=only)
        return st.snapshot(30.0), st.dropped_series

    snap, dropped = _both(run)
    assert dropped > 0            # the noise family crowds the store cap
    fams = {"req_total", "depth", "lat_seconds"}
    snap, dropped = _both(lambda p: run(p, only=fams))
    assert dropped == 0 and not any(n.startswith("noise") for n in snap)
    assert snap["req_total{status=err}"]["delta"] == 2.0


def test_install_collector_pumps_on_render_equal_jax():
    def run(pkg):
        clk = FakeClock(10.0)
        st = pkg.ts.TimeSeriesStore(window_s=60.0, bucket_s=1.0, clock=clk)
        reg, c, g, _ = _seeded_registry(pkg)
        fn = pkg.ts.install_collector(st, reg, only={"depth"})
        g.set(3.0)
        reg.render()
        reg.remove_collector(fn)
        g.set(9.0)
        reg.render()
        return st.names(), st.last("depth", None)

    assert _both(run) == (["depth"], 3.0)


# ------------------------------------------------------- objective grammar


_VALID = [
    {"name": "ttft", "metric": "p95:marlin_serve_ttft_seconds",
     "target": 0.5, "window_s": 300},
    {"name": "t", "metric": "p999:x", "target": 1, "window_s": 10},
    {"name": "avail", "metric": "ratio:req_total{status=ok}/req_total",
     "target": 0.99, "window_s": 60},
    {"name": "g", "metric": "gauge:depth", "target": 10, "window_s": 60,
     "op": ">=", "budget": 0.25},
    {"name": "m", "metric": "mean:lat", "target": 0.2, "window_s": 5},
    {"name": "r", "metric": "rate:req_total", "target": 3, "window_s": 5},
]

_MALFORMED = [
    {"name": "x", "metric": "p95:lat", "target": 1},
    {"name": "x", "metric": "p95:lat", "target": 1, "window_s": 0},
    {"name": "x", "metric": "lat", "target": 1, "window_s": 1},
    {"name": "x", "metric": "p0:lat", "target": 1, "window_s": 1},
    {"name": "x", "metric": "max:lat", "target": 1, "window_s": 1},
    {"name": "x", "metric": "ratio:good", "target": 1, "window_s": 1},
    {"name": "x", "metric": "ratio:g/t", "target": 2, "window_s": 1},
    {"name": "x", "metric": "p95:lat", "target": 1, "window_s": 1,
     "op": "=="},
    {"name": "x", "metric": "p95:lat", "target": 1, "window_s": 1,
     "budget": 0},
]


def _objective_fields(o):
    return (repr(o),) + tuple(getattr(o, f) for f in o.__slots__)


@pytest.mark.parametrize("spec", _VALID, ids=lambda s: s["metric"])
def test_parse_objective_equal_jax(spec):
    _both(lambda p: _objective_fields(p.slo.parse_objective(spec)))


@pytest.mark.parametrize("spec", _MALFORMED, ids=str)
def test_parse_objective_refusals_equal_jax(spec):
    def refuse(pkg):
        with pytest.raises(ValueError) as err:
            pkg.slo.parse_objective(spec)
        return str(err.value)

    _both(refuse)


def test_objectives_from_config_and_pump_families_equal_jax():
    specs = tuple(_VALID)

    def run(pkg):
        with pkg.config_context(serve_slo=specs):
            objs = pkg.slo.objectives_from_config()
        return ([_objective_fields(o) for o in objs],
                sorted(pkg.slo.pump_families(objs)))

    _both(run)


# ----------------------------------------------------- burn state machine


def _slo_stream(pkg, seed):
    """One SloEngine over one seeded sample stream on an injected clock:
    the evaluate lists, the hook events, tick's rate limit and the final
    payload."""
    rng = np.random.default_rng(seed)
    clk = FakeClock(100.0)
    st = pkg.ts.TimeSeriesStore(window_s=60.0, bucket_s=1.0, clock=clk)
    reg = pkg.metrics.MetricsRegistry()
    eng = pkg.slo.SloEngine(
        [{"name": "lat", "metric": "p90:lat", "target": 0.1,
          "window_s": 30.0},
         {"name": "avail", "metric": "ratio:ok_total/all_total",
          "target": 0.9, "window_s": 20.0},
         {"name": "depth", "metric": "gauge:depth", "target": 4,
          "window_s": 10.0}],
        st, scope="unit", registry=reg, clock=clk, eval_interval_s=1.0,
        fast_window_s=10.0, burn_threshold=5.0, hysteresis=2)
    seen = []
    eng.add_breach_hook(lambda ev: seen.append(ev))
    evals = []
    for step in range(40):
        clk.advance(float(rng.choice([0.5, 1.0, 2.0])))
        spike = 10 <= step < 16
        for _ in range(int(rng.integers(0, 4))):
            st.observe("lat", 2.0 if spike else 0.01 * rng.random())
        st.add("all_total", 4.0)
        st.add("ok_total", 4.0 if not spike else float(rng.integers(0, 4)))
        st.set("depth", float(rng.integers(0, 8)))
        if step % 3 == 0:
            eng.record_shed()
        evals.append(eng.evaluate())
        evals.append(eng.tick())
        evals.append(eng.breached())
    gauges = sorted((f.name, sorted((k, c.value)
                                    for k, c in f.children().items()))
                    for f in reg.families())
    return evals, seen, eng.payload(), gauges


@pytest.mark.parametrize("seed", [3, 4])
def test_slo_engine_evaluate_sequence_equal_jax(seed):
    evals, seen, payload, gauges = _both(lambda p: _slo_stream(p, seed))
    assert any(ev["state"] == "breach" for ev in seen)
    assert any(r and r[0]["breached"] for r in evals if isinstance(r, list)
               and r and isinstance(r[0], dict))


def test_fleet_merge_equal_jax():
    rng = np.random.default_rng(5)
    payloads = []
    for r in range(4):
        objs = []
        for name in ("ttft", "avail"):
            objs.append({"slo": name, "compliance": float(rng.random()),
                         "budget_remaining": float(rng.random()),
                         "burn_rate": float(rng.random() * 10),
                         "breached": bool(rng.random() < 0.3),
                         "value": float(rng.random()), "target": 0.5})
        payloads.append({"scope": f"r{r}", "objectives": objs,
                         "events": [{"slo": "ttft", "state": "breach"}]
                         * r})
    merged = _both(lambda p: p.slo.fleet_merge(payloads))
    assert merged["scope"] == "fleet" and len(merged["objectives"]) == 2


def test_admission_shed_equal_jax():
    def run(pkg):
        q = pkg.request.AdmissionQueue(8, 0)
        q.set_shed(1, reason="ttft", protect_slack_s=2.0)
        out = [q.try_admit(1, priority=0), q.try_admit(1, priority=1),
               q.try_admit(1, priority=0, deadline_slack_s=1.5),
               q.try_admit(1, priority=0, deadline_slack_s=10.0),
               q.shed_count]
        q.clear_shed()
        out += [q.shed_level, q.try_admit(1, priority=0)]
        return out

    out = _both(run)
    assert out[0].startswith(trequest.SHED_REASON_PREFIX)


# ------------------------------------------------------------------- e2e


class _Hold:
    """Block the worker at the fault point until released: the latency
    spike, deterministic on the injected clock."""

    @staticmethod
    def make(pkg, gate, release):
        class Hold(pkg.faults.Fault):
            def on_fire(self, point, ctx):
                gate.set()
                release.wait(timeout=60)

        return Hold(times=1)


_SLO = ({"name": "ttft", "metric": "p95:marlin_serve_ttft_seconds",
         "target": 0.05, "window_s": 30.0},)
_SLO_KW = dict(serve_slo=_SLO, serve_slo_eval_interval_s=1.0,
               serve_slo_fast_window_s=10.0, serve_slo_burn_fast=5.0,
               serve_slo_hysteresis=2, serve_ts_bucket_s=1.0,
               serve_slo_shed_slack_s=2.0)


def _slo_record(p):
    (rec,) = p["objectives"]
    return (rec["slo"], rec["breached"], rec["compliance"],
            rec["burn_rate"] >= 5.0, p["shed_level"])


def _breach_shed_recover(pkg, params):
    """The JAX package's tests/test_slo.py e2e, returning what it saw:
    healthy → held prefill spikes TTFT → breach arms shedding → a
    low-priority submit is shed, a high-priority one served → the spike
    ages out and two quiet evaluations clear it."""
    clk = FakeClock(1000.0)
    seen = []
    with config_context(device="cpu"), pkg.config_context(**_SLO_KW):
        eng = pkg.Engine(params, HEADS, buckets=((8, 4),), max_batch=4,
                         max_wait_ms=0.0, queue_depth=16, page_len=4,
                         num_pages=256, clock=clk, hbm_budget_bytes=0)
    with eng:
        assert eng._slo is not None and eng._ts is not None
        hs = [eng.submit(pkg.Request(prompt=[1 + i, 2, 3], steps=3))
              for i in range(3)]
        seen.append([h.result(timeout=WAIT_S).status for h in hs])
        clk.advance(1.5)
        seen.append(_slo_record(eng._slo_payload()))
        gate, release = threading.Event(), threading.Event()
        pkg.faults.inject("serve.prefill", _Hold.make(pkg, gate, release))
        try:
            hs = [eng.submit(pkg.Request(prompt=[2 + i, 3, 4], steps=3))
                  for i in range(4)]
            assert gate.wait(timeout=WAIT_S)
            clk.advance(2.0)
        finally:
            release.set()
        seen.append([h.result(timeout=WAIT_S).status for h in hs])
        clk.advance(1.5)
        seen.append(_slo_record(eng._slo_payload()))
        r = eng.submit(pkg.Request(prompt=[1, 2, 3], steps=2)).result(
            timeout=WAIT_S)
        seen.append((r.status, r.reason))
        r = eng.submit(pkg.Request(prompt=[1, 2, 3], steps=2,
                                   priority=1)).result(timeout=WAIT_S)
        seen.append((r.status, r.tokens.tolist()))
        seen.append(eng._queue.shed_count)
        clk.advance(12.0)
        seen.append(_slo_record(eng._slo_payload()))
        clk.advance(1.5)
        seen.append(_slo_record(eng._slo_payload()))
        r = eng.submit(pkg.Request(prompt=[1, 2, 3], steps=2)).result(
            timeout=WAIT_S)
        seen.append(r.status)
        seen.append([{k: e[k] for k in ("slo", "state")}
                     for e in eng._slo.payload()["events"]])
    pkg.faults.clear("serve.prefill")
    return seen


def test_engine_breach_shed_recover_equal_jax(jparams, tparams):
    seen = [_breach_shed_recover(JAX, jparams),
            _breach_shed_recover(TORCH, tparams)]
    assert seen[0] == seen[1], seen
    out = seen[1]
    assert out[3][1] and out[3][4] == 1           # breached, shed level 1
    assert out[4][0] == "rejected"
    assert out[4][1].startswith(trequest.SHED_REASON_PREFIX)
    assert out[5][0] == "ok" and out[6] == 1
    assert out[7][1] and not out[8][1] and out[8][4] == 0
    assert out[9] == "ok"
    assert [e["state"] for e in out[10]] == ["breach", "clear"]
    assert "marlin_slo_shed_total" in tmetrics.get_registry().render()


def test_engine_without_slo_config_builds_nothing(tparams):
    with config_context(device="cpu"):
        with TEngine(tparams, HEADS, buckets=((8, 4),), max_batch=4,
                     queue_depth=16, page_len=4, start=False) as eng:
            assert eng._slo is None and eng._ts is None
            assert eng._ts_collector is None
            assert eng._slo_payload() is None


def test_malformed_serve_slo_refused_alike(jparams, tparams):
    bad = ({"name": "x"},)
    msgs = []
    for pkg, params in ((JAX, jparams), (TORCH, tparams)):
        with config_context(device="cpu"), pkg.config_context(serve_slo=bad):
            with pytest.raises(ValueError) as err:
                pkg.Engine(params, HEADS, buckets=((8, 4),), max_batch=4,
                           page_len=4, start=False)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


def test_debug_slo_provider_payload_and_prune(tparams):
    with config_context(device="cpu", serve_slo=_SLO):
        eng = TEngine(tparams, HEADS, buckets=((8, 4),), max_batch=4,
                      queue_depth=16, page_len=4, num_pages=256)
    with eng:
        assert eng.submit(TRequest(prompt=[1, 2, 3], steps=2)).result(
            timeout=WAIT_S).ok
        code, payload = texpo.slo_payload()
        assert code == 200 and payload["status"] == "ok"
        scope = next(s for s in payload["scopes"] if s["scope"] == eng._name)
        assert {o["slo"] for o in scope["objectives"]} == {"ttft"}
        assert scope["health"]["state"] == "accepting"
        assert "pages" in scope and "shed_level" in scope
    code, payload = texpo.slo_payload()
    assert all(s["scope"] != eng._name for s in payload["scopes"])


def test_router_fleet_slo_scope(tparams):
    with config_context(device="cpu", serve_slo=_SLO):
        router = TRouter(lambda: TEngine(
            tparams, HEADS, buckets=((8, 4),), max_batch=4, queue_depth=16,
            page_len=4, num_pages=256), replicas=2)
    with router:
        hs = [router.submit(TRequest(prompt=[1 + i, 2, 3], steps=2))
              for i in range(4)]
        for h in hs:
            assert h.result(timeout=WAIT_S).ok
        code, payload = texpo.slo_payload()
        assert code == 200
        fleet = next(s for s in payload["scopes"]
                     if s.get("router") == router._name)
        assert fleet["scope"] == "fleet"
        (o,) = [o for o in fleet["objectives"] if o["slo"] == "ttft"]
        assert o["replicas"] >= 1
        replica_scopes = [s for s in payload["scopes"]
                          if s.get("router") != router._name
                          and s.get("objectives")]
        assert len(replica_scopes) >= 2
    code, payload = texpo.slo_payload()
    assert all(s.get("router") != router._name for s in payload["scopes"])
