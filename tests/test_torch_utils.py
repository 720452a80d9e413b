"""The port's utils (``StepTimer``, ``StageTimes``, ``timer``, ``trace``,
``RetryPolicy``, the MTUtils factories) against the JAX package's, on the
CPU.

``RetryPolicy`` runs in both packages on the same seeded faults (each
package's own fault registry, ``Schedule(seed=...)``): the same delays, the
same attempts and the same EventLog records. The factories compare exactly
where the two packages draw the same numbers (``random_spa_vec_matrix`` is
the JAX package's threefry draws; the deterministic factories and
converters); the dense random factories draw from other generators
(``random.py``), so they compare by shape, type, range and seeding.
"""

import json
import os

import numpy as np
import pytest
import torch

import marlin_tpu_torch as tm
from marlin_tpu.obs import metrics as jmetrics
from marlin_tpu.utils import faults as jfaults
from marlin_tpu.utils import mtutils as jmtu
from marlin_tpu.utils import profiling as jprof
from marlin_tpu.utils import retry as jretry
from marlin_tpu.utils import tracing as jtracing
from marlin_tpu_torch.obs import metrics as tmetrics
from marlin_tpu_torch.obs import trace as ttrace
from marlin_tpu_torch.utils import faults as tfaults
from marlin_tpu_torch.utils import mtutils as tmtu
from marlin_tpu_torch.utils import profiling as tprof
from marlin_tpu_torch.utils import retry as tretry
from marlin_tpu_torch.utils import tracing as ttracing


@pytest.fixture(autouse=True)
def _cpu():
    with tm.config_context(device="cpu"):
        yield
    leaked = tfaults.active()
    tfaults.clear()
    assert not leaked, f"port fault(s) leaked across tests: {leaked}"


@pytest.fixture
def tlog(tmp_path):
    log = ttracing.EventLog(str(tmp_path / "port.jsonl"))
    prev = ttracing.set_default_event_log(log)
    yield log
    ttracing.set_default_event_log(prev)
    log.close()


# ------------------------------------------------------------- profiling


def test_step_timer_waits_and_summarizes():
    for mod in (jprof, tprof):
        st = mod.StepTimer()
        assert st.summary() == "no steps recorded" and st.mean_ms == 0.0
        for _ in range(3):
            st.start()
            st.stop(sync=torch.ones(4) if mod is tprof else None)
        assert len(st.times_ms) == 3 and all(t >= 0 for t in st.times_ms)
        assert st.summary().startswith("3 steps, mean ")
    st = tprof.StepTimer()
    st.start()
    out = torch.ones((64, 64)) @ torch.ones((64, 64))
    st.stop(sync={"a": [out]})  # nested containers are walked
    assert st.times_ms[0] >= 0


def test_timer_lands_in_default_log(tlog, capsys):
    with ttrace.span("bench") as ctx:
        with tprof.timer("unit-test", quiet=True):
            pass
    recs = [r for r in tlog.read() if r["kind"] == "timer"]
    assert len(recs) == 1 and recs[0]["label"] == "unit-test"
    assert recs[0]["seconds"] >= 0 and recs[0]["trace_id"] == ctx.trace_id
    assert capsys.readouterr().out == ""
    times = []
    with tprof.timer("loud", results=times):
        pass
    assert len(times) == 1 and "loud: " in capsys.readouterr().out


def test_stage_times_alike(tlog, tmp_path):
    stages = [("produce", 0.25), ("compute", 0.5), ("produce", 0.25),
              ("drain", 0.125)]
    jst, tst = jprof.StageTimes(), tprof.StageTimes()
    for name, secs in stages:
        jst.add(name, secs)
        tst.add(name, secs)
    assert tst.seconds == jst.seconds and tst.counts == jst.counts
    assert tst.summary() == jst.summary()
    assert tprof.StageTimes().summary() == "no stages recorded"
    with tst.timed("stall"):
        pass
    assert tst.counts["stall"] == 1
    # events: one summary record, the JAX package's fields
    jlog = jtracing.EventLog(str(tmp_path / "jax.jsonl"))
    jst.emit(log=jlog, op="unit")
    tst2 = tprof.StageTimes()
    for name, secs in stages:
        tst2.add(name, secs)
    tst2.emit(op="unit")  # to the default log
    (jrec,), (trec,) = ([r for r in log.read() if r["kind"] == "stage_times"]
                        for log in (jlog, tlog))
    drop = ("ts", "t", "pid", "host", "seq", "trace_id", "span_id",
            "parent_id")
    assert {k: v for k, v in trec.items() if k not in drop} == \
        {k: v for k, v in jrec.items() if k not in drop}
    jlog.close()


def test_stage_times_feed_registry():
    fams = []
    for reg, mod in ((tmetrics.get_registry(), tprof),
                     (jmetrics.get_registry(), jprof)):
        fam = reg.counter("marlin_stage_seconds_total", labelnames=("stage",))
        ev = reg.counter("marlin_stage_events_total", labelnames=("stage",))
        before = (fam.labels(stage="torch_test").value,
                  ev.labels(stage="torch_test").value)
        st = mod.StageTimes()
        st.add("torch_test", 0.25)
        st.add("torch_test", 0.25)
        fams.append((fam.labels(stage="torch_test").value - before[0],
                     ev.labels(stage="torch_test").value - before[1]))
    assert fams[0] == fams[1] == (pytest.approx(0.5), 2)
    assert "marlin_stage_seconds_total" in tmetrics.get_registry().render()


def test_trace_writes_a_chrome_trace(tmp_path):
    logdir = str(tmp_path / "trace")
    with tprof.trace(logdir) as where:
        assert where == logdir
        torch.ones((32, 32)) @ torch.ones((32, 32))
    files = [f for f in os.listdir(logdir) if f.endswith(".json")]
    assert len(files) == 1
    with open(os.path.join(logdir, files[0])) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)
    with tprof.trace(logdir):
        pass
    assert len(os.listdir(logdir)) == 2  # a second trace, not an overwrite


# ----------------------------------------------------------------- retry


def test_retry_delays_alike():
    for kw in (dict(max_attempts=6, base_delay=0.1, multiplier=2.0,
                    max_delay=0.5, jitter=0.0),
               dict(max_attempts=5, jitter=0.25, seed=9)):
        want = list(jretry.RetryPolicy(sleep=lambda s: None, **kw).delays())
        got = list(tretry.RetryPolicy(sleep=lambda s: None, **kw).delays())
        assert got == want
    assert got == list(tretry.RetryPolicy(max_attempts=5, jitter=0.25,
                                          seed=9).delays())
    with pytest.raises(ValueError, match="max_attempts"):
        tretry.RetryPolicy(max_attempts=0)


def _run_policy(retry, faults, log, point="fs.open", **kw):
    """Call a function that fires ``point`` under a seeded schedule through
    a seeded policy; returns (outcome, sleeps, retries, fired)."""
    sleeps = []
    pol = retry.RetryPolicy(seed=3, sleep=sleeps.append, event_log=log, **kw)
    calls = []

    def op():
        calls.append(1)
        faults.fire(point, path=f"/data/{len(calls)}")
        return len(calls)

    fault = faults.RaiseFault(times=-1,
                              schedule=faults.Schedule(seed=3, rate=0.6))
    with faults.injected(point, fault):
        try:
            out = ("ok", pol.call(op, describe="unit"))
        except faults.FaultInjected as exc:
            out = ("raised", str(exc))
    return out, sleeps, pol.retries, fault.fired


@pytest.mark.parametrize("attempts", [2, 8])
def test_retry_on_seeded_faults_alike(tmp_path, attempts):
    jlog = jtracing.EventLog(str(tmp_path / "j.jsonl"))
    tlog = ttracing.EventLog(str(tmp_path / "t.jsonl"))
    want = _run_policy(jretry, jfaults, jlog, max_attempts=attempts)
    got = _run_policy(tretry, tfaults, tlog, max_attempts=attempts)
    assert got == want
    # seed 3 fires the first three arrivals: 2 attempts run out, 8 succeed
    assert got[0][0] == ("raised" if attempts == 2 else "ok")
    keys = ("kind", "op", "attempt", "attempts", "delay_s", "error")
    strip = [[{k: r[k] for k in keys if k in r} for r in log.read()]
             for log in (jlog, tlog)]
    assert strip[1] == strip[0] and strip[1]
    jlog.close()
    tlog.close()


def test_retry_deadline_and_filter():
    t = {"now": 0.0}

    def sleep(s):
        t["now"] += s

    pol = tretry.RetryPolicy(max_attempts=100, base_delay=1.0, multiplier=1.0,
                             jitter=0.0, deadline=3.5, clock=lambda: t["now"],
                             sleep=sleep)
    calls = []

    def failing():
        calls.append(1)
        raise OSError("down")

    with pytest.raises(OSError):
        pol.call(failing)
    assert len(calls) == 4 and t["now"] == 3.0
    calls.clear()
    with pytest.raises(KeyError):  # not retryable: one call
        pol.call(lambda: (calls.append(1), {}["x"]))
    assert len(calls) == 1


def test_process_policy_swaps():
    default = tretry.get_retry_policy()
    mine = tretry.RetryPolicy(max_attempts=2)
    assert tretry.set_retry_policy(mine) is default
    assert tretry.get_retry_policy() is mine
    assert tretry.set_retry_policy(None) is mine
    assert tretry.get_retry_policy() is not mine
    assert tretry.get_retry_policy().max_attempts == \
        jretry.get_retry_policy().max_attempts


# -------------------------------------------------------------- mtutils


def test_mtutils_deterministic_factories_alike():
    arr = np.arange(12, dtype=np.float32).reshape(3, 4)
    pairs = [
        (jmtu.zeros_den_vec_matrix(3, 4), tmtu.zeros_den_vec_matrix(3, 4)),
        (jmtu.ones_den_vec_matrix(3, 4), tmtu.ones_den_vec_matrix(3, 4)),
        (jmtu.array_to_matrix(arr), tmtu.array_to_matrix(arr)),
        (jmtu.array_to_matrix(arr, "block"),
         tmtu.array_to_matrix(arr, "block")),
        (jmtu.repeat_by_row(jmtu.array_to_matrix(arr), 2),
         tmtu.repeat_by_row(tmtu.array_to_matrix(arr), 2)),
        (jmtu.repeat_by_column(jmtu.array_to_matrix(arr), 3),
         tmtu.repeat_by_column(tmtu.array_to_matrix(arr), 3)),
        (jmtu.random_spa_vec_matrix(40, 30, density=0.1, seed=4),
         tmtu.random_spa_vec_matrix(40, 30, density=0.1, seed=4)),
    ]
    for a, b in pairs:
        assert type(b).__name__ == type(a).__name__
        np.testing.assert_array_equal(tmtu.matrix_to_array(b),
                                      jmtu.matrix_to_array(a))
    np.testing.assert_array_equal(tmtu.ones_dis_vector(5).to_numpy(),
                                  jmtu.ones_dis_vector(5).to_numpy())
    for mod in (jmtu, tmtu):
        with pytest.raises(ValueError, match="unknown matrix kind"):
            mod.array_to_matrix(arr, "coo")


@pytest.mark.parametrize("name,args", [
    ("random_den_vec_matrix", (6, 5)), ("random_block_matrix", (6, 5)),
    ("random_dis_vector", (7,))])
def test_mtutils_random_factories(name, args):
    a = getattr(jmtu, name)(*args, seed=2)
    b = getattr(tmtu, name)(*args, seed=2)
    assert type(b).__name__ == type(a).__name__
    nb = b.to_numpy()
    assert nb.shape == a.to_numpy().shape and nb.dtype == np.float32
    assert ((nb >= 0) & (nb < 1)).all()
    np.testing.assert_array_equal(getattr(tmtu, name)(*args, seed=2)
                                  .to_numpy(), nb)
    normal = getattr(tmtu, name)(*args, seed=2, dist="normal").to_numpy()
    assert (normal < 0).any()
