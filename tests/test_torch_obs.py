"""The port's observability modules against the JAX package's, on the same
calls.

Copied modules (metrics, faults, the EventLog and its torn-line-tolerant
reader, the flight recorder, the memory ledger's accounting) must behave
exactly alike; the rewritten device sides hold their own contracts: no TPU
row in the peak table and ``(None, None)`` on the CPU, "n/a" live bytes on
the CPU, the analytic paged decode cost counting the kernel's bytes as
``paged_attention_cost`` does, and ``torch.cuda.OutOfMemoryError`` read as
an out-of-memory error.
"""

import json

import numpy as np
import pytest
import torch

import jax

from marlin_tpu.models import TransformerLM as JaxLM
from marlin_tpu.obs import memledger as jmem
from marlin_tpu.obs import metrics as jmetrics
from marlin_tpu.obs import perf as jperf
from marlin_tpu.obs import report as jreport
from marlin_tpu.utils import faults as jfaults
from marlin_tpu.utils import tracing as jtracing
from marlin_tpu_torch import config_context, interop
from marlin_tpu_torch.models.transformer import _n_layers
from marlin_tpu_torch.obs import memledger as tmem
from marlin_tpu_torch.obs import metrics as tmetrics
from marlin_tpu_torch.obs import perf as tperf
from marlin_tpu_torch.obs import report as treport
from marlin_tpu_torch.ops.paged_attention import paged_attention_cost
from marlin_tpu_torch.serving import batcher as tbatcher
from marlin_tpu_torch.serving import kvpool as tkv
from marlin_tpu_torch.utils import faults as tfaults
from marlin_tpu_torch.utils import tracing as ttracing


@pytest.fixture(autouse=True)
def _no_port_fault_leaks():
    yield
    leaked = tfaults.active()
    tfaults.clear()
    assert not leaked, f"port fault(s) leaked across tests: {leaked}"


def _fill(mod):
    reg = mod.MetricsRegistry()
    c = reg.counter("marlin_t_total", "a counter", labelnames=("kind",))
    c.labels(kind="a").inc()
    c.labels(kind="b").inc(2.5)
    g = reg.gauge("marlin_t_depth", "a gauge")
    g.set(7)
    g.dec(2)
    h = reg.histogram("marlin_t_seconds", "a histogram")
    for v in (0.001, 0.02, 0.3, 4.0, 50.0):
        h.observe(v)
    return reg


def test_metrics_registry_renders_alike():
    assert _fill(tmetrics).render() == _fill(jmetrics).render()
    vals = [0.5, 3.0, 1.0, 9.0, 2.0]
    for q in (0, 50, 90, 99, 100):
        assert tmetrics.percentile(vals, q) == jmetrics.percentile(vals, q)


def _firings(mod, **kw):
    fault = mod.RaiseFault(times=-1, schedule=mod.Schedule(**kw))
    fired = []
    with mod.injected("serve.decode_step", fault):
        for i in range(200):
            try:
                mod.fire("serve.decode_step", path=f"bucket-{i}")
            except mod.FaultInjected:
                fired.append(i)
    return fired


@pytest.mark.parametrize("kw", [dict(seed=7, rate=0.3),
                                dict(seed=11, rate=0.05),
                                dict(fire_on=[0, 3, 199])])
def test_fault_schedule_fires_alike(kw):
    assert _firings(tfaults, **kw) == _firings(jfaults, **kw)
    assert not jfaults.active()


def _log_and_read(mod_tracing, mod_report, path):
    log = mod_tracing.EventLog(str(path))
    log.event("serve", ev="step", rows=3, seconds=0.25)
    with log.timed("prefill", rid=4):
        pass
    log.close()
    with open(path, "a") as f:
        f.write('{"t": 1.0, "kind": "serve", "ev": "res')  # a torn tail
    recs, skipped = mod_report.load_events(str(path))
    with pytest.warns(RuntimeWarning):
        via_log = mod_tracing.EventLog(str(path)).read()
    strip = [{k: v for k, v in r.items()
              if k not in ("t", "seconds", "trace_id", "span_id",
                           "parent_id")} for r in recs]
    return strip, skipped, len(via_log)


def test_eventlog_and_torn_line_reader_alike(tmp_path):
    got = _log_and_read(ttracing, treport, tmp_path / "t.jsonl")
    want = _log_and_read(jtracing, jreport, tmp_path / "j.jsonl")
    assert got == want
    assert got[1] == 1 and got[2] == 2


def test_flight_recorder_ring_alike(tmp_path):
    rings = []
    for mod in (tperf, jperf):
        fr = mod.FlightRecorder(maxlen=4, name="t")
        for i in range(7):
            fr.record("step", i=i, rows=i % 3)
        path = fr.dump(path=str(tmp_path / f"{mod.__name__}.jsonl"),
                       reason="test")
        with open(path) as f:
            dumped = [json.loads(line) for line in f]
        rings.append(([{k: v for k, v in r.items() if k != "t"}
                       for r in fr.records()],
                      [(r["i"], r["reason"]) for r in dumped]))
    assert rings[0] == rings[1]
    assert [r["i"] for r in rings[0][0]] == [3, 4, 5, 6]


def _ledger(mod):
    led = mod.MemoryLedger()
    led.register("kvpool:e0", 4096, "kvpool", owner="e0")
    led.register("program:x", 512, "program", owner="p")
    led.add("prefetch:flow", 300, "prefetch")
    led.add("prefetch:flow", -500, "prefetch")  # driven negative: anomaly
    led.register("kvpool:e0", 1024, "kvpool", owner="e0")  # double register
    freed = [led.free("program:x"), led.free("nope"),
             led.free_owner("e0")]
    audit = led.audit()
    return freed, led.totals(), led.total_bytes(), audit["ok"], \
        len(audit["errors"])


def test_memledger_accounting_alike():
    assert _ledger(tmem) == _ledger(jmem)


def test_memledger_live_view_is_na_on_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tmem.live_device_bytes() is None
    code, body = tmem.memory_payload()
    assert body["live_bytes"] == "n/a"
    assert body["unattributed_bytes"] == "n/a"
    rec = tmem.reconcile(tmem.MemoryLedger())
    assert rec["live_bytes"] is None and rec["unattributed_bytes"] is None


def test_admission_ratio_reads_no_tpu_table():
    """The port's calibration is a peak measured in this process or 1.0:
    no AOT_MEMORY.json figure reaches it, whatever the key."""
    tmem.reset_ledger()
    key = "bucket=128x32 rows=8 dtype=float32 model=v4096d512l4/page16"
    assert tmem.admission_ratio(1 << 20, ("lm_decode_paged",), key) == 1.0
    tmem.reset_ledger()


def test_peak_rates_have_no_tpu_row(monkeypatch):
    names = [sub for sub, _, _ in tperf._GPU_PEAKS]
    assert names == ["h100"]
    assert not any(n.startswith("v") and n[1:2].isdigit() for n in names)
    assert not hasattr(tperf, "_TPU_PEAKS")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tperf.peak_rates() == (None, None)
    assert tperf.peak_rates("cpu") == (None, None)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda d=None: "NVIDIA H100 80GB HBM3")
    assert tperf.peak_rates("cuda") == (67e12, 3.35e12)
    assert tperf.peak_rates("cuda", "bfloat16") == (989e12, 3.35e12)
    assert tperf.peak_rates("cuda", "tf32") == (495e12, 3.35e12)
    with config_context(obs_peak_flops=1.0, obs_peak_bw=2.0):
        assert tperf.peak_rates() == (1.0, 2.0)


@pytest.fixture(scope="module")
def tparams():
    jp = JaxLM(vocab=32, d_model=16, heads=4, layers=2, seed=9).init_params()
    return interop.lm_params_from_numpy(jax.tree.map(np.asarray, jp),
                                        device="cpu")


def test_paged_costs_count_the_kernel_like_paged_attention_cost(tparams):
    heads, page_len, max_batch, bucket = 4, 4, 3, (8, 4)
    with config_context(device="cpu"):
        pool = tkv.PagedKVPool(tparams, heads, 16, page_len)
    g = tkv.PagedGroup(bucket, max_batch, page_len, 8)
    dense = tbatcher.lm_call_cost(tparams, heads, max_batch, 1, 0,
                                  attention=False)
    kc = paged_attention_cost(max_batch, g.pages_per_row, page_len, 4, 1, 4)
    costs = tperf.get_program_costs()
    costs.reset()
    key = tkv.paged_program_key(tparams, bucket, max_batch, page_len,
                                kernel="pallas")
    assert key == ("bucket=8x4 rows=3 dtype=float32 model=v32d16l2"
                   "/page4/kpallas")
    tkv.capture_paged_costs(tparams, heads, bucket, max_batch, pool, 8,
                            key=key, kernel="pallas")
    rows = {r["program"]: r for r in costs.rows()}
    n = _n_layers(tparams)
    dec = rows["lm_decode_paged"]
    assert dec["bytes"] - dense["bytes accessed"] == n * kc["bytes accessed"]
    assert dec["flops"] - dense["flops"] == n * kc["flops"]
    assert rows["lm_prefill_paged"]["flops"] > 0
    tkv.capture_paged_costs(tparams, heads, bucket, max_batch, pool, 8,
                            key=key, kernel="pallas")  # gated: no change
    assert {r["program"]: r for r in costs.rows()} == rows
    costs.reset()


def test_is_oom_error_reads_cuda_oom():
    assert tmem.is_oom_error(torch.cuda.OutOfMemoryError("CUDA out of mem"))
    assert tmem.is_oom_error(type("PagePoolExhausted", (Exception,), {})())
    assert tmem.is_oom_error(RuntimeError("RESOURCE_EXHAUSTED: x"))
    assert not tmem.is_oom_error(ValueError("bad shape"))
