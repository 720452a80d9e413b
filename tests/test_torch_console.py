"""The port's ops console (``marlin_tpu_torch/obs/console.py``) and the cost
hooks of its multiplies and tuners, against the JAX package's, on the CPU.

- The console is a copy: ``render`` gives byte-identical frames to
  ``marlin_tpu.obs.console.render`` for the same payloads (the fleet panel
  of ``tests/test_fleet.py``, the memory panel of
  ``tests/test_memledger.py``, the SLO golden of ``tests/test_slo.py``,
  empty payloads), and ``parse_metrics``, ``metric_value``, ``sparkline``
  and ``bar`` return what the JAX versions return. ``main(["--url", url,
  "--once"])`` renders one frame off a live port engine's ``MetricsServer``.
- The hooks: ``rmm_matmul``, ``broadcast_matmul`` and ``gspmd_matmul`` land
  ``ProgramCosts`` rows under the JAX package's program names and key
  strings; ``tune_multiply``, ``tune_gemm`` and ``tune_bsr`` land one row per
  timed candidate under ``"multiply"``, ``"gemm"`` and ``"bsr_spmm"`` with
  the JAX package's analytic flops and bytes, hold their result buffer in
  the memory ledger under ``autotune`` for the timing window only, and rank
  and cache exactly as without the hooks.

Counts compare exactly (flops, bytes, keys, frames).
"""

import contextlib
import importlib
import os
import sys

import numpy as np
import pytest
import torch

import jax

import marlin_tpu as jm
import marlin_tpu_torch as tm
from marlin_tpu.obs import console as jcon
from marlin_tpu.obs import memledger as jmem
from marlin_tpu.obs import perf as jperf
from marlin_tpu_torch.obs import console as tcon
from marlin_tpu_torch.obs import memledger as tmem
from marlin_tpu_torch.obs import perf as tperf
from marlin_tpu_torch.parallel import autotune

# the packages' parallel/__init__ export the function matmul over the module
jmatmul = importlib.import_module("marlin_tpu.parallel.matmul")
tmatmul = importlib.import_module("marlin_tpu_torch.parallel.matmul")

_METRICS_TEXT = """\
# TYPE marlin_serve_queue_depth gauge
marlin_serve_queue_depth 3
marlin_serve_slot_occupancy 0.75
marlin_serve_kv_pages_used 40
marlin_serve_kv_pages_total 128
marlin_slo_shed_total{slo="ttft",scope="serve-0"} 2
marlin_serve_migrations_total{leg="export"} 4
marlin_serve_migrations_total{leg="adopt"} 4
garbage line that must be skipped
"""

_SLO = {
    "status": "ok",
    "scopes": [
        {"scope": "serve-0",
         "health": {"state": "accepting", "queue_depth": 3, "live_slots": 2},
         "pages": {"total": 128, "used": 40},
         "objectives": [
             {"slo": "ttft", "value": 0.8, "target": 0.5, "compliance": 0.82,
              "burn_rate": 6.4, "budget_remaining": 0.0, "breached": True}],
         "events": [{"slo": "ttft", "state": "breach", "burn_rate": 6.4,
                     "value": 0.8, "target": 0.5}]},
        {"scope": "fleet",
         "objectives": [
             {"slo": "ttft", "value": 0.8, "target": 0.5, "compliance": 0.82,
              "burn_rate": 6.4, "budget_remaining": 0.0, "breached": True,
              "replicas": 1, "worst": "serve-0"}],
         "events": []},
    ],
}

# a FleetController.payload() as tests/test_fleet.py's controller gives it
# after one scale-out (marlin_tpu/serving/fleet.py:438-464), an action in
# flight that timed out, and replica-hours
_FLEET = {"fleets": [{
    "controller": "fleet-0", "router": "router-7", "closed": False,
    "replicas": 2, "bounds": {"min": 1, "max": 4}, "burn": 5.0,
    "thresholds": {"out": 2.0, "in": 0.5, "hysteresis": 1},
    "streaks": {"hot": 1, "slack": 0, "imbalance": 0},
    "action": {"action": "scale_in", "timed_out": True},
    "history": [{"action": "scale_out", "outcome": "ok"},
                {"action": "rebalance", "outcome": "ok", "replica": 1},
                {"action": "scale_out", "outcome": "ok"},
                {"action": "scale_in", "outcome": "failed", "replica": 0}],
    "view": [], "replica_seconds": 7200.0}]}


@pytest.fixture(autouse=True)
def _cpu():
    with tm.config_context(device="cpu", autotune_cache_path=""):
        yield


@pytest.fixture
def costs():
    tperf.get_program_costs().reset()
    jperf.get_program_costs().reset()
    yield tperf.get_program_costs()
    tperf.get_program_costs().reset()
    jperf.get_program_costs().reset()


@pytest.fixture
def ledgers(monkeypatch):
    monkeypatch.setattr(tmem, "live_device_bytes", lambda: None)
    monkeypatch.setattr(jmem, "live_device_bytes", lambda: None)
    tmem.reset_ledger()
    jmem.reset_ledger()
    yield
    tmem.reset_ledger()
    jmem.reset_ledger()


# ----------------------------------------------------------------- console


@pytest.mark.parametrize("case", ["slo", "empty_scopes", "empty", "fleet",
                                  "no_fleet", "history"])
def test_render_matches_the_jax_console(case):
    metrics = tcon.parse_metrics(_METRICS_TEXT)
    kw = {}
    if case == "slo":
        args = (metrics, _SLO)
    elif case == "empty_scopes":
        args = ({}, {"scopes": []})
    elif case == "empty":
        args = ({}, {})
    elif case == "fleet":
        args, kw = ({}, {"scopes": []}), {"fleet": _FLEET}
    elif case == "no_fleet":
        args, kw = ({}, {"scopes": []}), {"fleet": None}
    else:
        args = (metrics, _SLO, {"fleet/ttft": [0.5, 2.0, 6.4]})
    got, want = tcon.render(*args, **kw), jcon.render(*args, **kw)
    assert got == want
    if case == "fleet":
        assert "fleet router-7" in got and "replicas=2 [1..4]" in got
        assert "(TIMED OUT)" in got and "replica-hours 2.000" in got
    if case == "empty":
        assert "no SLO scopes registered" in got


def test_render_golden_snapshot():
    """The JAX package's goldened frame (tests/test_slo.py), byte for byte."""
    frame = tcon.render(tcon.parse_metrics(_METRICS_TEXT), _SLO,
                        history={"fleet/ttft": [0.5, 2.0, 6.4]})
    golden = os.path.join(os.path.dirname(__file__), "..", "tools",
                          "fixtures", "slo_console_golden.txt")
    with open(golden) as f:
        assert frame == f.read()


def test_memory_panel_matches(ledgers):
    """The ``/debug/memory`` payload of the port's ledger renders as the
    JAX console renders it, and as the JAX ledger's payload of the same
    registrations renders (tests/test_memledger.py's panel)."""
    for mem in (tmem, jmem):
        led = mem.get_ledger()
        led.register("kvpool:x", 700, "kvpool")
        led.register("program:y", 300, "program")
    frames = []
    for mem in (tmem, jmem):
        _, body = mem.memory_payload()
        body["leak_alerts"] = [{"component": "kvpool", "freed_bytes": 4096,
                                "live_drop_bytes": 0, "windows": 3,
                                "t": 0.0}]
        frames.append((tcon.render({}, {"scopes": []}, memory=body),
                       jcon.render({}, {"scopes": []}, memory=body)))
    (tt, tj), (jt, jj) = frames
    assert tt == tj and jt == jj
    # the JAX ledger's payload adds the planner-ratio table of its TPU
    # compile figures (AOT_MEMORY.json), which the port leaves out
    assert tt == "".join(ln for ln in jt.splitlines(keepends=True)
                         if not ln.startswith(("    bucket ", "    256x",
                                               "    64x", "    128x",
                                               "    512x")))
    assert "memory: registered=1000 live=n/a unattributed=n/a" in tt
    assert "LEAK kvpool: freed 4096 B" in tt
    assert "LEDGER AUDIT VIOLATED" not in tt
    tmem.get_ledger().register("kvpool:x", 700, "kvpool")  # double register
    _, body = tmem.memory_payload()
    frame = tcon.render({}, {"scopes": []}, memory=body)
    assert frame == jcon.render({}, {"scopes": []}, memory=body)
    assert "LEDGER AUDIT VIOLATED" in frame


@pytest.mark.parametrize("text", [
    _METRICS_TEXT,
    "",
    'a{x="1",y="2"} 3\na{x="1"} 4\nb 5e-3\nc{} nan\n  # comment\nbroken{ 1',
])
def test_parse_metrics_and_value_match(text):
    got, want = tcon.parse_metrics(text), jcon.parse_metrics(text)
    assert repr(got) == repr(want)
    for name, labels in (("marlin_serve_migrations_total", {}),
                         ("marlin_serve_migrations_total", {"leg": "adopt"}),
                         ("a", {"x": "1"}), ("b", {}), ("missing", {})):
        assert tcon.metric_value(got, name, -1.0, **labels) == \
            jcon.metric_value(want, name, -1.0, **labels)


@pytest.mark.parametrize("values,width", [
    ([0, 1, 2, 4], 4), ([], 4), ([0, 0], 4), ([3.5, -1, 7, 2, 9, 0.1], 24),
    (list(range(40)), 24), ([5, 5, 5], 2)])
def test_sparkline_matches(values, width):
    assert tcon.sparkline(values, width) == jcon.sparkline(values, width)


@pytest.mark.parametrize("frac,width", [
    (0.5, 4), (2.0, 4), (-1.0, 4), (0.0, 20), (0.333, 20), (0.97, 7)])
def test_bar_matches(frac, width):
    assert tcon.bar(frac, width) == jcon.bar(frac, width)


def test_main_usage_and_unreachable(capsys):
    """A bad flag prints the usage (naming the port's module) and returns 2;
    an unreachable server renders one "unreachable" frame with ``--once``."""
    assert tcon.main(["--bogus"]) == 2
    assert "python -m marlin_tpu_torch.obs.console" in capsys.readouterr().err
    import socket

    with socket.socket() as s:  # a free loopback port nobody listens on
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    assert tcon.main(["--url", f"http://127.0.0.1:{port}", "--once"]) == 0
    assert "unreachable" in capsys.readouterr().out


def test_console_once_against_a_live_engine(ledgers, capsys):
    """``main(["--url", url, "--once"])`` off a port engine's MetricsServer:
    the engine's gauges and the memory panel (its KV pool) in the frame, and
    the frame is the JAX console's ``render`` of the same fetched payloads."""
    from marlin_tpu_torch.models import TransformerLM
    from marlin_tpu_torch.obs import MetricsServer
    from marlin_tpu_torch.serving import Request, ServeEngine

    params = TransformerLM(vocab=32, d_model=16, heads=2, layers=2,
                           seed=9).init_params()
    with ServeEngine(params, 2, buckets=((8, 4),), max_batch=2, page_len=4,
                     max_wait_ms=0.0) as eng:
        eng.submit(Request(prompt=np.arange(5, dtype=np.int32),
                           steps=3)).result(timeout=60)
        with MetricsServer(port=0) as srv:
            url = f"http://127.0.0.1:{srv.port}"
            assert tcon.main(["--url", url, "--once"]) == 0
            frame = capsys.readouterr().out
            metrics, slo = tcon.fetch(url)
            memory = tcon.fetch_memory(url)
            fleet = tcon.fetch_fleet(url)
    assert fleet is None and slo.get("scopes") == []
    pages = tcon.metric_value(metrics, "marlin_serve_kv_pages_total")
    assert pages > 0
    assert f"pages=0/{int(pages)}" in frame or "pages=" in frame
    assert "memory: registered=" in frame and "kvpool" in frame
    assert frame == jcon.render(metrics, slo, {}, fleet=fleet, memory=memory)


def test_console_runs_as_a_module():
    import subprocess

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-m", "marlin_tpu_torch.obs.console",
                          "--help"], capture_output=True, text=True, cwd=root)
    assert out.returncode == 2 and "marlin_tpu_torch.obs.console" in out.stderr


# ------------------------------------------------------------ matmul hooks


def _operands(m=24, k=16, n=8, dtype=np.float32):
    rng = np.random.default_rng(0)
    return (rng.random((m, k)).astype(dtype), rng.random((k, n)).astype(dtype))


def _rows(reg, program):
    return {r["key"]: (r["flops"], r["bytes"]) for r in reg.rows()
            if r["program"] == program}


@pytest.mark.parametrize("strategy", ["gspmd", "broadcast", "broadcast_a",
                                      "rmm"])
def test_matmul_hook_keys_match_jax(costs, strategy):
    """The strategy functions land the JAX package's program name and key
    string with the analytic cost; the JAX side's own hook runs on a
    one-device mesh (XLA's cost model, whose flops are the same 2mkn)."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    a, b = _operands()
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    mesh = jm.create_mesh((1, 1), devices=jax.devices()[:1])
    out = NamedSharding(mesh, P("rows", "cols"))
    ja, jb = jax.numpy.asarray(a), jax.numpy.asarray(b)
    if strategy == "gspmd":
        program = "gspmd_matmul"
        got = tmatmul.gspmd_matmul(ta, tb, tm.create_mesh())
        want = jmatmul.gspmd_matmul(ja, jb, out)
    elif strategy == "rmm":
        program = "rmm_matmul"
        got = tmatmul.rmm_matmul(ta, tb, (1, 1, 1))
        try:
            want = jmatmul.rmm_matmul(ja, jb, (1, 1, 1), jax.devices()[:1])
        except Exception:
            # the seed's shard_map path under this jax
            # (tests/test_perf.py:575-577): the key string is still
            # the JAX package's, built before the program runs
            want = a @ b
    else:
        program = "broadcast_matmul"
        rep = "a" if strategy == "broadcast_a" else "b"
        got = tmatmul.broadcast_matmul(ta, tb, tm.create_mesh(), rep)
        want = jmatmul.broadcast_matmul(ja, jb, out, rep)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
    trows = _rows(costs, program)
    assert len(trows) == 1
    (key, (flops, nbytes)), = trows.items()
    assert flops == 2.0 * 24 * 16 * 8
    assert nbytes == float((24 * 16 + 16 * 8 + 24 * 8) * 4)
    meta = {"gspmd": "devices=1", "rmm": "split=1x1x1",
            "broadcast": "replicate=b", "broadcast_a": "replicate=a"}
    assert key == f"shape=24x16x8 dtype=float32 {meta[strategy]}"
    jrows = _rows(jperf.get_program_costs(), program)
    if jrows:
        # XLA's own count of the same product: 2mkn give or take the
        # reduction's first add and rmm's psum
        assert set(jrows) == {key}
        assert jrows[key][0] == pytest.approx(flops, rel=0.05)


def test_multiply_lands_the_strategy_rows(costs):
    """``DenseMatrix.multiply`` reaches the strategy functions through the
    padded path, so each strategy lands its row, once per configuration."""
    a, b = _operands(32, 32, 32)
    ma = tm.DenseVecMatrix.from_array(a)
    mb = tm.DenseVecMatrix.from_array(b)
    for s in ("rmm", "gspmd", "broadcast", "broadcast_a", "auto"):
        for _ in range(2):
            c = ma.multiply(mb, strategy=s)
            np.testing.assert_allclose(c.to_numpy(), a @ b, rtol=1e-5)
    programs = sorted(r["program"] for r in costs.rows())
    assert programs == ["broadcast_matmul", "broadcast_matmul",
                        "gspmd_matmul", "rmm_matmul"]
    assert all(r["flops"] == 2.0 * 32 ** 3 and r["calls"] == 0
               for r in costs.rows())


def test_matmul_hook_is_tried_gated_and_never_raises(costs, monkeypatch):
    a, b = (torch.from_numpy(x) for x in _operands())
    calls = []
    capture = tperf.ProgramCosts.capture

    def counting(self, *args, **kwargs):
        calls.append(args[:2])
        return capture(self, *args, **kwargs)

    monkeypatch.setattr(tperf.ProgramCosts, "capture", counting)
    for _ in range(3):
        tmatmul.gspmd_matmul(a, b)
    assert len(calls) == 1

    def broken(**parts):
        raise RuntimeError("program_key unavailable")

    monkeypatch.setattr(tperf, "program_key", broken)
    out = tmatmul.rmm_matmul(a, b)  # the hook fails; the multiply does not
    np.testing.assert_allclose(out.numpy(), (a @ b).numpy())


# ------------------------------------------------------------ tuner hooks


def test_tune_multiply_lands_multiply_rows(costs):
    """The port of tests/test_perf.py::test_autotune_lands_candidate_timings,
    held against the JAX tuner's rows on a one-device mesh: the same keys,
    flops 2·64³ and the same analytic bytes."""
    from marlin_tpu.parallel.autotune import tune_multiply as jtune

    mesh = jm.create_mesh((1, 1), devices=jax.devices()[:1])
    ja = jm.DenseVecMatrix.random(0, 64, 64, mesh=mesh)
    jb = jm.DenseVecMatrix.random(1, 64, 64, mesh=mesh)
    ta = tm.DenseVecMatrix.random(0, 64, 64)
    tb = tm.DenseVecMatrix.random(1, 64, 64)
    strategies = ["gspmd", "broadcast"]
    jres = jtune(ja, jb, strategies=strategies, reps=1)
    tres = autotune.tune_multiply(ta, tb, strategies=strategies, reps=1)
    assert {s for s, _ in tres} == {s for s, _ in jres} == set(strategies)
    trows = {r["key"]: r for r in costs.rows() if r["program"] == "multiply"}
    jrows = {r["key"]: r for r in jperf.get_program_costs().rows()
             if r["program"] == "multiply"}
    assert set(trows) == set(jrows) and len(trows) == 2
    for key, r in trows.items():
        assert "shape=64x64x64" in key
        assert r["flops"] == pytest.approx(2 * 64 ** 3) == jrows[key]["flops"]
        assert r["bytes"] == jrows[key]["bytes"] == float(3 * 64 * 64 * 4)
        assert r["calls"] == 1 and r["seconds"] > 0


def test_tune_gemm_lands_gemm_rows(costs):
    a, b = _operands(48, 40, 24)
    res = autotune.tune_gemm(torch.from_numpy(a), torch.from_numpy(b), reps=1)
    rows = {r["key"]: r for r in costs.rows() if r["program"] == "gemm"}
    assert len(rows) == len(res) >= 2
    for name, _ in res:
        r = rows[f"candidate={name} shape=48x40x24 dtype=float32"]
        # JAX autotune.py:414-421
        assert r["flops"] == 2.0 * 48 * 40 * 24
        assert r["bytes"] == float((48 * 40 + 40 * 24 + 48 * 24) * 4)
        assert r["calls"] == 1
    # the JAX tuner's row for the candidate both packages time
    from marlin_tpu.parallel.autotune import tune_gemm as jtune

    jtune(a, b, candidates=["xla"], reps=1)
    jrow, = [r for r in jperf.get_program_costs().rows()
             if r["program"] == "gemm"]
    key = "candidate=xla shape=48x40x24 dtype=float32"
    assert jrow["key"] == key and jrow["bytes"] == rows[key]["bytes"]


def _bsr_pair(seed=0, m=64, n=48, bs=8, keep=0.3):
    from marlin_tpu.ops import sparse_bsr as jbsr
    from marlin_tpu_torch.ops import sparse_bsr as tbsr

    rng = np.random.default_rng(seed)
    mask = rng.random((m // bs, n // bs)) < keep
    dense = rng.standard_normal((m, n)).astype(np.float32)
    dense *= np.kron(mask, np.ones((bs, bs), np.float32))
    return (tbsr.bsr_from_dense(torch.from_numpy(dense), bs),
            jbsr.bsr_from_dense(dense, bs), dense)


def test_tune_bsr_lands_bsr_rows(costs):
    tb, jb, dense = _bsr_pair()
    b = np.random.default_rng(1).standard_normal((48, 16)).astype(np.float32)
    res = autotune.tune_bsr(tb, torch.from_numpy(b), reps=1)
    rows = {r["key"]: r for r in costs.rows() if r["program"] == "bsr_spmm"}
    assert len(rows) == len(res)
    bs, nnzb, p = 8, tb.nnzb, 16
    for name, _ in res:
        r = rows[f"candidate={name} shape=64x48 bs={bs} nnzb={nnzb} p={p}"]
        # JAX autotune.py:489-500
        assert r["flops"] == 2.0 * nnzb * bs * bs * p
        assert r["bytes"] == float(nnzb * (bs * bs + bs * p) * 4 + 64 * p * 4)
        assert r["calls"] == 1
    from marlin_tpu.parallel.autotune import tune_bsr as jtune

    chunked = next(name for name, _ in res if name.startswith("chunked"))
    jtune(jb, b, candidates=[chunked], reps=1)
    jrow, = [r for r in jperf.get_program_costs().rows()
             if r["program"] == "bsr_spmm"]
    key = f"candidate={chunked} shape=64x48 bs={bs} nnzb={nnzb} p={p}"
    assert jrow["key"] == key
    assert (jrow["flops"], jrow["bytes"]) == (rows[key]["flops"],
                                              rows[key]["bytes"])


def test_tuners_account_scratch_for_the_window_only(costs, ledgers,
                                                    monkeypatch):
    """Inside each tuner's timing loop the ledger holds the result buffer
    under ``autotune``; after the tune the component is gone."""
    from marlin_tpu_torch.ops import local

    seen = []
    led = tmem.get_ledger()
    gemm = local.gemm

    def watching(*args, **kwargs):
        seen.append(led.totals().get("autotune", 0))
        return gemm(*args, **kwargs)

    monkeypatch.setattr(local, "gemm", watching)
    a, b = _operands(48, 40, 24)
    autotune.tune_gemm(torch.from_numpy(a), torch.from_numpy(b),
                       candidates=["xla"], reps=1)
    assert seen and all(v == 48 * 24 * 4 for v in seen)
    assert led.totals().get("autotune", 0) == 0

    ta = tm.DenseVecMatrix.random(0, 32, 32)
    mult = type(ta).multiply
    seen.clear()

    def watching_multiply(self, *args, **kwargs):
        seen.append(led.totals().get("autotune", 0))
        return mult(self, *args, **kwargs)

    monkeypatch.setattr(type(ta), "multiply", watching_multiply)
    autotune.tune_multiply(ta, ta, strategies=["gspmd"], reps=1)
    assert seen and all(v == 32 * 32 * 4 for v in seen)

    tb, _, _ = _bsr_pair()
    bmat = type(tb).multiply
    seen.clear()

    def watching_bsr(self, *args, **kwargs):
        seen.append(led.totals().get("autotune", 0))
        return bmat(self, *args, **kwargs)

    monkeypatch.setattr(type(tb), "multiply", watching_bsr)
    autotune.tune_bsr(tb, torch.ones((48, 16)), reps=1)
    assert seen and all(v == 64 * 16 * 4 for v in seen)
    assert led.totals().get("autotune", 0) == 0
    assert led.audit()["ok"]


def test_hooks_leave_rankings_and_caches_alone(costs, monkeypatch):
    """With the timings fixed, each tuner returns the same table and caches
    the same winner with its hooks as with them switched off."""
    fixed = {"gspmd": 3.0, "rmm": 1.0, "ring": 2.0, "broadcast": 5.0,
             "broadcast_a": 4.0}
    timed = []

    def fake_time(run, reps):
        run()
        return fixed[timed.pop(0)] if timed else 1.0

    ta = tm.DenseVecMatrix.random(0, 32, 32)
    a, b = (torch.from_numpy(x) for x in _operands(48, 40, 24))
    tb, _, _ = _bsr_pair()
    rhs = torch.ones((48, 16))

    def tune_all():
        autotune.clear_cache()
        timed[:] = autotune._candidates(ta, (32, 32), 4)
        mres = autotune.tune_multiply(ta, ta)
        gres = autotune.tune_gemm(a, b)
        bres = autotune.tune_bsr(tb, rhs)
        return mres, [g for g, _ in gres], [n for n, _ in bres][0], \
            dict(autotune._CACHE)

    def fake_rounds(run, reps, rounds, device):
        run()
        return [1.0] * rounds

    monkeypatch.setattr(autotune, "_time", fake_time)
    monkeypatch.setattr(autotune, "_rounds", fake_rounds)
    with_hooks = tune_all()
    assert with_hooks[0][0] == ("rmm", 1.0)
    assert any(r["program"] == "multiply" for r in costs.rows())
    costs.reset()
    monkeypatch.setattr(autotune, "_land", lambda *args: None)
    monkeypatch.setattr(autotune, "_scratch_accounted",
                        lambda tag, nbytes: contextlib.nullcontext())
    without = tune_all()
    assert with_hooks == without
    assert not [r for r in costs.rows()
                if r["program"] in ("multiply", "gemm", "bsr_spmm")]
