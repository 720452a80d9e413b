"""The port's dense-slab serving control against the JAX package's, on the CPU.

``lm_prefill_slot`` / ``lm_decode_rows`` over ``init_kv_slab``, and
``ServeEngine(paged=False)`` over one ``SlotPool`` a bucket, with the row-level
cases of ``tests/test_serving.py`` as the oracle list. One tiny LM (vocab 32,
d_model 16, 2 heads, 2 layers, seed 9; and a GQA one, 4 heads over 2 K/V
heads) serves through both packages, the port's params carried from the JAX
package's by ``interop.lm_params_from_numpy``.

Tolerances: tokens, statuses and slots are EQUAL (greedy and sampled: the
threefry port replays the JAX package's streams); the slab's K/V within
1e-5 (f32 sums in two frameworks).
"""

import numpy as np
import pytest
import torch

import jax

from marlin_tpu.models import TransformerLM as JaxLM
from marlin_tpu.models import transformer as jt
from marlin_tpu.serving import Request as JRequest
from marlin_tpu.serving import ServeEngine as JEngine
from marlin_tpu_torch import config_context, interop
from marlin_tpu_torch.models import transformer as tt
from marlin_tpu_torch.obs import memledger
from marlin_tpu_torch.serving import MigrationError
from marlin_tpu_torch.serving import Request as TRequest
from marlin_tpu_torch.serving import ServeEngine as TEngine
from marlin_tpu_torch.serving import batcher as tbatcher
from marlin_tpu_torch.utils import faults as tfaults

HEADS = 2
BUCKETS = ((8, 4), (16, 4))
VOCAB = 32
WAIT_S = 60.0
KV_TOL = 1e-5


@pytest.fixture(autouse=True)
def _cpu_and_no_fault_leaks():
    with config_context(device="cpu"):
        yield
    leaked = tfaults.active()
    tfaults.clear()
    assert not leaked, f"port fault(s) leaked across tests: {leaked}"


def _pair(heads=HEADS, kv_heads=None, seed=9):
    jp = JaxLM(vocab=VOCAB, d_model=16, heads=heads, layers=2,
               kv_heads=kv_heads, seed=seed).init_params()
    return jp, interop.lm_params_from_numpy(jax.tree.map(np.asarray, jp),
                                            device="cpu")


@pytest.fixture(scope="module")
def params():
    return _pair()


def _tref(tp, prompt, steps, heads=HEADS):
    return tt.lm_generate(tp, np.asarray(prompt, np.int32), 0, heads=heads,
                          max_len=len(prompt) + steps, steps=steps).tolist()


def _engine(tp, heads=HEADS, **kw):
    kw.setdefault("buckets", BUCKETS)
    kw.setdefault("max_batch", 4)
    kw.setdefault("queue_depth", 64)
    return TEngine(tp, heads, paged=False, **kw)


# ---------------------------------------------------------------- programs


@pytest.mark.parametrize("kv_heads", [None, 2])
def test_prefill_slot_and_decode_rows_match_jax(kv_heads):
    """Two rows prefilled into slots 2 and 0 of a 3-slot slab (one greedy,
    one sampled), a free slot riding along, then three decode steps: first
    and next tokens equal, token rows equal, the slab's K/V within 1e-5."""
    heads = 4 if kv_heads else HEADS
    jp, tp = _pair(heads, kv_heads)
    rows, max_len, P = 3, 12, 8
    jc = jt.init_kv_slab(jp, rows, max_len, heads)
    jtok = np.zeros((rows, max_len), np.int32)
    tc = tt.init_kv_slab(tp, rows, max_len, heads)
    ttok = torch.zeros((rows, max_len), dtype=torch.long)
    assert tc["l1"][0].shape == tuple(jc["l1"][0].shape)
    rng = np.random.default_rng(3)
    knobs = dict(temperature=np.float32([0.0, 0.0, 0.8]),
                 top_p=np.float32([1.0, 1.0, 0.9]),
                 top_k=np.int32([0, 0, 5]), seeds=np.uint32([0, 0, 17]))
    lengths = {2: 5, 0: 8}
    positions = np.zeros(rows, np.int32)
    for slot, n in lengths.items():
        prompt = np.zeros(P, np.int32)
        prompt[:n] = rng.integers(0, VOCAB, n)
        kw = dict(heads=heads, max_len=max_len,
                  seed=int(knobs["seeds"][slot]),
                  temperature=float(knobs["temperature"][slot]),
                  top_p=float(knobs["top_p"][slot]),
                  top_k=int(knobs["top_k"][slot]))
        jc, jtok, jf = jt.lm_prefill_slot(jp, jc, jtok, slot, prompt, n, **kw)
        tc, ttok, tf = tt.lm_prefill_slot(tp, tc, ttok, slot, prompt, n, **kw)
        assert int(tf) == int(jf)
        positions[slot] = n
    steps = np.where(positions > 0, 1, 0).astype(np.int32)
    for _ in range(3):
        args = (positions, steps, knobs["seeds"], knobs["temperature"],
                knobs["top_p"], knobs["top_k"])
        jc, jtok, jn = jt.lm_decode_rows(jp, jc, jtok, *args, heads=heads,
                                         max_len=max_len)
        tc, ttok, tn = tt.lm_decode_rows(tp, tc, ttok, *args, heads=heads,
                                         max_len=max_len)
        np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
        live = positions > 0
        positions[live] += 1
        steps[live] += 1
    np.testing.assert_array_equal(ttok.numpy()[[0, 2]],
                                  np.asarray(jtok)[[0, 2]])
    for name in jc:
        for j in range(2):
            np.testing.assert_allclose(tc[name][j].numpy()[[0, 2]],
                                       np.asarray(jc[name][j])[[0, 2]],
                                       rtol=0, atol=KV_TOL)
    with pytest.raises(ValueError, match="no room"):
        tt.lm_prefill_slot(tp, tc, ttok, 0, np.zeros(max_len, np.int32), 1,
                           heads=heads, max_len=max_len)


def test_slot_pool_and_warmup():
    """A SlotPool's vectors as the JAX package's; warmup_buckets runs both
    buckets' pair and lands their costs."""
    from marlin_tpu.serving import batcher as jbatcher

    jp, tp = _pair()
    jpool = jbatcher.SlotPool(jp, HEADS, (8, 4), 3)
    tpool = tbatcher.SlotPool(tp, HEADS, (8, 4), 3)
    for k in ("positions", "steps_done", "lengths", "seeds", "temperature",
              "top_p", "top_k"):
        np.testing.assert_array_equal(getattr(tpool, k), getattr(jpool, k))
    assert tpool.max_len == jpool.max_len == 12
    assert tpool.nbytes() == 2 * 2 * 3 * 12 * 16 * 4 + 3 * 12 * 8
    assert tbatcher.warmup_buckets(tp, HEADS, BUCKETS, 2) == 2


# ------------------------------------------------------------------ engine


def _specs(tp, seed=0):
    """Ragged greedy rows, sampled rows (their own seeds and knobs), and a
    greedy row whose eos is its second generated token."""
    rng = np.random.default_rng(seed)
    specs = []
    for _ in range(6):
        n = int(rng.integers(1, 15))
        specs.append(dict(prompt=rng.integers(0, VOCAB, n).astype(np.int32),
                          steps=int(rng.integers(1, 5))))
    for i in range(3):
        n = int(rng.integers(2, 15))
        specs.append(dict(prompt=rng.integers(0, VOCAB, n).astype(np.int32),
                          steps=4, temperature=0.8, seed=100 + i,
                          top_k=(None, 8)[i % 2], top_p=(None, 0.9)[i // 2]))
    p = rng.integers(0, VOCAB, 6).astype(np.int32)
    specs.append(dict(prompt=p, steps=4, eos=int(_tref(tp, p, 4)[7])))
    return specs


def _staged(eng, request_cls, specs):
    hs = [eng.submit(request_cls(**s)) for s in specs]
    eng.start()
    return [h.result(timeout=WAIT_S) for h in hs]


def test_slab_engine_matches_jax_and_generate(params):
    """The same staged queue through both packages' slab engines: statuses,
    tokens and slots equal; greedy rows equal ``lm_generate``; no
    migration; the slab in the memory ledger while it lives."""
    jp, tp = params
    specs = _specs(tp)
    with JEngine(jp, HEADS, paged=False, buckets=BUCKETS, max_batch=4,
                 queue_depth=64, start=False) as je:
        jr = _staged(je, JRequest, specs)
    with _engine(tp, start=False) as te:
        assert te.freeze_rows() is None  # a slab engine does not migrate
    with _engine(tp, start=False) as te:
        te.warmup()
        tr = _staged(te, TRequest, specs)
        names = {e["name"] for e in memledger.get_ledger().entries()
                 if e["owner"] == te._name}
        assert names == {f"slab:{te._name}:8x4", f"slab:{te._name}:16x4"}
        assert te.kvpool_audit()["note"] == "engine is not paged"
        assert te.export_prefixes(2) is None and te.import_prefixes(b"x") == 0
        with pytest.raises(MigrationError, match="not a paged engine"):
            te.adopt_rows({"blob": b"x", "entries": {0: None}})
    assert not [e for e in memledger.get_ledger().entries()
                if e["owner"] == te._name]
    assert [(r.status, r.tokens.tolist(), r.metrics["slot"]) for r in tr] \
        == [(r.status, r.tokens.tolist(), r.metrics["slot"]) for r in jr]
    assert all(r.status == "ok" for r in tr)
    for s, r in zip(specs, tr):
        if s.get("temperature"):
            continue
        steps = len(r.tokens) - len(s["prompt"])
        assert r.tokens.tolist() == _tref(tp, s["prompt"], steps)
    # the eos row stops at its first eos, at the latest its second token
    assert tr[-1].tokens[-1] == specs[-1]["eos"]
    assert len(tr[-1].tokens) <= len(specs[-1]["prompt"]) + 2


def test_sampled_replay_is_composition_independent(params):
    """fold_in(key(seed), step) per row: a sampled request replays the same
    tokens alone and beside other rows."""
    _, tp = params
    req = dict(prompt=[2, 4, 6], steps=4, temperature=0.7, seed=13)
    with _engine(tp) as eng:
        alone = eng.submit(TRequest(**req)).result(timeout=WAIT_S)
    with _engine(tp, start=False) as eng:
        crowd = [eng.submit(TRequest(prompt=[1] * n, steps=3))
                 for n in (2, 7, 3)]
        again = eng.submit(TRequest(**req))
        eng.start()
        eng.drain()
        assert all(h.result(timeout=WAIT_S).status == "ok" for h in crowd)
        again = again.result(timeout=WAIT_S)
    assert alone.status == again.status == "ok"
    assert alone.tokens.tolist() == again.tokens.tolist()


def test_gqa_rows_equal_generate():
    _, tp = _pair(4, 2, seed=3)
    rng = np.random.default_rng(8)
    reqs = [dict(prompt=rng.integers(0, VOCAB, int(rng.integers(2, 17)))
                 .astype(np.int32), steps=int(rng.integers(1, 5)))
            for _ in range(6)]
    with _engine(tp, heads=4) as eng:
        hs = [eng.submit(TRequest(**r)) for r in reqs]
        for r, h in zip(reqs, hs):
            res = h.result(timeout=WAIT_S)
            assert res.status == "ok", res.reason
            assert res.tokens.tolist() == _tref(tp, r["prompt"], r["steps"],
                                                heads=4)


def test_eos_retirement_and_slot_refill(params):
    """A row that emits its eos retires early and its slot takes the next
    queued row on the next step: 3 requests through 2 slots in 2 full
    decode steps; an eos value the row never emits runs the full budget."""
    _, tp = params
    with _engine(tp, max_batch=2, start=False) as eng:
        a = eng.submit(TRequest(prompt=[1, 2, 3], steps=3))
        b = eng.submit(TRequest(prompt=[4, 5], steps=2))
        c = eng.submit(TRequest(prompt=[6, 7], steps=2))
        eng.start()
        eng.drain()
        res = [h.result(timeout=WAIT_S) for h in (a, b, c)]
    assert all(r.status == "ok" for r in res)
    assert res[1].metrics["slot"] == res[2].metrics["slot"]
    snap = eng.metrics.snapshot()
    assert snap["steps"] == 2 and snap["occupancy_mean"] == 1.0
    prompt = [5, 3]
    ref = _tref(tp, prompt, 4)
    gen = ref[2:]
    unseen = next(v for v in range(VOCAB) if v not in gen)
    with _engine(tp, max_batch=1) as eng:
        h = eng.submit(TRequest(prompt=prompt, steps=4, eos=gen[1]))
        tail = eng.submit(TRequest(prompt=[9, 8], steps=2))
        full = eng.submit(TRequest(prompt=prompt, steps=4, eos=unseen))
        r = h.result(timeout=WAIT_S)
        stop = gen.index(gen[1]) + 1
        assert r.tokens.tolist() == ref[:2 + stop]
        assert tail.result(timeout=WAIT_S).status == "ok"
        assert full.result(timeout=WAIT_S).tokens.tolist() == ref


def test_decode_step_fault_fails_only_live_rows(params):
    """A serve.decode_step fault fails only that step's live rows; queued
    requests still serve, every slot and byte of budget comes back."""
    _, tp = params
    with _engine(tp, max_batch=2, start=False) as eng:
        live = [eng.submit(TRequest(prompt=[1, 2], steps=3))
                for _ in range(2)]
        queued = eng.submit(TRequest(prompt=[3, 4], steps=2))
        with tfaults.injected("serve.decode_step",
                              tfaults.RaiseFault(times=1)):
            eng.start()
            for h in live:
                r = h.result(timeout=WAIT_S)
                assert r.status == "error" and "FaultInjected" in r.reason
            assert queued.result(timeout=WAIT_S).status == "ok"
        after = eng.submit(TRequest(prompt=[5], steps=2))
        assert after.result(timeout=WAIT_S).tokens.tolist() == \
            _tref(tp, [5], 2)
        snap = eng.metrics.snapshot()
        assert snap["errors"] == 2 and snap["completed"] == 2
    assert eng.pending() == 0 and eng._queue.bytes_in_flight == 0


def test_prefill_fault_retries_and_recovery_rebuilds_zeroed(params):
    """A serve.step fault fails (or, with attempts left, retries) only the
    row being admitted; a supervisor recovery drops the slot pools and the
    next admissions rebuild them zeroed, with the same tokens."""
    _, tp = params
    with _engine(tp) as eng:
        with tfaults.injected("serve.step", tfaults.RaiseFault(times=1)):
            bad = eng.submit(TRequest(prompt=[1, 2], steps=2))
            r = bad.result(timeout=WAIT_S)
            assert r.status == "error" and "FaultInjected" in r.reason
        with tfaults.injected("serve.step", tfaults.RaiseFault(times=1)):
            again = eng.submit(TRequest(prompt=[1, 2], steps=2,
                                        max_attempts=2))
            assert again.result(timeout=WAIT_S).tokens.tolist() == \
                _tref(tp, [1, 2], 2)
        eng.drain()
    with _engine(tp) as eng:
        first = eng.submit(TRequest(prompt=[3, 1, 4], steps=3))
        want = first.result(timeout=WAIT_S).tokens.tolist()
        pool = eng._pools[(8, 4)]
        assert float(pool.caches["l0"][0].abs().sum()) > 0
        eng.attach_supervisor(lambda: None)
        eng._recover("test recovery")
        assert eng._pools == {} and not [
            e for e in memledger.get_ledger().entries()
            if e["name"].startswith(f"slab:{eng._name}")]
        second = eng.submit(TRequest(prompt=[3, 1, 4], steps=3))
        assert second.result(timeout=WAIT_S).tokens.tolist() == want
        assert eng._pools[(8, 4)] is not pool


def test_drain_and_close(params):
    """close() retires queued requests ``shutting_down`` and finishes what
    runs; drain() completes everything accepted; both are terminal."""
    _, tp = params
    eng = _engine(tp, start=False)
    handles = [eng.submit(TRequest(prompt=[i + 1], steps=1))
               for i in range(3)]
    eng.close()
    for h in handles:
        r = h.result(timeout=1)
        assert r.status == "shutting_down" and "closed" in r.reason
    assert eng.submit(TRequest(prompt=[9], steps=1)).result(
        timeout=1).status == "shutting_down"
    eng = _engine(tp, start=False)
    handles = [eng.submit(TRequest(prompt=[i + 1, 2], steps=2))
               for i in range(5)]
    eng.drain()
    assert [h.result(timeout=1).tokens.tolist() for h in handles] == \
        [_tref(tp, [i + 1, 2], 2) for i in range(5)]
    assert eng.pending() == 0 and eng._queue.bytes_in_flight == 0
    assert not any(t.name.startswith(eng._name)
                   for t in __import__("threading").enumerate())
