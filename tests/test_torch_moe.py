"""The port's mixture-of-experts family against the JAX package's, on the CPU.

``marlin_tpu.models.moe`` and the JAX ``TransformerLM(n_experts=...)`` are
the oracle (the case list of ``tests/test_moe.py``): the same numpy weights
(JAX's initial params carried over by ``interop.lm_params_from_numpy``) and
inputs go through both packages, the JAX side on a one-device mesh and
under ``jax.jit`` (one compile a case: the file stays a few seconds a case
on one CPU worker).

Tolerances:

- routing: the dispatch tensors and the top-k choices are EQUAL; combine
  weights and statistics within 1e-6 (f32 softmax in two frameworks);
- ``moe_ffn`` / ``moe_decode_ffn`` outputs within 1e-5 absolute of JAX's
  (and of the per-token oracle, rtol 1e-4 as ``tests/test_moe.py``);
- ``lm_loss`` rtol 1e-5, gradients rtol 2e-4 atol 1e-6, Adam steps as
  ``tests/test_torch_train.py`` (params 1e-5 with 0.1 % of a leaf's
  elements allowed a tenth of the learning rate);
- greedy tokens (``lm_generate``, ``lm_generate_batch``, the engine, the
  CLI's sample): EQUAL. The CLI's losses within 1e-4 relative.
"""

import importlib
import math

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from marlin_tpu import mesh as jax_mesh
from marlin_tpu.models import TransformerLM as JaxLM
from marlin_tpu.models import moe as jm
from marlin_tpu.models import transformer as jt
from marlin_tpu_torch import config_context, interop
from marlin_tpu_torch.mesh import Mesh
from marlin_tpu_torch.models import moe as tm
from marlin_tpu_torch.models import transformer as tt
from marlin_tpu_torch.serving import Request as TRequest
from marlin_tpu_torch.serving import ServeEngine as TEngine
from marlin_tpu_torch.serving import batcher as tbatcher

OUT_ATOL = 1e-5
STAT_ATOL = 1e-6
LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 2e-4, 1e-6
LR = 1e-2
PARAM_ATOL, PARAM_OUTLIER_ATOL, PARAM_OUTLIER_SHARE = 1e-5, LR / 10, 1e-3
CLI_TOL = 1e-4
HEADS = 2
MOE = (2, 2.0, 64)
TOKS = jt.synthetic_stream(129, vocab=32, seed=2)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def jmesh():
    return jax_mesh.create_mesh((1, 1), devices=jax.devices()[:1])


@pytest.fixture(scope="module")
def lm_pair():
    """A 2-layer MoE LM (vocab 32, d_model 16, 4 experts) in both packages,
    the port's params carried from the JAX package's."""
    jp = JaxLM(vocab=32, d_model=16, heads=HEADS, layers=2, n_experts=4,
               seed=3).init_params()
    tp = interop.lm_params_from_numpy(jax.tree.map(np.asarray, jp),
                                      device="cpu")
    return jp, tp


def _mixture(mp, x, top_k):
    """Per-token oracle (numpy f64): the renormalized top-k expert mixture
    with no capacity."""
    mp = {k: np.asarray(v, np.float64) for k, v in mp.items()}
    x = np.asarray(x, np.float64)
    logits = x @ mp["wg"]
    gates = np.exp(logits - logits.max(-1, keepdims=True))
    gates /= gates.sum(-1, keepdims=True)
    out = np.zeros_like(x)
    gelu = lambda v: 0.5 * v * (1 + np.tanh(  # noqa: E731
        math.sqrt(2 / math.pi) * (v + 0.044715 * v ** 3)))
    for t in range(x.shape[0]):
        top = np.argsort(-gates[t], kind="stable")[:top_k]
        w = gates[t, top] / gates[t, top].sum()
        for j, e in enumerate(top):
            out[t] += w[j] * (gelu(x[t] @ mp["w1"][e]) @ mp["w2"][e])
    return out


def _moe_pair(seed, d=8, ff=16, e=4):
    """One MoE layer's weights (``init_moe``'s scales, numpy draws) as JAX
    arrays and as the port's tensors."""
    rng = np.random.default_rng(seed)
    w = {"wg": rng.standard_normal((d, e)) / math.sqrt(d),
         "w1": rng.standard_normal((e, d, ff)) / math.sqrt(d),
         "w2": rng.standard_normal((e, ff, d)) / math.sqrt(ff)}
    w = {k: v.astype(np.float32) for k, v in w.items()}
    return ({k: jnp.asarray(v) for k, v in w.items()},
            {k: _t(v) for k, v in w.items()})


def _x(seed, n, d=8):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(
        np.float32)


# --------------------------------------------------------------- routing


@pytest.mark.parametrize("cap,top_k", [(3, 2), (8, 2), (5, 1)])
def test_route_group_dispatch_equal(cap, top_k):
    """Choice-major routing: dispatch equal, combine and the statistics
    within 1e-6, with a padded (invalid) tail that routes nowhere."""
    jp, tp = _moe_pair(0)
    x = _x(0, 16)
    valid = np.ones(16, np.float32)
    valid[13:] = 0.0
    want = jax.jit(lambda x, v, wg: jm._route_group(x, v, wg, top_k, cap))(
        jnp.asarray(x), jnp.asarray(valid), jp["wg"])
    got = tm._route_group(_t(x), _t(valid), tp["wg"], top_k, cap)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=STAT_ATOL)
    assert float(got[0][13:].abs().sum()) == 0.0  # the pad tail never routes


@pytest.mark.parametrize("cf,group", [(100.0, None), (100.0, 16),
                                      (1.25, 16), (0.5, 16)])
def test_moe_ffn_matches_jax(cf, group):
    """50 tokens: one group, and groups of 16 with a ragged tail of 2; with
    capacity to spare and with drops. Output and aux as JAX's."""
    jp, tp = _moe_pair(2)
    x = _x(2, 50)
    want, waux = jax.jit(lambda p, x: jm.moe_ffn(
        p, x, mesh=None, top_k=2, capacity_factor=cf, group_size=group))(
        jp, jnp.asarray(x))
    got, aux = tm.moe_ffn(tp, _t(x), mesh=None, top_k=2,
                          capacity_factor=cf, group_size=group)
    assert got.shape == (50, 8) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=OUT_ATOL)
    np.testing.assert_allclose(float(aux), float(waux), rtol=1e-6)
    if cf == 100.0:  # no drops: the per-token mixture, ragged tail included
        np.testing.assert_allclose(got.numpy(), _mixture(jp, x, 2),
                                   rtol=1e-4, atol=1e-5)


def test_moe_grouped_equals_single():
    jp, tp = _moe_pair(1)
    x = _t(_x(1, 64))
    a, _ = tm.moe_ffn(tp, x, top_k=2, capacity_factor=100.0, group_size=None)
    b, _ = tm.moe_ffn(tp, x, top_k=2, capacity_factor=100.0, group_size=16)
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-6)


def test_moe_capacity_drops_choice_major():
    """Every token prefers expert 0: with top_k 1 and 3 slots, exactly the
    first 3 tokens get expert 0's output, the rest zeros."""
    jp, tp = _moe_pair(3, d=4, ff=8, e=2)
    tp = dict(tp, wg=torch.zeros((4, 2)).index_fill_(1, torch.tensor([0]),
                                                      10.0))
    x = torch.ones((12, 4))
    cap = tm.moe_capacity(12, 2, 1, 0.5)
    assert cap == 3
    out, _ = tm.moe_ffn(tp, x, top_k=1, capacity_factor=0.5, group_size=None)
    expert0 = tt._gelu(x[0] @ tp["w1"][0]) @ tp["w2"][0]
    for t in range(12):
        if t < cap:
            np.testing.assert_allclose(out[t].numpy(), expert0.numpy(),
                                       rtol=1e-5)
        else:
            assert float(out[t].abs().max()) == 0.0


def test_moe_aux_near_one_for_balanced_router():
    jp, tp = _moe_pair(6, d=16, ff=8)
    x = _x(6, 512, d=16)
    _, aux = tm.moe_ffn(tp, _t(x), top_k=2)
    _, waux = jax.jit(lambda p, x: jm.moe_ffn(p, x, mesh=None, top_k=2))(
        jp, jnp.asarray(x))
    assert 0.7 < float(aux) < 1.6, float(aux)
    np.testing.assert_allclose(float(aux), float(waux), rtol=1e-6)


def test_moe_decode_ffn_matches_mixture():
    """One token and a batch of rows (the JAX package's vmap): the exact
    mixture, as JAX's; bf16 in gives bf16 out."""
    jp, tp = _moe_pair(7)
    h = _x(7, 5)
    rows = tm.moe_decode_ffn(tp, _t(h), top_k=2)
    jdecode = jax.jit(lambda p, h: jm.moe_decode_ffn(p, h, top_k=2))
    for b in range(5):
        want = np.asarray(jdecode(jp, jnp.asarray(h[b])))
        one = tm.moe_decode_ffn(tp, _t(h[b]), top_k=2)
        np.testing.assert_allclose(one.numpy(), want, rtol=0, atol=OUT_ATOL)
        np.testing.assert_allclose(rows[b].numpy(), one.numpy(), rtol=0,
                                   atol=1e-6)
    np.testing.assert_allclose(rows.numpy(), _mixture(jp, h, 2), rtol=1e-4,
                               atol=1e-5)
    assert tm.moe_decode_ffn(tp, torch.ones(8, dtype=torch.bfloat16)).dtype \
        == torch.bfloat16


def test_moe_validation_and_placement():
    jp, tp = _moe_pair(5, e=6)
    x = torch.zeros((8, 8))
    wide = Mesh(torch.device("cpu"), (4, 2))
    with pytest.raises(ValueError, match="multiple of mesh axis"):
        tm.moe_ffn(tp, x, mesh=wide)
    with pytest.raises(ValueError, match="n_experts must be >= 2"):
        tm.init_moe(5, 8, 16, 1, device="cpu")
    with pytest.raises(ValueError, match="moe precision"):
        tm.moe_ffn(tp, x, precision="low")
    _, tp8 = _moe_pair(5, e=8)
    # experts across devices need a mesh over torch.distributed ranks
    with pytest.raises(ValueError, match="mesh over torch.distributed ranks"):
        tm.moe_ffn(tp8, x, mesh=wide)
    with pytest.raises(ValueError, match="mesh over torch.distributed ranks"):
        tm.shard_moe_params(tp8, wide)
    one = Mesh(torch.device("cpu"), (1, 1))
    assert tm.shard_moe_params(tp8, one) is tp8
    got, _ = tm.moe_ffn(tp8, x, mesh=one)
    assert float(got.abs().max()) == 0.0  # gelu(0) = 0


def test_moe_init_interleaving():
    """``moe_every`` places MoE layers where JAX does, with its shapes."""
    jp = jax.jit(lambda k: jt.init_transformer(k, 32, 16, 2, 4, n_experts=4,
                                               moe_every=2))(
        jax.random.key(0))
    tp = tt.init_transformer(0, 32, 16, 2, 4, n_experts=4, moe_every=2,
                             device="cpu")
    for i in range(4):
        assert set(tp[f"l{i}"]) == set(jp[f"l{i}"])
    assert "moe" in tp["l1"] and "w1" not in tp["l1"] and "w1" in tp["l0"]
    assert tp["l1"]["moe"]["w1"].shape == (4, 16, 64)
    carried = interop.lm_params_from_numpy(jax.tree.map(np.asarray, jp),
                                           device="cpu")
    assert np.array_equal(carried["l3"]["moe"]["wg"].numpy(),
                          np.asarray(jp["l3"]["moe"]["wg"]))
    bad = {"l0": {"moe": {"wg": np.zeros((2, 2))}}}
    with pytest.raises(ValueError, match="mixture-of-experts"):
        interop.lm_params_from_numpy(bad, device="cpu")


# ------------------------------------------------------------ the LM


def test_lm_loss_and_grads_match_jax(jmesh, lm_pair):
    """Loss (aux included) and every gradient as JAX's, through remat (each
    routing group recomputed under its own checkpoint) and the chunked LM
    head; the router's gradient is nonzero."""
    jp, tp = lm_pair
    kw = dict(heads=HEADS, attn="ring_flash", moe=MOE, remat=True,
              loss_chunk=50)
    jv, jg = jax.jit(jax.value_and_grad(lambda p: jt.lm_loss(
        p, TOKS, jmesh, **kw)))(jp)
    tv, tg = tt.lm_value_and_grad(tp, TOKS, **kw)
    np.testing.assert_allclose(float(tv), float(jv), rtol=LOSS_RTOL)
    for i in range(2):
        for k, v in jg[f"l{i}"]["moe"].items():
            np.testing.assert_allclose(tg[f"l{i}"]["moe"][k].numpy(),
                                       np.asarray(v), rtol=GRAD_RTOL,
                                       atol=GRAD_ATOL, err_msg=f"l{i}/{k}")
        np.testing.assert_allclose(tg[f"l{i}"]["wq"].numpy(),
                                   np.asarray(jg[f"l{i}"]["wq"]),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL)
    assert float(tg["l0"]["moe"]["wg"].abs().max()) > 0


def test_lm_loss_interleaved_and_offload_guard(jmesh):
    """``moe_every=2``: a dense and a MoE layer, loss as JAX's; the offload
    guard refuses the mixed structure as JAX's does."""
    jp = jax.jit(lambda k: jt.init_transformer(k, 32, 16, 2, 2, n_experts=4,
                                               moe_every=2))(
        jax.random.key(4))
    tp = interop.lm_params_from_numpy(jax.tree.map(np.asarray, jp),
                                      device="cpu")
    want = float(jax.jit(lambda p: jt.lm_loss(
        p, TOKS, jmesh, heads=HEADS, attn="ring_flash", moe=MOE))(jp))
    got = float(tt.lm_loss(tp, TOKS, heads=HEADS, attn="ring_flash", moe=MOE))
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    with pytest.raises(ValueError, match="uniform layer structure"):
        tt.lm_loss(tp, TOKS, heads=HEADS, remat=True, offload_residuals=True)


def test_train_steps_match_optax(jmesh, lm_pair):
    """Three Adam steps: losses and params as optax.adam's."""
    jp, tp = lm_pair
    js = optax.adam(LR).init(jp)
    ts = tt.adam_init(tp)
    jl, tl = [], []
    for _ in range(3):
        jp, js, loss = jt.lm_train_step(jp, js, TOKS, jmesh, HEADS,
                                        "ring_flash", False, "high", LR,
                                        moe=MOE)
        jl.append(float(loss))
        tp, ts, loss = tt.lm_train_step(tp, ts, TOKS, None, HEADS,
                                        "ring_flash", False, "high", LR,
                                        moe=MOE)
        tl.append(float(loss))
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    want = jax.tree.map(np.asarray, jp)
    for name in want:
        for k, v in (want[name].items() if isinstance(want[name], dict)
                     else [(None, want[name])]):
            for kk, vv in (v.items() if isinstance(v, dict) else [(None, v)]):
                got = tp[name] if k is None else tp[name][k]
                got = got if kk is None else got[kk]
                err = np.abs(got.numpy() - vv)
                assert err.max() <= PARAM_OUTLIER_ATOL, (name, k, kk)
                assert (err > PARAM_ATOL).mean() <= PARAM_OUTLIER_SHARE


def test_facade_trains_and_generates():
    """``TransformerLM(n_experts=4)`` trains (the loss falls) and its greedy
    generate continues the training forward's argmax."""
    lm = tt.TransformerLM(vocab=32, d_model=16, heads=HEADS, layers=2,
                          learning_rate=1e-2, n_experts=4, moe_group=64,
                          moe_capacity_factor=100.0)
    with config_context(device="cpu"):
        params, losses = lm.train(TOKS, steps=8)
    assert losses[-1] < losses[0] * 0.9, losses
    assert "moe" in params["l0"]
    prompt = list(TOKS[:16])
    out = lm.generate(params, prompt, steps=6).tolist()
    cur = list(prompt)
    for _ in range(6):
        logits = tt.transformer_forward(params, np.array(cur, np.int32),
                                        heads=HEADS, moe=(2, 100.0, 64))
        cur.append(int(torch.argmax(logits[-1])))
    assert out == cur


def test_generate_matches_jax(lm_pair):
    """Greedy ``lm_generate`` (prefill routing grouped, decode exact) and
    ``lm_generate_batch`` over ragged rows equal JAX's tokens."""
    jp, tp = lm_pair
    moe = (2, 100.0, 32)
    prompts = [(np.arange(5) % 32).astype(np.int32),
               (np.arange(3) * 7 % 32).astype(np.int32)]
    for pr in prompts:
        want = np.asarray(jt.lm_generate(jp, pr, jax.random.key(9),
                                         heads=HEADS, max_len=16, steps=6,
                                         moe=moe)).tolist()
        got = tt.lm_generate(tp, pr, 9, heads=HEADS, max_len=16, steps=6,
                             moe=moe).tolist()
        assert got == want
    padded = np.zeros((2, 5), np.int32)
    padded[0], padded[1, :3] = prompts[0], prompts[1]
    lengths = np.array([5, 3], np.int32)
    want = np.asarray(jt.lm_generate_batch(jp, padded, lengths,
                                           jax.random.key(9), heads=HEADS,
                                           max_len=16, steps=4, moe=moe))
    got = tt.lm_generate_batch(tp, padded, lengths, 9, heads=HEADS,
                               max_len=16, steps=4, moe=moe).numpy()
    np.testing.assert_array_equal(got[0, :9], want[0, :9])
    np.testing.assert_array_equal(got[1, :7], want[1, :7])


@pytest.mark.parametrize("paged", [True, False])
def test_engine_with_moe_equals_generate(lm_pair, paged):
    """``ServeEngine(moe=...)`` — paged and dense-slab — serves greedy rows
    equal to ``lm_generate`` and sampled rows equal to the same request
    served alone."""
    _, tp = lm_pair
    moe = (2, 100.0, 32)
    rng = np.random.default_rng(4)
    specs = [dict(prompt=rng.integers(0, 32, int(rng.integers(2, 12)))
                  .astype(np.int32), steps=4) for _ in range(5)]
    specs.append(dict(prompt=specs[0]["prompt"], steps=4, temperature=0.9,
                      seed=7))
    kw = dict(buckets=((16, 4),), max_batch=3, page_len=4, moe=moe,
              paged=paged)
    with config_context(device="cpu"):
        with TEngine(tp, HEADS, **kw) as eng:
            eng.warmup()
            handles = [eng.submit(TRequest(**s)) for s in specs]
            res = [h.result(timeout=60) for h in handles]
        with TEngine(tp, HEADS, **kw) as eng:
            alone = eng.submit(TRequest(**specs[-1])).result(timeout=60)
    assert all(r.status == "ok" for r in res), [r.reason for r in res]
    for s, r in zip(specs[:-1], res):
        n = len(s["prompt"])
        want = tt.lm_generate(tp, s["prompt"], 0, heads=HEADS,
                              max_len=n + 4, steps=4, moe=moe).tolist()
        assert r.tokens.tolist() == want
    assert res[-1].tokens.tolist() == alone.tokens.tolist()


def test_lm_call_cost_counts_router_and_top_k_experts(lm_pair):
    """The analytic cost of a MoE model: per token and layer the
    projections, the router 2·d·E and top-k expert FFNs k·2·2·d·ff; bytes
    the experts a call's tokens can reach (min(E, tokens·k) of them)."""
    _, tp = lm_pair
    v, d = tp["emb"].shape
    e, _, ff = tp["l0"]["moe"]["w1"].shape
    kv = tp["l0"]["wk"].shape[1]
    nb = lambda t: t.numel() * t.element_size()  # noqa: E731
    for rows, tokens, k in ((1, 1, 2), (3, 1, 1), (1, 16, 2)):
        got = tbatcher.lm_call_cost(tp, HEADS, rows, tokens, 20,
                                    moe=(k, 1.25, 64))
        toks = rows * tokens
        layer = 2.0 * d * (2 * d + 2 * kv) + 2.0 * d * e + k * 4.0 * d * ff
        flops = toks * 2 * layer + 2.0 * rows * d * v \
            + toks * 2 * 4.0 * 20 * d
        reached = min(e, toks * k)
        weights = nb(tp["emb"]) + nb(tp["ln_f"]) + sum(
            sum(nb(tp[f"l{i}"][w]) for w in ("wq", "wk", "wv", "wo", "ln1",
                                             "ln2"))
            + nb(tp[f"l{i}"]["moe"]["wg"])
            + reached * (nb(tp[f"l{i}"]["moe"]["w1"])
                         + nb(tp[f"l{i}"]["moe"]["w2"])) // e
            for i in range(2))
        byts = weights + toks * 2 * 2 * kv * 4 + toks * d * 4 + rows * v * 4 \
            + rows * 2 * 2.0 * 20 * kv * 4
        assert got == {"flops": float(flops), "bytes accessed": float(byts)}
    # a warm-up of a MoE engine lands both programs' costs (no KeyError)
    from marlin_tpu_torch.obs import perf

    costs = perf.get_program_costs()
    costs.reset()
    with config_context(device="cpu"):
        tbatcher.capture_bucket_costs(tp, HEADS, (8, 4), 2, moe=MOE)
    assert {r["program"] for r in costs.rows()} == {"lm_prefill_slot",
                                                    "lm_decode_rows"}
    assert all(r["flops"] > 0 for r in costs.rows())
    costs.reset()


# ------------------------------------------------------------- the CLI


def test_moe_training_cli(jmesh, monkeypatch, capsys):
    """The port's CLI against the JAX CLI on a one-device mesh, from the
    JAX package's initial params: losses within 1e-4, the aux line's value
    within 1e-3, the greedy continuation equal."""
    import marlin_tpu as jmt
    from marlin_tpu_torch.models import TransformerLM as TorchLM

    monkeypatch.setattr(jmt, "create_mesh", lambda *a, **k: jmesh)

    def init_params(self, dtype=None, device=None):
        ref = JaxLM(vocab=self.vocab, d_model=self.d_model, heads=self.heads,
                    layers=self.layers, seed=self.seed,
                    n_experts=self.n_experts).init_params()
        return interop.lm_params_from_numpy(jax.tree.map(np.asarray, ref),
                                            device=device, dtype=dtype)

    monkeypatch.setattr(TorchLM, "init_params", init_params)
    args = ["256", "3", "4", "2", "64", "1"]
    jl = importlib.import_module("examples.moe_training").main(args)
    jout = capsys.readouterr().out.splitlines()
    with config_context(device="cpu"):
        tl = importlib.import_module(
            "marlin_tpu_torch.examples.moe_training").main(args)
    tout = capsys.readouterr().out.splitlines()
    np.testing.assert_allclose(tl, jl, rtol=CLI_TOL)
    aux = [float(o.split(": ")[1].split()[0]) for o in (jout[2], tout[2])]
    np.testing.assert_allclose(aux[1], aux[0], atol=1e-3)
    assert tout[3] == jout[3]  # the greedy continuation
    assert tout[0].split(":")[0] == jout[0].split(":")[0]
