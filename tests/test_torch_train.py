"""The port's LM training against the JAX package's, on the CPU.

The JAX model's params (numpy) are carried into the port with
``interop.lm_params_from_numpy``; the same 250-token stream (249 positions:
no multiple of 128, so the pad and ``valid_len`` masking run) then goes
through both packages, the JAX one on a one-device mesh with its Pallas
kernels in interpret mode.

Tolerances, per element:

- f32: loss rtol 1e-5; gradients rtol 2e-4, atol 1e-6 (as the JAX package's
  own chunked-loss test); both sides are IEEE f32 with other summation
  orders.
- after Adam steps: moments rtol 2e-4 with atol 1e-4 · max |moment| (from
  the second step on the gradients are taken at params that differ as
  below); params atol 1e-5, except that 0.1 % of a leaf's elements may be off by up
  to a tenth of the learning rate (3e-4): Adam moves an element by about
  ``lr · g / |g|`` whatever the gradient's scale, so where ``g`` is within
  rounding of 0 the two frameworks' steps may differ by a fraction of
  ``lr`` (a missing bias correction or a wrong sign is off by more than
  ``lr`` on every element).
- bf16 ``compute_dtype``: loss rtol 2e-3, gradients within 2e-2 · max |grad|
  of the leaf: activations round to bf16 at points where the frameworks'
  f32 values differ by a few ulps, and the rounding steps (2^-8 relative)
  then propagate through two layers.

The ``cuda``-marked test holds a training step on the card (the flash
kernels) against the CPU's plain versions and skips where there is no card.
"""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from marlin_tpu.mesh import create_mesh
from marlin_tpu.models import TransformerLM as JaxLM
from marlin_tpu.models import transformer as jt
from marlin_tpu_torch import config_context, interop, ops
from marlin_tpu_torch.models import transformer as tt

TOKS = jt.synthetic_stream(250, vocab=64)
LR = 3e-3
LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 2e-4, 1e-6
PARAM_ATOL, PARAM_OUTLIER_ATOL, PARAM_OUTLIER_SHARE = 1e-5, LR / 10, 1e-3
MOMENT_ATOL = 1e-4
BF16_LOSS_RTOL, BF16_GRAD_TOL = 2e-3, 2e-2


@pytest.fixture(scope="module")
def jmesh():
    return create_mesh((1, 1))


def _jax_model(kv_heads):
    heads = 2 if kv_heads is None else 4
    return JaxLM(vocab=64, d_model=32, heads=heads, layers=2,
                 kv_heads=kv_heads, seed=0 if kv_heads is None else 1)


@pytest.fixture(scope="module")
def models():
    """(heads, JAX params, port params) for MHA and GQA (kv_heads 2 of 4)."""
    out = {}
    for kvh in (None, 2):
        lm = _jax_model(kvh)
        jp = lm.init_params()
        tp = interop.lm_params_from_numpy(jax.tree.map(np.asarray, jp),
                                          device="cpu")
        out[kvh] = (lm.heads, jp, tp)
    return out


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is false)")
    return torch.device("cuda")


def _paths(tree, prefix=""):
    """{path: array} over a params-shaped nested dict."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_paths(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree.detach().float().cpu().numpy()
            if isinstance(tree, torch.Tensor) else np.asarray(tree, np.float32)}


def _assert_trees_close(got, want, rtol, atol, rel_to_max=False):
    g, w = _paths(got), _paths(want)
    assert set(g) == set(w)
    for k in w:
        tol = atol * np.abs(w[k]).max() if rel_to_max else atol
        np.testing.assert_allclose(g[k], w[k], rtol=rtol, atol=tol,
                                   err_msg=k)


def _assert_params_close(got, want):
    g, w = _paths(got), _paths(want)
    assert set(g) == set(w)
    for k in w:
        err = np.abs(g[k] - w[k])
        assert err.max() <= PARAM_OUTLIER_ATOL, (k, err.max())
        assert (err > PARAM_ATOL).mean() <= PARAM_OUTLIER_SHARE, \
            (k, int((err > PARAM_ATOL).sum()))


@pytest.mark.parametrize("attn,kv_heads,knobs", [
    ("ring_flash", None, {}),
    ("ring_xla", None, {}),
    ("ulysses", None, {}),
    ("ring_flash", None, {"remat": True}),
    ("ring_xla", None, {"loss_chunk": 64}),
    ("ulysses", None, {"mlp_chunk": 100}),
    ("ring_flash", 2, {}),
    ("ulysses", 2, {"remat": True, "loss_chunk": 100, "mlp_chunk": 64}),
])
def test_lm_loss_and_grads_match_jax(jmesh, models, attn, kv_heads, knobs):
    heads, jp, tp = models[kv_heads]
    jv, jg = jax.value_and_grad(lambda p: jt.lm_loss(
        p, TOKS, jmesh, heads=heads, attn=attn, **knobs))(jp)
    tv, tg = tt.lm_value_and_grad(tp, TOKS, heads=heads, attn=attn, **knobs)
    assert tv.dtype == torch.float32 and tv.shape == ()
    np.testing.assert_allclose(float(tv), float(jv), rtol=LOSS_RTOL)
    _assert_trees_close(tg, jg, GRAD_RTOL, GRAD_ATOL)


@pytest.mark.parametrize("attn", ["ulysses"])
def test_lm_loss_bf16_compute_dtype_matches_jax(jmesh, models, attn):
    heads, jp, tp = models[None]
    kw = dict(heads=heads, attn=attn, compute_dtype="bfloat16")
    jv, jg = jax.value_and_grad(lambda p: jt.lm_loss(p, TOKS, jmesh,
                                                     **kw))(jp)
    tv, tg = tt.lm_value_and_grad(tp, TOKS, **kw)
    np.testing.assert_allclose(float(tv), float(jv), rtol=BF16_LOSS_RTOL)
    _assert_trees_close(tg, jg, 0.0, BF16_GRAD_TOL, rel_to_max=True)


def test_transformer_forward_matches_jax(jmesh, models):
    heads, jp, tp = models[2]
    want = np.asarray(jt.transformer_forward(jp, TOKS, jmesh, heads=heads,
                                             attn="ring_flash"))
    got = tt.transformer_forward(tp, TOKS, heads=heads, attn="ring_flash")
    assert got.shape == (250, 64) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def _jax_steps(jmesh, jp, state, n, heads, attn):
    losses = []
    for _ in range(n):
        jp, state, loss = jt.lm_train_step(jp, state, TOKS, jmesh, heads,
                                           attn, False, "high", LR)
        losses.append(float(loss))
    return jp, state, losses


def _port_steps(tp, state, n, heads, attn):
    losses = []
    for _ in range(n):
        tp, state, loss = tt.lm_train_step(tp, state, TOKS, None, heads,
                                           attn, False, "high", LR)
        losses.append(float(loss))
    return tp, state, losses


@pytest.mark.parametrize("attn", ["ring_flash", "ulysses"])
def test_train_steps_match_optax(jmesh, models, attn):
    """Three Adam steps: losses, params and moments as optax.adam's."""
    heads, jp, tp = models[2]
    jp3, jstate, jlosses = _jax_steps(jmesh, jp, optax.adam(LR).init(jp), 3,
                                      heads, attn)
    tp3, tstate, tlosses = _port_steps(tp, tt.adam_init(tp), 3, heads, attn)
    np.testing.assert_allclose(tlosses, jlosses, rtol=LOSS_RTOL)
    assert tstate.count == int(jstate[0].count) == 3
    _assert_params_close(tp3, jp3)
    for name in ("mu", "nu"):
        _assert_trees_close(getattr(tstate, name), getattr(jstate[0], name),
                            GRAD_RTOL, MOMENT_ATOL, rel_to_max=True)
    # the step returns new params and leaves its inputs as they were
    _assert_trees_close(tp, jp, 0.0, 0.0)


def test_resume_from_jax_optimizer_state(jmesh, models):
    """Two JAX steps, then the params and optax state carried over: the
    port's next step equals the JAX package's."""
    heads, jp, _ = models[None]
    jp2, jstate2, _ = _jax_steps(jmesh, jp, optax.adam(LR).init(jp), 2,
                                 heads, "ring_flash")
    tp2 = interop.lm_params_from_numpy(jax.tree.map(np.asarray, jp2),
                                       device="cpu")
    tstate2 = interop.adam_state_from_numpy(
        jax.tree.map(np.asarray, jstate2), device="cpu")
    assert tstate2.count == 2
    triple = interop.adam_state_from_numpy(
        (np.int32(2), jax.tree.map(np.asarray, jstate2[0].mu),
         jax.tree.map(np.asarray, jstate2[0].nu)), device="cpu")
    _assert_trees_close(triple.nu, tstate2.nu, 0.0, 0.0)
    jp3, _, jl = _jax_steps(jmesh, jp2, jstate2, 1, heads, "ring_flash")
    tp3, tstate3, tl = _port_steps(tp2, tstate2, 1, heads, "ring_flash")
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    assert tstate3.count == 3
    _assert_params_close(tp3, jp3)


@pytest.mark.parametrize("attn,knobs", [
    ("ring", {}), ("ulysses", {}),
    ("ring_flash", {"remat": True, "loss_chunk": 64, "mlp_chunk": 100})])
def test_facade_trains(attn, knobs):
    """The JAX package's acceptance: 15 steps drop the loss below 0.8 of the
    first."""
    lm = tt.TransformerLM(vocab=64, d_model=32, heads=4, layers=1,
                          learning_rate=5e-3, attn=attn, seed=0, **knobs)
    with config_context(device="cpu"):
        params, losses = lm.train(TOKS, steps=15)
    assert len(losses) == 15 and np.isfinite(losses).all()
    assert losses[-1] < 0.8 * losses[0], (losses[0], losses[-1])
    assert params["l0"]["wq"].device.type == "cpu"


def test_bad_knobs_raise(jmesh, models):
    heads, jp, tp = models[None]
    kw = dict(heads=heads)
    with pytest.raises(ValueError, match="attention strategy"):
        tt.lm_loss(tp, TOKS, attn="dense", **kw)
    with pytest.raises(ValueError, match="attention strategy"):
        tt.TransformerLM(attn="dense").train(TOKS, steps=1, params=tp)
    with pytest.raises(ValueError, match="requires remat"):
        tt.lm_loss(tp, TOKS, offload_residuals=True, **kw)
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 12"):
        tt.lm_loss(tp, TOKS, remat=True, offload_residuals=True, **kw)
    with pytest.raises(ValueError, match="loss_chunk"):
        tt.lm_loss(tp, TOKS, loss_chunk=0, **kw)
    with pytest.raises(ValueError, match="mlp_chunk"):
        tt.lm_loss(tp, TOKS, mlp_chunk=0, **kw)
    # a mixture-of-experts layer in place of l0's FFN trains: its loss (the
    # load-balance term included) is the JAX package's
    rng = np.random.default_rng(0)
    d, ff = tp["l0"]["w1"].shape
    mp = {"wg": rng.standard_normal((d, 4)) / np.sqrt(d),
          "w1": rng.standard_normal((4, d, ff)) / np.sqrt(d),
          "w2": rng.standard_normal((4, ff, d)) / np.sqrt(ff)}
    mp = {k: v.astype(np.float32) for k, v in mp.items()}
    dense = {k: v for k, v in jp["l0"].items() if k not in ("w1", "w2")}
    jmoe = dict(jp, l0=dict(dense, moe={k: jnp.asarray(v)
                                        for k, v in mp.items()}))
    tmoe = interop.lm_params_from_numpy(jax.tree.map(np.asarray, jmoe),
                                        device="cpu")
    want = float(jt.lm_loss(jmoe, TOKS, jmesh, moe=(2, 1.25, 64), **kw))
    got = float(tt.lm_loss(tmoe, TOKS, moe=(2, 1.25, 64), **kw))
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)


@pytest.mark.cuda
def test_train_step_on_card_matches_cpu(cuda, models):
    """One step on the card — "ring" resolves to the flash kernels there —
    against the CPU's plain flash versions; the forward, dK/dV and dQ
    kernels each launch once per layer."""
    heads, _, tp = models[2]
    want_p, _, want_l = tt.lm_train_step(tp, tt.adam_init(tp), TOKS, None,
                                         heads, "ring_flash", False, "high",
                                         LR)
    tc = tt._tree_map(lambda p: p.to(cuda), tp)
    ops.reset_launch_counts()
    got_p, _, got_l = tt.lm_train_step(tc, tt.adam_init(tc), TOKS, None,
                                       heads, "ring", False, "high", LR)
    counts = ops.launch_counts()
    for name in ("flash_attention_panel", "flash_attention_bwd_dkv",
                 "flash_attention_bwd_dq"):
        assert counts[name] == 2, (name, counts)
    np.testing.assert_allclose(float(got_l), float(want_l), rtol=LOSS_RTOL)
    _assert_params_close(got_p, want_p)
