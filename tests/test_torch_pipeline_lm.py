"""The pipeline-parallel LM across ``torch.distributed`` ranks against the
JAX package's, and its CLI.

One 4-rank gloo world (``_torch_dist.run_world``) runs the cases of
``tests/test_pipeline_lm.py`` on the JAX package's ``init_transformer``
params (carried over as numpy), and the ``pipeline_training`` CLI with
``tests/test_examples.py``'s arguments; each is compared here with the JAX
package on a ("rows" 4) mesh: losses within ``LOSS_RTOL``, gradients within
the reference test's 1e-4 / 1e-6 against the JAX gradient of the same
blocks applied in sequence (its oracle), and Adam steps within
``TRAIN_RTOL``. The pp x tp composition has no counterpart (ROADMAP queue
3).
"""

import importlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from marlin_tpu import mesh as jmesh
from marlin_tpu.models.pipeline_lm import (_pp_block, pp_lm_loss,
                                           pp_lm_train_step, pp_stage_params)
from marlin_tpu.models.transformer import (_head_logits, _n_layers,
                                           _rmsnorm, init_transformer,
                                           lm_loss, synthetic_stream)

from _torch_dist import run_world

WORLD = 4
LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
# Adam steps each element by about lr·g/|g|, so after several steps the few
# elements whose gradient sits within rounding of 0 may differ; the losses
# stay within this
TRAIN_RTOL = 1e-4


def _batch(b, t, vocab=32):
    return np.stack([synthetic_stream(t, vocab=vocab, seed=i)
                     for i in range(b)])


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(tree)}


def _params(seed, vocab, d, heads, layers, **kw):
    return init_transformer(jax.random.key(seed), vocab, d, heads, layers,
                            **kw)


CASES = {  # name: (params, tokens, heads, microbatch, extra inputs)
    "pp_loss": (_params(0, 32, 32, 2, 4), _batch(8, 17), 2, 2, {}),
    "pp_gqa": (_params(4, 32, 32, 4, 4, kv_heads=2), _batch(4, 17), 4, 1, {}),
    "pp_flagship": (_params(5, 32, 32, 2, 4), _batch(1, 65), 2, 1, {}),
    "pp_grad": (_params(6, 32, 32, 2, 4), _batch(4, 17), 2, 1, {}),
    "pp_train": (_params(1, 32, 32, 2, 4), _batch(8, 33), 2, 2,
                 {"steps": np.array(4), "lr": np.array(1e-2)}),
}
LONG = (_params(7, 16, 16, 2, 4), _batch(1, 2049, vocab=16))
CLI_ARGV = ["8", "65", "6", "32", "4", "2"]
CLI_PARAMS = _params(0, 512, 32, 1, 4)  # the JAX CLI's own init


def _inputs():
    out = {}
    for name, (p, toks, heads, mb, extra) in CASES.items():
        out[name] = dict(_flat(p), tokens=toks, heads=np.array(heads),
                         microbatch=np.array(mb), **extra)
    out["pp_refuses_long_grad"] = dict(_flat(LONG[0]), tokens=LONG[1])
    out["pp_cli"] = dict(_flat(CLI_PARAMS), argv=np.array(CLI_ARGV, int))
    return out


INPUTS = _inputs()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return run_world(WORLD, list(INPUTS), INPUTS,
                     tmp_path_factory.mktemp("pp_world"))


@pytest.fixture(scope="module")
def jmesh4():
    return jmesh.create_mesh((WORLD, 1), devices=jax.devices()[:WORLD])


def _sequential_loss(params, tokens, heads):
    """tests/test_pipeline_lm.py's oracle: the blocks in sequence."""
    tokens = jnp.asarray(tokens)
    x = params["emb"][tokens[:, :-1]]
    for i in range(_n_layers(params)):
        x = jax.vmap(lambda row, lp=params[f"l{i}"]: _pp_block(
            lp, row, heads))(x)
    x = _rmsnorm(x, params["ln_f"])
    logp = jax.nn.log_softmax(_head_logits(x, params["emb"]), axis=-1)
    return -jnp.mean(jnp.take_along_axis(logp, tokens[:, 1:, None], axis=-1))


@pytest.mark.parametrize("name", ["pp_loss", "pp_gqa", "pp_flagship"])
def test_pp_lm_loss_matches_jax(world, jmesh4, name):
    p, toks, heads, mb, _ = CASES[name]
    sp, outer = pp_stage_params(p, jmesh4)
    want = float(jax.jit(lambda a, b: pp_lm_loss(
        a, b, toks, jmesh4, heads=heads, microbatch=mb))(sp, outer))
    got = float(world[name]["loss"])
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    if name == "pp_flagship":  # the same function as the flagship LM's
        np.testing.assert_allclose(got, float(jax.jit(lambda q: lm_loss(
            q, toks[0], jmesh4, heads=heads))(p)), rtol=2e-4)


def test_pp_lm_grad_matches_jax(world):
    p, toks, heads, _, _ = CASES["pp_grad"]
    got = world["pp_grad"]
    jl, g = jax.jit(jax.value_and_grad(
        lambda q: _sequential_loss(q, toks, heads)))(p)
    np.testing.assert_allclose(float(got["loss"]), float(jl), rtol=LOSS_RTOL)
    for s in range(WORLD):
        for leaf in ("wq", "wk", "wv", "wo", "w1", "w2", "ln1", "ln2"):
            np.testing.assert_allclose(got[f"gsp/{leaf}"][s, 0],
                                       np.asarray(g[f"l{s}"][leaf]),
                                       rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                       err_msg=f"stage {s} {leaf}")
    for leaf in ("emb", "ln_f"):
        np.testing.assert_allclose(got[f"gouter/{leaf}"], np.asarray(g[leaf]),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=leaf)


def test_pp_lm_train_steps_match_jax(world, jmesh4):
    import optax

    p, toks, heads, mb, extra = CASES["pp_train"]
    sp, outer = pp_stage_params(p, jmesh4)
    state = optax.adam(float(extra["lr"])).init((sp, outer))
    losses = []
    for _ in range(int(extra["steps"])):
        sp, outer, state, l = pp_lm_train_step(
            sp, outer, state, toks, jmesh4, heads=heads, microbatch=mb,
            lr=float(extra["lr"]))
        losses.append(float(l))
    got = world["pp_train"]["losses"]
    np.testing.assert_allclose(got, losses, rtol=TRAIN_RTOL)
    assert got[-1] < got[0]


def test_pp_lm_long_sequences_refuse_gradients_as_jax_does(world, jmesh4):
    """At 2048 tokens the stage attention is the flash forward. Without
    gradients the loss is the JAX package's; with them both packages raise
    NotImplementedError (JAX: pallas_call has no JVP rule)."""
    from marlin_tpu.config import config_context

    p, toks = LONG
    sp, outer = pp_stage_params(p, jmesh4)
    with config_context(pallas_interpret=True):
        want = float(jax.jit(lambda a, b: pp_lm_loss(
            a, b, toks, jmesh4, heads=2, microbatch=1))(sp, outer))
        with pytest.raises(NotImplementedError):
            jax.grad(lambda t: pp_lm_loss(t[0], t[1], toks, jmesh4, heads=2,
                                          microbatch=1))((sp, outer))
    got = world["pp_refuses_long_grad"]
    np.testing.assert_allclose(float(got["loss"]), want, rtol=LOSS_RTOL)
    assert "2048" in str(got["raised"]) and "JAX" in str(got["raised"])


@pytest.mark.parametrize("trained", ["wk", "wv", "ln1", "x"])
def test_pp_block_long_sequence_refuses_any_trained_leaf(trained):
    """At 2048 tokens a stage block refuses gradients whichever of its
    inputs is trained, not only the first projection: with every other leaf
    frozen, a trained ``wk``, ``wv``, ``ln1`` or block input still raises.
    With everything frozen the block runs."""
    import torch

    from marlin_tpu_torch import interop
    from marlin_tpu_torch.models import pipeline_lm as tpl

    p = interop.lm_params_from_numpy(
        jax.tree.map(np.asarray, _params(5, 32, 16, 2, 1)), device="cpu")
    lp = p["l0"]
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2048, 16)).astype(np.float32))
    assert tpl._pp_block(lp, x, 2).shape == (2048, 16)
    if trained == "x":
        x.requires_grad_(True)
    else:
        lp[trained].requires_grad_(True)
    with pytest.raises(NotImplementedError, match="2048 tokens"):
        tpl._pp_block(lp, x, 2)


def test_pp_stage_params_validation():
    import torch

    from marlin_tpu_torch import config_context
    from marlin_tpu_torch import interop
    from marlin_tpu_torch.mesh import Mesh
    from marlin_tpu_torch.models import pipeline_lm as tpl

    four = Mesh(torch.device("cpu"), (WORLD, 1))  # only its shape is read
    with config_context(device="cpu"):
        p3 = interop.lm_params_from_numpy(
            jax.tree.map(np.asarray, _params(2, 32, 32, 2, 3)), device="cpu")
        with pytest.raises(ValueError, match="do not split"):
            tpl.pp_stage_params(p3, four)
        pm = interop.lm_params_from_numpy(jax.tree.map(
            np.asarray, _params(3, 32, 32, 2, 4, n_experts=4)), device="cpu")
        with pytest.raises(ValueError, match="dense-FFN"):
            tpl.pp_stage_params(pm, four)


def test_pipeline_training_cli_matches_jax(world, capsys):
    """The port's CLI on 4 ranks (2 stages of 2 blocks) against the JAX
    CLI on its 8 devices (4 stages of 1) from the same initial params: the
    same losses, falling."""
    jcli = importlib.import_module("examples.pipeline_training")
    want = jcli.main(CLI_ARGV)
    jout = capsys.readouterr().out.splitlines()
    got = world["pp_cli"]
    np.testing.assert_allclose(got["losses"], want, rtol=TRAIN_RTOL)
    assert got["losses"][-1] < got["losses"][0]
    assert str(got["first"]).startswith("pipeline: 2 stages x 2 blocks")
    assert jout[0].endswith("batch 8 x 65 tokens")
    assert str(got["first"]).endswith("batch 8 x 65 tokens")
    assert str(got["loss_line"]).split(":")[0] == jout[1].split(":")[0]
