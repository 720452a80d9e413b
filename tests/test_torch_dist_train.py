"""The sequence-sharded trainer, the experts across ranks and the training
CLIs on ranks, against the JAX package on a 4-device CPU mesh.

One 4-rank gloo world (``_torch_dist.run_world``) trains the JAX package's
initial params (carried over as numpy) with ``TransformerLM.train`` on a
(4, 1) mesh over the ranks: each rank holds its block of the padded stream
from the embedding to the loss, attention runs on the blocks
(``ring_attention_shard``, ``ulysses_attention_shard``) and a MoE layer
sends each expert's batch to the rank that owns the expert. The JAX package
trains the same params on ``jax.devices()[:4]`` as a ("rows" 4, "cols" 1)
mesh, Pallas in interpret mode. The same world runs ``moe_ffn`` under the
logical contract and the ``long_context_training`` CLI on the default
(2, 2) mesh of four ranks, which the JAX CLI gets too
(``moe_training`` on ranks is in ``tests/test_torch_dist_ml.py``, which has
the time to spare).

Tolerances (as ``tests/test_torch_train.py`` and ``tests/test_torch_moe.py``
state them; both sides IEEE f32, summing in other orders):

- losses of the 3 steps: rtol ``LOSS_RTOL`` (1e-5);
- params after 3 Adam steps: atol ``PARAM_ATOL`` (1e-5), except that 0.1 %
  of a leaf's elements may be off by up to a tenth of the learning rate
  (Adam moves an element by about ``lr · g / |g|`` whatever the gradient's
  scale, so where ``g`` is within rounding of 0 the frameworks' steps may
  differ by a fraction of ``lr``);
- ``moe_ffn``: outputs within ``OUT_ATOL`` (1e-5), aux rtol 1e-5,
  gradients rtol 2e-4 atol 1e-6;
- the CLI's losses rtol ``CLI_TOL`` (1e-4), its greedy continuation
  equal.
"""

import importlib
import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import marlin_tpu as jmt
from marlin_tpu import mesh as jmesh
from marlin_tpu.models import TransformerLM as JaxLM
from marlin_tpu.models import moe as jm
from marlin_tpu.models.transformer import synthetic_stream
from marlin_tpu_torch import config_context
from marlin_tpu_torch.models import TransformerLM as TorchLM
from marlin_tpu_torch.models import transformer as tt

from _torch_dist import _lm_params, run_world

WORLD = 4
STEPS = 3
LOSS_RTOL = 1e-5
PARAM_ATOL, PARAM_OUTLIER_SHARE = 1e-5, 1e-3
OUT_ATOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 2e-4, 1e-6
CLI_TOL = 1e-4
# 256 positions: 64 a rank, padded to ring flash's 128-row panels (the pad
# and valid_len masking run) and Ulysses' 128-row slabs. The JAX compiles
# dominate the file's time, so the parity runs are of one layer but ring
# flash's (two), and the shard proof runs two.
TOKS = synthetic_stream(257, vocab=64)
BASE = dict(vocab=64, d_model=32, heads=4, layers=2, seed=0)
ONE = dict(BASE, layers=1)
MOE = dict(ONE, attn="ring_xla", n_experts=8, moe_capacity_factor=1.25,
           learning_rate=1e-2)
TRAIN = {
    # remat with the residuals offloaded and the LM head in chunks
    "lm_ring_xla": dict(ONE, attn="ring_xla", remat=True,
                        offload_residuals=True, loss_chunk=48),
    "lm_ring_flash": dict(BASE, attn="ring_flash"),
    # GQA: 4 query heads over 2 K/V heads
    "lm_ulysses": dict(ONE, attn="ulysses", kv_heads=2),
    # routing groups of 32 positions: two whole groups a rank
    "lm_moe": dict(MOE, moe_group=32),
    # groups of 48: every rank's 64 rows meet a group that spans ranks
    "lm_moe_span": dict(MOE, moe_group=48),
}
# "ring" resolves to the tiled path for CPU tensors in both packages, as
# "ring_xla" pins it: the port's run is held equal to its ring_xla run,
# which the JAX package's checks
RING = {"lm_ring": dict(TRAIN["lm_ring_xla"], attn="ring")}
SHARDS = {"lm_shards_ring": dict(BASE, attn="ring_flash"),
          "lm_shards_ulysses": dict(BASE, attn="ulysses"),
          "lm_shards_moe": dict(MOE, layers=2, moe_group=32)}
LCT_ARGS = ["128", "3", "32", "4", "1", "ring", "1", "48"]


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(tree)}


def _init(knobs):
    """Seeded initial params as numpy (the port's draws on the CPU: no JAX
    compile), for both packages."""
    with config_context(device="cpu"):
        params = TorchLM(**knobs).init_params()
    return _flat(tt._tree_map(lambda t: t.numpy(), params))


def _nested(flat: dict) -> dict:
    """The params among a case's inputs as the JAX package's nested dict."""
    out = {}
    for key, val in flat.items():
        if "/" not in key and key not in ("emb", "ln_f"):
            continue
        node = out
        *path, leaf = key.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(val)
    return out


def _moe_ffn_inputs():
    rng = np.random.default_rng(4)
    mp = jm.init_moe(jax.random.key(4), 8, 16, 8)
    return dict({k: np.asarray(v) for k, v in mp.items()},
                x=rng.standard_normal((40, 8)).astype(np.float32),
                ct=rng.standard_normal((40, 8)).astype(np.float32),
                group=np.array(16))


def _inputs():
    out = {}
    for name, knobs in {**TRAIN, **RING, **SHARDS}.items():
        out[name] = dict(_init(knobs), tokens=TOKS, steps=np.array(STEPS),
                         knobs=np.array(json.dumps(knobs)))
    out["moe_ffn"] = _moe_ffn_inputs()
    lct = _flat(JaxLM(vocab=512, d_model=32, heads=4, layers=1).init_params())
    out["lct_cli"] = dict(lct, argv=np.array(LCT_ARGS))
    return out


INPUTS = _inputs()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return run_world(WORLD, list(INPUTS), INPUTS,
                     tmp_path_factory.mktemp("train_world"))


@pytest.fixture(scope="module")
def jmesh4():
    return jmesh.create_mesh((WORLD, 1), devices=jax.devices()[:WORLD])


def _params_close(got: dict, want: dict, lr: float):
    assert set(got) == set(want)
    for k, w in want.items():
        err = np.abs(got[k] - w)
        assert err.max() <= lr / 10, (k, err.max())
        assert (err > PARAM_ATOL).mean() <= PARAM_OUTLIER_SHARE, \
            (k, int((err > PARAM_ATOL).sum()))


@pytest.mark.parametrize("name", list(TRAIN))
def test_sharded_training_matches_jax(world, jmesh4, name):
    """Three Adam steps over the 4-rank mesh against the JAX package's on
    4 devices: the losses and the final (whole) params."""
    knobs = TRAIN[name]
    lm = JaxLM(**knobs)
    params, losses = lm.train(TOKS, steps=STEPS, mesh=jmesh4,
                              params=_nested(INPUTS[name]))
    got = world[name]
    np.testing.assert_allclose(got["losses"], losses, rtol=LOSS_RTOL)
    _params_close({k[2:]: v for k, v in got.items() if k.startswith("p/")},
                  _flat(jax.tree.map(np.asarray, params)), lm.learning_rate)


def test_sharded_ring_auto_is_the_tiled_path(world):
    """attn="ring" over the ranks equals the ring_xla run bit for bit."""
    got, want = world["lm_ring"], world["lm_ring_xla"]
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("name", list(SHARDS))
def test_each_rank_holds_its_shard(world, name):
    """Every rank's residual stream is its (sp/p, d) block and the ring's or
    Ulysses' q/k/v are its (H, sp/p, dh) panels; the forward gathers no
    activation (no all_gather_cat at all); a MoE rank holds E/p experts.
    The loss and ``transformer_forward``'s gathered logits equal the world
    of one's (the port's, on the same params)."""
    got = world[name]
    knobs = SHARDS[name]
    p, d, heads = WORLD, knobs["d_model"], knobs["heads"]
    rows = 128 if knobs["attn"] != "ring_xla" else 64  # padded 512 or 256
    layers = knobs["layers"]
    assert got["rank_block"].shape == (p, layers, 2)
    assert (got["rank_block"] == (rows, d)).all()
    assert got["rank_panel"].shape == (p, layers, 9)
    assert (got["rank_panel"] == (heads, rows, d // heads) * 3).all()
    assert (got["rank_forward_gathers"] == 0).all()
    if "n_experts" in knobs:
        assert (got["rank_w1"] == (knobs["n_experts"] // p, d, 4 * d)).all()
    # the loss and the gathered logits are the world of one's
    lm = TorchLM(**knobs)
    params = _lm_params(INPUTS[name])
    with config_context(device="cpu"):
        loss = tt.lm_loss(params, TOKS, None, lm.heads, lm.attn, moe=lm._moe())
        logits = tt.transformer_forward(params, TOKS[:-1], None, lm.heads,
                                        lm.attn, moe=lm._moe())
    np.testing.assert_allclose(got["loss"], float(loss), rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["logits"], logits.numpy(), rtol=0,
                               atol=OUT_ATOL)


def test_moe_ffn_over_ranks_matches_jax(world, jmesh4):
    """moe_ffn(mesh=rank mesh) with each rank's experts against the JAX
    package's sharded moe_ffn: output, aux and the gradients of
    sum(out · ct) + aux; each rank held 2 of the 8 experts."""
    inp = INPUTS["moe_ffn"]
    mp = {k: jnp.asarray(inp[k]) for k in ("wg", "w1", "w2")}
    x, ct = jnp.asarray(inp["x"]), jnp.asarray(inp["ct"])

    def run(mp, x):
        out, aux = jm.moe_ffn(mp, x, mesh=jmesh4, top_k=2, group_size=16)
        return jnp.sum(out * ct) + aux, (out, aux)

    (_, (out, aux)), (gmp, gx) = jax.jit(jax.value_and_grad(
        run, argnums=(0, 1), has_aux=True))(jm.shard_moe_params(mp, jmesh4),
                                             x)
    got = world["moe_ffn"]
    assert (got["rank_w1"] == (2, 8, 16)).all()
    np.testing.assert_allclose(got["out"], np.asarray(out), rtol=0,
                               atol=OUT_ATOL)
    np.testing.assert_allclose(got["aux"], float(aux), rtol=1e-5)
    for name, want in (("gx", gx), ("gwg", gmp["wg"]), ("gw1", gmp["w1"]),
                       ("gw2", gmp["w2"])):
        np.testing.assert_allclose(got[name], np.asarray(want),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=name)


@pytest.fixture
def jmesh22(monkeypatch):
    """The JAX CLIs' create_mesh() over 4 devices: (2, 2), the port's
    default mesh of four ranks."""
    mesh = jmesh.create_mesh((2, 2), devices=jax.devices()[:WORLD])
    monkeypatch.setattr(jmt, "create_mesh", lambda *a, **k: mesh)
    return mesh


def _without_times(line: str) -> str:
    return line.split(" in ")[0] if " in " in line else line


def test_long_context_training_cli_on_ranks(world, jmesh22, capsys):
    """The CLI with remat and a chunked head, its (2, 2) mesh's rows axis of
    two ranks holding the sequence's halves."""
    jl = importlib.import_module("examples.long_context_training").main(
        LCT_ARGS)
    jout = capsys.readouterr().out.splitlines()
    got = world["lct_cli"]
    np.testing.assert_allclose(got["losses"], jl, rtol=CLI_TOL)
    for lines in got["rank_lines"]:
        assert lines[0].split(":")[0] == jout[0].split(":")[0]
        assert lines[-1] == jout[-1]  # the greedy continuation
