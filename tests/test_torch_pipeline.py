"""The GPipe pipeline across ``torch.distributed`` ranks, forward and
gradients, against the JAX package's on a 4-stage mesh.

One 4-rank gloo world (``_torch_dist.run_world``) runs the cases of
``tests/test_pipeline.py`` with seeded numpy stages (tanh(x @ w + b) per
stage); each is compared here with the JAX package's ``pipeline_apply`` on
the same inputs over a ("rows" 4) mesh, within ``PIPE_TOL`` of max |ref|,
and with the plain sequential composition. The pp x tp case has no
counterpart: it needs GSPMD inside a stage (ROADMAP queue 3).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from marlin_tpu import mesh as jmesh
from marlin_tpu.parallel.pipeline import pipeline_apply, stack_stage_params

from _torch_dist import run_world

WORLD = 4
PIPE_TOL = 1e-5


def _stages(seed, d, batch, target=False, microbatch=0):
    rng = np.random.default_rng(seed)
    out = {"w": (rng.standard_normal((WORLD, d, d)) / np.sqrt(d)).astype(
               np.float32),
           "b": (0.1 * rng.standard_normal((WORLD, d))).astype(np.float32),
           "x": rng.standard_normal((batch, d)).astype(np.float32),
           "microbatch": np.array(microbatch)}
    if target:
        out["y"] = (0.1 * rng.standard_normal((batch, d))).astype(np.float32)
    return out


INPUTS = {
    "pipeline_seq": _stages(0, 16, 24, microbatch=4),
    "pipeline_default_mb": _stages(1, 8, 8),
    "pipeline_mb1": _stages(2, 8, 6, microbatch=1),
    "pipeline_grad": _stages(3, 8, 16, target=True, microbatch=4),
    "pipeline_train": _stages(4, 8, 16, target=True, microbatch=4),
    "pipeline_refuses": {},
}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return run_world(WORLD, list(INPUTS), INPUTS,
                     tmp_path_factory.mktemp("pipeline_world"))


@pytest.fixture(scope="module")
def jmesh4():
    return jmesh.create_mesh((WORLD, 1), devices=jax.devices()[:WORLD])


def _stage(p, x):
    return jnp.tanh(x @ p["w"] + p["b"])


def _jax_params(inp, mesh):
    return stack_stage_params([{"w": jnp.asarray(inp["w"][s]),
                                "b": jnp.asarray(inp["b"][s])}
                               for s in range(WORLD)], mesh)


def _sequential(inp):
    x = inp["x"].astype(np.float64)
    for s in range(WORLD):
        x = np.tanh(x @ inp["w"][s] + inp["b"][s])
    return x


def _close(got, want, tol=PIPE_TOL):
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * np.abs(want).max())


@pytest.mark.parametrize("name", ["pipeline_seq", "pipeline_default_mb",
                                  "pipeline_mb1"])
def test_pipeline_matches_jax_and_sequential(world, jmesh4, name):
    inp = INPUTS[name]
    mb = int(inp["microbatch"]) or None
    want = jax.jit(lambda p, x: pipeline_apply(p, _stage, x, jmesh4,
                                               microbatch=mb))(
        _jax_params(inp, jmesh4), jnp.asarray(inp["x"]))
    _close(world[name]["out"], want)
    _close(world[name]["out"], _sequential(inp))


def test_pipeline_grad_matches_jax(world, jmesh4):
    inp = INPUTS["pipeline_grad"]
    x, y = jnp.asarray(inp["x"]), jnp.asarray(inp["y"])

    def loss(params, xx):
        out = pipeline_apply(params, _stage, xx, jmesh4, microbatch=4)
        return jnp.mean((out - y) ** 2)

    got = world["pipeline_grad"]
    jl, (gp, gx) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1)))(
        _jax_params(inp, jmesh4), x)
    np.testing.assert_allclose(got["loss"], float(jl), rtol=PIPE_TOL)
    _close(got["gw"], gp["w"])
    _close(got["gb"], gp["b"])
    _close(got["gx"], gx)


def test_pipeline_train_steps_drop_the_loss(world, jmesh4):
    """Two SGD steps (lr 0.1): the port's losses equal the JAX package's and
    fall."""
    inp = INPUTS["pipeline_train"]
    x, y = jnp.asarray(inp["x"]), jnp.asarray(inp["y"])
    params = _jax_params(inp, jmesh4)

    @jax.jit  # one compile for both steps
    def step(p):
        l, g = jax.value_and_grad(lambda q: jnp.mean((pipeline_apply(
            q, _stage, x, jmesh4, microbatch=4) - y) ** 2))(p)
        return jax.tree.map(lambda w, gw: w - 0.1 * gw, p, g), l

    losses = []
    for _ in range(2):
        params, l = step(params)
        losses.append(float(l))
    got = world["pipeline_train"]["losses"]
    np.testing.assert_allclose(got, losses, rtol=PIPE_TOL)
    assert got[1] < got[0]


def test_pipeline_validation(world):
    msgs = [str(m) for m in world["pipeline_refuses"]["msgs"]]
    assert len(msgs) == 2
    assert "3 stage param sets" in msgs[0]
    assert "multiple of microbatch" in msgs[1]
