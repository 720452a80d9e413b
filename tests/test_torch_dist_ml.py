"""The ML workloads across ranks — the (dp, tp) MLP and its CLI, blocked ALS
and edge-sharded PageRank — and the ``moe_training`` CLI on ranks, against
the JAX package on a 4-device CPU mesh.

One 4-rank gloo world (``_torch_dist.run_world``) runs each on the default
mesh of four ranks, ``best_grid(4)`` = (2, 2); the JAX package runs the same
numpy inputs on ``jax.devices()[:4]`` as a (2, 2) mesh (its CLIs see four
devices). Tolerances, as ``tests/test_torch_ml.py`` and
``tests/test_torch_examples.py`` state them:

- the MLP: ``train_step``'s losses and params within ``MLP_TOL`` (1e-5);
  the CLI's step losses within ``TRAIN_TOL`` (1e-4) relative and its
  accuracy equal;
- ALS factors after 5 sweeps within ``ALS_TOL`` (2e-4) absolute, the user
  and item without ratings exactly 0;
- PageRank ranks within ``PR_TOL`` (1e-6);
- the ``moe_training`` CLI's losses within ``CLI_TOL`` (1e-4) relative, the
  aux line's value within 1e-3, the greedy continuation equal.
"""

import importlib
import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

import marlin_tpu as jmt
from marlin_tpu import mesh as jmesh
from marlin_tpu.models import TransformerLM as JaxLM

from _torch_dist import run_world

WORLD = 4
MLP_TOL = 1e-5
TRAIN_TOL = 1e-4
ALS_TOL = 2e-4
PR_TOL = 1e-6
CLI_TOL = 1e-4

jnn = importlib.import_module("marlin_tpu.ml.neural_network")
jpr = importlib.import_module("marlin_tpu.ml.pagerank")

NN_CLI_ARGS = ["60", "16", "64"]
MOE_ARGS = ["128", "3", "4", "2", "64", "1"]


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(tree)}


def _ratings(seed, implicit):
    """tests/test_torch_ml.py's low-rank ratings, user 3 and item 5 with
    none."""
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((30, 4)).astype(np.float32)
    v = rng.standard_normal((20, 4)).astype(np.float32)
    mask = rng.random((30, 20)) < 0.5
    mask[3] = False
    mask[:, 5] = False
    ui, ii = np.nonzero(mask)
    vals = (rng.integers(1, 10, len(ui)).astype(np.float32) if implicit
            else (u @ v.T)[mask])
    return dict(users=ui, items=ii, vals=vals, shape=np.array([30, 20]))


def _mlp_step_inputs():
    """A 3-layer MLP (12 -> 8 -> 8 -> 6): w0 and w2 cut by columns, w1 by
    rows, so the last layer's output columns are gathered."""
    rng = np.random.default_rng(1)
    params = jnn.mlp_init(jax.random.key(3), (12, 8, 8, 6))
    return dict({k: np.asarray(v) for k, v in params.items()},
                x=rng.standard_normal((128, 12)).astype(np.float32),
                y=np.eye(6, dtype=np.float32)[rng.integers(0, 6, 128)],
                steps=np.array(4), batch=np.array(32))


def _inputs():
    rng = np.random.default_rng(2)
    edges = np.stack([rng.integers(0, 50, 301), rng.integers(0, 50, 301)],
                     axis=1)
    moe = JaxLM(vocab=512, d_model=64, heads=1, layers=1,
                n_experts=4).init_params()
    return {
        "nn_cli": {"argv": np.array(NN_CLI_ARGS)},
        "nn_step": _mlp_step_inputs(),
        "als_explicit": _ratings(0, False),
        "als_implicit": _ratings(0, True),
        "pagerank": dict(edges=edges, n=np.array(50), iters=np.array(20)),
        "moe_cli": dict(_flat(moe), argv=np.array(MOE_ARGS)),
    }


INPUTS = _inputs()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return run_world(WORLD, list(INPUTS), INPUTS,
                     tmp_path_factory.mktemp("ml_world"))


@pytest.fixture(scope="module")
def jmesh22():
    return jmesh.create_mesh((2, 2), devices=jax.devices()[:WORLD])


def test_mlp_cli_on_ranks(world, tmp_path, monkeypatch, capsys):
    """distributed_training at (2, 2): the JAX CLI over four devices."""
    devices = jax.devices()[:WORLD]
    monkeypatch.setattr(jax, "devices", lambda *a, **k: devices)
    importlib.import_module("examples.distributed_training").main(
        [*NN_CLI_ARGS, str(tmp_path)])
    jout = capsys.readouterr().out.splitlines()
    with open(tmp_path / "events.jsonl") as f:
        jl = [json.loads(ln)["loss"] for ln in f
              if json.loads(ln)["kind"] == "step"]
    got = world["nn_cli"]
    assert jout[0] == "mesh: 2 data-parallel x 2 tensor-parallel over 4 devices"
    assert len(got["losses"]) == len(jl) == 60
    np.testing.assert_allclose(got["losses"], jl, rtol=TRAIN_TOL)
    for r, lines in enumerate(got["rank_lines"]):
        assert lines[0] == jout[0]
        assert lines[1].split("accuracy")[1] == jout[1].split("accuracy")[1]
        # each rank checkpoints into its own directory
        assert got["rank_dirs"][r].tolist() == [f"rank{r}"]


def test_mlp_step_dp_tp_matches_jax(world, jmesh22):
    """train_step(mesh=) with three layers against the JAX package's step
    with its NamedSharding placements on the (2, 2) mesh."""
    inp = INPUTS["nn_step"]
    spec = {"w0": P(None, "cols"), "w1": P("cols", None),
            "w2": P(None, "cols")}
    params = {k: jax.device_put(jnp.asarray(inp[k]),
                                NamedSharding(jmesh22, s))
              for k, s in spec.items()}
    x, y = (jax.device_put(jnp.asarray(inp[k]),
                           NamedSharding(jmesh22, P("rows", None)))
            for k in ("x", "y"))
    losses = []
    for i in range(int(inp["steps"])):
        params, loss = jnn.train_step(params, x, y, jax.random.key(i),
                                      int(inp["batch"]), 0.5,
                                      activation="tanh")
        losses.append(float(loss))
    got = world["nn_step"]
    np.testing.assert_allclose(got["losses"], losses, rtol=MLP_TOL)
    for k in spec:
        np.testing.assert_allclose(got[k], np.asarray(params[k]), rtol=0,
                                   atol=MLP_TOL, err_msg=k)


@pytest.mark.parametrize("mode", ["explicit", "implicit"])
def test_als_over_ranks_matches_jax(world, jmesh22, mode):
    """Blocked ALS (segment blocks of 8 over the four ranks) against the
    JAX package's sharded solver on four devices."""
    inp = INPUTS[f"als_{mode}"]
    kw = dict(implicit_prefs=True, alpha=5.0) if mode == "implicit" else {}
    coo = jmt.CoordinateMatrix(inp["users"], inp["items"], inp["vals"],
                               shape=tuple(int(n) for n in inp["shape"]),
                               mesh=jmesh22)
    model = coo.als(rank=4, iterations=5, lam=0.05, shard=True,
                    segment_block=8, **kw)
    got = world[f"als_{mode}"]
    for key, want in (("u", model.user_features.to_numpy()),
                      ("v", model.product_features.to_numpy())):
        assert got[key].shape == want.shape
        np.testing.assert_allclose(got[key], want, rtol=0, atol=ALS_TOL,
                                   err_msg=key)
    assert not np.any(got["u"][3]) and not np.any(got["v"][5])
    np.testing.assert_allclose(got["rmse"], model.rmse(coo), rtol=1e-4)


def test_pagerank_over_ranks_matches_jax(world, jmesh22):
    """The edge-sharded operator: 301 edges padded to 304, 76 a rank (the
    last rank's 3 pad edges weigh 0), against the JAX package's."""
    inp = INPUTS["pagerank"]
    op = jpr.build_transition_operator(inp["edges"], n=int(inp["n"]),
                                       mesh=jmesh22)
    want = jpr.pagerank(op, iterations=int(inp["iters"]))
    got = world["pagerank"]
    np.testing.assert_allclose(got["ranks"], want, rtol=0, atol=PR_TOL)
    assert got["rank_edges"].tolist() == [76] * WORLD
    assert got["rank_weight"].tolist() == [76.0, 76.0, 76.0, 73.0]


def test_moe_training_cli_on_ranks(world, jmesh22, monkeypatch, capsys):
    """moe_training on the (2, 2) mesh: the sequence over the rows axis's
    two ranks, each holding 2 of the 4 experts."""
    monkeypatch.setattr(jmt, "create_mesh", lambda *a, **k: jmesh22)
    jl = importlib.import_module("examples.moe_training").main(MOE_ARGS)
    jout = capsys.readouterr().out.splitlines()
    got = world["moe_cli"]
    np.testing.assert_allclose(got["losses"], jl, rtol=CLI_TOL)
    for lines in got["rank_lines"]:
        aux = [float(o.split(": ")[1].split()[0]) for o in (jout[2],
                                                             lines[2])]
        np.testing.assert_allclose(aux[1], aux[0], atol=1e-3)
        assert lines[3] == jout[3]  # the greedy continuation
        assert lines[0].split(":")[0] == jout[0].split(":")[0]


def test_mesh_of_many_devices_not_over_ranks_refused():
    """ALS's blocked solver and the (dp, tp) MLP step need a mesh over
    torch.distributed ranks to spread over devices: a (2, 2) mesh that is
    not over ranks raises, as ring attention does."""
    import torch

    import marlin_tpu_torch as tm
    from marlin_tpu_torch.mesh import Mesh

    wide = Mesh(torch.device("cpu"), (2, 2))
    inp = INPUTS["als_explicit"]
    with tm.config_context(device="cpu"):
        coo = tm.CoordinateMatrix(inp["users"], inp["items"], inp["vals"],
                                  shape=(30, 20))
        with pytest.raises(ValueError, match="over torch.distributed ranks"):
            coo.als(rank=4, iterations=1, shard=True, mesh=wide)
        tnn = importlib.import_module("marlin_tpu_torch.ml.neural_network")
        step = INPUTS["nn_step"]
        params = {k: torch.tensor(step[k]) for k in ("w0", "w1", "w2")}
        with pytest.raises(ValueError, match="over torch.distributed ranks"):
            tnn.train_step(params, torch.tensor(step["x"]),
                           torch.tensor(step["y"]), 0, 32, 0.5, mesh=wide)
