"""The pipeline composed with tensor parallelism (pp x tp) across
``torch.distributed`` ranks, against the JAX package on a (2, 2) mesh.

One 4-rank gloo world (``_torch_dist.run_world``) on a (2, 2) rank grid
runs two stages over "rows" with their weights split over "cols"; the JAX
package runs the same inputs on a (2, 2) mesh of 4 of its 8 CPU devices
with the same placements (``jax.device_put`` with ``NamedSharding``):

- ``tests/test_pipeline.py``'s two-matrix stage (``w0`` by columns, ``w1``
  by rows): output within ``PIPE_TOL`` of max |ref| of JAX and of the
  stages in sequence, gradients of a squared loss within
  ``GRAD_RTOL``/``GRAD_ATOL`` of ``jax.grad``;
- ``pp_lm_loss`` on the Megatron placement (``pp_tp_placement``), with and
  without GQA, within ``LOSS_RTOL``, and one ``pp_lm_train_step`` within
  ``TRAIN_RTOL``;
- at 2048 tokens with no gradients, the split loss against the port's
  unsplit one (plain attention on the CPU), and the gradient refusal;
- a call that names no split issues the collectives of a call without a
  placement and returns the same bits.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from marlin_tpu import mesh as jmesh
from marlin_tpu.models.pipeline_lm import (pp_lm_loss, pp_lm_train_step,
                                           pp_stage_params)
from marlin_tpu.models.transformer import init_transformer, synthetic_stream
from marlin_tpu.parallel.pipeline import pipeline_apply

from _torch_dist import run_world

WORLD = 4
STAGES = 2
PIPE_TOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
LOSS_RTOL = 1e-5
TRAIN_RTOL = 1e-4
COL_SPLIT = ("wq", "wk", "wv", "w1")
ROW_SPLIT = ("wo", "w2")


def _mlp_inputs(seed):
    rng = np.random.default_rng(seed)
    d, ff, batch = 8, 16, 16
    return {"w0": (rng.standard_normal((STAGES, d, ff)) / 3).astype(
                np.float32),
            "w1": (rng.standard_normal((STAGES, ff, d)) / 4).astype(
                np.float32),
            "x": rng.standard_normal((batch, d)).astype(np.float32),
            "y": (0.1 * rng.standard_normal((batch, d))).astype(np.float32),
            "microbatch": np.array(4)}


def _batch(b, t, vocab):
    return np.stack([synthetic_stream(t, vocab=vocab, seed=i)
                     for i in range(b)])


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(tree)}


def _params(seed, heads, layers=2, vocab=64, d=32, **kw):
    return init_transformer(jax.random.key(seed), vocab, d, heads, layers,
                            **kw)


LM_CASES = {  # name: (params, tokens, heads, microbatch, extra inputs)
    "pptp_lm": (_params(10, 4), _batch(4, 17, 64), 4, 2, {}),
    "pptp_lm_gqa": (_params(11, 4, kv_heads=2), _batch(4, 17, 64), 4, 2, {}),
    "pptp_train": (_params(12, 4), _batch(4, 17, 64), 4, 2,
                   {"steps": np.array(1), "lr": np.array(1e-2)}),
}
LONG = (_params(13, 2, vocab=16, d=16), _batch(1, 2049, 16))


def _inputs():
    out = {"pptp_mlp": _mlp_inputs(7), "pptp_unsplit": _mlp_inputs(8)}
    for name, (p, toks, heads, mb, extra) in LM_CASES.items():
        out[name] = dict(_flat(p), tokens=toks, heads=np.array(heads),
                         microbatch=np.array(mb), **extra)
    out["pptp_long"] = dict(_flat(LONG[0]), tokens=LONG[1])
    return out


INPUTS = _inputs()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return run_world(WORLD, list(INPUTS), INPUTS,
                     tmp_path_factory.mktemp("pptp_world"))


@pytest.fixture(scope="module")
def jmesh22():
    return jmesh.create_mesh((STAGES, 2), devices=jax.devices()[:WORLD])


def _place(mesh, tree, specs):
    return {k: jax.device_put(v, NamedSharding(mesh, specs.get(
        k, P("rows", *(None,) * (v.ndim - 1))))) for k, v in tree.items()}


def _megatron(mesh, sp):
    specs = {**dict.fromkeys(COL_SPLIT, P("rows", None, None, "cols")),
             **dict.fromkeys(ROW_SPLIT, P("rows", None, "cols", None))}
    return _place(mesh, sp, specs)


def _mlp2(p, x):
    return jnp.tanh(jax.nn.relu(x @ p["w0"]) @ p["w1"])


def _close(got, want, tol=PIPE_TOL):
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * np.abs(want).max())


def test_split_stage_matches_jax_and_sequential(world, jmesh22):
    inp = INPUTS["pptp_mlp"]
    params = _place(jmesh22, {"w0": jnp.asarray(inp["w0"]),
                              "w1": jnp.asarray(inp["w1"])},
                    {"w0": P("rows", None, "cols"),
                     "w1": P("rows", "cols", None)})
    x, y = jnp.asarray(inp["x"]), jnp.asarray(inp["y"])

    def loss(p, xx):
        out = pipeline_apply(p, _mlp2, xx, jmesh22, microbatch=4)
        return jnp.mean((out - y) ** 2), out

    (jl, jout), (gp, gx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(params, x)
    assert params["w0"].sharding.spec == P("rows", None, "cols")
    got = world["pptp_mlp"]
    _close(got["out"], jout)
    seq = inp["x"].astype(np.float64)
    for s in range(STAGES):
        seq = np.tanh(np.maximum(seq @ inp["w0"][s], 0) @ inp["w1"][s])
    _close(got["out"], seq)
    np.testing.assert_allclose(got["loss"], float(jl), rtol=LOSS_RTOL)
    for name, want in (("gw0", gp["w0"]), ("gw1", gp["w1"]), ("gx", gx)):
        np.testing.assert_allclose(got[name], np.asarray(want),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=name)


def test_no_split_is_the_unplaced_call(world):
    """A placement that names no split issues, on every rank, the
    collectives of a call without one (per tick a shift, one all-reduce of
    the output; backward the shifts, one all-reduce of the input's gradient
    and one all-gather a leaf, all over the pipeline axis), and returns the
    same bits; the output is the stages applied in sequence to each
    microbatch, bit for bit."""
    got = world["pptp_unsplit"]
    for k in ("out", "gw0", "gw1", "gx"):
        np.testing.assert_array_equal(got[f"{k}_unsplit"], got[f"{k}_none"],
                                      err_msg=k)
    np.testing.assert_array_equal(got["out_none"], got["seq"])
    ticks = INPUTS["pptp_unsplit"]["x"].shape[0] // 4 + STAGES - 1
    for r in range(WORLD):
        log = list(got["rank_log_none"][r])
        assert log == list(got["rank_log_unsplit"][r]), r
        rows = [str(x) for x in (r % 2, r % 2 + 2)]  # this rank's stages
        groups = {c[c.index("(") + 1:-1] for c in log
                  if not c.startswith("batch")}
        assert groups == {",".join(rows)}, (r, log)
        kinds = [c.split("(")[0] for c in log]
        assert kinds.count("batch_isend_irecv") == 2 * (ticks - 1), log
        assert kinds.count("all_reduce") == 2, log
        assert kinds.count("all_gather") == 2, log


@pytest.mark.parametrize("name", ["pptp_lm", "pptp_lm_gqa"])
def test_pp_lm_loss_split_matches_jax(world, jmesh22, name):
    p, toks, heads, mb, _ = LM_CASES[name]
    sp, outer = pp_stage_params(p, jmesh22)
    sp = _megatron(jmesh22, sp)
    want = float(jax.jit(lambda a, b: pp_lm_loss(
        a, b, toks, jmesh22, heads=heads, microbatch=mb))(sp, outer))
    np.testing.assert_allclose(float(world[name]["loss"]), want,
                               rtol=LOSS_RTOL)


def test_pp_lm_train_step_split_matches_jax(world, jmesh22):
    """The split loss's gradients within GRAD_RTOL/GRAD_ATOL of jax.grad on
    the same placement, and one Adam step's params within TRAIN_RTOL of
    JAX's. Adam's first step moves an element by lr·g/(|g| + 1e-8), so
    where |g| is within GRAD_ATOL of 0 the rounding of g decides the step;
    there the two params may differ by up to 2·lr."""
    import optax

    p, toks, heads, mb, extra = LM_CASES["pptp_train"]
    lr = float(extra["lr"])
    sp, outer = pp_stage_params(p, jmesh22)
    sp = _megatron(jmesh22, sp)
    got = world["pptp_train"]
    _, (gsp, gouter) = jax.jit(jax.value_and_grad(lambda t: pp_lm_loss(
        t[0], t[1], toks, jmesh22, heads=heads, microbatch=mb)))((sp, outer))
    grads = {"sp": _flat(gsp), "outer": _flat(gouter)}
    for prefix in grads:
        for k, want in grads[prefix].items():
            np.testing.assert_allclose(got[f"g{prefix}/{k}"], want,
                                       rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                       err_msg=f"g{prefix}/{k}")
    state = optax.adam(lr).init((sp, outer))
    sp, outer, state, l = pp_lm_train_step(sp, outer, state, toks, jmesh22,
                                           heads=heads, microbatch=mb, lr=lr)
    np.testing.assert_allclose(got["losses"], [float(l)], rtol=TRAIN_RTOL)
    for prefix, tree in (("sp", sp), ("outer", outer)):
        for k, want in _flat(tree).items():
            settled = np.abs(grads[prefix][k]) > GRAD_ATOL
            have = got[f"{prefix}/{k}"]
            np.testing.assert_allclose(have[settled], want[settled],
                                       rtol=TRAIN_RTOL, atol=1e-6,
                                       err_msg=f"{prefix}/{k}")
            assert np.all(np.abs(have - want)[~settled] <= 2 * lr), k


def test_long_sequences_split_loss_and_refusal(world):
    """At 2048 tokens (one head a rank) the split loss equals the unsplit
    one without gradients; with a gradient wanted it raises, as the JAX
    package's jax.grad does there."""
    got = world["pptp_long"]
    np.testing.assert_allclose(float(got["split"]), float(got["whole"]),
                               rtol=LOSS_RTOL)
    assert "2048" in str(got["raised"]) and "JAX" in str(got["raised"])


def test_split_validation():
    """Heads or KV heads that do not divide by the split axis, a placement
    other than the Megatron one, and a leaf whose first dimension is not
    the pipeline axis raise ValueError before any collective."""
    import torch

    from marlin_tpu_torch import config_context
    from marlin_tpu_torch import interop
    from marlin_tpu_torch.mesh import Mesh, Sharding
    from marlin_tpu_torch.models import pipeline_lm as tpl
    from marlin_tpu_torch.parallel import pipeline as tpipe

    grid = Mesh(torch.device("cpu"), (1, 2))  # only its shape is read
    with config_context(device="cpu"):
        for heads, kv, msg in ((1, None, "1 heads and 1 KV heads"),
                               (4, 1, "4 heads and 1 KV heads")):
            p = interop.lm_params_from_numpy(jax.tree.map(
                np.asarray, _params(14, heads, kv_heads=kv)), device="cpu")
            sp, outer = tpl.pp_stage_params(p, grid)
            with pytest.raises(ValueError, match=msg) as e:
                tpl.pp_lm_loss(sp, outer, _batch(1, 9, 64), grid,
                               heads=heads,
                               placement=tpl.pp_tp_placement(grid))
            assert "'cols' axis (2)" in str(e.value)
        wrong = dict(tpl.pp_tp_placement(grid),
                     wo=Sharding(grid, ("rows", None, None, "cols")))
        with pytest.raises(ValueError, match="Megatron way only"):
            tpl.pp_lm_loss(sp, outer, _batch(1, 9, 64), grid, heads=4,
                           placement=wrong)
        x = torch.zeros((4, 8))
        with pytest.raises(ValueError, match="pipeline axis 'rows'"):
            tpipe.pipeline_apply(
                {"w": torch.zeros((1, 8, 8))}, lambda q, xs: xs @ q["w"], x,
                grid, placement={"w": Sharding(grid, ("cols", None, None))})
