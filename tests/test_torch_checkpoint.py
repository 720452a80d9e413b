"""The port's checkpoints, resume and recovery against the JAX package's, on
the CPU.

Generations are written to ``tmp_path`` by one package and read by the
other, or replayed under the same injected faults in both
(``marlin_tpu.io.checkpoint`` / ``utils.failure`` and their counterparts in
``marlin_tpu_torch``, under ``config_context(device="cpu")``). Every check
here is exact:

- a generation written by either package loads in the other, bit for bit,
  for a nested dict of arrays and for the LM's params with Adam state (the
  leaf order is ``jax.tree.flatten``'s: dict keys sorted); a sharded array
  written by either package loads in the other;
- optimizer states (Adam, momentum) and the port's matrices round-trip within
  the port;
- torn and corrupt generations raise alike, and recovery falls back alike;
- ``ResilientLoop`` emits the same ``resume``/``resume_skip``/
  ``step_failure`` sequence in both packages under the same faults;
- ``TransformerLM.train`` and ``NeuralNetwork.train`` resumed from a
  ``checkpoint_dir`` equal an uninterrupted run bit for bit.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import marlin_tpu_torch as tm
from marlin_tpu.io import checkpoint as jck
from marlin_tpu.models import TransformerLM as JaxLM
from marlin_tpu.utils import failure as jfail
from marlin_tpu.utils import faults as jfaults
from marlin_tpu_torch import interop
from marlin_tpu_torch.io import checkpoint as tck
from marlin_tpu_torch.io.orbax_ckpt import OrbaxCheckpointer
from marlin_tpu_torch.ml import neural_network as tnn
from marlin_tpu_torch.models import transformer as tt
from marlin_tpu_torch.utils import failure as tfail
from marlin_tpu_torch.utils import faults as tfaults
from marlin_tpu_torch.utils.tracing import EventLog as TLog
from marlin_tpu.utils.tracing import EventLog as JLog

LM_KW = dict(vocab=64, d_model=32, heads=2, layers=2, seed=0)
TOKS = np.random.default_rng(0).integers(0, 64, 200).astype(np.int32)


@pytest.fixture(autouse=True)
def _cpu():
    with tm.config_context(device="cpu"):
        yield


def _flip_byte(path, offset=-20):
    with open(path, "r+b") as f:
        f.seek(offset, os.SEEK_END)
        b = f.read(1)
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([b[0] ^ 0xFF]))


def _state_np(seed=0):
    """A nested state whose dict keys are inserted out of sorted order."""
    rng = np.random.default_rng(seed)
    return {"z": rng.standard_normal((3, 4)).astype(np.float32),
            "b": {"y": rng.standard_normal(5).astype(np.float32),
                  "a": rng.integers(0, 9, (2, 2)).astype(np.int32)},
            "list": [rng.standard_normal(2).astype(np.float32),
                     (rng.standard_normal((1, 3)).astype(np.float32),)]}


def _as_torch(tree):
    """Arrays as tensors, keeping dict insertion order (jax.tree.map would
    sort the keys)."""
    if isinstance(tree, dict):
        return {k: _as_torch(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_as_torch(v) for v in tree)
    return torch.from_numpy(np.array(tree))


def _flat_np(tree):
    leaves, _ = tck.tree_flatten(tree)
    return [np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)
            for x in leaves]


# ----------------------------------------------------------------- leaf order
def test_tree_flatten_order_is_jax_order():
    s = _state_np()
    jl = [np.asarray(x) for x in jax.tree.leaves(s)]
    tl = _flat_np(_as_torch(s))
    assert len(jl) == len(tl) == 5
    for a, b in zip(jl, tl):
        assert np.array_equal(a, b)
    leaves, spec = tck.tree_flatten({"n": None, "t": (), "s": _as_torch(s)})
    back = tck.tree_unflatten(spec, leaves)
    assert back["n"] is None and back["t"] == ()
    assert list(back["s"]) == ["z", "b", "list"]  # insertion order kept
    assert isinstance(back["s"]["list"][1], tuple)


# ------------------------------------------------------ cross-package states
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_dict_state_loads_across_packages(tmp_path, writer):
    s = _state_np(1)
    d = str(tmp_path)
    if writer == "jax":
        jck.save_checkpoint(jax.tree.map(jnp.asarray, s), d, 3)
        got, step = tck.load_checkpoint(_as_torch(_state_np(2)), d)
        assert isinstance(got["z"], torch.Tensor)
        assert got["b"]["a"].dtype == torch.int32
    else:
        tck.save_checkpoint(_as_torch(s), d, 3)
        got, step = jck.load_checkpoint(
            jax.tree.map(jnp.asarray, _state_np(2)), d)
    assert step == 3
    for a, b in zip(_flat_np(got), jax.tree.leaves(s)):
        assert np.array_equal(a, np.asarray(b))


@pytest.fixture(scope="module")
def lm_params():
    jp = JaxLM(**LM_KW).init_params()
    tp = interop.lm_params_from_numpy(jax.tree.map(np.asarray, jp),
                                      device="cpu")
    return jp, tp


def test_lm_generation_written_by_jax_loads_in_port(tmp_path, lm_params):
    """The JAX trainer's own generations (``{"params", "opt_state"}`` with
    optax's Adam state) load into the port's template: params, moments and
    step count bit for bit."""
    jp, tp = lm_params
    d = str(tmp_path)
    params_j, _ = JaxLM(**LM_KW).train(TOKS, steps=2, params=jp,
                                       checkpoint_dir=d, checkpoint_every=1)
    assert jck.list_generations(d) == [1, 2]
    tmpl = {"params": tp, "opt_state": tt.adam_init(tp)}
    got, step = tck.load_checkpoint(tmpl, d)
    assert step == 2 and got["opt_state"].count == 2
    want = jax.tree.map(np.asarray, params_j)
    for k, v in got["params"].items():
        w = want[k]
        if isinstance(v, dict):
            for kk in v:
                assert np.array_equal(v[kk].numpy(), w[kk])
        else:
            assert np.array_equal(v.numpy(), w)


def test_lm_generation_written_by_port_loads_in_jax(tmp_path, lm_params):
    jp, tp = lm_params
    d = str(tmp_path)
    params_t, _ = tt.TransformerLM(**LM_KW).train(
        TOKS, steps=2, params=tp, checkpoint_dir=d, checkpoint_every=2)
    tmpl = {"params": jp, "opt_state": optax.adam(3e-3).init(jp)}
    got, step = jck.load_checkpoint(tmpl, d)
    assert step == 2 and int(got["opt_state"][0].count) == 2
    for a, b in zip(jax.tree.leaves(got["params"]),
                    _flat_np(params_t)):
        assert np.array_equal(np.asarray(a), b)


@pytest.mark.parametrize("opt", ["adam", "momentum"])
def test_optimizer_state_round_trips_in_port(tmp_path, opt):
    params = {"w1": torch.randn(4, 3), "w0": torch.randn(5, 4)}
    if opt == "adam":
        state = tt.AdamState(7, {k: v + 1 for k, v in params.items()},
                             {k: v * 2 for k, v in params.items()})
    else:
        state = tnn.MomentumState({k: v - 1 for k, v in params.items()})
    tck.save_checkpoint({"params": params, "opt_state": state},
                        str(tmp_path), 1)
    tmpl = {"params": {k: torch.zeros_like(v) for k, v in params.items()},
            "opt_state": tnn.opt_init(opt, params)}
    got, _ = tck.load_checkpoint(tmpl, str(tmp_path))
    assert type(got["opt_state"]) is type(state)
    for a, b in zip(_flat_np(got), _flat_np({"params": params,
                                             "opt_state": state})):
        assert np.array_equal(a, b)
    if opt == "adam":
        assert got["opt_state"].count == 7
        assert isinstance(got["opt_state"].count, int)


def test_matrix_and_bf16_leaves_round_trip(tmp_path):
    m = tm.DenseVecMatrix.from_array(np.arange(12.0).reshape(3, 4))
    v = torch.arange(6, dtype=torch.float32).to(torch.bfloat16) / 3
    tck.save_checkpoint({"m": m, "v": v}, str(tmp_path), 5)
    tmpl = {"m": tm.DenseVecMatrix.zeros(3, 4),
            "v": torch.zeros(6, dtype=torch.bfloat16)}
    got, _ = tck.load_checkpoint(tmpl, str(tmp_path))
    assert isinstance(got["m"], tm.DenseVecMatrix) and got["m"].shape == (3, 4)
    assert np.array_equal(got["m"].to_numpy(), m.to_numpy())
    assert torch.equal(got["v"], v)


def test_template_mismatch_raises(tmp_path):
    tck.save_checkpoint({"a": torch.ones(3)}, str(tmp_path), 1)
    with pytest.raises(ValueError, match="different configuration"):
        tck.load_checkpoint({"a": torch.ones(4)}, str(tmp_path))
    with pytest.raises(ValueError, match="leaves"):
        tck.load_checkpoint({"a": torch.ones(3), "b": torch.ones(1)},
                            str(tmp_path))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_sharded_loads_across_packages(tmp_path, mesh, writer):
    from jax.sharding import NamedSharding, PartitionSpec as P

    a = np.random.default_rng(3).standard_normal((16, 12)).astype(np.float32)
    d = str(tmp_path / "arr")
    if writer == "jax":
        integ = jck.save_sharded(jax.device_put(
            a, NamedSharding(mesh, P("rows", "cols"))), d)
        got = tck.load_sharded(d, sharding="cpu")
        assert got.dtype == torch.float32 and got.device.type == "cpu"
        assert np.array_equal(got.numpy(), a)
    else:
        integ = tck.save_sharded(tm.DenseVecMatrix.from_array(a), d)
        assert sorted(integ) == ["manifest_0.json", "shard_0_0_0.npy"]
        with open(os.path.join(d, "manifest_0.json")) as f:
            man = json.load(f)
        assert man["shards"][0]["crc32"] == integ["shard_0_0_0.npy"]["crc32"]
        for sh in (None, NamedSharding(mesh, P("rows", None))):
            assert np.array_equal(np.asarray(jck.load_sharded(d, sh)), a)
        assert np.array_equal(tck.load_sharded(d).numpy(), a)


def test_remote_checkpoint_round_trip():
    import fsspec

    d = "memory://marlin_ckpt_port"
    s = _as_torch(_state_np(4))
    tck.save_checkpoint(s, d, 1)
    tck.save_checkpoint(s, d, 2, keep=1)
    assert tck.list_generations(d) == [2]
    got, step = tck.load_checkpoint(_as_torch(_state_np(5)), d)
    assert step == 2
    for a, b in zip(_flat_np(got), _flat_np(s)):
        assert np.array_equal(a, b)
    tck.save_sharded(torch.arange(6.0).reshape(2, 3), f"{d}/arr")
    assert tck.load_sharded(f"{d}/arr").tolist() == [[0, 1, 2], [3, 4, 5]]
    fsspec.filesystem("memory").rm("/marlin_ckpt_port", recursive=True)


# ------------------------------------------------------- damage and recovery
def _save_gens(pkg, d, steps=(1, 2, 3), keep=0):
    for s in steps:
        if pkg == "jax":
            jck.save_checkpoint({"w": jnp.full(4, float(s))}, d, s, keep=keep)
        else:
            tck.save_checkpoint({"w": torch.full((4,), float(s))}, d, s,
                                keep=keep)


@pytest.mark.parametrize("damage", ["crc", "marker", "manifest"])
def test_damage_raises_alike(tmp_path, damage):
    errs = {}
    for pkg, ck in (("jax", jck), ("port", tck)):
        d = str(tmp_path / pkg)
        _save_gens(pkg, d)
        gen = os.path.join(d, "ckpt_00000003")
        if damage == "crc":
            _flip_byte(os.path.join(gen, "state.npz"))
        elif damage == "marker":
            os.remove(os.path.join(gen, "COMMITTED"))
        else:
            with open(os.path.join(gen, "integrity_0.json"), "w") as f:
                f.write("{not json")
        errs[pkg] = []
        for step in (1, 2, 3):
            try:
                ck.verify_generation(d, step)
                errs[pkg].append(None)
            except ck.CheckpointCorruptError as e:
                errs[pkg].append(str(e).split(": ", 1)[1][:20])
        errs[pkg].append(tuple(ck.list_generations(d)))
    assert errs["port"] == errs["jax"]
    assert errs["port"][2] is not None and errs["port"][0] is None


def test_retention_and_prune_alike(tmp_path):
    for pkg, ck in (("jax", jck), ("port", tck)):
        d = str(tmp_path / pkg)
        _save_gens(pkg, d, steps=(1, 2, 3, 4), keep=2)
        os.makedirs(os.path.join(d, "ckpt_00000001.tmp"))  # crash debris
        assert ck.list_generations(d) == [3, 4]
        assert ck.prune_generations(d, 1) == [3]
        assert sorted(os.listdir(d)) == ["ckpt_00000004", "latest"]


def _contract(state, i, lib):
    """Deterministic contraction toward 1.0 (the JAX suite's step)."""
    w = state["w"] - 0.25 * (state["w"] - 1.0)
    loss = ((w - 1.0) ** 2).sum()
    return {"w": w}, float(loss)


def _loop_events(pkg, d, scenario, tmp_path):
    """(metrics, [(kind, step)]) of one ResilientLoop run under ``scenario``
    in package ``pkg``."""
    fail, faults, Log = ((jfail, jfaults, JLog) if pkg == "jax"
                         else (tfail, tfaults, TLog))
    w0 = (jnp.zeros(4, jnp.float32) if pkg == "jax"
          else torch.zeros(4))
    log = Log(str(tmp_path / f"{pkg}-{scenario}.jsonl"))
    loop = fail.ResilientLoop(lambda s, i: _contract(s, i, pkg), d,
                              checkpoint_every=2, event_log=log)
    if scenario == "crash":
        fault = faults.RaiseFault(RuntimeError("device lost"),
                                  schedule=faults.Schedule(fire_on=[3]))
        with faults.injected("step.run", fault):
            _, metrics = loop.run({"w": w0}, 6)
    elif scenario == "nan":
        with faults.injected("step.run", faults.MutateFault(float("nan"))):
            _, metrics = loop.run({"w": w0}, 6)
    elif scenario == "save":
        with faults.injected("ckpt.write",
                             faults.RaiseFault(OSError("disk full"),
                                               match="ckpt_00000004")):
            _, metrics = loop.run({"w": w0}, 6)
    else:  # corrupt the newest generation, then restart the process
        loop.run({"w": w0}, 4)
        _flip_byte(os.path.join(d, "ckpt_00000004", "state.npz"))
        loop = fail.ResilientLoop(lambda s, i: _contract(s, i, pkg), d,
                                  checkpoint_every=2, event_log=log)
        _, metrics = loop.run({"w": w0}, 8)
    events = [(e["kind"], e["step"]) for e in log.read()
              if e["kind"] in ("resume", "resume_skip", "step_failure")]
    return metrics, events


@pytest.mark.parametrize("scenario", ["crash", "nan", "save", "corrupt"])
def test_resilient_loop_events_match_jax(tmp_path, scenario):
    out = {pkg: _loop_events(pkg, str(tmp_path / pkg), scenario, tmp_path)
           for pkg in ("jax", "port")}
    (mj, ej), (mt_, et) = out["jax"], out["port"]
    assert et == ej and et
    assert len(mt_) == len(mj)
    np.testing.assert_allclose(mt_, mj, rtol=1e-6)


def test_resilient_loop_budget_exhaustion_reraises(tmp_path):
    with tfaults.injected("step.run", tfaults.RaiseFault(
            RuntimeError("always"), times=-1)):
        loop = tfail.ResilientLoop(lambda s, i: _contract(s, i, "port"),
                                   str(tmp_path), max_retries=2)
        with pytest.raises(RuntimeError, match="always"):
            loop.run({"w": torch.zeros(4)}, 3)
    assert loop.retries == 3


def test_heartbeat(tmp_path):
    out = tfail.heartbeat(timeout_s=5.0)
    assert list(out) == ["cpu"] and np.isfinite(out["cpu"])
    with tfaults.injected("device.probe",
                          tfaults.RaiseFault(RuntimeError("dead card"))):
        with pytest.raises(TimeoutError, match="1/1 device heartbeats") as e:
            tfail.heartbeat(timeout_s=5.0)
    assert e.value.results["cpu"] == float("inf")
    assert "dead card" in repr(e.value.results.errors["cpu"])


# ------------------------------------------------------ the trainers resumed
def test_lm_train_resumed_equals_uninterrupted(tmp_path, lm_params):
    """3 steps straight, against 2 steps, a failed third save, and a resume
    from generation 2 — then again with generation 3 corrupt, which falls
    back to generation 2: the same losses and params bit for bit."""
    _, tp = lm_params
    lm = tt.TransformerLM(**LM_KW)
    want_p, want_l = lm.train(TOKS, steps=3, params=tp)
    d = str(tmp_path)
    with tfaults.injected("ckpt.write", tfaults.RaiseFault(
            match="ckpt_00000003")):
        with pytest.raises(tfaults.FaultInjected):
            lm.train(TOKS, steps=3, params=tp, checkpoint_dir=d,
                     checkpoint_every=1)
    assert tck.list_generations(d) == [1, 2]
    for attempt in ("resume", "fall back"):
        got_p, got_l = lm.train(TOKS, steps=3, params=tp, checkpoint_dir=d,
                                checkpoint_every=1, resume=True)
        assert got_l == want_l[2:], attempt
        for a, b in zip(_flat_np(got_p), _flat_np(want_p)):
            assert np.array_equal(a, b), attempt
        _flip_byte(os.path.join(d, "ckpt_00000003", "state.npz"))


@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
def test_nn_train_resumed_equals_uninterrupted(tmp_path, optimizer):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((128, 16)).astype(np.float32)
    y = rng.integers(0, 4, 128).astype(np.int32)
    nn = tnn.NeuralNetwork(16, 8, 4, optimizer=optimizer,
                           learning_rate=0.1 if optimizer == "sgd" else 0.01)
    want_p, want_l = nn.train(x, y, iterations=5, batch_size=32)
    d = str(tmp_path)
    _, first = nn.train(x, y, iterations=3, batch_size=32, checkpoint_dir=d,
                        checkpoint_every=1)
    assert first == want_l[:3] and tck.list_generations(d) == [1, 2, 3]
    got_p, got_l = nn.train(x, y, iterations=5, batch_size=32,
                            checkpoint_dir=d, checkpoint_every=1,
                            resume=True)
    assert got_l == want_l[3:]
    for k in want_p:
        assert torch.equal(got_p[k], want_p[k])
    # the JAX package reads the port's sgd generation (params alone)
    if optimizer == "sgd":
        jp = jax.tree.map(jnp.asarray,
                          {k: v.numpy() for k, v in want_p.items()})
        got, step = jck.load_checkpoint(jp, d)
        assert step == 5
        for k in want_p:
            assert np.array_equal(np.asarray(got[k]), want_p[k].numpy())


# --------------------------------------------------------------- orbax / DCP
def test_orbax_checkpointer_round_trip_and_retention(tmp_path):
    s = {"params": {"w": torch.randn(3, 4), "b": torch.randn(4)},
         "opt_state": tt.AdamState(3, {"w": torch.ones(3, 4)},
                                   {"w": torch.zeros(3, 4)})}
    with OrbaxCheckpointer(str(tmp_path), max_to_keep=2) as ck:
        for step in (1, 2, 3):
            ck.save({"params": {k: v * step for k, v in s["params"].items()},
                     "opt_state": s["opt_state"]}, step)
        ck.wait()
        assert ck.all_steps() == [2, 3] and ck.latest_step() == 3
        tmpl = {"params": {k: torch.zeros_like(v)
                           for k, v in s["params"].items()},
                "opt_state": tt.AdamState(0, {"w": torch.zeros(3, 4)},
                                          {"w": torch.zeros(3, 4)})}
        got, step = ck.restore(tmpl)
        assert step == 3 and got["opt_state"].count == 3
        assert torch.equal(got["params"]["w"], s["params"]["w"] * 3)
        got2, _ = ck.restore(tmpl, step=2)
        assert torch.equal(got2["params"]["b"], s["params"]["b"] * 2)
    assert not any(n.endswith(".tmp") for n in os.listdir(tmp_path))


def test_orbax_checkpointer_missing_and_fault(tmp_path):
    ck = OrbaxCheckpointer(str(tmp_path / "empty"), async_save=False)
    with pytest.raises(FileNotFoundError):
        ck.restore({"w": torch.zeros(2)})
    with tfaults.injected("ckpt.write", tfaults.RaiseFault()):
        with pytest.raises(tfaults.FaultInjected):
            ck.save({"w": torch.ones(2)}, 1)
    ck.save({"w": torch.ones(2)}, 1)
    assert ck.restore({"w": torch.zeros(2)})[0]["w"].tolist() == [1.0, 1.0]
    ck.close()
