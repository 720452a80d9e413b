"""The port's example CLIs (``marlin_tpu_torch/examples/``) against the JAX
package's (``examples/``), on the CPU.

Each test runs both ``main``s with the arguments ``tests/test_examples.py``
uses. The JAX CLIs run on a one-device mesh, the port's world: the
``world1`` fixture makes ``marlin_tpu.create_mesh()`` with no shape (the
CLIs' call) and the JAX default mesh a (1, 1) mesh over the first CPU
device, and its dense ``random`` factories (``DenseVecMatrix``,
``BlockMatrix``, ``DistributedVector``) return the port's draws for the same
seed: the port draws dense matrices from a ``torch.Generator``, not JAX's
threefry (``marlin_tpu_torch/random.py``), so both CLIs get the same
operands. Likewise the LM CLIs' models start from the JAX package's
initial params (``jax_init``: the port's ``TransformerLM.init_params`` draws
its own). ``SparseVecMatrix.random``, the MLP's init and the numpy draws
are the same in both packages as they stand. The port's CLIs run under
``config_context(device="cpu")``.

Where a CLI returns a value it is compared; where it returns nothing, the
numbers it prints or writes, and the value its library call returned,
caught by wrapping that call (``_Spy``) without changing it.

Tolerances:

- products (``matrix_multiply``'s C, ``blas1``'s dot, ``blas3``'s sums, the
  sparse modes' results, LU's L and U): ``PROD_TOL`` (1e-5) of the largest
  |entry| of the JAX result;
- the trainers' losses (``long_context_training``, ``distributed_training``),
  logistic regression's weights and attention's outputs: ``TRAIN_TOL``
  (1e-4) relative, as ``tests/test_torch_train.py`` states; the MLP's
  losses and weights ``MLP_TOL`` (1e-5) as ``tests/test_torch_ml.py``;
- ALS's RMSE ``ALS_TOL`` (2e-4) and PageRank's ranks ``PR_TOL`` (1e-6), as
  ``tests/test_torch_ml.py``;
- greedy tokens, nnz counts, permutations, table keys: exact.
"""

import importlib
import json
import os
import re
import shutil
import subprocess

import numpy as np
import pytest

import jax

import marlin_tpu as jm
import marlin_tpu_torch as tm
from marlin_tpu import mesh as jmesh

PROD_TOL = 1e-5
TRAIN_TOL = 1e-4
MLP_TOL = 1e-5
ALS_TOL = 2e-4
PR_TOL = 1e-6

# the gate tests/test_examples.py puts on the JAX CLIs that need the
# top-level jax.shard_map / jax.typeof era
modern_jax = (getattr(jax, "shard_map", None) is not None
              and hasattr(jax, "typeof"))


def _cli(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}").main


def jcli(name):
    return _cli("examples", name)


def tcli(name):
    return _cli("marlin_tpu_torch.examples", name)


@pytest.fixture(autouse=True)
def _cpu():
    with tm.config_context(device="cpu", autotune_cache_path=""):
        yield


@pytest.fixture
def world1(monkeypatch):
    one = jm.create_mesh((1, 1), devices=jax.devices()[:1])
    create = jm.create_mesh

    def create_mesh(shape=None, *args, **kwargs):
        if shape is None and not args and not kwargs:
            return one
        return create(shape, *args, **kwargs)

    monkeypatch.setattr(jm, "create_mesh", create_mesh)
    for name in ("DenseVecMatrix", "BlockMatrix"):
        def random(cls, seed, rows, cols, dist="uniform", mesh=None, spec=None,
                   dtype=None, _port=getattr(tm, name), **kwargs):
            arr = _port.random(seed, rows, cols, dist, **kwargs).to_numpy()
            return cls.from_array(arr, mesh, spec, dtype)

        monkeypatch.setattr(getattr(jm, name), "random", classmethod(random))

    def vector(cls, seed, length, dist="uniform", mesh=None,
               column_major=True, dtype=None, **kwargs):
        arr = tm.DistributedVector.random(seed, length, dist,
                                          **kwargs).to_numpy()
        return cls.from_array(arr, mesh, column_major, dtype)

    monkeypatch.setattr(jm.DistributedVector, "random", classmethod(vector))
    prev = jmesh._default_mesh
    jmesh.set_default_mesh(one)
    yield one
    jmesh.set_default_mesh(prev)


@pytest.fixture
def jax_init(monkeypatch):
    from marlin_tpu.models import TransformerLM as JaxLM
    from marlin_tpu_torch import interop
    from marlin_tpu_torch.models import TransformerLM as TorchLM

    def init_params(self, dtype=None, device=None):
        ref = JaxLM(vocab=self.vocab, d_model=self.d_model, heads=self.heads,
                    layers=self.layers, d_ff=self.d_ff, seed=self.seed,
                    kv_heads=self.kv_heads).init_params()
        return interop.lm_params_from_numpy(jax.tree.map(np.asarray, ref),
                                            device=device, dtype=dtype)

    monkeypatch.setattr(TorchLM, "init_params", init_params)


class _Spy:
    """Wrap ``owner.name`` so every call's return value is kept."""

    def __init__(self, monkeypatch, owner, name):
        self.values = []
        orig = getattr(owner, name)

        def wrapper(*args, **kwargs):
            out = orig(*args, **kwargs)
            self.values.append(out)
            return out

        monkeypatch.setattr(owner, name, wrapper)


def _run(main, args, capsys):
    """(return value, stdout lines) of one CLI run."""
    capsys.readouterr()
    value = main(list(args))
    return value, capsys.readouterr().out.splitlines()


def _nums(line: str) -> list[float]:
    return [float(x) for x in re.findall(r"-?\d+\.?\d*(?:e-?\d+)?", line)]


def _without_times(lines):
    """The printed lines with every millis, rate and speed-up figure masked
    (the only numbers that differ between runs)."""
    pat = re.compile(r"-?\d+\.?\d*(?= ?(millis|ms|GFLOP/s|k tok/s|tok/s|x\)))")
    return [pat.sub("T", ln) for ln in lines]


def _close(got, want, tol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30) if want.size else 1.0
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= tol * scale, f"{what}: {err:.3e} > {tol} * {scale:.3e}"


def _np(x):
    if hasattr(x, "to_numpy"):
        return x.to_numpy()
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


# ------------------------------------------------------------- the products


def test_matrix_multiply_cli(world1, capsys):
    jc, jout = _run(jcli("matrix_multiply"), ["64", "48", "32", "8"], capsys)
    tc, tout = _run(tcli("matrix_multiply"), ["64", "48", "32", "8"], capsys)
    assert type(tc).__name__ == type(jc).__name__ == "DenseVecMatrix"
    assert tc.shape == jc.shape == (64, 32)
    _close(tc.to_numpy(), jc.to_numpy(), PROD_TOL, "C")
    assert _without_times(tout) == _without_times(jout)
    assert "used time" in tout[0] and "GFLOP/s" in tout[1]


def test_matrix_multiply_cli_files(world1, tmp_path, capsys):
    a = np.random.default_rng(0).random((12, 12)).astype(np.float32)
    b = np.random.default_rng(1).random((12, 12)).astype(np.float32)
    pa, pb = str(tmp_path / "a.txt"), str(tmp_path / "b.txt")
    jm.DenseVecMatrix.from_array(a, world1).save_to_file_system(pa)
    jm.DenseVecMatrix.from_array(b, world1).save_to_file_system(pb)
    jc, _ = _run(jcli("matrix_multiply"), ["--files", pa, pb], capsys)
    tc, _ = _run(tcli("matrix_multiply"), ["--files", pa, pb], capsys)
    _close(tc.to_numpy(), jc.to_numpy(), PROD_TOL, "C from files")
    _close(tc.to_numpy(), a.astype(np.float64) @ b, PROD_TOL, "C vs f64")


@pytest.mark.parametrize("args", [[], ["1", "2"], ["--files", "a"]])
def test_matrix_multiply_cli_usage(args, capsys):
    """The same refusal, to stderr, exit code 1."""
    for main in (jcli("matrix_multiply"), tcli("matrix_multiply")):
        with pytest.raises(SystemExit) as e:
            main(list(args))
        assert e.value.code == 1
    err = capsys.readouterr().err.splitlines()
    half = len(err) // 2
    assert err[:half] == err[half:] and err[0]


@pytest.mark.parametrize("mode", ["local", "dist"])
def test_blas1_cli(world1, capsys, mode):
    jr, jout = _run(jcli("blas1"), [mode, "100", "4"], capsys)
    tr, tout = _run(tcli("blas1"), [mode, "100", "4"], capsys)
    assert isinstance(tr, float)
    _close(tr, jr, PROD_TOL, "inner product")
    assert "inner product" in tout[0]
    _close(_nums(tout[0])[-1], _nums(jout[0])[-1], PROD_TOL, "printed")


@pytest.mark.parametrize("mode", ["1", "2", "3"])
def test_blas3_cli(world1, monkeypatch, capsys, mode):
    """Modes 1-3 with the CARMA split: the printed sum (mode 1) and the
    evaluated product (modes 2-3, caught at ``evaluate``) agree."""
    jspy = _Spy(monkeypatch, jm, "evaluate")
    tspy = _Spy(monkeypatch, tm, "evaluate")
    _, jout = _run(jcli("blas3"), ["32", "32", "32", mode], capsys)
    _, tout = _run(tcli("blas3"), ["32", "32", "32", mode], capsys)
    assert _without_times(tout) == _without_times(jout) or mode == "1"
    if mode == "1":
        assert tout[0].startswith("local multiply used")
        _close(_nums(tout[0])[-1], _nums(jout[0])[-1], PROD_TOL, "sum")
    else:
        _close(_np(tspy.values[-1]), _np(jspy.values[-1]), PROD_TOL, "C")


def test_blas3_cli_split_must_fill_the_world(world1):
    """``2 2 2`` needs 8 devices: at world size 1 the port raises the
    ValueError the JAX package's build_rmm_mesh raises with one device."""
    from marlin_tpu.parallel.matmul import build_rmm_mesh

    with pytest.raises(ValueError) as want:
        build_rmm_mesh((2, 2, 2), jax.devices()[:1])
    with pytest.raises(ValueError) as got:
        tcli("blas3")(["32", "32", "32", "3", "2", "2", "2"])
    assert str(got.value) == str(want.value)


def test_rmm_compare_cli(world1, capsys):
    jt, jout = _run(jcli("rmm_compare"), ["48", "48", "48", "all"], capsys)
    tt, tout = _run(tcli("rmm_compare"), ["48", "48", "48", "all"], capsys)
    assert set(tt) == set(jt) == {"rmm", "gspmd", "broadcast"}
    assert [ln.split(":")[0] for ln in tout] == \
        [ln.split(":")[0] for ln in jout]
    assert tout[-1].startswith("fastest:")


def test_rmm_compare_tuned_mode(world1, capsys):
    """``tuned`` times the same candidates as the JAX tuner and lands one
    ``multiply`` row per timed strategy with flops 2mkn."""
    from marlin_tpu_torch.obs import perf

    perf.get_program_costs().reset()
    jt, _ = _run(jcli("rmm_compare"), ["48", "32", "24", "tuned"], capsys)
    tt, tout = _run(tcli("rmm_compare"), ["48", "32", "24", "tuned"], capsys)
    assert set(tt) == set(jt) and len(tt) >= 2
    assert tout[-1].startswith("fastest:")
    rows = [r for r in perf.get_program_costs().rows()
            if r["program"] == "multiply"]
    assert {r["key"].split()[0].split("=")[1] for r in rows} == set(tt)
    for r in rows:
        assert r["flops"] == 2.0 * 48 * 32 * 24 and r["calls"] >= 1
        assert "shape=48x32x24 dtype=float32 prec=config devices=1" in r["key"]


@pytest.mark.parametrize("mode", list("1234567"))
def test_sparse_multiply_cli(world1, monkeypatch, capsys, mode):
    """Modes 1 and 3 print the sparse product's nnz; the others' product is
    caught at ``evaluate`` (mode 5 is the port's ``mult_dense_sparse``,
    mode 7 the BSR path its tuner picks)."""
    jspy = _Spy(monkeypatch, jm, "evaluate")
    tspy = _Spy(monkeypatch, tm, "evaluate")
    args = ["32", "32", "32", "0.1", mode]
    jr, jout = _run(jcli("sparse_multiply"), args, capsys)
    tr, tout = _run(tcli("sparse_multiply"), args, capsys)
    assert jr is None and tr is None
    assert _without_times(tout) == _without_times(jout)
    if mode in "13":
        assert "nnz" in tout[0]
    else:
        _close(_np(tspy.values[-1]), _np(jspy.values[-1]), PROD_TOL,
               f"mode {mode}")
    if mode == "7":
        assert "nnzb 1, block density 1.000" in tout[0]


def test_lu_decompose_cli(world1, tmp_path, capsys):
    n = 12
    a = np.random.default_rng(0).random((n, n)).astype(np.float32) \
        + n * np.eye(n, dtype=np.float32)
    p = str(tmp_path / "a.txt")
    jm.DenseVecMatrix.from_array(a, world1).save_to_file_system(p)
    _, jout = _run(jcli("lu_decompose"),
                   [p, str(n), str(n), str(tmp_path / "j")], capsys)
    _, tout = _run(tcli("lu_decompose"),
                   [p, str(n), str(n), str(tmp_path / "t")], capsys)
    assert tout[0].startswith("LU used") and tout[1].startswith("saved")
    perms = [open(str(tmp_path / f"{w}.perm")).read() for w in "jt"]
    assert perms[0] == perms[1]
    perm = [int(x) for x in perms[1].split(",")]
    for part in ("L", "U"):
        want = jm.load_matrix_file(str(tmp_path / f"j.{part}"),
                                   world1).to_numpy()
        got = tm.load_matrix_file(str(tmp_path / f"t.{part}")).to_numpy()
        _close(got, want, PROD_TOL, part)
    lo = tm.load_matrix_file(str(tmp_path / "t.L")).to_numpy()
    up = tm.load_matrix_file(str(tmp_path / "t.U")).to_numpy()
    _close(lo.astype(np.float64) @ up, a[perm], PROD_TOL, "A[perm] - LU")


# --------------------------------------------------------------------- ml


def test_logistic_regression_cli(world1, monkeypatch, capsys):
    import marlin_tpu.ml as jml
    import marlin_tpu_torch.ml as tml

    jspy = _Spy(monkeypatch, jml, "logistic_regression")
    tspy = _Spy(monkeypatch, tml, "logistic_regression")
    args = ["50", "10.0", "500", "10"]
    _, jout = _run(jcli("logistic_regression"), args, capsys)
    _, tout = _run(tcli("logistic_regression"), args, capsys)
    _close(tspy.values[0].weights, jspy.values[0].weights, TRAIN_TOL,
           "weights")
    assert tout[0].split(",")[1] == jout[0].split(",")[1]  # accuracy


@pytest.mark.parametrize("source", ["file", "random"])
def test_pagerank_cli(world1, tmp_path, monkeypatch, capsys, source):
    import marlin_tpu.ml as jml
    import marlin_tpu_torch.ml as tml

    if source == "file":
        p = tmp_path / "edges.txt"
        p.write_text("0 1\n1 2\n2 0\n2 1\n")
        args = [str(p), "30"]
    else:
        args = ["random", "30", "40"]
    jspy = _Spy(monkeypatch, jml, "pagerank")
    tspy = _Spy(monkeypatch, tml, "pagerank")
    _, jout = _run(jcli("pagerank"), args, capsys)
    _, tout = _run(tcli("pagerank"), args, capsys)
    _close(tspy.values[0], jspy.values[0], PR_TOL, "ranks")
    jtop = [_nums(ln) for ln in jout if ln.startswith("node")]
    ttop = [_nums(ln) for ln in tout if ln.startswith("node")]
    assert len(ttop) == len(jtop) == min(10, len(jspy.values[0]))
    _close([r for _, r in ttop], [r for _, r in jtop], PR_TOL, "top ten")
    # the top ten's nodes, where their ranks are not tied
    ranks = jspy.values[0]
    for (tn, _), (jn, jr) in zip(ttop, jtop):
        if np.sum(np.abs(ranks - ranks[int(jn)]) <= PR_TOL) == 1:
            assert tn == jn


def test_als_cli(world1, tmp_path, monkeypatch, capsys):
    rng = np.random.default_rng(0)
    lines = [f"{u} {i} {rng.random() * 5:.3f}" for u in range(20)
             for i in range(10) if rng.random() < 0.5]
    p = tmp_path / "ratings.txt"
    p.write_text("\n".join(lines))
    _, jout = _run(jcli("als"), [str(p), "3", "5", "0.1"], capsys)
    _, tout = _run(tcli("als"), [str(p), "3", "5", "0.1"], capsys)
    assert tout[0] == jout[0]  # loaded N ratings, shape
    assert "train RMSE" in tout[1]
    _close(_nums(tout[1])[-1], _nums(jout[1])[-1], ALS_TOL, "RMSE")


def test_neural_network_cli(world1, tmp_path, monkeypatch, capsys):
    """Losses, accuracy and the saved weights. Both CLIs' weight files go
    under ``tmp_path``: the JAX CLI's fixed path is also written by
    ``tests/test_examples.py``, which may run beside this file."""
    import marlin_tpu.ml as jml
    import marlin_tpu_torch.ml as tml
    from marlin_tpu_torch.examples import neural_network as tnn_cli

    jw, tw = str(tmp_path / "jax_w"), str(tmp_path / "torch_w")
    save = jml.NeuralNetwork.save_weights
    monkeypatch.setattr(jml.NeuralNetwork, "save_weights",
                        lambda self, params, path: save(self, params, jw))
    monkeypatch.setattr(tnn_cli, "WEIGHTS", tw)
    jspy = _Spy(monkeypatch, jml.NeuralNetwork, "train")
    tspy = _Spy(monkeypatch, tml.NeuralNetwork, "train")
    args = ["synthetic", "-", "30", "16", "1.0", "128"]
    _, jout = _run(jcli("neural_network"), args, capsys)
    _, tout = _run(tcli("neural_network"), args, capsys)
    _close(tspy.values[0][1], jspy.values[0][1], MLP_TOL, "losses")
    assert tout[-2].split(",")[1:] == jout[-2].split(",")[1:]
    assert tout[-1] == f"weights saved to {tw}.*.csv"
    for name in ("w0", "w1"):
        _close(np.loadtxt(f"{tw}.{name}.csv", delimiter=","),
               np.loadtxt(f"{jw}.{name}.csv", delimiter=","), MLP_TOL, name)


def test_neural_network_cli_weights_path():
    """The port's CLI writes apart from the JAX CLI's fixed path."""
    from marlin_tpu_torch.examples import neural_network as tnn_cli

    assert tnn_cli.WEIGHTS == "/tmp/marlin_tpu_torch_nn_weights"


# ------------------------------------------------------ attention and the LM


@pytest.mark.parametrize("strategy", ["ring", "ulysses"])
def test_attention_cli(world1, monkeypatch, capsys, strategy):
    name = f"{strategy}_attention"
    jspy = _Spy(monkeypatch, jm, name)
    tspy = _Spy(monkeypatch, tm, name)
    args = ["64", "16", "1", "4", strategy]
    _, jout = _run(jcli("attention"), args, capsys)
    _, tout = _run(tcli("attention"), args, capsys)
    assert len(tspy.values) == len(jspy.values) == 2
    _close(_np(tspy.values[-1]), _np(jspy.values[-1]), TRAIN_TOL, "out")
    assert _without_times(tout) == _without_times(jout)
    assert strategy in tout[0] and "GFLOP/s" in tout[0]


@pytest.mark.skipif(not modern_jax, reason="the JAX CLI needs modern jax")
@pytest.mark.parametrize("args", [
    ["128", "6", "32", "4", "1"],
    # remat + chunked head, chunk ∤ seq - 1 (tests/test_examples.py's
    # second case)
    ["128", "6", "32", "4", "1", "ring", "1", "48"],
    ["128", "3", "32", "4", "1", "ulysses"],
])
def test_long_context_training_cli(world1, jax_init, capsys, args):
    jl, jout = _run(jcli("long_context_training"), args, capsys)
    tl, tout = _run(tcli("long_context_training"), args, capsys)
    _close(tl, jl, TRAIN_TOL, "losses")
    assert tl[-1] < tl[0]
    assert _without_times(tout)[0].split(":")[0] == \
        _without_times(jout)[0].split(":")[0]
    assert tout[-1] == jout[-1]  # greedy continuation matches n/16


def test_long_context_training_cli_plan_refused():
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 12"):
        tcli("long_context_training")(["128", "2", "32", "4", "1", "ring",
                                       "plan"])


@pytest.mark.skipif(not modern_jax, reason="the JAX CLI needs modern jax")
def test_decode_serving_cli(world1, jax_init, capsys):
    """The rows against the JAX CLI's; each CLI also asserts its greedy rows
    against its own one-row path (``generate``)."""
    args = ["3", "12", "4", "32", "2", "1"]
    jo, jout = _run(jcli("decode_serving"), args, capsys)
    to, tout = _run(tcli("decode_serving"), args, capsys)
    assert len(to) == len(jo) == 3
    assert [np.asarray(r).tolist() for r in to] == \
        [np.asarray(r).tolist() for r in jo]
    assert tout[0].split(";")[0] == jout[0].split(";")[0]  # loss a -> b
    assert "batched" in tout[0] and "one-at-a-time" in tout[0]


def test_distributed_training_cli(world1, tmp_path, capsys):
    """The step losses the EventLog holds and the printed accuracy. The
    JAX CLI meshes all eight CPU devices (``best_grid(8)``), the port its
    one (``best_grid(1)``)."""
    runs = {}
    for pkg, main in (("jax", jcli("distributed_training")),
                      ("torch", tcli("distributed_training"))):
        d = tmp_path / pkg
        _, out = _run(main, ["60", "16", "64", str(d)], capsys)
        with open(d / "events.jsonl") as f:
            losses = [json.loads(ln)["loss"] for ln in f
                      if '"kind": "step"' in ln or '"kind":"step"' in ln]
        runs[pkg] = (out, losses)
    (jout, jl), (tout, tl) = runs["jax"], runs["torch"]
    assert tout[0] == "mesh: 1 data-parallel x 1 tensor-parallel over 1 devices"
    assert len(tl) == len(jl) == 60
    _close(tl, jl, TRAIN_TOL, "losses")
    assert tout[1].split("accuracy")[1] == jout[1].split("accuracy")[1]


def test_cli_refuses_without_a_card():
    """Entry points run on the configured device: asked for ``cuda`` on a
    host without one they raise, as resolve_device does."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with tm.config_context(device="cuda"):
        with pytest.raises(RuntimeError, match="torch.cuda is not available"):
            tcli("matrix_multiply")(["8", "8", "8", "1"])


# ----------------------------------------------------------------- genmat


@pytest.mark.skipif(shutil.which("g++") is None, reason="no C++ toolchain")
def test_genmat_tool_through_the_port(tmp_path, world1):
    """``tools/genmat.cpp`` compiled into ``tmp_path`` (its Makefile's
    flags; ``make`` is not run in ``tools/``); its output loads through the
    port's ``load_matrix_file`` to the JAX package's values."""
    src = os.path.join(os.path.dirname(__file__), "..", "tools", "genmat.cpp")
    exe = str(tmp_path / "genmat")
    build = subprocess.run(["g++", "-O2", "-std=c++17", "-Wall", "-o", exe,
                            src], capture_output=True, text=True)
    assert build.returncode == 0, build.stderr
    out = subprocess.run([exe, "5", "4", "7"], capture_output=True, text=True)
    assert out.returncode == 0
    path = tmp_path / "gen.txt"
    path.write_text(out.stdout)
    got = tm.load_matrix_file(str(path)).to_numpy()
    want = jm.load_matrix_file(str(path), world1).to_numpy()
    assert got.shape == (5, 4)
    np.testing.assert_array_equal(got, want)
    assert (got >= 0).all() and (got < 5).all()
