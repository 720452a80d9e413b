"""Dense matrices of marlin_tpu_torch against the JAX package.

The same numpy arrays (made from a seed) become JAX matrices through
``from_array`` on the 8-device CPU test mesh, and port matrices through
``interop.matrices_from_numpy`` on the CPU. Every result is compared with
rtol/atol 1e-4 (f32, as in tests/test_pallas.py) unless a test states
otherwise.
"""

import numpy as np
import pytest
import torch

import marlin_tpu as mt
import marlin_tpu_torch as mtt
from marlin_tpu.parallel.matmul import _STRATEGIES
from marlin_tpu_torch import config as tconfig
from marlin_tpu_torch import interop, random as trandom
from marlin_tpu_torch.ops import local as tlocal
from marlin_tpu_torch.parallel import autotune
from marlin_tpu_torch.parallel.matmul import UnknownStrategyError

TOL = 1e-4


@pytest.fixture(autouse=True)
def _cpu(tmp_path):
    with mtt.config_context(device="cpu",
                            autotune_cache_path=str(tmp_path / "at.json")):
        autotune.clear_cache()
        yield
        autotune.clear_cache()


@pytest.fixture
def arrays():
    rng = np.random.default_rng(42)
    return {
        "a": rng.standard_normal((37, 29)).astype(np.float32),
        "b": rng.standard_normal((29, 23)).astype(np.float32),
        "c": rng.standard_normal((37, 29)).astype(np.float32) + 3.0,
        "v": rng.standard_normal(29).astype(np.float32),
    }


def _pair(arrays, name, kind="DenseVecMatrix"):
    jm = getattr(mt, kind).from_array(arrays[name])
    tm = interop.matrices_from_numpy({name: arrays[name]}, kind=kind)[name]
    return jm, tm


def close(got, want, tol=TOL):
    got = got.to_numpy() if hasattr(got, "to_numpy") else np.asarray(got)
    want = want.to_numpy() if hasattr(want, "to_numpy") else np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


# ------------------------------------------------------------- building


@pytest.mark.parametrize("kind", ["DenseVecMatrix", "BlockMatrix"])
def test_interop_builds_the_same_matrices(arrays, kind):
    jm, tm = _pair(arrays, "a", kind)
    assert type(tm).__name__ == kind and tm.shape == jm.shape
    assert tm.device == torch.device("cpu") and tm.dtype == torch.float32
    np.testing.assert_array_equal(tm.to_numpy(), jm.to_numpy())


def test_interop_keeps_bf16_and_checks_rank(arrays):
    import ml_dtypes

    x = arrays["a"].astype(ml_dtypes.bfloat16)
    tm = interop.matrices_from_numpy({"x": x})["x"]
    assert tm.dtype == torch.bfloat16
    np.testing.assert_array_equal(tm.to_numpy(), x.astype(np.float32))
    vec = interop.matrices_from_numpy({"v": arrays["v"]},
                                      kind="DistributedVector")["v"]
    np.testing.assert_array_equal(vec.to_numpy(), arrays["v"])
    with pytest.raises(ValueError):
        interop.matrices_from_numpy({"v": arrays["v"]})
    with pytest.raises(ValueError):
        interop.matrices_from_numpy({"a": arrays["a"]}, kind="Sparse")


# -------------------------------------------------------------- multiply


@pytest.mark.parametrize("strategy", list(_STRATEGIES) + ["tuned"])
def test_multiply_each_strategy_matches_jax(arrays, strategy):
    ja, ta = _pair(arrays, "a")
    jb, tb = _pair(arrays, "b")
    want = ja.multiply(jb)  # the JAX package's adaptive multiply
    got = ta.multiply(tb, strategy=strategy)
    assert got.shape == (37, 23)
    close(got, want)


def test_multiply_error_cases(arrays):
    _, ta = _pair(arrays, "a")
    with pytest.raises(UnknownStrategyError):
        ta.multiply(ta.transpose(), strategy="carrier-pigeon")
    with pytest.raises(ValueError, match="inner dim"):
        ta.multiply(ta)
    # an explicit RMM split needs devices the world of one does not have
    with pytest.raises(ValueError, match="needs 8 devices"):
        ta.multiply(ta.transpose(), strategy="rmm", split=(2, 2, 2))


def test_multiply_scalar_vector_and_array(arrays):
    ja, ta = _pair(arrays, "a")
    close(ta.multiply(2.5), ja.multiply(2.5))
    close(ta.multiply(arrays["v"]), ja.multiply(arrays["v"]))
    close(ta.multiply(arrays["b"]), ja.multiply(arrays["b"]))
    close(ta @ ta.transpose(), ja @ ja.transpose())


def test_multiply_vector_gramian_and_multiply_by(arrays):
    ja, ta = _pair(arrays, "a")
    jv = mt.DistributedVector.from_array(arrays["v"])
    tv = mtt.DistributedVector.from_array(arrays["v"])
    close(ta.multiply_vector(tv), ja.multiply_vector(jv))
    close(ta.gramian(), ja.gramian())
    close(ta.multiply_gramian_by(tv), ja.multiply_gramian_by(jv))
    left = arrays["c"].T  # (29, 37) @ (37, 29)
    close(ta.multiply_by(left), ja.multiply_by(left))
    close(ta.multiply_broadcast(ta.transpose()),
          ja.multiply_broadcast(ja.transpose()))


# ----------------------------------------------------- reductions, norms


@pytest.mark.parametrize("mode", ["1", "inf", "fro", "2"])
def test_norm_matches_jax(arrays, mode):
    ja, ta = _pair(arrays, "a")
    got, want = float(ta.norm(mode)), float(ja.norm(mode))
    assert abs(got - want) <= TOL * max(1.0, abs(want))
    with pytest.raises(ValueError):
        ta.norm("nuclear")


def test_sum_and_elementwise_match_jax(arrays):
    ja, ta = _pair(arrays, "a")
    jc, tc = _pair(arrays, "c")
    assert abs(float(ta.sum()) - float(ja.sum())) <= TOL * 37 * 29
    close(ta.add(tc), ja.add(jc))
    close(ta - tc, ja - jc)
    close(ta.divide(tc), ja.divide(jc))
    close(ta.dot_product(tc), ja.dot_product(jc))
    close(ta.subtract_by(2.0), ja.subtract_by(2.0))
    close(tc.divide_by(3.0), jc.divide_by(3.0))
    close(ta.add(arrays["c"]), ja.add(arrays["c"]))


def _padded(x, rows_pad=3, cols_pad=2):
    """A port matrix whose data carries a zero pad beyond its logical
    shape (the layout the JAX package gives a row-sharded matrix)."""
    m, n = x.shape
    data = torch.zeros((m + rows_pad, n + cols_pad))
    data[:m, :n] = torch.from_numpy(x)
    return mtt.DenseVecMatrix(data, (m, n), mtt.create_mesh(), (mtt.ROWS, None))


def test_scalar_ops_keep_the_pad_zero(arrays):
    ja = mt.DenseVecMatrix.from_array(arrays["a"])
    ta = _padded(arrays["a"])
    for op in (lambda m: m.add(1.5), lambda m: m.subtract(2.0),
               lambda m: m.subtract_by(4.0), lambda m: m.divide_by(2.0)):
        got, want = op(ta), op(ja)
        assert torch.count_nonzero(got.data[37:, :]) == 0
        assert torch.count_nonzero(got.data[:, 29:]) == 0
        assert abs(float(got.sum()) - float(want.sum())) <= \
            TOL * abs(float(want.sum()))
        close(got, want)
    # matrix divide: 0/0 in the pad is re-masked
    q = ta.divide(_padded(arrays["c"]))
    assert torch.count_nonzero(q.data[37:, :]) == 0
    assert torch.isfinite(q.data).all()
    close(q, ja.divide(mt.DenseVecMatrix.from_array(arrays["c"])))


def test_padded_matrix_multiplies_and_reduces(arrays):
    ta = _padded(arrays["a"])
    tb = _padded(arrays["b"], 1, 5)
    want = arrays["a"] @ arrays["b"]
    close(ta.multiply(tb), want)
    close(ta.norm("1"), np.abs(arrays["a"]).sum(axis=0).max())
    close(ta.transpose(), arrays["a"].T)


# ----------------------------------------------------------- structure


def test_structure_ops_match_jax(arrays):
    ja, ta = _pair(arrays, "a")
    jc, tc = _pair(arrays, "c")
    close(ta.transpose(), ja.transpose())
    close(ta.c_bind(tc), ja.c_bind(jc))
    close(ta.r_bind(tc), ja.r_bind(jc))
    close(ta.slice_by_row(3, 10), ja.slice_by_row(3, 10))
    close(ta.slice_by_column(0, 28), ja.slice_by_column(0, 28))
    close(ta.get_sub_matrix(2, 5, 7, 9), ja.get_sub_matrix(2, 5, 7, 9))
    close(ta[1:7, ::2], ja[1:7, ::2])
    close(ta[4, :], ja[4, :])
    close(ta.repeat_by_row(3), ja.repeat_by_row(3))
    close(ta.repeat_by_column(2), ja.repeat_by_column(2))
    perm = np.random.default_rng(0).permutation(37)
    close(ta.row_exchange(perm), ja.row_exchange(perm))
    assert isinstance(ta.to_block_matrix(), mtt.BlockMatrix)
    assert isinstance(ta.to_block_matrix().to_dense_vec_matrix(),
                      mtt.DenseVecMatrix)
    close(ta.to_block_matrix(), arrays["a"])


def test_structure_error_cases(arrays):
    _, ta = _pair(arrays, "a")
    with pytest.raises(ValueError):
        ta.slice_by_row(5, 37)
    with pytest.raises(IndexError):
        ta[37, 0]
    with pytest.raises(ValueError):
        ta.c_bind(np.ones((5, 2), np.float32))
    with pytest.raises(ValueError):
        ta.repeat_by_row(0)
    with pytest.raises(ValueError):
        mtt.DenseVecMatrix.from_array(np.ones((0, 3)))


def test_vectors_match_jax(arrays):
    v, w = arrays["v"], arrays["v"][::-1].copy()
    jv, tv = mt.DistributedVector.from_array(v), mtt.DistributedVector.from_array(v)
    jw, tw = mt.DistributedVector.from_array(w), mtt.DistributedVector.from_array(w)
    close(tv.add(tw), jv.add(jw))
    close(tv.subtract(w), jv.subtract(w))
    close(tv.scale(2.0), jv.scale(2.0))
    close(tv.transpose().multiply(tw), jv.transpose().multiply(jw))
    close(tv.multiply(tw.transpose()), jv.multiply(jw.transpose()))
    close(tv.norm(), jv.norm())
    close(tv.sum(), jv.sum())
    assert mtt.DistributedIntVector.from_array([1, 2, 3]).dtype == torch.int32
    with pytest.raises(ValueError):
        tv.multiply(tw)


# -------------------------------------------------------------- random


@pytest.mark.parametrize("dist", ["uniform", "normal", "poisson"])
def test_random_is_deterministic_per_seed(dist):
    a = mtt.DenseVecMatrix.random(7, 50, 40, dist=dist)
    b = mtt.DenseVecMatrix.random(7, 50, 40, dist=dist)
    c = mtt.DenseVecMatrix.random(8, 50, 40, dist=dist)
    assert torch.equal(a.data, b.data)
    assert not torch.equal(a.data, c.data)


def test_random_moments():
    u = mtt.DenseVecMatrix.random(0, 300, 300).data
    assert abs(float(u.mean()) - 0.5) < 0.01 and abs(float(u.var()) - 1 / 12) < 0.005
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0
    g = mtt.DenseVecMatrix.random(1, 300, 300, dist="normal").data
    assert abs(float(g.mean())) < 0.02 and abs(float(g.var()) - 1.0) < 0.03
    p = mtt.DenseVecMatrix.random(2, 300, 300, dist="poisson", lam=3.0).data
    assert abs(float(p.mean()) - 3.0) < 0.05 and torch.equal(p, p.round())
    r = mtt.DenseVecMatrix.random(3, 100, 100, minval=-2.0, maxval=5.0).data
    assert float(r.min()) >= -2.0 and float(r.max()) < 5.0
    assert float(mtt.DenseVecMatrix.zeros(3, 4).sum()) == 0.0
    assert float(mtt.BlockMatrix.ones(3, 4).sum()) == 12.0
    assert mtt.DenseVecMatrix.random(0, 4, 4, dtype=torch.bfloat16).dtype == torch.bfloat16
    with pytest.raises(ValueError):
        trandom.random_array(0, (2, 2), dist="cauchy")
    v = mtt.DistributedVector.random(4, 1000)
    assert v.length == 1000 and 0.4 < float(v.sum()) / 1000 < 0.6


# ----------------------------------------------------------- precision


def test_precision_mapping_is_pinned():
    assert tconfig.TF32_BY_PRECISION == {"highest": False, "high": False,
                                         "default": True}
    assert mtt.get_config().matmul_precision == "highest"
    with pytest.raises(ValueError):
        tconfig.tf32_for("bf16_3x")


def test_precision_is_set_per_call_and_restored(monkeypatch):
    flags = torch.backends.cuda.matmul
    seen = []
    real = torch.matmul

    def spy(a, b):
        seen.append(flags.allow_tf32)
        return real(a, b)

    monkeypatch.setattr(torch, "matmul", spy)
    before = flags.allow_tf32
    x = torch.ones(4, 4)
    for p in ("highest", "high", "default", None):
        tlocal.gemm(x, x, precision=p)
        assert flags.allow_tf32 == before
    assert seen == [False, False, True, False]
    with mtt.config_context(matmul_precision="default"):
        tlocal.gemm(x, x)
    assert seen[-1] is True and flags.allow_tf32 == before
    with pytest.raises(RuntimeError):
        with tlocal.precision_scope("default"):
            raise RuntimeError("inside")
    assert flags.allow_tf32 == before


def test_local_ops_match_jax():
    import jax.numpy as jnp
    from marlin_tpu.ops import local as jlocal

    rng = np.random.default_rng(3)
    a = rng.standard_normal((12, 9)).astype(np.float32)
    x = rng.standard_normal(9).astype(np.float32)
    y = rng.standard_normal(12).astype(np.float32)
    s = rng.standard_normal((9, 9)).astype(np.float32)
    ta = torch.from_numpy(a)
    close(tlocal.matvec(ta, torch.from_numpy(x)), jlocal.matvec(jnp.asarray(a), jnp.asarray(x)))
    close(tlocal.syrk(ta), jlocal.syrk(jnp.asarray(a)))
    close(tlocal.dspr(0.5, torch.from_numpy(x), torch.from_numpy(s)),
          jlocal.dspr(0.5, jnp.asarray(x), jnp.asarray(s)))
    close(tlocal.axpy(2.0, torch.from_numpy(y), torch.from_numpy(y)),
          jlocal.axpy(2.0, jnp.asarray(y), jnp.asarray(y)))
    close(tlocal.triu_to_full(torch.from_numpy(s)), jlocal.triu_to_full(jnp.asarray(s)))
    close(tlocal.block_multiply(ta, torch.from_numpy(s)),
          jlocal.block_multiply(jnp.asarray(a), jnp.asarray(s)))
    from jax.experimental import sparse as jsparse

    # a sparse operand now takes the sparse quarter of the dispatch
    close(tlocal.block_multiply(ta.to_sparse(), torch.from_numpy(s)),
          jlocal.block_multiply(jsparse.BCOO.fromdense(jnp.asarray(a)),
                                jnp.asarray(s)))


def test_evaluate_and_timer(capsys, arrays):
    _, ta = _pair(arrays, "a")
    assert mtt.evaluate(ta) is ta
    out = mtt.evaluate(ta, ta.data, [ta.data])
    assert len(out) == 3
    times = []
    with mtt.timer("mm", results=times):
        mtt.evaluate(ta.multiply(ta.transpose()))
    assert len(times) == 1 and "mm:" in capsys.readouterr().out
