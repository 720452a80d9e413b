"""``marlin_tpu_torch.fuse`` / ``lazy.grad`` against ``marlin_tpu.fuse`` /
``jax.grad``, on the CPU: the eight cases of ``tests/test_fuse.py``.

The port's matrices are drawn by the port (``DenseVecMatrix.random``, a
``torch.Generator``) and handed to the JAX package as numpy, so both fused
chains see the same operands; the JAX side runs on the 2 x 4 CPU mesh of
``tests/conftest.py``. ``torch.compile`` runs with ``backend="aot_eager"``
(dynamo's graph capture and AOT autograd, no code generation) except in
the first case, which takes the default backend (inductor) once.

Tolerances: 1e-4 relative and absolute against the JAX package and the
numpy oracle (as ``tests/test_fuse.py``; products in two frameworks and in
compiled code); vector and elementwise results 1e-5; cotangent pads and
integer vectors exact.

``test_fuse_single_trace`` counts dynamo's compiles (its ``CompileCounter``
backend) where the JAX test counts the Python body's runs: dynamo replays a
traced list mutation on every call, so the body's side effects are no
measure of retracing here (ROADMAP queue 3).
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax

import marlin_tpu as jm
import marlin_tpu_torch as tm
from marlin_tpu_torch import lazy

TOL = 1e-4
VEC_TOL = 1e-5
EAGER = dict(backend="aot_eager")


@pytest.fixture(autouse=True)
def _cpu():
    with tm.config_context(device="cpu"):
        yield


@pytest.fixture()
def abc():
    return (tm.DenseVecMatrix.random(0, 100, 60),
            tm.DenseVecMatrix.random(1, 60, 80),
            tm.DenseVecMatrix.random(2, 100, 80))


def _jax(m, mesh, cls=None):
    return (cls or jm.DenseVecMatrix).from_array(m.to_numpy(), mesh)


def test_fuse_chain_matches_oracle(abc, mesh):
    a, b, c = abc

    def chain(a, b, c):
        return a.multiply(b).add(c).multiply(2.0).transpose()

    out = tm.fuse(chain)(a, b, c)
    want = jm.fuse(chain)(*(_jax(m, mesh) for m in abc)).to_numpy()
    ref = 2.0 * (a.to_numpy() @ b.to_numpy() + c.to_numpy()).T
    assert isinstance(out, tm.DenseVecMatrix) and out.shape == (80, 100)
    np.testing.assert_allclose(out.to_numpy(), want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(out.to_numpy(), ref, rtol=TOL, atol=TOL)


def test_fuse_single_trace(abc):
    """Two calls on the same geometry: one dynamo compile, one graph."""
    from torch._dynamo.testing import CompileCounter

    a, b, c = abc
    cnt = CompileCounter()

    @tm.fuse(backend=cnt)
    def chain(a, b, c):
        return a.multiply(b).add(c)

    r1 = chain(a, b, c)
    r2 = chain(a, b, c)  # cache hit: no recompile
    assert cnt.frame_count == 1
    np.testing.assert_allclose(r1.to_numpy(), r2.to_numpy())


def test_fuse_grad_returns_matrix_cotangent(abc, mesh):
    a, b, _ = abc

    def loss(a, b):
        return a.multiply(b).sum()

    fused = tm.fuse(loss, **EAGER)
    g = lazy.grad(lambda a: fused(a, b))(a)
    assert isinstance(g, tm.DenseVecMatrix) and g.shape == a.shape
    jb = _jax(b, mesh)
    jg = jax.grad(lambda x: jm.fuse(loss)(x, jb))(_jax(a, mesh))
    ref = np.ones((100, 80), np.float32) @ b.to_numpy().T
    np.testing.assert_allclose(g.to_numpy(), jg.to_numpy(), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(g.to_numpy(), ref, rtol=TOL, atol=TOL)


def test_fuse_vector_roundtrip(mesh):
    v = tm.DistributedVector.from_array(np.arange(10, dtype=np.float32))
    a = tm.DenseVecMatrix.random(3, 7, 10)

    def mv(a, v):
        return a.multiply_vector(v)

    out = tm.fuse(mv, **EAGER)(a, v)
    want = jm.fuse(mv)(_jax(a, mesh), jm.DistributedVector.from_array(
        v.to_numpy(), mesh)).to_numpy()
    assert isinstance(out, tm.DistributedVector)
    np.testing.assert_allclose(out.to_numpy(), want, rtol=VEC_TOL,
                               atol=VEC_TOL)
    np.testing.assert_allclose(out.to_numpy(), a.to_numpy() @ v.to_numpy(),
                               rtol=VEC_TOL, atol=VEC_TOL)


def test_fuse_shape_mismatch_raises_at_trace(abc, mesh):
    a, b, _ = abc

    def bad(a, b):
        return b.multiply(a)  # (60, 80) @ (100, 60): inner-dim mismatch

    with pytest.raises(ValueError, match="inner dim"):
        tm.fuse(bad, **EAGER)(a, b)
    with pytest.raises(ValueError, match="inner dim"):
        jm.fuse(bad)(_jax(a, mesh), _jax(b, mesh))


def test_fuse_block_matrix(mesh, a4):
    am = tm.BlockMatrix.from_array(a4)
    bm = tm.BlockMatrix.from_array(a4.T)

    def f(x, y):
        return x.multiply(y).subtract(x)

    out = tm.fuse(f, **EAGER)(am, bm)
    want = jm.fuse(f)(jm.BlockMatrix.from_array(a4, mesh),
                      jm.BlockMatrix.from_array(a4.T, mesh)).to_numpy()
    # the type eager gives (a world of one has no column blocks)
    assert type(out) is type(f(am, bm))
    np.testing.assert_allclose(out.to_numpy(), want, rtol=VEC_TOL,
                               atol=VEC_TOL)
    np.testing.assert_allclose(out.to_numpy(), a4 @ a4.T - a4, rtol=VEC_TOL,
                               atol=VEC_TOL)


def test_fuse_int_vector(mesh):
    iv = tm.DistributedIntVector.from_array(np.arange(6))

    def double(v):
        return type(v)(v.data * 2, v._length, v.mesh, v.column_major)

    out = tm.fuse(double, **EAGER)(iv)
    want = jm.fuse(double)(jm.DistributedIntVector.from_array(
        np.arange(6), mesh)).to_numpy()
    assert isinstance(out, tm.DistributedIntVector)
    np.testing.assert_array_equal(out.to_numpy(), np.arange(6) * 2)
    np.testing.assert_array_equal(out.to_numpy(), want)


def test_fuse_grad_cotangent_pads_are_zero(row_mesh):
    """100 rows padded to 104 (the JAX test's 8-row-shard layout, built
    here by hand: the port's mesh is a world of one): the cotangent of a
    masked-reduction loss keeps the pad zero, and reductions and an update
    on it agree with the logical oracle and with JAX's."""
    a0 = tm.DenseVecMatrix.random(0, 100, 60)
    b = tm.DenseVecMatrix.random(1, 60, 80)
    a = tm.DenseVecMatrix(F.pad(a0.data, (0, 0, 0, 4)), (100, 60), a0.mesh,
                          a0.spec)
    g = lazy.grad(lambda a: a.multiply(b).sum())(a)
    assert g.data.shape[0] == 104  # padding actually present
    assert bool((g.data[100:] == 0.0).all()), "cotangent pads nonzero"
    jb = jm.DenseVecMatrix.from_array(b.to_numpy(), row_mesh)
    jg = jax.grad(lambda x: x.multiply(jb).sum())(
        jm.DenseVecMatrix.from_array(a0.to_numpy(), row_mesh))
    assert np.asarray(jg.data).shape[0] == 104
    ref = np.ones((100, 80), np.float32) @ b.to_numpy().T
    np.testing.assert_allclose(g.to_numpy(), jg.to_numpy(), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(float(g.sum()), ref.sum(), rtol=TOL)
    np.testing.assert_allclose(float(g.norm("fro")), np.linalg.norm(ref),
                               rtol=TOL)
    new_a = a.subtract(g.multiply(1e-3))
    np.testing.assert_allclose(float(new_a.sum()),
                               (a0.to_numpy() - 1e-3 * ref).sum(), rtol=1e-3)
