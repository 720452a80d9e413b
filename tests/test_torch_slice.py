"""The ported slice end to end: the dense multiply and its hand-written GEMM.

The same seeded numpy inputs go through the JAX package's path (``from_array``
→ ``multiply``; ``ops.gemm(backend="pallas")`` in interpret mode;
``tune_gemm``/``best_gemm``) and the port's on ``device="cpu"``, compared with
rtol/atol 1e-4 (f32). Two more guarantees: the port imports neither JAX nor
``marlin_tpu``, and its entry points refuse to run on the CPU unless asked.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import marlin_tpu as mt
import marlin_tpu_torch as mtt
from marlin_tpu import ops as jops
from marlin_tpu.parallel import autotune as jautotune
from marlin_tpu_torch import interop, ops as tops
from marlin_tpu_torch.mesh import create_mesh
from marlin_tpu_torch.models import TransformerLM, usable_hbm_bytes
from marlin_tpu_torch.parallel import autotune as tautotune
from marlin_tpu_torch.random import ensure_key

ROOT = Path(__file__).resolve().parents[1]
M, K, N = 96, 80, 72
TOL = 1e-4


def test_slice_end_to_end_matches_jax(tmp_path):
    rng = np.random.default_rng(2026)
    a = rng.uniform(size=(M, K)).astype(np.float32)
    b = rng.uniform(size=(K, N)).astype(np.float32)
    want = mt.DenseVecMatrix.from_array(a).multiply(
        mt.DenseVecMatrix.from_array(b), precision="high").to_numpy()
    want_pl = np.asarray(jops.gemm(jnp.asarray(a), jnp.asarray(b),
                                   backend="pallas"))
    with mt.config_context(autotune_cache_path=str(tmp_path / "jax.json")):
        jax_rank = jautotune.tune_gemm(a, b, reps=1)

    with mtt.config_context(device="cpu",
                            autotune_cache_path=str(tmp_path / "torch.json")):
        mats = interop.matrices_from_numpy({"a": a, "b": b})
        ta, tb = mats["a"], mats["b"]
        c = mtt.evaluate(ta.multiply(tb, precision="high"))
        assert isinstance(c, mtt.DenseVecMatrix) and c.device.type == "cpu"
        np.testing.assert_allclose(c.to_numpy(), want, rtol=TOL, atol=TOL)
        g = tops.gemm(ta.data, tb.data, backend="pallas")
        np.testing.assert_allclose(g.numpy(), want_pl, rtol=TOL, atol=TOL)
        rank = tautotune.tune_gemm(ta.data, tb.data, reps=1)
        # both tuners time the library product against a family of tiles
        for ranking in (rank, jax_rank):
            names = [n for n, _ in ranking]
            assert "xla" in names and len(names) >= 2
        best = tautotune.best_gemm(ta.data, tb.data)
        assert best == rank[0][0]
        for name, _ in rank:
            if name == "xla":
                continue
            t = tops.tile_family.parse_gemm_candidate(name)
            got = tops.pallas_matmul(ta.data, tb.data, *t).numpy()
            np.testing.assert_allclose(got, a @ b, rtol=TOL, atol=TOL)
        tautotune.clear_cache()


def test_slice_random_inputs_agree_with_numpy():
    with mtt.config_context(device="cpu"):
        a = mtt.DenseVecMatrix.random(0, M, K)
        b = mtt.DenseVecMatrix.random(1, K, N)
        c = a.multiply(b)
        want = a.to_numpy().astype(np.float64) @ b.to_numpy().astype(np.float64)
        assert np.isfinite(c.to_numpy()).all() and c.shape == (M, N)
        np.testing.assert_allclose(c.to_numpy(), want, rtol=TOL, atol=TOL)
        np.testing.assert_allclose(
            tops.gemm(a.data, b.data, backend="pallas").numpy(), want,
            rtol=TOL, atol=TOL)


# modules the walk must reach (each slice adds its own), and the root
# scripts that drive the port on the card
PORT_MODULES = (
    "marlin_tpu_torch.ops.pallas_kernels",
    "marlin_tpu_torch.ops.paged_attention",
    "marlin_tpu_torch.ops.flash_attention",
    "marlin_tpu_torch.threefry",
    "marlin_tpu_torch.models.transformer",
    "marlin_tpu_torch.models.planner",
    "marlin_tpu_torch.serving.batcher",
    "marlin_tpu_torch.serving.kvpool",
    "marlin_tpu_torch.interop",
    "paged_serve_loop",
    "chip_smoke",
)


def test_port_imports_neither_jax_nor_marlin_tpu():
    code = (
        "import importlib, pkgutil, sys\n"
        "import marlin_tpu_torch\n"
        "for m in pkgutil.walk_packages(marlin_tpu_torch.__path__, "
        "'marlin_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke, paged_serve_loop\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
        "('jax', 'jaxlib', 'marlin_tpu'))\n"
        "missing = [m for m in " + repr(PORT_MODULES) + " if m not in "
        "sys.modules]\n"
        "print(bad, missing)\n"
        "sys.exit(1 if bad or missing else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT), env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_entry_points_refuse_cpu_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert mtt.get_config().device == "cuda"
    for call in (lambda: mtt.DenseVecMatrix.random(0, 4, 4),
                 lambda: mtt.DenseVecMatrix.from_array(np.ones((2, 2))),
                 lambda: mtt.DistributedVector.from_array(np.ones(3)),
                 lambda: create_mesh(),
                 lambda: ensure_key(0),
                 lambda: tautotune.tune_gemm(np.ones((2, 2), np.float32),
                                             np.ones((2, 2), np.float32)),
                 lambda: TransformerLM(vocab=8, d_model=8, heads=2,
                                       layers=1).init_params(),
                 lambda: interop.lm_params_from_numpy(
                     {"emb": np.ones((8, 8), np.float32)}),
                 lambda: usable_hbm_bytes()):
        with pytest.raises(RuntimeError, match="cuda"):
            call()
    # asked for explicitly, the CPU works
    m = mtt.DenseVecMatrix.random(0, 4, 4, mesh=create_mesh(device="cpu"))
    assert m.device.type == "cpu"
    with mtt.config_context(device="cpu"):
        assert mtt.DenseVecMatrix.ones(2, 2).device.type == "cpu"


def test_mesh_is_a_world_of_one():
    mesh = create_mesh(device="cpu")
    assert mesh.shape == {mtt.ROWS: 1, mtt.COLS: 1} and mesh.size == 1
    with pytest.raises(ValueError, match="needs 8 devices"):
        create_mesh((4, 2), device="cpu")
    mtt.set_default_mesh(mesh)
    try:
        assert mtt.default_mesh() is mesh
    finally:
        mtt.set_default_mesh(None)
    with mtt.config_context(device="cpu"):
        assert mtt.default_mesh() == mesh
