"""The port's GEMM tile family and its tuner (marlin_tpu_torch).

Three layers, as in tests/test_tile_family.py: the pure generator (the tiles
are exactly the CUDA library's instantiations, they fit a Hopper block's
shared memory, clamp-dedupe, traffic ranking, name round-trips — shared with
the JAX family's spelling), every candidate computing the JAX package's
product, and the measuring tuner with its two cache layers. The tuner tests
run on the CPU (``config_context(device="cpu")``), where a candidate runs the
kernel's plain version.
"""

import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from marlin_tpu.ops import tile_family as jax_tile_family
from marlin_tpu.ops.local import gemm as jax_gemm
import marlin_tpu_torch as mtt
from marlin_tpu_torch.ops import pallas_kernels as pk
from marlin_tpu_torch.ops import tile_family as tf
from marlin_tpu_torch.parallel import autotune

CSRC = Path(tf.__file__).resolve().parent.parent / "csrc" / "gemm.cu"


@pytest.fixture(autouse=True)
def _cpu_fresh_cache(tmp_path):
    with mtt.config_context(device="cpu",
                            autotune_cache_path=str(tmp_path / "at.json")):
        autotune.clear_cache()
        yield
        autotune.clear_cache()


def _instantiated():
    return {tf.TileCandidate(*t) for t in (tuple(map(int, m)) for m in
            re.findall(r"MARLIN_TILE\((\d+), (\d+), (\d+)\)\n",
                       CSRC.read_text()))}


# ------------------------------------------------------------- generator


def test_family_axes_are_the_instantiated_tiles():
    want = {tf.TileCandidate(bm, bn, bk) for bm in tf.BM_AXIS
            for bn in tf.BN_AXIS for bk in tf.BK_AXIS}
    assert _instantiated() == want
    assert all(tf.is_instantiated(c) for c in want)
    assert not tf.is_instantiated(tf.TileCandidate(64, 64, 16))
    # the shared-memory model's constants are the kernel's
    src = CSRC.read_text()
    stages = int(re.search(r"constexpr int kMaxStages = (\d+);", src)[1])
    assert stages == tf.MAX_STAGES
    assert "constexpr int kSmemReserve = 1024 + 16 * kMaxStages;" in src
    assert tf.SMEM_RESERVE == 1024 + 16 * tf.MAX_STAGES


@pytest.mark.parametrize("mkn", [(4096, 4096, 4096), (20000, 20000, 20000),
                                 (100, 5000, 70)])
def test_candidates_instantiated_and_fit_shared_memory(mkn):
    cands = tf.gemm_candidates(*mkn)
    assert cands and len(set(cands)) == len(cands)
    for c in cands:
        assert c in _instantiated()
        assert tf.smem_bytes(*c) <= tf.SMEM_BUDGET_BYTES
        # more than half an SM's shared memory: one block an SM
        assert 2 * tf.smem_bytes(*c) > tf.SMEM_BUDGET_BYTES
        assert tf.stages(*c) >= 3
        assert c.bm % 64 == 0 and c.bn % 64 == 0


def test_smem_bytes_counts_padded_f32_panels():
    # a stage holds the A and B tiles in rows of 32 words = 128 bytes (f32
    # values with their lo halves, or bf16): as many stages as fit, at most
    # MAX_STAGES, plus the reserve
    stage = (128 + 128) * 128
    assert tf.stages(128, 128, 32) == 7
    assert tf.smem_bytes(128, 128, 32) == tf.SMEM_RESERVE + 7 * stage
    assert tf.stages(64, 128, 32) == 9
    assert tf.stages(64, 64, 32) == 14
    assert tf.smem_bytes(64, 64, 32) == tf.SMEM_RESERVE + 14 * 128 * 128


def test_candidates_clamp_and_dedupe_on_small_problems():
    # every tile wider than the problem collapses onto the smallest that covers it
    assert tf.gemm_candidates(16, 64, 64) == [tf.TileCandidate(64, 64, 32)]
    assert tf.gemm_candidates(16, 64, 200) == [tf.TileCandidate(64, 128, 32),
                                               tf.TileCandidate(64, 64, 32)]
    assert tf.gemm_candidates(8, 8, 8) == [tf.TileCandidate(64, 64, 32)]
    assert tf._clamp(100, 50, 20, tf.TileCandidate(128, 128, 32)) == \
        tf.TileCandidate(128, 64, 32)


def test_candidates_ranked_by_traffic_and_capped():
    cands = tf.gemm_candidates(1024, 1024, 1024, max_candidates=8)
    scores = [tf.gemm_traffic_bytes(1024, 1024, 1024, *c) for c in cands]
    # the whole family: 4 instantiated tiles, none collapsed at 1024^3
    assert scores == sorted(scores) and len(cands) == 4
    assert cands[0] == tf.TileCandidate(128, 128, 32)
    assert tf.gemm_candidates(1024, 1024, 1024, max_candidates=3) == cands[:3]


def test_traffic_model_is_the_jax_model():
    for t in [(128, 128, 16), (64, 128, 32), (130, 70, 50)]:
        assert tf.gemm_traffic_bytes(1000, 777, 300, *t) == \
            jax_tile_family.gemm_traffic_bytes(1000, 777, 300, *t)


def test_degenerate_problem_rejected():
    with pytest.raises(ValueError):
        tf.gemm_candidates(0, 128, 128)


def test_gemm_name_round_trip_and_jax_spelling():
    c = tf.TileCandidate(128, 64, 32)
    assert c.name == "pallas:128x64x32"
    assert tf.parse_gemm_candidate(c.name) == c
    # JAX family names parse the same way
    for jc in jax_tile_family.gemm_candidates(4096, 4096, 4096):
        assert tuple(tf.parse_gemm_candidate(jc.name)) == tuple(jc)
    for junk in (None, 17, "xla", "pallas:1x2", "chunked:4"):
        with pytest.raises(ValueError):
            tf.parse_gemm_candidate(junk)


def test_select_tile():
    # the JAX defaults (256, 256, 512) select the largest instantiated tile
    assert tf.select_tile(4096, 4096, 4096, 256, 256, 512) == (128, 128, 32)
    assert tf.select_tile(130, 50, 70, 64, 128, 128) == (64, 64, 32)
    assert tf.select_tile(4096, 4096, 4096, 8, 8, 8) == (64, 64, 32)
    # a family candidate selects itself
    for c in tf.gemm_candidates(500, 300, 700, max_candidates=8):
        assert tf.select_tile(500, 700, 300, *c) == c


# -------------------------------------------- family vs the JAX product


def test_family_candidates_match_jax_gemm():
    rng = np.random.default_rng(7)
    a = rng.standard_normal((200, 160)).astype(np.float32)
    b = rng.standard_normal((160, 260)).astype(np.float32)
    want = np.asarray(jax_gemm(jnp.asarray(a), jnp.asarray(b)))
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    for c in tf.gemm_candidates(200, 160, 260, max_candidates=8):
        got = pk.pallas_matmul(ta, tb, *c).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


# ------------------------------------------------------- measuring tuner


def _operands(seed, n=96):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.standard_normal((n, n)).astype(np.float32)),
            torch.from_numpy(rng.standard_normal((n, n)).astype(np.float32)))


def test_tune_gemm_ranks_and_persists():
    a, b = _operands(8)
    results = autotune.tune_gemm(a, b, reps=1)
    names = [n for n, _ in results]
    secs = [s for _, s in results]
    assert secs == sorted(secs) and "xla" in names
    assert set(names) - {"xla"} == {c.name for c in tf.gemm_candidates(96, 96, 96)}
    key = autotune._gemm_key(96, 96, 96, a.dtype, a.device)
    assert key[-2:] == autotune._device_sig(torch.device("cpu"))
    assert autotune._CACHE[key] == results[0][0]
    disk = json.load(open(mtt.get_config().autotune_cache_path))
    assert disk["__version__"] == autotune._DISK_VERSION
    assert disk[repr(key)] == results[0][0]


def test_tune_gemm_explicit_candidates_do_not_pin_cache():
    a, b = _operands(9)
    results = autotune.tune_gemm(a, b, candidates=["pallas:64x64x32"], reps=1)
    assert [n for n, _ in results] == ["pallas:64x64x32"]
    assert len(autotune._CACHE) == 0


def test_best_gemm_caches_without_retune(monkeypatch):
    a, b = _operands(10)
    first = autotune.best_gemm(a, b, reps=1)

    def boom(*args, **kw):
        raise AssertionError("best_gemm re-timed a cached configuration")

    monkeypatch.setattr(autotune, "tune_gemm", boom)
    assert autotune.best_gemm(a, b) == first
    # a fresh process: memory layer gone, the disk layer answers
    autotune._CACHE.clear()
    assert autotune.best_gemm(a, b) == first


def test_best_gemm_retunes_on_a_stale_persisted_name():
    """A name that does not parse, or one of an older family that parses but
    has no kernel any more, re-tunes instead of raising."""
    a, b = _operands(11)
    key = autotune._gemm_key(96, 96, 96, a.dtype, a.device)
    for stale in ("pallas:banana", "pallas:64x64x16"):
        autotune._persist(key, stale)
        autotune._CACHE.clear()
        best = autotune.best_gemm(a, b, reps=1)
        assert best != stale and autotune._valid_gemm_name(best)
    assert not autotune._valid_gemm_name("pallas:64x64x16")


def test_tune_gemm_propagates_a_candidate_error(monkeypatch):
    """The family proposes only built tiles, so a candidate that raises is a
    bug to surface, never a candidate to skip."""
    a, b = _operands(12)

    def broken(*args, **kw):
        raise RuntimeError("launch refused")

    monkeypatch.setattr(pk, "pallas_matmul", broken)
    with pytest.raises(RuntimeError, match="launch refused"):
        autotune.tune_gemm(a, b, reps=1)
    assert len(autotune._CACHE) == 0


def test_tune_multiply_and_tuned_multiply():
    rng = np.random.default_rng(13)
    x = rng.standard_normal((40, 30)).astype(np.float32)
    y = rng.standard_normal((30, 20)).astype(np.float32)
    a, b = mtt.DenseVecMatrix.from_array(x), mtt.DenseVecMatrix.from_array(y)
    results = autotune.tune_multiply(a, b, reps=1)
    assert {s for s, _ in results} == {"gspmd", "rmm", "ring", "broadcast",
                                       "broadcast_a"}
    assert autotune.best_strategy(a, b) == results[0][0]
    np.testing.assert_allclose(a.multiply(b, strategy="tuned").to_numpy(),
                               x @ y, rtol=1e-4, atol=1e-4)
    # an unknown name is skipped; nothing left raises
    assert autotune.tune_multiply(a, b, strategies=["nope", "rmm"], reps=1)[0][0] == "rmm"
    with pytest.raises(ValueError, match="no viable"):
        autotune.tune_multiply(a, b, strategies=["nope"], reps=1)


def test_clear_cache_removes_the_file():
    a, b = _operands(14)
    autotune.tune_gemm(a, b, reps=1)
    path = Path(mtt.get_config().autotune_cache_path)
    assert path.exists()
    autotune.clear_cache()
    assert not path.exists() and not autotune._CACHE
