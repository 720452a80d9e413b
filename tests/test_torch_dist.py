"""The port's mesh over ``torch.distributed`` ranks and its multiplies across
them, against the JAX package on its CPU devices.

One 4-rank gloo world (``_torch_dist.run_world``) runs every case of this
file; each case is then compared here, one test each, with the JAX
package's function on the same numpy inputs over a 4-device mesh. The
products sum in other orders (gloo's all-reduce, the ring's panels), so
each product holds within ``PRODUCT_TOL`` of max |ref|.
"""

import importlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from marlin_tpu import mesh as jmesh
from marlin_tpu.parallel.ring import ring_matmul as jring

from _torch_dist import run_world

# the module (``marlin_tpu.parallel.matmul`` is the function)
jmm = importlib.import_module("marlin_tpu.parallel.matmul")

WORLD = 4
PRODUCT_TOL = 1e-5


def _ab(m, k, n, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((m, k)).astype(np.float32),
            rng.standard_normal((k, n)).astype(np.float32))


def _inputs():
    cases = {
        "mesh": {},
        "ring_even": _ab(24, 40, 16, 0),
        "ring_uneven": _ab(13, 9, 5, 1),
        "ring_2x2": _ab(24, 40, 16, 2),
        "ring_strategy": _ab(32, 32, 32, 3),
        "rmm_221": _ab(24, 40, 16, 4) + ((2, 2, 1),),
        "rmm_122": _ab(24, 40, 16, 5) + ((1, 2, 2),),
        "rmm_411": _ab(24, 40, 16, 6) + ((4, 1, 1),),
        "rmm_auto": _ab(64, 96, 48, 7),
        "rmm_uneven": _ab(13, 9, 7, 8) + ((2, 2, 1),),
        "rmm_subset": _ab(24, 40, 16, 9) + ((2, 1, 1),),
        "broadcast_b": _ab(40, 24, 8, 10),
        "broadcast_a": _ab(6, 24, 40, 11),
        "gspmd": _ab(40, 24, 33, 12),
        "auto": _ab(48, 40, 16, 13),
    }
    out = {}
    for name, val in cases.items():
        if not val:
            out[name] = {}
            continue
        d = {"a": val[0], "b": val[1]}
        if len(val) > 2:
            d["split"] = np.array(val[2])
        out[name] = d
    return out


INPUTS = _inputs()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return run_world(WORLD, list(INPUTS), INPUTS,
                     tmp_path_factory.mktemp("dist_world"))


@pytest.fixture(scope="module")
def jmeshes():
    devs = jax.devices()[:WORLD]
    return {g: jmesh.create_mesh(g, devices=devs) for g in ((4, 1), (2, 2))}


def _close(got, want):
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=PRODUCT_TOL * np.abs(want).max())


def test_mesh_over_ranks(world):
    r = world["mesh"]
    assert r["grid"].tolist() == [2, 2] and int(r["world"]) == WORLD
    # each rank's view: row-major coordinates, its lines along each axis
    assert r["rank_coords"].tolist() == [[0, 0], [0, 1], [1, 0], [1, 1]]
    assert r["rank_line_rows"].tolist() == [[0, 2], [1, 3], [0, 2], [1, 3]]
    assert r["rank_line_cols"].tolist() == [[0, 1], [0, 1], [2, 3], [2, 3]]
    assert int(r["group_size"]) == 2
    x = np.arange(48, dtype=np.float32).reshape(8, 6)
    for rank in range(WORLD):
        np.testing.assert_array_equal(r["rank_rows_local"][rank],
                                      x[2 * rank:2 * rank + 2])
        i, j = divmod(rank, 2)
        np.testing.assert_array_equal(r["rank_block_local"][rank],
                                      x[4 * i:4 * i + 4, 3 * j:3 * j + 3])
    np.testing.assert_array_equal(r["repl_local"], x)
    assert r["mesh_shape"].tolist() == [2, 2]
    assert bool(r["hashable"]) and int(r["refused"]) == 1


@pytest.mark.parametrize("case,grid", [("ring_even", (4, 1)),
                                       ("ring_uneven", (4, 1)),
                                       ("ring_2x2", (2, 2))])
def test_ring_matmul_matches_jax(world, jmeshes, case, grid):
    a, b = INPUTS[case]["a"], INPUTS[case]["b"]
    want = jring(jnp.asarray(a), jnp.asarray(b), jmeshes[grid])
    _close(world[case]["c"], want)
    _close(world[case]["c"], a.astype(np.float64) @ b)


def test_matmul_ring_strategy_reaches_ring_matmul(world, jmeshes):
    a, b = INPUTS["ring_strategy"]["a"], INPUTS["ring_strategy"]["b"]
    assert int(world["ring_strategy"]["calls"]) == 1
    sh = NamedSharding(jmeshes[(4, 1)], P("rows", "cols"))
    want = jmm.matmul(jnp.asarray(a), jnp.asarray(b), sh, strategy="ring")
    _close(world["ring_strategy"]["c"], want)


@pytest.mark.parametrize("case", ["rmm_221", "rmm_122", "rmm_411", "rmm_auto",
                                  "rmm_uneven", "rmm_subset"])
def test_rmm_matmul_matches_jax(world, case):
    inp = INPUTS[case]
    split = tuple(int(s) for s in inp["split"]) if "split" in inp else None
    want = jmm.rmm_matmul(jnp.asarray(inp["a"]), jnp.asarray(inp["b"]),
                          split, jax.devices()[:WORLD])
    _close(world[case]["c"], want)


@pytest.mark.parametrize("case,replicate", [("broadcast_b", "b"),
                                            ("broadcast_a", "a")])
def test_broadcast_matmul_matches_jax(world, jmeshes, case, replicate):
    inp = INPUTS[case]
    sh = NamedSharding(jmeshes[(2, 2)], P("rows", "cols"))
    want = jmm.broadcast_matmul(jnp.asarray(inp["a"]), jnp.asarray(inp["b"]),
                                sh, replicate)
    _close(world[case]["c"], want)


@pytest.mark.parametrize("case,fn", [("gspmd", "gspmd_matmul"),
                                     ("auto", "matmul")])
def test_gspmd_and_auto_match_jax(world, jmeshes, case, fn):
    inp = INPUTS[case]
    sh = NamedSharding(jmeshes[(2, 2)], P("rows", "cols"))
    want = getattr(jmm, fn)(jnp.asarray(inp["a"]), jnp.asarray(inp["b"]), sh)
    _close(world[case]["c"], want)


def test_initialize_distributed_refuses_without_cuda_or_cpu_request(
        tmp_path):
    """Without CUDA, joining a world needs the caller to ask for the CPU;
    the refusal starts no process group."""
    import torch

    from marlin_tpu_torch import mesh as tmesh

    url = f"file://{tmp_path / 'store'}"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            tmesh.initialize_distributed(url, 1, 0)
    assert not tmesh.distributed()
