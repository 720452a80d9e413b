"""Ring and Ulysses attention across ``torch.distributed`` ranks, forward and
gradients, against the JAX package's on a 2-device mesh.

One 2-rank gloo world (``_torch_dist.run_world``) runs every case of
``tests/test_ring_attention.py`` and ``tests/test_ulysses.py`` that computes
something (the oracle-free ones — a compiled program's memory — have no
counterpart); each is then compared here, one test each, with the JAX
package's function on the same numpy inputs over a ("rows" 2) mesh, the
Pallas kernels in interpret mode. f32 outputs and gradients hold within
``ATTN_TOL`` of max |ref| (the softmax sums run in other orders and tiles);
``precision="default"`` (bf16 products) within the reference tests' 2e-2.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from marlin_tpu import mesh as jmesh
from marlin_tpu.parallel.ring_attention import attention_reference
from marlin_tpu.parallel.ring_attention import ring_attention as jring
from marlin_tpu.parallel.ulysses import ulysses_attention as julysses

from _torch_dist import run_world

WORLD = 2
ATTN_TOL = 1e-5
BF16_TOL = 2e-2


def _qkv(shape, seed, ct=False):
    rng = np.random.default_rng(seed)
    out = {n: rng.standard_normal(shape).astype(np.float32)
           for n in ("q", "k", "v")}
    if ct:  # a non-uniform cotangent, as the reference's cos weights
        out["ct"] = np.broadcast_to(
            np.cos(np.arange(shape[-1], dtype=np.float32)), shape).copy()
    return out


def _case(shape, seed, ct=False, **kw):
    d = _qkv(shape, seed, ct)
    d.update({k: np.array(v) for k, v in kw.items()})
    return d


def _sweep():
    rng = np.random.default_rng(10)
    out = {}
    for i in range(6):
        seq = int(rng.integers(16, 400))
        d = int(rng.choice([8, 16, 32, 64]))
        causal = bool(rng.integers(0, 2))
        qkv = {n: rng.standard_normal((seq, d)).astype(np.float32)
               for n in ("q", "k", "v")}
        for j, backend in enumerate(("xla", "flash")):
            out[f"ra_sweep{2 * i + j}"] = dict(
                qkv, causal=np.array(causal), backend=np.array(backend))
    return out


INPUTS = {
    "ra_dense": _case((64, 32), 0),
    "ra_causal": _case((64, 16), 1, causal=True),
    "ra_uneven": _case((51, 16), 2),
    "ra_uneven_causal": _case((51, 16), 2, causal=True),
    "ra_multihead": _case((4, 32, 8), 3, causal=True),
    "ra_scale": _case((16, 8), 4, scale=0.1),
    "ra_tile_pad": _case((2 * 2048 + 3, 8), 6, causal=True),
    "ra_flash": _case((100, 32), 6, backend="flash"),
    "ra_flash_causal": _case((100, 32), 6, causal=True, backend="flash"),
    "ra_flash_multihead": _case((3, 64, 16), 7, causal=True, backend="flash"),
    "ra_flash_odd": _case((1000, 32), 9, causal=True, backend="flash"),
    "ra_bf16_xla": _case((100, 32), 11, causal=True, backend="xla",
                         precision="default"),
    "ra_bf16_flash": _case((100, 32), 11, causal=True, backend="flash",
                           precision="default"),
    "ra_grad_xla": _case((64, 16), 12, ct=True, causal=True, backend="xla"),
    "ra_grad_flash": _case((64, 16), 12, ct=True, causal=True,
                           backend="flash"),
    "ra_grad_uneven": _case((51, 8), 13, ct=True, causal=True,
                            backend="flash"),
    "ra_batched": _case((2, 3, 40, 8), 22, causal=True),
    **_sweep(),
    "ul_dense": _case((4, 64, 16), 0),
    "ul_causal": _case((4, 64, 16), 0, causal=True),
    "ul_uneven": _case((2, 51, 8), 1, causal=True),
    "ul_bf16": _case((2, 64, 16), 3, causal=True, precision="default"),
    "ul_scale": _case((2, 32, 8), 4, scale=0.2),
    "ul_grad": _case((4, 64, 16), 7, ct=True, causal=True),
    "ul_grad_uneven": _case((2, 51, 8), 8, ct=True, causal=True),
    "ul_batched": _case((3, 4, 40, 8), 21, causal=True),
    "ul_vs_ring": _case((2, 96, 16), 2, causal=True),
    "ulysses_refuses": {},
}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return run_world(WORLD, list(INPUTS), INPUTS,
                     tmp_path_factory.mktemp("ring_world"))


@pytest.fixture(scope="module")
def jmesh2():
    return jmesh.create_mesh((WORLD, 1), devices=jax.devices()[:WORLD])


def _jax_run(fn, inp, mesh):
    """The JAX function's output, and with a cotangent its gradients, from
    one jitted program (jit compiles the case once, where eager dispatch
    compiles each of its many small ops)."""
    kw = {k: (bool(inp[k]) if k == "causal" else float(inp[k])
              if k == "scale" else str(inp[k]))
          for k in ("causal", "scale", "backend", "precision") if k in inp}
    q, k, v = (jnp.asarray(inp[n]) for n in ("q", "k", "v"))
    if "ct" not in inp:
        return {"out": np.asarray(jax.jit(
            lambda *a: fn(*a, mesh, **kw))(q, k, v))}

    @jax.jit
    def run(q, k, v, ct):
        out, vjp = jax.vjp(lambda *a: fn(*a, mesh, **kw), q, k, v)
        return (out, *vjp(ct))

    out, gq, gk, gv = run(q, k, v, jnp.asarray(inp["ct"]))
    return {"out": np.asarray(out), "gq": np.asarray(gq),
            "gk": np.asarray(gk), "gv": np.asarray(gv)}


def _compare(got, want, tol):
    for key, w in want.items():
        assert got[key].shape == w.shape, key
        np.testing.assert_allclose(got[key], w, rtol=0,
                                   atol=tol * np.abs(w).max(), err_msg=key)


def _ring_kwargs(name):
    return BF16_TOL if "bf16" in name else ATTN_TOL


@pytest.mark.parametrize("name", [n for n in INPUTS if n.startswith("ra_")])
def test_ring_attention_matches_jax(world, jmesh2, name):
    inp = INPUTS[name]
    _compare(world[name], _jax_run(jring, inp, jmesh2), _ring_kwargs(name))
    assert bool(world[name]["dtype_f32"])  # f32 out, bf16 products or not
    if "ct" not in inp and "precision" not in inp:  # and the dense oracle
        kw = {k: inp[k] for k in ("causal", "scale") if k in inp}
        ref = attention_reference(
            *(jnp.asarray(inp[n]) for n in ("q", "k", "v")),
            causal=bool(kw.get("causal", False)),
            scale=float(kw["scale"]) if "scale" in kw else None)
        np.testing.assert_allclose(world[name]["out"], np.asarray(ref),
                                   rtol=3e-4, atol=3e-4)


@pytest.mark.parametrize("name", [n for n in INPUTS if n.startswith("ul_")])
def test_ulysses_matches_jax(world, jmesh2, name):
    inp = INPUTS[name]
    _compare(world[name], _jax_run(julysses, inp, jmesh2), _ring_kwargs(name))
    if name == "ul_vs_ring":  # the two strategies agree
        r = _jax_run(jring, inp, jmesh2)["out"]
        np.testing.assert_allclose(world[name]["out"], r, rtol=0,
                                   atol=ATTN_TOL * np.abs(r).max())


def test_ulysses_refuses_unbalanced_heads(world):
    assert bool(world["ulysses_refuses"]["refused"])
