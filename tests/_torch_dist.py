"""Spawned ``torch.distributed`` worlds on the CPU, for the port's multi-rank
parity tests.

``run_world(n, cases, inputs, tmp)`` starts ``n`` fresh Python processes
running this file, each a gloo rank of one world that meets through a
``FileStore`` under ``tmp`` (never a fixed port, so worlds of several test
files run side by side). Every rank runs the named cases in order — each a
function of this module taking its numpy inputs and returning a dict of
numpy arrays — and writes what it returns to ``tmp``. The parent waits with
a deadline, kills every rank if one fails or the deadline passes, and
returns rank 0's results, after checking every rank returned the same
arrays (the logical in/out contract) — except for keys starting with
``rank_``, which come back stacked over the ranks. The ranks import torch and the port
only, never jax; one thread each.

Run as a script, this file is one rank:
``python _torch_dist.py <rank> <world> <dir> <case>...``.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time
import traceback

import numpy as np

WORLD_DEADLINE_S = 240.0


def run_world(n: int, cases: list[str], inputs: dict, tmp) -> dict:
    """Run ``cases`` on every rank of an ``n``-rank gloo world; ``inputs``
    maps a case to its dict of arrays. Returns ``{case: {name: array}}``."""
    tmp = str(tmp)
    for case in cases:
        np.savez(os.path.join(tmp, f"in_{case}.npz"), **inputs.get(case, {}))
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root, OMP_NUM_THREADS="1",
               CUDA_VISIBLE_DEVICES="")
    env.pop("XLA_FLAGS", None)
    logs = [open(os.path.join(tmp, f"rank{r}.log"), "w") for r in range(n)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(r), str(n), tmp,
         *cases], env=env, stdout=logs[r], stderr=subprocess.STDOUT)
        for r in range(n)]
    deadline = time.monotonic() + WORLD_DEADLINE_S
    try:
        while any(p.poll() is None for p in procs):
            if time.monotonic() > deadline or any(
                    p.poll() not in (None, 0) for p in procs):
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for f in logs:
            f.close()
    if any(p.returncode != 0 for p in procs):
        text = "\n".join(
            f"--- rank {r} (rc {p.returncode}):\n" + open(
                os.path.join(tmp, f"rank{r}.log")).read()[-4000:]
            for r, p in enumerate(procs))
        raise RuntimeError(f"the {n}-rank world failed or passed its "
                           f"{WORLD_DEADLINE_S:.0f} s deadline:\n{text}")
    out = {}
    for case in cases:
        got = [dict(np.load(os.path.join(tmp, f"out{r}_{case}.npz")))
               for r in range(n)]
        for r in range(1, n):
            assert got[r].keys() == got[0].keys(), (case, r)
            for k in got[0]:
                if not k.startswith("rank_"):
                    np.testing.assert_array_equal(
                        got[r][k], got[0][k],
                        err_msg=f"{case}/{k}: rank {r} differs from rank 0")
        out[case] = {k: np.stack([g[k] for g in got])
                     if k.startswith("rank_") else v
                     for k, v in got[0].items()}
    return out


# ------------------------------------------------------------------ cases
# Each case runs on every rank with the same inputs and returns numpy
# arrays. ``t`` makes a CPU f32 tensor of an input.


def _t(x, grad=False):
    import torch

    out = torch.as_tensor(np.asarray(x))
    return out.requires_grad_(True) if grad else out


def _np(x):
    import torch

    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x)


def case_mesh(inp):
    """The mesh over ranks: default grid, coordinates, lines, groups, the
    sharding helpers' local blocks, and a shape that does not fill the
    world."""
    import torch

    from marlin_tpu_torch import mesh as mm

    m = mm.create_mesh()
    m41 = mm.create_mesh((4, 1))
    x = torch.arange(8 * 6, dtype=torch.float32).reshape(8, 6)
    try:
        mm.create_mesh((2, 1))
        refused = 0
    except ValueError:
        refused = 1
    grp = m.group("rows")
    return {
        "grid": np.array(m.grid), "world": np.array(mm.world_size()),
        "rank_coords": np.array([m.coords()[a] for a in m.axis_names]),
        "rank_line_rows": np.array(m.line("rows")),
        "rank_line_cols": np.array(m.line("cols")),
        "group_size": np.array(torch.distributed.get_world_size(grp)),
        "rank_rows_local": _np(mm.row_sharding(m41).local(x)),
        "rank_block_local": _np(mm.block_sharding(m).local(x)),
        "repl_local": _np(mm.replicated_sharding(m).local(x)),
        "mesh_shape": np.array(mm.mesh_shape(m)),
        "hashable": np.array(hash(m) == hash(mm.create_mesh())),
        "refused": np.array(refused),
    }


def _ring_matmul(inp, grid):
    from marlin_tpu_torch import mesh as mm
    from marlin_tpu_torch.parallel import ring_matmul

    return {"c": _np(ring_matmul(_t(inp["a"]), _t(inp["b"]),
                                 mm.create_mesh(grid)))}


def case_ring_even(inp):
    return _ring_matmul(inp, (4, 1))


def case_ring_uneven(inp):
    return _ring_matmul(inp, (4, 1))


def case_ring_2x2(inp):
    return _ring_matmul(inp, (2, 2))


def case_ring_strategy(inp):
    """``matmul(strategy="ring")`` reaches ``ring_matmul``."""
    import marlin_tpu_torch.parallel.ring as ring_mod
    from marlin_tpu_torch import mesh as mm
    from marlin_tpu_torch.parallel import matmul

    calls = []
    real = ring_mod.ring_matmul

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)

    ring_mod.ring_matmul = counted
    try:
        c = matmul(_t(inp["a"]), _t(inp["b"]), mm.create_mesh((4, 1)),
                   strategy="ring")
    finally:
        ring_mod.ring_matmul = real
    return {"c": _np(c), "calls": np.array(len(calls))}


def _rmm(inp):
    from marlin_tpu_torch.parallel import rmm_matmul

    split = tuple(int(s) for s in inp["split"]) if "split" in inp else None
    return {"c": _np(rmm_matmul(_t(inp["a"]), _t(inp["b"]), split))}


case_rmm_221 = case_rmm_122 = case_rmm_411 = case_rmm_auto = \
    case_rmm_uneven = case_rmm_subset = _rmm


def _broadcast(inp, replicate):
    from marlin_tpu_torch import mesh as mm
    from marlin_tpu_torch.parallel import broadcast_matmul

    return {"c": _np(broadcast_matmul(_t(inp["a"]), _t(inp["b"]),
                                      mm.create_mesh(), replicate))}


def case_broadcast_b(inp):
    return _broadcast(inp, "b")


def case_broadcast_a(inp):
    return _broadcast(inp, "a")


def case_gspmd(inp):
    from marlin_tpu_torch import mesh as mm
    from marlin_tpu_torch.parallel import gspmd_matmul

    return {"c": _np(gspmd_matmul(_t(inp["a"]), _t(inp["b"]),
                                  mm.create_mesh()))}


def case_auto(inp):
    """``matmul`` with the default dispatch on the default mesh."""
    from marlin_tpu_torch.parallel import matmul

    return {"c": _np(matmul(_t(inp["a"]), _t(inp["b"])))}


# ring and Ulysses attention: ``inp`` holds q, k, v, and optionally ct (a
# cotangent: the case then also returns the gradients of sum(out * ct)),
# with the call's knobs as 0-d arrays

def _attn(inp, fn):
    import torch

    from marlin_tpu_torch import mesh as mm

    mesh = mm.create_mesh((mm.world_size(), 1))
    kw = {}
    if "causal" in inp:
        kw["causal"] = bool(inp["causal"])
    if "scale" in inp:
        kw["scale"] = float(inp["scale"])
    if "backend" in inp:
        kw["backend"] = str(inp["backend"])
    if "precision" in inp:
        kw["precision"] = str(inp["precision"])
    grad = "ct" in inp
    q, k, v = (_t(inp[n], grad) for n in ("q", "k", "v"))
    out = fn(q, k, v, mesh, **kw)
    res = {"out": _np(out), "dtype_f32": np.array(out.dtype == torch.float32)}
    if grad:
        gq, gk, gv = torch.autograd.grad((out * _t(inp["ct"])).sum(),
                                         (q, k, v))
        res.update(gq=_np(gq), gk=_np(gk), gv=_np(gv))
    return res


def ring_case(inp):
    from marlin_tpu_torch.parallel import ring_attention

    return _attn(inp, ring_attention)


def ulysses_case(inp):
    from marlin_tpu_torch.parallel import ulysses_attention

    return _attn(inp, ulysses_attention)


def case_ulysses_refuses(inp):
    """heads that do not divide the axis raise, as in the reference."""
    from marlin_tpu_torch import mesh as mm
    from marlin_tpu_torch.parallel import ulysses_attention

    x = _t(np.zeros((3, 16, 8), np.float32))
    try:
        ulysses_attention(x, x, x, mm.create_mesh((mm.world_size(), 1)))
    except ValueError as e:
        return {"refused": np.array("heads" in str(e))}
    return {"refused": np.array(False)}


# the GPipe pipeline: ``inp`` holds the stacked stage params w (S, d, d),
# b (S, d), the input x, optionally a target y (then the case returns the
# gradients of mean((out - y)^2)), and microbatch (0: the default)

def _mlp_stage(p, x):
    import torch

    return torch.tanh(x @ p["w"] + p["b"])


def pipeline_case(inp):
    import torch

    from marlin_tpu_torch import mesh as mm
    from marlin_tpu_torch.parallel.pipeline import (pipeline_apply,
                                                    stack_stage_params)

    mesh = mm.create_mesh((mm.world_size(), 1))
    grad = "y" in inp
    w, b = _t(inp["w"], grad), _t(inp["b"], grad)
    stacked = stack_stage_params([{"w": w[s], "b": b[s]}
                                  for s in range(w.shape[0])], mesh)
    mb = int(inp["microbatch"]) or None
    x = _t(inp["x"], grad)
    out = pipeline_apply(stacked, _mlp_stage, x, mesh, microbatch=mb)
    res = {"out": _np(out)}
    if grad:
        loss = torch.mean((out - _t(inp["y"])) ** 2)
        gw, gb, gx = torch.autograd.grad(loss, (w, b, x))
        res.update(loss=_np(loss), gw=_np(gw), gb=_np(gb), gx=_np(gx))
    return res


def case_pipeline_train(inp):
    """Two SGD steps through the pipeline (lr 0.1): the losses."""
    import torch

    from marlin_tpu_torch import mesh as mm
    from marlin_tpu_torch.parallel.pipeline import pipeline_apply

    mesh = mm.create_mesh((mm.world_size(), 1))
    params = {"w": _t(inp["w"]), "b": _t(inp["b"])}
    x, y = _t(inp["x"]), _t(inp["y"])
    losses = []
    for _ in range(2):
        p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        loss = torch.mean((pipeline_apply(p, _mlp_stage, x, mesh,
                                          microbatch=4) - y) ** 2)
        g = torch.autograd.grad(loss, (p["w"], p["b"]))
        params = {k: p[k].detach() - 0.1 * gk
                  for k, gk in zip(("w", "b"), g)}
        losses.append(float(loss))
    return {"losses": np.array(losses)}


def case_pipeline_refuses(inp):
    from marlin_tpu_torch import mesh as mm
    from marlin_tpu_torch.parallel.pipeline import (split_microbatches,
                                                    stack_stage_params)

    x = _t(np.zeros((3, 8, 8), np.float32))
    msgs = []
    for call in (lambda: stack_stage_params([{"w": x[i]} for i in range(3)],
                                            mm.create_mesh((4, 1))),
                 lambda: split_microbatches(_t(np.zeros((10, 4))), 3)):
        try:
            call()
        except ValueError as e:
            msgs.append(str(e))
    return {"msgs": np.array(msgs)}


# the pipeline LM: ``inp`` holds the JAX package's init_transformer params
# flattened as "l0/wq", ..., "emb", "ln_f", the token batch, heads and
# microbatch (0: the default)

def _lm_params(inp):
    params = {}
    for key, val in inp.items():
        if "/" in key or key in ("emb", "ln_f"):
            node = params
            *path, leaf = key.split("/")
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = _t(val)
    return params


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: _np(tree)}


def pp_case(inp):
    """pp_lm_loss, its gradients, and (with ``steps``) that many
    pp_lm_train_step losses (Adam at ``lr``)."""
    import torch

    from marlin_tpu_torch import mesh as mm
    from marlin_tpu_torch.models import pipeline_lm as pl
    from marlin_tpu_torch.models import transformer as tt

    mesh = mm.create_mesh((mm.world_size(), 1))
    heads = int(inp["heads"])
    mb = int(inp["microbatch"]) or None
    toks = inp["tokens"]
    sp, outer = pl.pp_stage_params(_lm_params(inp), mesh)
    tree = tt._tree_map(lambda p: p.detach().requires_grad_(True),
                        (sp, outer))
    loss = pl.pp_lm_loss(tree[0], tree[1], toks, mesh, heads=heads,
                         microbatch=mb)
    grads = torch.autograd.grad(loss, tt._leaves(tree))
    it = iter(grads)
    g = tt._tree_map(lambda _: next(it), tree)
    res = {"loss": _np(loss)}
    res.update({f"gsp/{k}": v for k, v in _flat(g[0]).items()})
    res.update({f"gouter/{k}": v for k, v in _flat(g[1]).items()})
    steps = int(inp.get("steps", 0))
    if steps:
        state = tt.adam_init((sp, outer))
        losses = []
        for _ in range(steps):
            sp, outer, state, l = pl.pp_lm_train_step(
                sp, outer, state, toks, mesh, heads=heads, microbatch=mb,
                lr=float(inp["lr"]))
            losses.append(float(l))
        res["losses"] = np.array(losses)
    return res


def case_pp_refuses_long_grad(inp):
    """At 2048 tokens the stage attention is the flash forward: with
    gradients wanted pp_lm_loss raises; without, it runs."""
    import torch

    from marlin_tpu_torch import mesh as mm
    from marlin_tpu_torch.models import pipeline_lm as pl

    mesh = mm.create_mesh((mm.world_size(), 1))
    params = _lm_params(inp)
    sp, outer = pl.pp_stage_params(params, mesh)
    toks = inp["tokens"]
    with torch.no_grad():
        loss = pl.pp_lm_loss(sp, outer, toks, mesh, heads=2, microbatch=1)
    leaf = sp["wq"].detach().requires_grad_(True)
    try:
        pl.pp_lm_loss(dict(sp, wq=leaf), outer, toks, mesh, heads=2,
                      microbatch=1)
        raised = ""
    except NotImplementedError as e:
        raised = str(e)
    return {"loss": _np(loss), "raised": np.array(raised)}


def case_pp_cli(inp):
    """The pipeline_training CLI on every rank, with the JAX package's
    initial params (``inp``) in place of the port's draws."""
    import contextlib
    import io

    from marlin_tpu_torch.examples import pipeline_training
    from marlin_tpu_torch.models import transformer as tt

    params = _lm_params(inp)
    real = tt.init_transformer
    tt.init_transformer = lambda *a, **k: params
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            losses = pipeline_training.main(
                [str(int(a)) for a in inp["argv"]])
    finally:
        tt.init_transformer = real
    lines = buf.getvalue().splitlines()
    return {"losses": np.array(losses), "first": np.array(lines[0]),
            "loss_line": np.array(lines[1])}


for _name in ("dense", "causal", "uneven", "uneven_causal", "multihead",
              "scale", "tile_pad", "flash", "flash_causal", "flash_multihead",
              "flash_odd", "bf16_xla", "bf16_flash", "grad_xla", "grad_flash",
              "grad_uneven", "batched", *(f"sweep{i}" for i in range(12))):
    globals()[f"case_ra_{_name}"] = ring_case
for _name in ("dense", "causal", "uneven", "bf16", "scale", "grad",
              "grad_uneven", "batched", "vs_ring"):
    globals()[f"case_ul_{_name}"] = ulysses_case
for _name in ("pipeline_seq", "pipeline_default_mb", "pipeline_mb1",
              "pipeline_grad"):
    globals()[f"case_{_name}"] = pipeline_case
for _name in ("pp_loss", "pp_gqa", "pp_flagship", "pp_grad", "pp_train"):
    globals()[f"case_{_name}"] = pp_case


def _rank_main(rank: int, world: int, tmp: str, cases: list[str]) -> None:
    import torch

    torch.set_num_threads(1)
    from marlin_tpu_torch import config_context
    from marlin_tpu_torch import mesh as mm

    with config_context(device="cpu"):
        mm.initialize_distributed(f"file://{os.path.join(tmp, 'store')}",
                                  world, rank, device="cpu")
        try:
            for case in cases:
                inp = dict(np.load(os.path.join(tmp, f"in_{case}.npz")))
                out = globals()[f"case_{case}"](inp)
                np.savez(os.path.join(tmp, f"out{rank}_{case}.npz"), **out)
        finally:
            mm.shutdown_distributed()


if __name__ == "__main__":
    try:
        _rank_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                   sys.argv[4:])
    except BaseException:
        traceback.print_exc()
        sys.stdout.flush()
        os._exit(1)
    sys.stdout.flush()
    os._exit(0)
