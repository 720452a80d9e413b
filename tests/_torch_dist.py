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


def case_peers(inp):
    """What each rank receives along each axis of a (2, 2) and a (4, 1)
    mesh: a ring step (``ring_send_recv``), the non-wrapping shift both
    ways, and an all-to-all, each of a tensor holding the sender's rank;
    with each axis group's global ranks."""
    import torch
    import torch.distributed as dist

    import marlin_tpu_torch.parallel.collectives as col
    from marlin_tpu_torch import mesh as mm

    me = dist.get_rank()
    out = {}
    for grid in ((2, 2), (4, 1)):
        m = mm.create_mesh(grid)
        for axis in m.axis_names:
            if m.shape[axis] == 1:
                continue
            tag = f"{grid[0]}{grid[1]}_{axis}"
            mine = torch.full((3,), float(me))
            got = col.finish(*col.ring_send_recv([mine, mine + 100], m, axis))
            out[f"rank_ring_{tag}"] = np.array([float(g[0]) for g in got])
            out[f"rank_fwd_{tag}"] = np.array(
                float(col._shift(mine, m, axis, 1)[0]))
            out[f"rank_back_{tag}"] = np.array(
                float(col._shift(mine, m, axis, -1)[0]))
            p = m.shape[axis]
            sent = torch.stack([mine * 10 + j for j in range(p)])
            out[f"rank_a2a_{tag}"] = _np(col._all_to_all(sent, m, axis)[:, 0])
            out[f"rank_group_{tag}"] = np.array(
                dist.get_process_group_ranks(m.group(axis)))
    return out


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


# the pipeline composed with tensor parallelism on a (2, 2) rank mesh:
# stages over "rows", stage weights split over "cols"

def _pptp_mesh():
    from marlin_tpu_torch import mesh as mm

    return mm.create_mesh((2, 2))


def _mlp2_stage(p, x):
    """tests/test_pipeline.py's two-matrix stage, whole."""
    import torch

    return torch.tanh(torch.relu(x @ p["w0"]) @ p["w1"])


def _tp_mlp2_stage(mesh):
    """The same stage on this rank's blocks: ``w0``'s columns and ``w1``'s
    rows over "cols", the activation collectives its own."""
    import torch

    from marlin_tpu_torch.parallel import collectives as col

    def stage(p, x):
        h = torch.relu(col.Replicate.apply(x, mesh, "cols") @ p["w0"])
        return torch.tanh(col.AllReduce.apply(h @ p["w1"], mesh, "cols"))
    return stage


class _CollectiveLog:
    """Record every ``torch.distributed`` call the collectives layer makes
    while entered: its name and its group's ranks (point-to-point calls:
    their ops and peers)."""

    NAMES = ("all_reduce", "all_gather", "all_to_all_single",
             "batch_isend_irecv")

    def __enter__(self):
        import torch.distributed as dist

        self.calls, self.real = [], {n: getattr(dist, n) for n in self.NAMES}

        def wrap(name, fn):
            def call(*args, **kw):
                if name == "batch_isend_irecv":
                    what = [f"{op.op.__name__}:{op.peer}" for op in args[0]]
                else:
                    group = kw.get("group")
                    what = [str(r) for r in dist.get_process_group_ranks(
                        group)] if group is not None else ["world"]
                self.calls.append(f"{name}({','.join(what)})")
                return fn(*args, **kw)
            return call
        for n, fn in self.real.items():
            setattr(dist, n, wrap(n, fn))
        return self

    def __exit__(self, *exc):
        import torch.distributed as dist

        for n, fn in self.real.items():
            setattr(dist, n, fn)


def case_pptp_mlp(inp):
    """The two-matrix stage with w0 split by columns and w1 by rows over
    "cols": the output, and the gradients of mean((out - y)^2)."""
    import torch

    from marlin_tpu_torch.mesh import Sharding
    from marlin_tpu_torch.parallel import pipeline_apply

    mesh = _pptp_mesh()
    w0, w1, x = (_t(inp[k], True) for k in ("w0", "w1", "x"))
    place = {"w0": Sharding(mesh, ("rows", None, "cols")),
             "w1": Sharding(mesh, ("rows", "cols", None))}
    out = pipeline_apply({"w0": w0, "w1": w1}, _tp_mlp2_stage(mesh), x, mesh,
                         microbatch=int(inp["microbatch"]), placement=place)
    loss = torch.mean((out - _t(inp["y"])) ** 2)
    gw0, gw1, gx = torch.autograd.grad(loss, (w0, w1, x))
    return {"out": _np(out), "loss": _np(loss), "gw0": _np(gw0),
            "gw1": _np(gw1), "gx": _np(gx)}


def case_pptp_unsplit(inp):
    """The whole stage on the (2, 2) mesh, with no placement and with one
    that names no split: outputs, gradients and the collectives each call
    issues (forward and backward), and the stages applied in sequence to
    each microbatch."""
    import torch

    from marlin_tpu_torch.mesh import Sharding
    from marlin_tpu_torch.parallel import pipeline_apply

    mesh = _pptp_mesh()
    mb = int(inp["microbatch"])
    res = {}
    for tag, place in (("none", None),
                       ("unsplit", {"w0": Sharding(mesh, ("rows",)),
                                    "w1": Sharding(mesh, ("rows", None))})):
        w0, w1, x = (_t(inp[k], True) for k in ("w0", "w1", "x"))
        with _CollectiveLog() as log:
            out = pipeline_apply({"w0": w0, "w1": w1}, _mlp2_stage, x, mesh,
                                 microbatch=mb, placement=place)
            loss = torch.mean((out - _t(inp["y"])) ** 2)
            grads = torch.autograd.grad(loss, (w0, w1, x))
        res.update({f"out_{tag}": _np(out), f"rank_log_{tag}":
                    np.array(log.calls)})
        res.update({f"{k}_{tag}": _np(g) for k, g in zip(("gw0", "gw1", "gx"),
                                                          grads)})
    w0, w1, x = (_t(inp[k]) for k in ("w0", "w1", "x"))
    seq = []
    for xs in x.split(mb):
        for s in range(w0.shape[0]):
            xs = _mlp2_stage({"w0": w0[s], "w1": w1[s]}, xs)
        seq.append(xs)
    res["seq"] = _np(torch.cat(seq))
    return res


def pptp_lm_case(inp):
    """pp_lm_loss with the stage weights split the Megatron way over
    "cols", and (with ``steps``) its gradients, that many pp_lm_train_step
    losses and the params after them."""
    import torch

    from marlin_tpu_torch.models import pipeline_lm as pl
    from marlin_tpu_torch.models import transformer as tt

    mesh = _pptp_mesh()
    heads, mb, toks = int(inp["heads"]), int(inp["microbatch"]), \
        inp["tokens"]
    sp, outer = pl.pp_stage_params(_lm_params(inp), mesh)
    place = pl.pp_tp_placement(mesh)
    steps = int(inp.get("steps", 0))
    tree = tt._tree_map(lambda p: p.detach().requires_grad_(steps > 0),
                        (sp, outer))
    loss = pl.pp_lm_loss(tree[0], tree[1], toks, mesh, heads=heads,
                         microbatch=mb, placement=place)
    res = {"loss": _np(loss)}
    if steps:
        it = iter(torch.autograd.grad(loss, tt._leaves(tree)))
        g = tt._tree_map(lambda _: next(it), tree)
        res.update({f"gsp/{k}": v for k, v in _flat(g[0]).items()})
        res.update({f"gouter/{k}": v for k, v in _flat(g[1]).items()})
        state = tt.adam_init((sp, outer))
        losses = []
        for _ in range(steps):
            sp, outer, state, l = pl.pp_lm_train_step(
                sp, outer, state, toks, mesh, heads=heads, microbatch=mb,
                lr=float(inp["lr"]), placement=place)
            losses.append(float(l))
        res["losses"] = np.array(losses)
        res.update({f"sp/{k}": v for k, v in _flat(sp).items()})
        res.update({f"outer/{k}": v for k, v in _flat(outer).items()})
    return res


def case_pptp_long(inp):
    """At 2048 tokens, with no gradients: the split loss and the unsplit
    one; with a gradient wanted, the refusal under the placement."""
    import torch

    from marlin_tpu_torch.models import pipeline_lm as pl

    mesh = _pptp_mesh()
    sp, outer = pl.pp_stage_params(_lm_params(inp), mesh)
    place = pl.pp_tp_placement(mesh)
    toks = inp["tokens"]
    with torch.no_grad():
        split = pl.pp_lm_loss(sp, outer, toks, mesh, heads=2,
                              placement=place)
        whole = pl.pp_lm_loss(sp, outer, toks, mesh, heads=2)
    leaf = sp["wq"].detach().requires_grad_(True)
    try:
        pl.pp_lm_loss(dict(sp, wq=leaf), outer, toks, mesh, heads=2,
                      placement=place)
        raised = ""
    except NotImplementedError as e:
        raised = str(e)
    return {"split": _np(split), "whole": _np(whole),
            "raised": np.array(raised)}


# the sequence-sharded trainer: ``inp`` holds the JAX package's params
# (flattened as above), the stream, ``steps`` and ``knobs`` (the
# TransformerLM fields, JSON); the mesh is (world, 1)

def _knobs(inp):
    import json

    return json.loads(str(inp["knobs"]))


def lm_train_case(inp):
    """TransformerLM.train over the ranks: the losses and the final params
    (whole, on every rank)."""
    from marlin_tpu_torch import mesh as mm
    from marlin_tpu_torch.models import transformer as tt

    mesh = mm.create_mesh((mm.world_size(), 1))
    lm = tt.TransformerLM(**_knobs(inp))
    params, losses = lm.train(inp["tokens"], steps=int(inp["steps"]),
                              mesh=mesh, params=_lm_params(inp))
    out = {"losses": np.array(losses)}
    out.update({f"p/{k}": v for k, v in _flat(params).items()})
    return out


def case_lm_shards(inp):
    """What each rank holds in one training step's forward: the rows of the
    residual stream each block sees, the attention's q/k/v panels, the
    experts, and every all_gather_cat the forward made; with the loss and
    transformer_forward's (gathered) logits."""
    import torch

    import marlin_tpu_torch.parallel.collectives as col
    from marlin_tpu_torch import mesh as mm
    from marlin_tpu_torch.models import moe as tm
    from marlin_tpu_torch.models import transformer as tt

    mesh = mm.create_mesh((mm.world_size(), 1))
    knobs = _knobs(inp)
    lm = tt.TransformerLM(**knobs)
    params = tm.shard_moe_params(_lm_params(inp), mesh)
    seen = {"block": [], "panel": [], "gather": []}
    real = (tt._block, tt.ring_attention_shard, tt.ulysses_attention_shard,
            col.all_gather_cat)

    def block(lp, x, *a, **k):
        seen["block"].append(x.shape)
        return real[0](lp, x, *a, **k)

    def attention(fn):
        def run(q, k, v, *a, **kw):
            seen["panel"].append(q.shape + k.shape + v.shape)
            return fn(q, k, v, *a, **kw)
        return run

    def gather(x, *a, **k):
        seen["gather"].append(x.shape)
        return real[3](x, *a, **k)

    tt._block = block
    tt.ring_attention_shard = attention(real[1])
    tt.ulysses_attention_shard = attention(real[2])
    col.all_gather_cat = gather
    try:
        leaves = tt._tree_map(lambda t: t.detach().requires_grad_(True),
                              params)
        loss = tt.lm_loss(leaves, inp["tokens"], mesh, lm.heads, lm.attn,
                          lm.remat, moe=lm._moe())
        forward_gathers = list(seen["gather"])
        torch.autograd.grad(loss, tt._leaves(leaves))
    finally:
        (tt._block, tt.ring_attention_shard, tt.ulysses_attention_shard,
         col.all_gather_cat) = real
    with torch.no_grad():
        logits = tt.transformer_forward(params, inp["tokens"][:-1], mesh,
                                        lm.heads, lm.attn, moe=lm._moe())
    out = {"rank_block": np.array(seen["block"]),
           "rank_panel": np.array(seen["panel"]),
           "rank_forward_gathers": np.array(len(forward_gathers)),
           "loss": _np(loss), "logits": _np(logits)}
    if lm.n_experts:
        out["rank_w1"] = np.array(params["l0"]["moe"]["w1"].shape)
    return out


def case_moe_ffn(inp):
    """moe_ffn under the logical contract on the rank mesh: this rank's
    experts (shard_moe_params), every token on every rank; the output, the
    aux and the gradients of sum(out * ct) + aux (the experts' gathered)."""
    import torch

    import marlin_tpu_torch.parallel.collectives as col
    from marlin_tpu_torch import mesh as mm
    from marlin_tpu_torch.models import moe as tm

    mesh = mm.create_mesh((mm.world_size(), 1))
    mp = tm.shard_moe_params({k: _t(inp[k]) for k in ("wg", "w1", "w2")},
                             mesh)
    mp = {k: v.requires_grad_(True) for k, v in mp.items()}
    x = _t(inp["x"], True)
    out, aux = tm.moe_ffn(mp, x, mesh=mesh, top_k=2,
                          group_size=int(inp["group"]))
    g = torch.autograd.grad((out * _t(inp["ct"])).sum() + aux,
                            (x, mp["wg"], mp["w1"], mp["w2"]))
    return {"out": _np(out), "aux": _np(aux), "gx": _np(g[0]),
            "gwg": _np(g[1]), "rank_w1": np.array(mp["w1"].shape),
            "gw1": _np(col.all_gather_cat(g[2], mesh, "rows", 0)),
            "gw2": _np(col.all_gather_cat(g[3], mesh, "rows", 0))}


def _cli(module, inp, params=None):
    """A CLI's main on every rank (``inp["argv"]``), its return value and
    its printed lines; with ``params`` the model's init returns them."""
    import contextlib
    import importlib
    import io

    from marlin_tpu_torch.models import transformer as tt

    main = importlib.import_module(
        f"marlin_tpu_torch.examples.{module}").main
    real = tt.init_transformer
    if params is not None:
        tt.init_transformer = lambda *a, **k: params
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            got = main([str(a) for a in inp["argv"]])
    finally:
        tt.init_transformer = real
    return got, buf.getvalue().splitlines()


def case_lct_cli(inp):
    losses, lines = _cli("long_context_training", inp, _lm_params(inp))
    return {"losses": np.array(losses), "rank_lines": np.array(lines)}


def case_moe_cli(inp):
    losses, lines = _cli("moe_training", inp, _lm_params(inp))
    return {"losses": np.array(losses), "rank_lines": np.array(lines)}


# the ML workloads on the default mesh over the ranks (best_grid: (2, 2)
# at four ranks)

def case_nn_cli(inp):
    """The distributed_training CLI: its printed lines and the step losses
    its EventLog holds (in this rank's directory)."""
    import json
    import tempfile

    import torch

    d = tempfile.mkdtemp()
    _, lines = _cli("distributed_training", {"argv": [*inp["argv"], d]})
    rank = torch.distributed.get_rank()
    with open(os.path.join(d, f"rank{rank}", "events.jsonl")) as f:
        losses = [json.loads(ln)["loss"] for ln in f
                  if json.loads(ln)["kind"] == "step"]
    return {"rank_lines": np.array(lines), "losses": np.array(losses),
            "rank_dirs": np.array(sorted(os.listdir(d)))}


def case_nn_step(inp):
    """train_step on the default (dp, tp) mesh: ``steps`` SGD steps of a
    model of ``sizes`` (3 layers: the last layer's columns are cut)."""
    import torch

    import importlib

    from marlin_tpu_torch.mesh import default_mesh

    nn = importlib.import_module("marlin_tpu_torch.ml.neural_network")

    mesh = default_mesh()
    params = {k: _t(inp[k]) for k in sorted(inp) if k.startswith("w")}
    x, y = _t(inp["x"]), _t(inp["y"])
    losses = []
    for i in range(int(inp["steps"])):
        params, loss = nn.train_step(params, x, y, i, int(inp["batch"]), 0.5,
                                     activation="tanh", mesh=mesh)
        losses.append(float(loss))
    out = {k: _np(v) for k, v in params.items()}
    out["losses"] = np.array(losses)
    return out


def _als(inp, **kw):
    import marlin_tpu_torch as tm

    coo = tm.CoordinateMatrix(inp["users"], inp["items"], inp["vals"],
                              shape=tuple(int(n) for n in inp["shape"]))
    model = coo.als(rank=4, iterations=5, lam=0.05, shard=True,
                    segment_block=8, **kw)
    return {"u": model.user_features.to_numpy(),
            "v": model.product_features.to_numpy(),
            "rmse": np.array(model.rmse(coo))}


def case_als_explicit(inp):
    return _als(inp)


def case_als_implicit(inp):
    return _als(inp, implicit_prefs=True, alpha=5.0)


def case_pagerank(inp):
    """The edge-sharded operator on the default mesh: the ranks, and this
    rank's run of the padded edges."""
    import importlib

    from marlin_tpu_torch.mesh import default_mesh

    pr = importlib.import_module("marlin_tpu_torch.ml.pagerank")
    op = pr.build_transition_operator(inp["edges"], n=int(inp["n"]),
                                      mesh=default_mesh())
    return {"ranks": pr.pagerank(op, iterations=int(inp["iters"])),
            "rank_edges": np.array(op.src.shape[0]),
            "rank_weight": _np(op.weight.sum())}


# the matrices across ranks: ``inp`` holds the numpy operands; a case
# returns each rank's block under a ``rank_`` key and the gathered result

def _mats(inp, grid=(2, 2)):
    import marlin_tpu_torch as tm
    from marlin_tpu_torch import mesh as mm

    mesh = mm.create_mesh(grid)
    return tm, mesh


def _blocks(prefix, mat):
    return {f"rank_{prefix}": _np(mat.data), prefix: mat.to_numpy()}


def case_dm_layout(inp):
    """from_array, random, zeros/ones and the vector factories on the (2, 2)
    and (4, 1) meshes: each rank's block and the gathered matrix."""
    tm, m22 = _mats(inp)
    from marlin_tpu_torch import mesh as mm

    m41 = mm.create_mesh((4, 1))
    a = inp["a"]
    out = {}
    for tag, mesh in (("22", m22), ("41", m41)):
        out.update(_blocks(f"vec{tag}", tm.DenseVecMatrix.from_array(a, mesh)))
        out.update(_blocks(f"blk{tag}", tm.BlockMatrix.from_array(a, mesh)))
        out.update(_blocks(f"uni{tag}", tm.DenseVecMatrix.random(
            7, 10, 7, mesh=mesh, minval=-2.0, maxval=3.0)))
        out.update(_blocks(f"buni{tag}", tm.BlockMatrix.random(7, 10, 7,
                                                               mesh=mesh)))
        out.update(_blocks(f"nrm{tag}", tm.BlockMatrix.random(
            5, 9, 6, dist="normal", mesh=mesh)))
        out[f"poi{tag}"] = tm.DenseVecMatrix.random(
            3, 9, 5, dist="poisson", lam=4.0, mesh=mesh).to_numpy()
        out.update(_blocks(f"ones{tag}", tm.BlockMatrix.ones(5, 3,
                                                             mesh=mesh)))
        v = tm.DistributedVector.from_array(inp["v"], mesh)
        out[f"rank_dv{tag}"] = _np(v.data)
        out[f"dv{tag}"] = v.to_numpy()
        r = tm.DistributedVector.random(11, 9, mesh=mesh)
        out[f"rank_rv{tag}"] = _np(r.data)
        out[f"rv{tag}"] = r.to_numpy()
    return out


def case_dm_ops(inp):
    """Elementwise ops over mixed layouts, reductions, norms, the
    structure ops and the vector ops on the (2, 2) mesh."""
    import torch

    tm, mesh = _mats(inp)
    a = tm.DenseVecMatrix.from_array(inp["a"], mesh)
    ab = tm.BlockMatrix.from_array(inp["a2"], mesh)
    c = tm.BlockMatrix.from_array(inp["c"], mesh)
    out = {}
    out.update(_blocks("add", a.add(ab)))
    out.update(_blocks("sub", ab.subtract(a)))
    out.update(_blocks("div", a.divide(ab)))
    out.update(_blocks("had", a.dot_product(inp["a2"])))
    out.update(_blocks("sadd", a.add(1.5)))
    out.update(_blocks("sdivby", ab.divide_by(2.0)))
    out.update(_blocks("scale", ab.multiply(3.0)))
    out["sum"] = _np(a.sum())
    for mode in ("1", "inf", "fro", "2"):
        out[f"norm_{mode}"] = _np(ab.norm(mode))
        out[f"vnorm_{mode}"] = _np(a.norm(mode))
    out.update(_blocks("t", a.transpose()))
    out.update(_blocks("tb", ab.transpose()))
    out.update(_blocks("cbind", a.c_bind(c)))
    out.update(_blocks("rbind", ab.r_bind(inp["a"])))
    out.update(_blocks("srow", a.slice_by_row(3, 8)))
    out.update(_blocks("scol", ab.slice_by_column(2, 5)))
    out.update(_blocks("sub_m", a.get_sub_matrix(1, 8, 2, 6)))
    out.update(_blocks("rrow", ab.repeat_by_row(3)))
    out.update(_blocks("rcol", a.repeat_by_column(2)))
    out.update(_blocks("toblk", a.to_block_matrix()))
    out.update(_blocks("tovec", ab.to_dense_vec_matrix()))
    out.update(_blocks("reshard", a.reshard(("cols", "rows"))))
    out.update(_blocks("rowx", ab.row_exchange(inp["perm"])))
    out.update(_blocks("gram", ab.gramian()))
    out.update(_blocks("gramv", a.gramian()))
    out.update(_blocks("mulby", ab.multiply_by(inp["l"])))
    mv = a.multiply_vector(inp["x"])
    out["rank_mv"], out["mv"] = _np(mv.data), mv.to_numpy()
    mg = ab.multiply_gramian_by(inp["x"])
    out["rank_mg"], out["mg"] = _np(mg.data), mg.to_numpy()
    u = tm.DistributedVector.from_array(inp["u"], mesh)
    w = tm.DistributedVector.from_array(inp["w"], mesh)
    out["dot"] = _np(u.dot(w))
    out["vsum"] = _np(u.sum())
    out["vnorm"] = _np(u.norm())
    out["vnorm1"] = _np(u.norm(1))
    out["vnorminf"] = _np(u.norm(float("inf")))
    out.update(_blocks("outer", u.multiply(w.transpose())))
    out["inner"] = _np(u.transpose().multiply(w))
    out["rank_vadd"] = _np(u.add(w).data)
    got = ab[2:7, 1:5]
    out.update(_blocks("getitem", got))
    out["getrow"] = _np(ab[3, :])
    out["dtype_kept"] = np.array(a.add(ab).data.dtype == torch.float32)
    return out


def case_dm_multiply(inp):
    """``a.multiply(b)`` by every strategy on the (2, 2) mesh: the blocks
    of C and C gathered; with, for the RMM, the element counts every
    all-gather and all-to-all received."""
    import torch.distributed as dist

    tm, mesh = _mats(inp)
    a = tm.DenseVecMatrix.from_array(inp["a"], mesh)
    b = tm.BlockMatrix.from_array(inp["b"], mesh)
    out = {}
    runs = {"rmm221": dict(strategy="rmm", split=(2, 2, 1)),
            "rmm122": dict(strategy="rmm", split=(1, 2, 2)),
            "rmm411": dict(strategy="rmm", split=(4, 1, 1)),
            "rmm_auto": dict(strategy="rmm"), "auto": {},
            "gspmd": dict(strategy="gspmd"),
            "broadcast": dict(strategy="broadcast"),
            "broadcast_a": dict(strategy="broadcast_a"),
            "ring": dict(strategy="ring"), "tuned": dict(strategy="tuned"),
            "subset": dict(strategy="rmm", split=(1, 1, 2))}
    real = (dist.all_gather, dist.all_to_all_single, dist.all_reduce)
    for tag, kw in runs.items():
        seen = []

        def gather(parts, t, *x, **k):
            seen.append(sum(p.numel() for p in parts))
            return real[0](parts, t, *x, **k)

        def a2a(o, i, *x, **k):  # bytes of float32 elements
            seen.append(o.numel() // 4)
            return real[1](o, i, *x, **k)

        def reduce(t, *x, **k):
            seen.append(t.numel())
            return real[2](t, *x, **k)

        dist.all_gather, dist.all_to_all_single, dist.all_reduce = \
            gather, a2a, reduce
        try:
            c = a.multiply(b, **kw)
        finally:
            dist.all_gather, dist.all_to_all_single, dist.all_reduce = real
        out.update(_blocks(tag, c))
        out[f"rank_moved_{tag}"] = np.array(max(seen or [0]))
    c = a.multiply(inp["b"], strategy="broadcast")
    out.update(_blocks("dense_b", c))
    return out


SPAN_NAMES = ("marlin.multiply", "marlin.rmm.fetch", "marlin.rmm.product",
              "marlin.rmm.reduce", "marlin.rmm.place", "marlin.remap.plan",
              "marlin.remap.exchange")


def case_dm_spans(inp):
    """``a.multiply(b)`` by the RMM on the (4, 1) mesh of row blocks, under
    ``torch.profiler``: each rank's count of every span of ``SPAN_NAMES``,
    and of its ``marlin.remap.*`` spans, how many lie inside
    ``marlin.rmm.fetch``, inside ``marlin.rmm.place`` and inside neither."""
    from torch.profiler import ProfilerActivity, profile

    import marlin_tpu_torch as tm
    from marlin_tpu_torch import mesh as mm

    mesh = mm.create_mesh((4, 1))
    a = tm.DenseVecMatrix.from_array(inp["a"], mesh)
    b = tm.DenseVecMatrix.from_array(inp["b"], mesh)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        c = a.multiply(b, strategy="rmm", split=(2, 2, 1))
    ev = [(e.time_range.start, e.time_range.end, e.name)
          for e in prof.events() if e.name.startswith("marlin.")]

    def within(s, e, name):
        return any(n == name and s0 <= s and e <= e0 for s0, e0, n in ev)

    remaps = [(s, e) for s, e, n in ev if n.startswith("marlin.remap.")]
    fetch = sum(within(s, e, "marlin.rmm.fetch") for s, e in remaps)
    place = sum(within(s, e, "marlin.rmm.place") for s, e in remaps)
    return {"rank_counts": np.array([sum(n == name for _, _, n in ev)
                                     for name in SPAN_NAMES]),
            "rank_remap_in": np.array([fetch, place,
                                       len(remaps) - fetch - place]),
            "c": c.to_numpy()}


def case_dm_io(inp):
    """The text saves (row, block, description) into ``dir``, the loaders
    of files the JAX package wrote (row, block, SVM), a chunk store read
    onto the ranks, the sparse and MTUtils conversions, and the sparse
    products of ``to_sparse_vec_matrix(tol)`` by the rank-local ``sb``:
    each rank's block (the sparse triplets whole)."""
    import marlin_tpu_torch.utils.mtutils as mu
    from marlin_tpu_torch import io as tio
    from marlin_tpu_torch.io.chunkstore import ChunkStore
    from marlin_tpu_torch.matrix.out_of_core import OutOfCoreMatrix

    tm, mesh = _mats(inp)
    d = str(inp["dir"])
    a = tm.DenseVecMatrix.from_array(inp["a"], mesh)
    b = tm.BlockMatrix.from_array(inp["a"], mesh)
    a.save_to_file_system(os.path.join(d, "port_rows.txt"))
    b.save_to_file_system(os.path.join(d, "port_blocks.txt"), fmt="block")
    a.save_with_description(os.path.join(d, "desc", "port_desc.txt"))
    out = {}
    out.update(_blocks("rows", tio.load_matrix_file(str(inp["rows"]), mesh)))
    out.update(_blocks("blocks", tio.load_block_matrix_file(
        str(inp["blocks"]), mesh)))
    out.update(_blocks("svm", tio.load_svm_den_vec_matrix(
        str(inp["svm"]), int(inp["svm_len"]), mesh)))
    with ChunkStore(str(inp["store"])) as store:
        out.update(_blocks("store", OutOfCoreMatrix(store)
                           .to_dense_vec_matrix(mesh)))
    coo = tm.CoordinateMatrix(inp["ci"], inp["cj"], inp["cv"],
                              shape=tuple(int(x) for x in inp["cshape"]))
    out.update(_blocks("coo_vec", coo.to_dense_vec_matrix(mesh)))
    out.update(_blocks("coo_blk", coo.to_block_matrix(mesh)))
    out.update(_blocks("mtu", mu.array_to_matrix(inp["a"], "block", mesh)))
    # the dense -> sparse conversion of a rank-local matrix (whole triplets
    # on every rank), and its product by a rank-local operand in each format
    sp = a.to_sparse_vec_matrix(float(inp["tol"]))
    for name, arr in zip(("sp_rows", "sp_cols", "sp_vals"),
                         sp._coo_triplets()):
        out[name] = np.asarray(arr)
    operand = tm.DenseVecMatrix.from_array(inp["sb"], mesh)
    for fmt in ("bcoo", "ell", "bsr"):
        out.update(_blocks(f"spmm_{fmt}", sp.multiply(operand, format=fmt)))
    return out


# sharded checkpoints across ranks: ``inp`` holds the matrix, the
# directories and the world's mesh grid

def _grid(inp):
    from marlin_tpu_torch import mesh as mm

    return mm.create_mesh(tuple(int(g) for g in inp["grid"]))


def case_ck_save(inp):
    """save_sharded of a BlockMatrix from every rank: its block and the
    file names this rank wrote."""
    import marlin_tpu_torch as tm
    from marlin_tpu_torch.io.checkpoint import save_sharded

    mat = tm.BlockMatrix.from_array(inp["a"], _grid(inp))
    integ = save_sharded(mat, str(inp["dir"]))
    return {"rank_block": _np(mat.data),
            "rank_files": np.array(sorted(integ))}


def case_ck_load(inp):
    """load_sharded of a saved (padded) array onto this world's mesh, by
    rows and by blocks: this rank's regions."""
    from marlin_tpu_torch.io.checkpoint import load_sharded
    from marlin_tpu_torch.mesh import Sharding

    mesh = _grid(inp)
    d = str(inp["dir"])
    return {"rank_rows": _np(load_sharded(d, Sharding(mesh, ("rows", None)))),
            "rank_blocks": _np(load_sharded(d, Sharding(mesh,
                                                        ("rows", "cols"))))}


def _elastic(inp, steps, fresh):
    import marlin_tpu_torch as tm
    from marlin_tpu_torch.utils.failure import ResilientLoop

    mesh = _grid(inp)
    target = tm.DenseVecMatrix.from_array(inp["target"], mesh)
    m, n = target.shape

    def step_fn(state, i):
        w = state["w"]
        w2 = w.subtract(w.subtract(target).multiply(0.25))
        d = w2.subtract(target)
        return {"w": w2, "bias": state["bias"] + 1.0}, \
            float(d.dot_product(d).sum()) / (m * n)

    w0 = {"w": tm.DenseVecMatrix.zeros(m, n, mesh=mesh),
          "bias": np.zeros((3,), np.float32)}
    if fresh:
        state, metrics = w0, []
        for i in range(steps):
            state, loss = step_fn(state, i)
            metrics.append(loss)
        return {"metrics": np.array(metrics),
                "w": state["w"].to_numpy()}
    loop = ResilientLoop(step_fn, str(inp["dir"]), checkpoint_every=2)
    state, metrics = loop.run(w0, steps)
    return {"metrics": np.array(metrics), "w": state["w"].to_numpy(),
            "rank_w": _np(state["w"].data), "bias": state["bias"]}


def case_ck_elastic_save(inp):
    return _elastic(inp, 6, False)


def case_ck_elastic_resume(inp):
    return _elastic(inp, 12, False)


def case_ck_elastic_fresh(inp):
    return _elastic(inp, 12, True)


def case_la(inp):
    """The dist-mode factorizations, inverse, solves, SVD and ``lr`` over
    the ranks, on a DenseVecMatrix of the (4, 1) mesh and a BlockMatrix of
    the (2, 2) mesh: the factors' blocks and the gathered results."""
    import marlin_tpu_torch as tm
    from marlin_tpu_torch import linalg
    from marlin_tpu_torch import mesh as mm

    b = int(inp["block"])
    out = {}
    for tag, grid, klass in (("r", (4, 1), tm.DenseVecMatrix),
                             ("b", (2, 2), tm.BlockMatrix)):
        mesh = mm.create_mesh(grid)
        a = klass.from_array(inp["a"], mesh)
        spd = klass.from_array(inp["spd"], mesh)
        for piv, sched in (("block", "shrinking"), ("block", "masked"),
                           ("panel", "masked")):
            l, u, perm = linalg.lu_decompose(a, mode="dist", block_size=b,
                                             pivot=piv, schedule=sched)
            key = f"{tag}_{piv}_{sched}"
            out.update(_blocks(f"l_{key}", l))
            out.update(_blocks(f"u_{key}", u))
            out[f"perm_{key}"] = _np(perm)
        for sched in ("shrinking", "masked"):
            out.update(_blocks(f"chol_{tag}_{sched}", linalg.cholesky_decompose(
                spd, mode="dist", block_size=b, schedule=sched)))
        out.update(_blocks(f"inv_{tag}", linalg.inverse(a, mode="dist",
                                                        block_size=b)))
        out[f"solve_{tag}"] = _np(linalg.solve(a, inp["rhs"], mode="dist",
                                               block_size=b))
        out[f"solvev_{tag}"] = _np(linalg.solve(a, inp["rhs"][:, 0],
                                                mode="local"))
        l, u, perm = linalg.lu_decompose(a, mode="dist", block_size=b)
        out[f"lusolve_{tag}"] = _np(linalg.lu_solve(l, u, perm, inp["rhs"]))
        lc = linalg.cholesky_decompose(spd, mode="dist", block_size=b)
        out[f"cholsolve_{tag}"] = _np(linalg.cholesky_solve(lc, inp["rhs"]))
        tall = klass.from_array(inp["tall"], mesh)
        for mode in ("dist-eigs", "local-eigs", "local-svd"):
            res = linalg.compute_svd(tall, 3, mode=mode)
            out[f"s_{tag}_{mode}"] = res.s
            out[f"v_{tag}_{mode}"] = res.v
            out.update(_blocks(f"svdu_{tag}_{mode}", res.u))
        out[f"lr_{tag}"] = klass.from_array(inp["lr"], mesh).lr(1.0, 20)
        out[f"local_{tag}"] = linalg.lu_decompose(a, mode="local")[0] \
            .to_numpy()
    return out


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
for _name in ("pptp_lm", "pptp_lm_gqa", "pptp_train"):
    globals()[f"case_{_name}"] = pptp_lm_case
for _name in ("ring", "ring_xla", "ring_flash", "ulysses", "moe", "moe_span"):
    globals()[f"case_lm_{_name}"] = lm_train_case
for _name in ("ring", "ulysses", "moe"):
    globals()[f"case_lm_shards_{_name}"] = case_lm_shards


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
