#!/usr/bin/env python3
"""The workloads across cards: the port's rank paths, one rank a card, one
NCCL world.

    python3 tools/workloads_ranks.py [WORLD]

Spawns WORLD processes (default: every card; more than the cards is
refused), rank r on card r, joined by ``mesh.initialize_distributed``
through a file store (``tools/ranks_world.py``). Every rank runs the legs
below in order; rank 0 keeps what they return, and after the world ends it
runs each leg's one-card counterpart on its own card and holds the world's
result against it. The models, sizes and tolerances are ``chip_smoke.py``'s
(phases 11 and 29-31), read from it:

1. the mesh: every rank's card is ``cuda:{rank}`` and the port's tensors
   land there; on four ranks a (2, 2) mesh's rows-axis groups are ranks
   {0, 2} and {1, 3};
2. the collectives: a ring step, the non-wrapping shift both ways, an
   all-to-all, ``remap``, the all-reduces and all-gathers, each against the
   values every rank sent; the time of a one-float ``all_reduce`` and
   ``all_gather``, and the bus bandwidth of a 256 MiB ``all_reduce`` and
   ``all_to_all_single``;
3. ``ring_matmul`` at ``DIST_N``² against ``torch.matmul`` of the same
   operands;
4. ring attention (flash) and Ulysses attention at ``DIST_ATTN``, causal,
   forward and backward, against the plain flash version; each flash
   panel's kernel time on every rank (the least of three calls), a fully
   masked panel (keys after every query) held to a quarter of the diagonal
   panel's (MASKED_SHARE); one call under ``torch.profiler``, rank 0's
   table of operations by device time logged;
5. config_lct trained on the stream sharded over the ranks with
   ``ring_flash`` (and ``ulysses`` where the ranks divide the heads; the
   refusal logged where they do not) against phase 11's logical run, the
   flash forward, dK/dV and dQ kernels launched on every rank (ring: once a
   panel, a layer and a step; Ulysses: once a layer and a step);
6. config_moe with its experts over the ranks: one step's loss and
   gradients, then ``TRAIN_STEPS`` losses, against its logical trainer;
7. ``pipeline_apply`` over WORLD stages at ``PIPE_SHAPE`` against the stages
   in sequence; the ``pipeline_training`` CLI at ``PP_CLI`` (4 layers of
   width 128) against the same CLI outside the world; ``pp_lm_loss`` at
   ``PP_LONG`` tokens against the plain flash version; then pp x tp on a
   (WORLD/2, 2) mesh (2 stages x 2 ``cols`` on four ranks, tp alone on
   two): the two-matrix stage at ``PIPE_SHAPE`` through ``PIPE_FF`` with
   its weights placed over ``cols``, against the stages in sequence;
   config_decode's model (``LM``) with ``pp_tp_placement``, trained
   ``TRAIN_STEPS`` steps on a ``PP_TP_BATCH`` batch after one warm-up step,
   against the same steps on one card (phase 11's tolerances), with one
   step under ``torch.profiler`` (the share of rank 0's device time in the
   all-reduces over ``cols``), and its loss at ``PP_LONG`` tokens without
   gradients through the flash forward (ticks x layers a stage x rows a
   microbatch launches a rank), against the unplaced loss on one card
   within ``PP_TP_RTOL``; the stage-weight bytes a rank holds beside one
   card's;
8. the ``distributed_training`` CLI at two (dp, tp) grids ((2, 2) and
   (4, 1); (2, 1) and (1, 2) on two ranks) against the CLI outside the
   world;
9. blocked ALS at ``RANKS_ALS`` and PageRank at ``RANKS_PR`` on the default
   mesh against their plain paths (``RANKS_TOL``: the sums are atomics);
10. ``to_sparse_vec_matrix`` of a rank-local 8192² matrix (95 % of its
    entries under the tolerance) and its ``multiply(format="bsr")`` by a
    rank-local 8192 x 256 operand, the BSR kernel launched on every rank,
    against the world of one.

For every leg the figures are the slowest rank's ms (CUDA events where the
card does the work, else the host clock), the one card's ms, the speedup and
each rank's peak memory. Each rank's log is
``chiprun_out/workloads_ranks/rank{r}.log``; the parent prints the logs and
one JSON line of the figures. Exits non-zero when a check fails, when a rank
passes the world's deadline, or when WORLD exceeds the cards. No leg falls
back to gloo, the CPU, a world of one or a plain version.
"""

from __future__ import annotations

import json
import math
import os
import sys
import tempfile
import time

from ranks_world import (ROOT, events, per_rank, run_world, slowest, smi,
                         world_size)

OUT = os.path.join(ROOT, "chiprun_out", "workloads_ranks")
REPS = 3
BUS_BYTES = 256 * 2 ** 20
# a fully masked flash panel's kernel time against the diagonal panel's. The
# kernel skips every tile with no live entry, so what is left is its launch
# and the copy of the carried (m, l, acc) state: an H100 read 0.096-0.112 of
# the diagonal panel's time at 8 heads x 1024-row panels (four ranks), where
# the diagonal panel costs about a live one (64 row blocks on 132 SMs: the
# longest block, the last, reads every key either way). Each panel counts
# the least of three calls, so that one call delayed beside the ring's
# transfers does not decide the check
MASKED_SHARE = 0.25
FLASH = ("flash_attention_panel", "flash_attention_bwd_dkv",
         "flash_attention_bwd_dq")
PP_LR = 3e-3  # the pipelined LM's Adam rate (pp_lm_train_step's default)


def _card(rank: int):
    import torch

    return torch.device("cuda", rank)


class Ctx:
    """What every leg of a rank reads and writes: the modules, this rank's
    card and mesh, its log, and (on rank 0) what the one-card runs check
    (``keep``) and the figures."""

    def __init__(self, rank, world, tmp, log):
        import numpy as np
        import torch

        import chip_smoke as cs
        import marlin_tpu_torch as mt
        from marlin_tpu_torch import mesh as mm
        from marlin_tpu_torch import ops
        from marlin_tpu_torch.models import transformer as tt
        from marlin_tpu_torch.ops import flash_attention as fa
        from marlin_tpu_torch.parallel import collectives as col

        cs.log = log  # chip_smoke's checks write to this rank's log
        self.np, self.torch, self.cs, self.mt, self.mm = np, torch, cs, mt, mm
        self.ops, self.tt, self.fa, self.col = ops, tt, fa, col
        self.rank, self.world, self.tmp, self.log = rank, world, tmp, log
        self.keep, self.figures = {}, {}
        self.mesh = None
        self.dev = _card(rank)

    def start(self):
        """Reset the peak memory and the launch counts, meet the other
        ranks; returns the host clock."""
        self.torch.cuda.synchronize()
        self.torch.cuda.reset_peak_memory_stats()
        self.ops.reset_launch_counts()
        self.torch.distributed.barrier()
        return time.perf_counter()

    def done(self, leg: str, ms: float, **extra) -> dict:
        """The leg's figures: the slowest rank's ``ms`` and every rank's
        peak memory (GiB), plus ``extra`` (collectives)."""
        torch = self.torch
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        fig = dict(ms=slowest(ms), peak_gib=per_rank(peak), **extra)
        self.figures[leg] = fig
        self.log(f"  {leg}: {ms:.3f} ms on rank {self.rank}, slowest "
                 f"{fig['ms']:.3f}; peak {peak:.3f} GiB")
        return fig

    def counts(self) -> dict:
        """Every rank's launch counts of the flash and BSR kernels."""
        got = self.ops.launch_counts()
        names = (*FLASH, "bsr_spmm_pallas")
        return {k: [int(x) for x in per_rank(got[k])] for k in names}

    def cpu(self, x):
        return x.detach().cpu() if hasattr(x, "detach") else x


# ---------------------------------------------------------------- the legs


def leg_mesh(c: Ctx) -> None:
    """Leg 1: the rank meshes, their cards and groups."""
    torch, mm, dist = c.torch, c.mm, c.torch.distributed
    t0 = c.start()
    c.mesh = mm.create_mesh((c.world, 1))
    ms = (time.perf_counter() - t0) * 1e3
    lm = c.tt.TransformerLM(**c.cs.LCT).init_params()
    mat = c.mt.DenseVecMatrix.random(0, 64, 64, mesh=c.mesh)
    where = {str(t.device) for t in (lm["emb"], lm["l0"]["wq"], mat.data)}
    c.log(f"rank {c.rank}: {dist.get_backend()} world of {mm.world_size()}, "
          f"mesh {c.mesh.grid} on {c.mesh.device}, current device "
          f"{torch.cuda.current_device()}, the port's tensors on {where}")
    if dist.get_backend() != "nccl" or c.mesh.device != c.dev or \
            where != {str(c.dev)}:
        raise AssertionError(f"rank {c.rank}: not an NCCL rank on {c.dev}")
    if c.world == 4:
        m22 = mm.create_mesh((2, 2))
        want = [c.rank % 2, c.rank % 2 + 2]
        got = dist.get_process_group_ranks(m22.group("rows"))
        c.log(f"  (2, 2) mesh: rows-axis group {got}, line "
              f"{m22.line('rows')}; cols-axis line {m22.line('cols')}")
        if sorted(got) != want or m22.line("rows") != want:
            raise AssertionError(f"rank {c.rank}: rows group {got}")
    c.done("mesh", ms)


def leg_collectives(c: Ctx) -> None:
    """Leg 2: the collectives, checked and timed.

    Each collective against the values every rank sent; the latency of a
    one-float all_reduce and all_gather; the bus bandwidth of BUS_BYTES
    all_reduce and all_to_all_single (nccl-tests' factors: 2(p-1)/p and
    (p-1)/p of bytes over time)."""
    import torch.nn.functional as F

    torch, col, mm, dist = c.torch, c.col, c.mm, c.torch.distributed
    m, p, r = c.mesh, c.world, c.rank
    t0 = c.start()
    x = torch.full((1024,), float(r), device=c.dev)
    prev = (r - 1) % p
    # a ring step of one rank sends to itself, which the ring code never
    # asks for (gloo refuses it)
    got = col.finish(*col.ring_send_recv([x, x + 100], m, "rows")) \
        if p > 1 else [x, x + 100]
    fwd = col._shift(x, m, "rows", 1)
    back = col._shift(x, m, "rows", -1)
    a2a = col._all_to_all(torch.stack([x * 10 + j for j in range(p)]), m,
                          "rows")
    summed = col.all_reduce_sum(x, m, "rows")
    gathered = col.all_gather_cat(x[None].to(torch.bfloat16), m, "rows", 0)
    leaves = col.all_reduce_leaves([x, x[:3] * 2], m, "rows")
    shape = (37, 29)
    whole = torch.arange(math.prod(shape), dtype=torch.float32,
                         device=c.dev).reshape(shape)
    src = mm.Sharding(m, ("rows", None))
    dst = mm.Sharding(m, (None, "rows"))

    def padded(sh):
        pr, pc = sh.padded_shape(shape)
        return F.pad(whole, (0, pc - shape[1], 0, pr - shape[0]))

    moved = col.redistribute(src.local(padded(src)), src, dst, shape)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    tot = float(sum(range(p)))
    checks = {
        "ring_send_recv": bool((got[0] == prev).all()
                               and (got[1] == prev + 100).all()),
        "shift +1": bool((fwd == (r - 1 if r > 0 else 0)).all()),
        "shift -1": bool((back == (r + 1 if r < p - 1 else 0)).all()),
        "all_to_all": all(bool((a2a[j] == j * 10 + r).all())
                          for j in range(p)),
        "all_reduce_sum": bool((summed == tot).all()),
        "all_gather_cat (bf16)": [float(g[0]) for g in gathered]
        == [float(j) for j in range(p)],
        "all_reduce_leaves": bool((leaves[0] == tot).all()
                                  and (leaves[1] == 2 * tot).all()),
        "remap": bool(torch.equal(moved, dst.local(padded(dst)))),
    }
    c.log(f"rank {r}: collectives {checks}")
    if not all(checks.values()):
        raise AssertionError(f"rank {r}: a collective differs: {checks}")
    one = torch.ones(1, device=c.dev)
    _, us_ar = events(lambda: dist.all_reduce(one), 100)
    _, us_ag = events(lambda: dist.all_gather(
        [torch.empty_like(one) for _ in range(p)], one), 100)
    big = torch.ones(BUS_BYTES // 4, device=c.dev)
    out = torch.empty_like(big)
    _, ms_ar = events(lambda: dist.all_reduce(big), 5)
    _, ms_a2a = events(lambda: dist.all_to_all_single(out, big), 5)
    ms_ar, ms_a2a = slowest(ms_ar), slowest(ms_a2a)
    gb = BUS_BYTES / 1e9
    bus = dict(all_reduce_1f_us=slowest(us_ar * 1e3),
               all_gather_1f_us=slowest(us_ag * 1e3),
               all_reduce_256mib_ms=ms_ar,
               all_reduce_busbw_gbs=gb / (ms_ar / 1e3) * 2 * (p - 1) / p,
               all_to_all_256mib_ms=ms_a2a,
               all_to_all_busbw_gbs=gb / (ms_a2a / 1e3) * (p - 1) / p)
    if p > 1:  # one ring hop of ring attention's K/V panels at DIST_ATTN
        h, seq, d = c.cs.DIST_ATTN
        kv = [torch.ones((h, seq // p, d), device=c.dev) for _ in range(2)]
        _, ms_hop = events(lambda: col.finish(*col.ring_send_recv(
            kv, m, "rows")), 20)
        ms_hop, mb = slowest(ms_hop), 2 * kv[0].numel() * 4 / 1e6
        bus.update(ring_hop_ms=ms_hop, ring_hop_mb=mb,
                   ring_hop_gbs=mb / ms_hop)
    c.log(f"  {bus}")
    del big, out
    c.done("collectives", ms, **bus)


def _operands(c, seed, *shapes):
    gen = c.torch.Generator(device=c.dev).manual_seed(seed)
    return [c.torch.randn(s, generator=gen, device=c.dev) for s in shapes]


def leg_ring_matmul(c: Ctx) -> None:
    """Leg 3: ring_matmul at DIST_N^2 (logical in/out, precision high)."""
    from marlin_tpu_torch.parallel import ring_matmul

    n = c.cs.DIST_N
    a, b = _operands(c, 29, (n, n), (n, n))
    c.start()
    out, ms = events(lambda: ring_matmul(a, b, c.mesh, precision="high"),
                     REPS)
    if c.rank == 0:
        c.keep["ring_matmul"] = c.cpu(out)
    del a, b, out
    c.done("ring_matmul", ms)


def _attn_inputs(c):
    return _operands(c, 31, *[c.cs.DIST_ATTN] * 4)


def _attn(c, fn, q, k, v, ct):
    xs = [x.detach().requires_grad_(True) for x in (q, k, v)]
    out = fn(*xs)
    grads = c.torch.autograd.grad((out * ct).sum(), xs)
    return [out.detach(), *grads]


class _PanelTimes:
    """Wrap the flash panel wrappers to time each call by CUDA events, with
    its offsets: (kind, q_offset, k_offset, rows, keys, event pair)."""

    def __init__(self, c):
        self.c, self.calls = c, []
        self.real = (c.fa.flash_attention_panel,
                     c.fa.flash_attention_panel_bwd)

    def _wrap(self, fn, kind, q_at):
        torch = self.c.torch

        def timed(q, k, *args, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            # a busy wait of about half a millisecond: the host queues the
            # call while the card waits, so the events time the kernel, not
            # the wrapper's host code
            torch.cuda._sleep(1_000_000)
            start.record()
            got = fn(q, k, *args, **kw)
            end.record()
            self.calls.append((kind, int(args[q_at]), int(args[q_at + 1]),
                               q.shape[-2], k.shape[-2], start, end))
            return got
        timed.launches = 0  # the wrapped function counts on this name
        return timed

    def __enter__(self):
        fwd, bwd = self.real
        # the offsets follow (v, m, l, acc) and (v, do, lse, delta)
        self.c.fa.flash_attention_panel = self._wrap(fwd, "fwd", 4)
        self.c.fa.flash_attention_panel_bwd = self._wrap(bwd, "bwd", 4)
        return self

    def __exit__(self, *exc):
        self.c.fa.flash_attention_panel, \
            self.c.fa.flash_attention_panel_bwd = self.real

    def check_skip(self, label):
        """Log each panel's ms (the least over the calls made); a fully
        masked panel (every key after every query) must take at most
        MASKED_SHARE of the diagonal panel's."""
        self.c.torch.cuda.synchronize()
        least = {}
        for kind, qo, ko, sq, skv, s, e in self.calls:
            key = (kind, qo, ko, sq)
            least[key] = min(least.get(key, math.inf), s.elapsed_time(e))
        rows = {}
        for (kind, qo, ko, sq), ms in sorted(least.items()):
            cls = "masked" if ko >= qo + sq else "diagonal" if ko == qo \
                else "live"
            rows.setdefault((kind, cls), []).append(ms)
        self.c.log(f"  {label} panels on rank {self.c.rank} (ms by kind): "
                   + "; ".join(f"{k} {c}: " + ", ".join(f"{t:.3f}" for t in v)
                               for (k, c), v in sorted(rows.items())))
        for kind in ("fwd", "bwd"):
            masked = rows.get((kind, "masked"), [])
            diag = rows.get((kind, "diagonal"), [])
            if masked and not max(masked) <= MASKED_SHARE * min(diag):
                raise AssertionError(f"{label} {kind}: a fully masked panel "
                                     f"took {max(masked):.3f} ms against the "
                                     f"diagonal's {min(diag):.3f}")
        self.calls.clear()


def _profile(c, fn, label, rows=12):
    """One call of ``fn`` under ``torch.profiler`` on every rank; rank 0
    logs the operations by device time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        c.torch.cuda.synchronize()
    if c.rank == 0:
        c.log(f"  {label} on rank 0 under torch.profiler, by device time:\n"
              + prof.key_averages().table(sort_by="self_cuda_time_total",
                                          row_limit=rows))


def leg_attention(c: Ctx) -> None:
    """Leg 4: ring attention (flash) and Ulysses attention.

    Forward and backward, logical in/out over the ranks."""
    from marlin_tpu_torch.parallel import ring_attention, ulysses_attention

    q, k, v, ct = _attn_inputs(c)
    for name, fn in (
            ("ring_attention", lambda *x: ring_attention(
                *x, c.mesh, causal=True, backend="flash")),
            ("ulysses_attention", lambda *x: ulysses_attention(
                *x, c.mesh, causal=True))):
        c.start()
        got, ms = events(lambda: _attn(c, fn, q, k, v, ct), REPS)
        launches = c.counts()
        if name == "ring_attention":
            with _PanelTimes(c) as panels:
                for _ in range(REPS):
                    _attn(c, fn, q, k, v, ct)
                panels.check_skip(name)
            _profile(c, lambda: _attn(c, fn, q, k, v, ct), name)
        c.log(f"  {name} {c.cs.DIST_ATTN}: launches (per rank, "
              f"{REPS + 1} calls) {launches}")
        if any(n <= 0 for k_ in FLASH for n in launches[k_]):
            raise AssertionError(f"{name}: a flash kernel did not launch on "
                                 f"every rank: {launches}")
        if c.rank == 0:
            c.keep[name] = [c.cpu(t) for t in got]
        c.done(name, ms, launches=launches)
    del q, k, v, ct


def _lct_stream(c):
    return c.np.random.default_rng(0).integers(
        0, c.cs.LCT["vocab"], c.cs.TRAIN_SEQ).astype(c.np.int32)


def leg_lct(c: Ctx) -> None:
    """Leg 5: config_lct with its stream sharded over the ranks."""
    cs, tt = c.cs, c.tt
    stream = _lct_stream(c)
    params0 = tt.TransformerLM(**cs.LCT).init_params()
    if c.rank == 0:
        c.keep["lct_params0"] = {k: c.cpu(t) for k, t in
                                 cs.flat(params0).items()}
    p, heads, layers = c.world, cs.LCT["heads"], cs.LCT["layers"]
    for attn in cs.RANKS_ATTN:
        lm = tt.TransformerLM(**cs.LCT, attn=attn)
        if attn == "ulysses" and heads % p:
            try:
                lm.train(stream, steps=1, mesh=c.mesh, params=params0)
            except ValueError as e:
                c.log(f"  config_lct ulysses at p = {p}: refused, as it "
                      f"must be ({heads} heads): {e}")
                c.figures["lct_ulysses"] = dict(refused=str(e))
                continue
            raise AssertionError(f"ulysses at p = {p} ran with {heads} heads")
        lm.train(stream, steps=1, mesh=c.mesh, params=params0)  # warm-up
        t0 = c.start()
        params, losses = lm.train(stream, steps=cs.TRAIN_STEPS, mesh=c.mesh,
                                  params=params0)
        c.torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / cs.TRAIN_STEPS
        launches = c.counts()
        # ring: one launch a panel (p of them) a layer a step on every rank;
        # Ulysses: one a layer a step
        want = (p if attn != "ulysses" else 1) * layers * cs.TRAIN_STEPS
        c.log(f"  config_lct {attn} at p = {p}: losses {losses}; launches "
              f"{launches} (want {want} of each flash kernel on each rank)")
        if any(n != want for k in FLASH for n in launches[k]):
            raise AssertionError(f"config_lct {attn}: launches {launches}, "
                                 f"want {want}")
        if c.rank == 0:
            c.keep[f"lct_{attn}"] = ({k: c.cpu(t) for k, t in
                                      cs.flat(params).items()}, losses)
        c.done(f"lct_{attn}", ms, losses=losses, launches=launches)
        del params


def leg_moe(c: Ctx) -> None:
    """Leg 6: config_moe with its experts over the ranks."""
    cs, tt = c.cs, c.tt
    from marlin_tpu_torch.models import moe as tm

    stream = _lct_stream(c)
    moe = tt.TransformerLM(**cs.MOE_LM)
    params0 = moe.init_params()
    mine = tm.shard_moe_params(params0, c.mesh)["l0"]["moe"]["w1"].shape[0]
    c.log(f"  config_moe at p = {c.world}: {mine} of "
          f"{cs.MOE_LM['n_experts']} experts on this rank")
    t0 = c.start()
    loss, grads = tt.lm_value_and_grad(params0, stream, c.mesh,
                                       **cs.moe_knobs())
    c.torch.cuda.synchronize()
    ms_grad = (time.perf_counter() - t0) * 1e3
    if c.rank == 0:
        c.keep["moe_params0"] = {k: c.cpu(t) for k, t in
                                 cs.flat(params0).items()}
        c.keep["moe_grads"] = (float(loss), {k: c.cpu(t) for k, t in
                                             cs.flat(grads).items()})
    del grads
    t0 = c.start()
    params, losses = moe.train(stream, steps=cs.TRAIN_STEPS, mesh=c.mesh,
                               params=params0)
    c.torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / cs.TRAIN_STEPS
    launches = c.counts()
    c.log(f"  config_moe: losses {losses}; launches {launches}")
    if c.rank == 0:
        c.keep["moe"] = losses
    c.done("moe", ms, grad_step_ms=slowest(ms_grad), losses=losses,
           experts_per_rank=mine, launches=launches)
    del params


def _stage(p, xs):
    import torch

    for j in range(p["w"].shape[0]):
        xs = torch.tanh(xs @ p["w"][j])
    return xs


def _pipe_inputs(c, stages):
    batch, width = c.cs.PIPE_SHAPE
    w, x = _operands(c, 29, (stages, 2, width, width), (batch, width))
    return w / math.sqrt(width), x


def _pp_params(c):
    return c.tt.init_transformer(0, 512, 128, 2, 4)


def _pp_tokens(c):
    return c.np.random.default_rng(0).integers(
        0, 512, (2, c.cs.PP_LONG + 1)).astype(c.np.int32)


def _pp_cli(c):
    import contextlib
    import io

    from marlin_tpu_torch.examples import pipeline_training

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        losses = pipeline_training.main([*c.cs.PP_CLI, "128", "4"])
    return losses, buf.getvalue().splitlines()


def leg_pipeline(c: Ctx) -> None:
    """Leg 7: the pipeline, its CLI and the pipelined LM.

    pipeline_apply over WORLD stages, the pipeline_training CLI, pp_lm_loss
    at PP_LONG tokens through the flash forward."""
    from marlin_tpu_torch.models import pipeline_lm as pl
    from marlin_tpu_torch.parallel import pipeline_apply, stack_stage_params

    cs, torch, p = c.cs, c.torch, c.world
    w, x = _pipe_inputs(c, p)
    stacked = stack_stage_params([{"w": w[s]} for s in range(p)], c.mesh)
    c.start()
    with c.mt.ops.local.precision_scope("highest"):
        out, ms = events(lambda: pipeline_apply(
            stacked, _stage, x, c.mesh, microbatch=cs.PIPE_MB), REPS)
    if c.rank == 0:
        c.keep["pipeline_apply"] = c.cpu(out)
    c.done("pipeline_apply", ms)
    del w, x, stacked, out
    t0 = c.start()
    losses, lines = _pp_cli(c)
    ms = (time.perf_counter() - t0) * 1e3
    for ln in lines:
        c.log(f"    | {ln}")
    if c.rank == 0:
        c.keep["pp_cli"] = losses
    c.done("pp_cli", ms, losses=losses, lines=lines)
    sp, outer = pl.pp_stage_params(_pp_params(c), c.mesh)
    toks = _pp_tokens(c)
    t0 = c.start()
    with torch.no_grad():
        loss = float(pl.pp_lm_loss(sp, outer, toks, c.mesh, heads=2))
    ms = (time.perf_counter() - t0) * 1e3
    launches = c.counts()
    # each tick every stage runs its layers on its microbatch (bubbles on
    # zeros): ticks x layers a stage x rows a microbatch launches a rank
    mb = max(1, toks.shape[0] // p)
    want = (toks.shape[0] // mb + p - 1) * (4 // p) * mb
    c.log(f"  pp_lm_loss at {cs.PP_LONG} tokens, {p} stages: {loss!r}; flash "
          f"forward launches {launches['flash_attention_panel']} (want "
          f"{want} on each rank)")
    if any(n != want for n in launches["flash_attention_panel"]):
        raise AssertionError(f"pp_lm_loss: launches {launches}")
    if c.rank == 0:
        c.keep["pp_lm_loss"] = loss
    c.done("pp_lm_loss", ms, launches=launches)


def _pptp_mlp(c, stages):
    """The two-matrix stage's stacked weights and input (pp x tp)."""
    batch, width = c.cs.PIPE_SHAPE
    ff = c.cs.PIPE_FF
    w0, w1, x = _operands(c, 20, (stages, width, ff), (stages, ff, width),
                          (batch, width))
    return {"w0": w0 / math.sqrt(width), "w1": w1 / math.sqrt(ff)}, x


def _pptp_params(c):
    lm = c.cs.LM
    return c.tt.init_transformer(lm["seed"], lm["vocab"], lm["d_model"],
                                 lm["heads"], lm["layers"])


def _pptp_tokens(c):
    """The training batch and the PP_LONG-token one."""
    rng = c.np.random.default_rng(20)
    b, t = c.cs.PP_TP_BATCH
    vocab = c.cs.LM["vocab"]
    return (rng.integers(0, vocab, (b, t + 1)).astype(c.np.int32),
            rng.integers(0, vocab, (2, c.cs.PP_LONG + 1)).astype(c.np.int32))


def _held_bytes(tree, place, mesh) -> int:
    """The bytes of this rank's blocks of the stacked stage weights
    (``place``: their Shardings; a leaf left out is whole on its stage)."""
    from marlin_tpu_torch.mesh import Sharding

    total = 0
    for k, v in tree.items():
        sh = place.get(k) or Sharding(mesh, ("rows",))
        total += sh.local(v).numel() * v.element_size()
    return total


def _pp_train(c, mesh, place, steps):
    """One warm-up step, then ``steps`` Adam steps of config_decode's
    pipelined model from its initial params; returns (losses, ms a step,
    (stage params, outer) after, the same before)."""
    from marlin_tpu_torch.models import pipeline_lm as pl

    torch, heads = c.torch, c.cs.LM["heads"]
    toks, _ = _pptp_tokens(c)
    sp, outer = pl.pp_stage_params(_pptp_params(c), mesh)
    start = (sp, outer)
    pl.pp_lm_train_step(sp, outer, c.tt.adam_init((sp, outer)), toks, mesh,
                        heads=heads, lr=PP_LR, placement=place)
    state = c.tt.adam_init((sp, outer))
    losses = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        sp, outer, state, loss = pl.pp_lm_train_step(
            sp, outer, state, toks, mesh, heads=heads, lr=PP_LR,
            placement=place)
        losses.append(float(loss))
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / steps
    return losses, ms, (sp, outer), start


def _logical(sp, outer) -> dict:
    """Pipelined params as one dict, the stage and layer axes merged (the
    layers in order), for params_close."""
    return {"sp": {k: v.reshape(-1, *v.shape[2:]) for k, v in sp.items()},
            "outer": outer}


def _tp_share(c, fn, label, tp_axis="cols"):
    """One call of ``fn`` under ``torch.profiler`` on every rank, each
    all-reduce over ``tp_axis`` inside a ``tp_all_reduce`` range; returns
    rank 0's device time (us) in all, in those ranges' kernels, and in
    NCCL all-reduce kernels of any group, and logs its table."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    col = c.col
    real = col.all_reduce_sum

    def labelled(x, mesh, axis):
        if axis != tp_axis:
            return real(x, mesh, axis)
        with record_function("tp_all_reduce"):
            return real(x, mesh, axis)

    def dev_us(e, self_time):
        name = ("self_" if self_time else "") + "device_time_total"
        if hasattr(e, name):
            return getattr(e, name)
        return getattr(e, name.replace("device", "cuda"))

    col.all_reduce_sum = labelled
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            c.torch.cuda.synchronize()
    finally:
        col.all_reduce_sum = real
    if c.rank != 0:
        return None
    events = prof.events()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and not e.is_user_annotation]
    total = sum(dev_us(e, True) for e in kernels)
    ranges = [e for e in events if e.name == "tp_all_reduce"
              and e.device_type == DeviceType.CPU]
    tp = sum(dev_us(e, False) for e in ranges)
    nccl = sum(dev_us(e, True) for e in kernels
               if "nccl" in e.name.lower() and "allreduce" in
               e.name.lower().replace("_", ""))
    c.log(f"  {label} on rank 0 under torch.profiler: device {total:.1f} "
          f"us, the {len(ranges)} all-reduces over {tp_axis} {tp:.1f} us, "
          f"NCCL all-reduce kernels {nccl:.1f} us; by device time:\n"
          + prof.key_averages().table(sort_by="self_cuda_time_total",
                                      row_limit=14))
    return dict(device_us=total, tp_all_reduces=len(ranges),
                tp_all_reduce_us=tp,
                nccl_all_reduce_us=nccl,
                tp_share=tp / total if total else None)


def leg_pptp(c: Ctx) -> None:
    """Leg 7 (pp x tp): stage weights split over cols.

    The two-matrix stage and config_decode's pipelined model on a
    (WORLD/2, 2) mesh with their stage weights placed over cols."""
    from marlin_tpu_torch.models import pipeline_lm as pl
    from marlin_tpu_torch.parallel import pipeline_apply

    cs, torch = c.cs, c.torch
    stages = c.world // 2
    mesh = c.mm.create_mesh((stages, 2))
    w, x = _pptp_mlp(c, stages)
    place = cs.mlp2_placement(mesh)
    c.start()
    with c.mt.ops.local.precision_scope("highest"):
        out, ms = events(lambda: pipeline_apply(
            w, cs.tp_mlp2_stage(mesh), x, mesh, microbatch=cs.PIPE_MB,
            placement=place), REPS)
    if c.rank == 0:
        c.keep["pptp_mlp"] = c.cpu(out)
    c.done("pptp_mlp", ms, grid=mesh.grid,
           weight_bytes=_held_bytes(w, place, mesh))
    del w, x, out
    place = pl.pp_tp_placement(mesh)
    c.start()
    losses, ms, (sp, outer), _ = _pp_train(c, mesh, place, cs.TRAIN_STEPS)
    if c.rank == 0:
        c.keep["pptp_train"] = (losses, {k: c.cpu(t) for k, t in cs.flat(
            _logical(sp, outer)).items()})
    c.done("pptp_train", ms, grid=mesh.grid, losses=losses,
           weight_bytes=_held_bytes(sp, place, mesh))
    toks, long_toks = _pptp_tokens(c)
    state = c.tt.adam_init((sp, outer))
    share = _tp_share(c, lambda: pl.pp_lm_train_step(
        sp, outer, state, toks, mesh, heads=cs.LM["heads"], lr=PP_LR,
        placement=place), "pp x tp train step")
    if c.rank == 0:
        c.figures["pptp_train"]["profile"] = share
    sp, outer = pl.pp_stage_params(_pptp_params(c), mesh)
    t0 = c.start()
    with torch.no_grad():
        loss = float(pl.pp_lm_loss(sp, outer, long_toks, mesh,
                                   heads=cs.LM["heads"], placement=place))
    ms = (time.perf_counter() - t0) * 1e3
    launches = c.counts()
    b, layers = long_toks.shape[0], cs.LM["layers"]
    mb = max(1, b // stages)
    want = (b // mb + stages - 1) * (layers // stages) * mb
    c.log(f"  pp_lm_loss at {cs.PP_LONG} tokens, {mesh.grid} pp x tp, "
          f"{cs.LM['heads'] // 2} heads a rank: {loss!r}; flash forward "
          f"launches {launches['flash_attention_panel']} (want {want} on "
          f"each rank)")
    if any(n != want for n in launches["flash_attention_panel"]):
        raise AssertionError(f"pp x tp pp_lm_loss: launches {launches}")
    if c.rank == 0:
        c.keep["pptp_long"] = loss
    c.done("pptp_long", ms, launches=launches)


def _nn_grids(world):
    if world == 4:
        return ((2, 2), (4, 1))
    return tuple(dict.fromkeys(((world, 1), (1, world))))


def _nn_cli(c, run_dir):
    import contextlib
    import io

    from marlin_tpu_torch.examples import distributed_training

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        distributed_training.main([*c.cs.RANKS_NN_CLI, run_dir])
    if c.mm.distributed():
        run_dir = os.path.join(run_dir, f"rank{c.rank}")
    with open(os.path.join(run_dir, "events.jsonl")) as f:
        rows = [json.loads(ln) for ln in f]
    return ([r["loss"] for r in rows if r["kind"] == "step"],
            buf.getvalue().splitlines())


def leg_nn(c: Ctx) -> None:
    """Leg 8: the (dp, tp) MLP's CLI at two grids.

    ``best_grid`` is set to each grid in turn."""
    real = c.mm.best_grid
    for grid in _nn_grids(c.world):
        c.mm.best_grid = lambda n, g=grid: g
        try:
            t0 = c.start()
            losses, lines = _nn_cli(c, os.path.join(
                c.tmp, f"nn{grid[0]}x{grid[1]}"))
            ms = (time.perf_counter() - t0) * 1e3
        finally:
            c.mm.best_grid = real
        c.log(f"  distributed_training at {grid}: {lines}")
        want = (f"mesh: {grid[0]} data-parallel x {grid[1]} tensor-parallel "
                f"over {c.world} devices")
        if lines[0] != want:
            raise AssertionError(f"distributed_training: {lines[0]!r}")
        tag = f"nn_{grid[0]}x{grid[1]}"
        if c.rank == 0:
            c.keep[tag] = losses
        c.done(tag, ms, lines=lines)


def _ml_inputs(c):
    np = c.np
    a, n, e = c.cs.RANKS_ALS, c.cs.RANKS_PR["n"], c.cs.RANKS_PR["e"]
    rng = np.random.default_rng(30)
    als = (rng.integers(0, a["users"], a["nnz"]),
           rng.integers(0, a["items"], a["nnz"]),
           rng.random(a["nnz"]).astype(np.float32) * 4 + 1)
    edges = np.stack([rng.integers(0, n, e), rng.integers(0, n, e)], axis=1)
    return als, edges


def _als(c, als_in, mesh):
    a = c.cs.RANKS_ALS
    coo = c.mt.CoordinateMatrix(*als_in, shape=(a["users"], a["items"]),
                                mesh=mesh)
    model = coo.als(rank=a["rank"], iterations=a["iters"], lam=0.05,
                    shard=True, segment_block=a["block"])
    return (model.user_features.logical(), model.product_features.logical())


def _pagerank(c, edges, mesh):
    from marlin_tpu_torch.ml import build_transition_operator, pagerank

    t0 = time.perf_counter()
    op = build_transition_operator(edges, n=c.cs.RANKS_PR["n"], mesh=mesh)
    c.torch.cuda.synchronize()
    if c.mm.distributed():  # the ranks' host builds end apart
        c.torch.distributed.barrier()
    t1 = time.perf_counter()
    r = pagerank(op, iterations=c.cs.RANKS_PR["iters"])
    return r, (t1 - t0) * 1e3, (time.perf_counter() - t1) * 1e3


def leg_ml(c: Ctx) -> None:
    """Leg 9: blocked ALS and edge-sharded PageRank on the default mesh.

    Each after one untimed call (the axes' first collectives set up their
    NCCL communicators)."""
    als_in, edges = _ml_inputs(c)
    mesh = c.mm.create_mesh()
    _als(c, als_in, mesh)
    t0 = c.start()
    u, v = _als(c, als_in, mesh)
    c.torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    if c.rank == 0:
        c.keep["als"] = (c.cpu(u), c.cpu(v))
    c.done("als", ms, mesh=list(mesh.grid))
    _pagerank(c, edges, mesh)
    c.start()
    r, build_ms, ms = _pagerank(c, edges, mesh)
    if c.rank == 0:
        c.keep["pagerank"] = r
    c.done("pagerank", ms, build_ms=slowest(build_ms))


def leg_sparse(c: Ctx) -> None:
    """Leg 10: the sparse conversion and its BSR product over the ranks.

    Phase 31's ``chip_smoke.matrices_sparse`` on the rank mesh: a rank-local
    RANKS_SPARSE matrix through ``to_sparse_vec_matrix`` and its
    ``multiply(format="bsr")`` by a rank-local operand, whose timed product
    must launch the BSR kernel on every rank."""
    c.start()
    sp, md, bd, od, fig, _ = c.cs.matrices_sparse(c.torch, c.mt, c.ops,
                                                  c.mesh)
    if c.rank == 0:
        c.keep["sparse"] = (sp._coo_triplets(),
                            *[c.cpu(t) for t in (md, bd, od)], fig)
    c.done("sparse_multiply", fig["ms"],
           to_sparse_ms=slowest(fig["to_sparse_s"] * 1e3), nnz=sp.nnz,
           launches=[int(n) for n in per_rank(fig["launches"])],
           first_call_launches=[int(n) for n in
                                per_rank(fig["first_launches"])])


LEGS = (leg_mesh, leg_collectives, leg_ring_matmul, leg_attention, leg_lct,
        leg_moe, leg_pipeline, leg_pptp, leg_nn, leg_ml, leg_sparse)


# ------------------------------------------------- the one-card runs


def _rel(a, b) -> float:
    a, b = a.float(), b.float()
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


def _one_card(c: Ctx, name: str, ms: float, **checks) -> None:
    """Record the one card's ``ms`` beside the world's and the speedup."""
    fig = c.figures[name]
    fig.update(one_card_ms=ms, speedup=ms / fig["ms"], **checks)
    c.log(f"  {name}: world {fig['ms']:.3f} ms, one card {ms:.3f} ms, "
          f"speedup {fig['speedup']:.3f}; peak per rank "
          f"{[round(x, 3) for x in fig['peak_gib']]} GiB; {checks}")


def _nested(flat: dict, dev) -> dict:
    """A ``{"a/b": tensor}`` dict as nested dicts on ``dev`` (the params
    dicts ``params_close`` takes)."""
    out = {}
    for name, t in flat.items():
        node = out
        *path, leaf = name.split("/")
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = t.to(dev)
    return out


def _check(label: str, err: float, tol: float) -> float:
    if not (math.isfinite(err) and err <= tol):
        raise AssertionError(f"{label}: {err:.3e} > {tol:g}")
    return err


def _pptp_one_card(c: Ctx, one) -> None:
    """Leg 7's pp x tp on one card: the stages in sequence, the unplaced
    trainer and loss."""
    from marlin_tpu_torch.models import pipeline_lm as pl

    cs, torch, k = c.cs, c.torch, c.keep
    w, x = _pptp_mlp(c, c.world // 2)

    def mlp_in_sequence():
        y = x
        for s in range(c.world // 2):
            y = cs.mlp2_stage({n_: t[s] for n_, t in w.items()}, y)
        return y

    with c.mt.ops.local.precision_scope("highest"):
        want, ms = events(mlp_in_sequence, REPS)
    rel = _check("pp x tp pipeline_apply", _rel(
        k.pop("pptp_mlp").to(c.dev), want), cs.PIPE_TOL)
    _one_card(c, "pptp_mlp", ms, max_rel=rel,
              one_card_weight_bytes=sum(t.numel() * t.element_size()
                                        for t in w.values()))
    del w, x, want
    losses, ms, (sp, outer), (sp0, outer0) = _pp_train(c, one, None,
                                                       cs.TRAIN_STEPS)
    got_losses, got = k.pop("pptp_train")
    worst = cs.losses_close("pp x tp train", got_losses, losses)
    note = cs.params_close("pp x tp train", _nested(got, c.dev),
                           _logical(sp, outer),
                           _logical(sp0, outer0), PP_LR)
    _one_card(c, "pptp_train", ms, losses_rel=worst, params=note,
              one_card_losses=losses,
              one_card_weight_bytes=sum(t.numel() * t.element_size()
                                        for t in sp0.values()))
    _, long_toks = _pptp_tokens(c)
    sp, outer = pl.pp_stage_params(_pptp_params(c), one)
    with torch.no_grad():
        t0 = time.perf_counter()
        whole = float(pl.pp_lm_loss(sp, outer, long_toks, one,
                                    heads=cs.LM["heads"]))
        ms = (time.perf_counter() - t0) * 1e3
    rel = _check("pp x tp pp_lm_loss vs unplaced",
                 abs(k.pop("pptp_long") - whole) / abs(whole), cs.PP_TP_RTOL)
    _one_card(c, "pptp_long", ms, rel_unplaced=rel)


def references(c: Ctx) -> None:
    """Rank 0 after the world: each leg's one-card run on this card, held
    against the world's result."""
    cs, torch, tt, np = c.cs, c.torch, c.tt, c.np
    k = c.keep
    one = c.mm.Mesh(c.dev)  # the world of one
    c.log(f"rank 0: the one-card runs on {c.dev}")
    # 3. ring_matmul
    n = cs.DIST_N
    a, b = _operands(c, 29, (n, n), (n, n))
    local_matmul = c.mt.ops.local.local_matmul
    ref = local_matmul(a, b, "highest")
    rel = _check("ring_matmul", _rel(k.pop("ring_matmul").to(c.dev), ref),
                 cs.DIST_TOL)
    _, ms = events(lambda: local_matmul(a, b, "high"), REPS)
    _one_card(c, "ring_matmul", ms, max_rel=rel)
    del a, b, ref
    # 4. attention against the plain flash version on one card
    from marlin_tpu_torch.parallel import ring_attention, ulysses_attention

    q, kk, v, ct = _attn_inputs(c)
    for name, fn in (
            ("ring_attention", lambda *x: ring_attention(
                *x, one, causal=True, backend="flash")),
            ("ulysses_attention", lambda *x: ulysses_attention(
                *x, one, causal=True))):
        restore = cs.plain_flash(c.fa)
        try:
            want = _attn(c, fn, q, kk, v, ct)
        finally:
            restore()
        got = [t.to(c.dev) for t in k.pop(name)]
        err = cs.attn_close(torch, f"{name} out vs plain flash", got[0],
                            want[0], torch.float32)
        for g, w, x in zip(got[1:], want[1:], "qkv"):
            cs.bwd_close(torch, f"{name} d{x} vs plain flash", g, w,
                         torch.float32)
        _, ms = events(lambda: _attn(c, fn, q, kk, v, ct), REPS)
        _one_card(c, name, ms, out_max_abs_err=err)
    del q, kk, v, ct
    # 5. config_lct: phase 11's logical run
    stream = _lct_stream(c)
    p0 = k.pop("lct_params0")
    params0 = tt.TransformerLM(**cs.LCT).init_params()
    if any(not torch.equal(p0[n_], t.cpu())
           for n_, t in cs.flat(params0).items()):
        raise AssertionError("config_lct's initial params differ on card 0")
    lct = tt.TransformerLM(**cs.LCT)
    lct.train(stream, steps=1, params=params0)
    t0 = time.perf_counter()
    params_ref, losses_ref = lct.train(stream, steps=cs.TRAIN_STEPS,
                                       params=params0)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / cs.TRAIN_STEPS
    for attn in cs.RANKS_ATTN:
        if f"lct_{attn}" not in k:
            continue
        flat_p, losses = k.pop(f"lct_{attn}")
        worst = cs.losses_close(f"config_lct {attn}", losses, losses_ref)
        note = cs.params_close(f"config_lct {attn}",
                               _nested(flat_p, c.dev), params_ref,
                               params0, tt.TransformerLM.learning_rate)
        _one_card(c, f"lct_{attn}", ms, losses_rel=worst, params=note,
                  one_card_losses=losses_ref)
    del params_ref, params0
    # 6. config_moe: its logical trainer
    moe = tt.TransformerLM(**cs.MOE_LM)
    p0 = k.pop("moe_params0")
    params0 = moe.init_params()
    if any(not torch.equal(p0[n_], t.cpu())
           for n_, t in cs.flat(params0).items()):
        raise AssertionError("config_moe's initial params differ on card 0")
    t0 = time.perf_counter()
    want_loss, want_grads = tt.lm_value_and_grad(params0, stream,
                                                 **cs.moe_knobs())
    torch.cuda.synchronize()
    ms_grad = (time.perf_counter() - t0) * 1e3
    loss_g, grads = k.pop("moe_grads")
    gw = cs.flat(want_grads)
    grad_rel = {n_: _rel(grads[n_].to(c.dev), g) for n_, g in gw.items()}
    worst_leaf = max(grad_rel, key=grad_rel.get)
    loss_rel = abs(loss_g - float(want_loss)) / abs(float(want_loss))
    c.log(f"  config_moe one step: loss {loss_g!r} (one card "
          f"{float(want_loss)!r}); gradients {grad_rel[worst_leaf]:.3e} of "
          f"max ({worst_leaf}; tol {cs.TRAIN_GRAD_TOL:g})")
    _check("config_moe loss", loss_rel, cs.TRAIN_LOSS0_RTOL)
    _check(f"config_moe gradient {worst_leaf}", grad_rel[worst_leaf],
           cs.TRAIN_GRAD_TOL)
    del want_grads, grads, gw
    t0 = time.perf_counter()
    _, want_losses = moe.train(stream, steps=cs.TRAIN_STEPS, params=params0)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / cs.TRAIN_STEPS
    worst = cs.losses_close("config_moe", k.pop("moe"), want_losses)
    _one_card(c, "moe", ms, losses_rel=worst, loss0_rel=loss_rel,
              grad_rel=grad_rel[worst_leaf], one_card_grad_step_ms=ms_grad)
    del params0
    torch.cuda.empty_cache()
    # 7. the pipeline: the stages in sequence, the CLI, the plain flash
    from marlin_tpu_torch.models import pipeline_lm as pl

    stages = c.world
    w, x = _pipe_inputs(c, stages)

    def in_sequence():
        y = x
        for s in range(stages):
            y = _stage({"w": w[s]}, y)
        return y

    with c.mt.ops.local.precision_scope("highest"):
        want, ms = events(in_sequence, REPS)
    rel = _check("pipeline_apply", _rel(k.pop("pipeline_apply").to(c.dev),
                                        want), cs.PIPE_TOL)
    _one_card(c, "pipeline_apply", ms, max_rel=rel)
    t0 = time.perf_counter()
    losses, _ = _pp_cli(c)
    ms = (time.perf_counter() - t0) * 1e3
    got = k.pop("pp_cli")
    rel = _check("pipeline_training", max(abs(a - b) / abs(b) for a, b in
                                          zip(got, losses)), cs.RANKS_TOL)
    _one_card(c, "pp_cli", ms, losses_rel=rel, one_card_losses=losses)
    sp, outer = pl.pp_stage_params(_pp_params(c), one)
    toks = _pp_tokens(c)
    with torch.no_grad():
        t0 = time.perf_counter()
        kern = float(pl.pp_lm_loss(sp, outer, toks, one, heads=2))
        ms = (time.perf_counter() - t0) * 1e3
        restore = cs.plain_flash(c.fa)
        try:
            plain = float(pl.pp_lm_loss(sp, outer, toks, one, heads=2))
        finally:
            restore()
    got = k.pop("pp_lm_loss")
    rel = _check("pp_lm_loss vs plain flash", abs(got - plain) / abs(plain),
                 1e-5)
    _one_card(c, "pp_lm_loss", ms, rel_plain=rel,
              one_card_rel_plain=abs(kern - plain) / abs(plain))
    _pptp_one_card(c, one)
    # 8. the MLP CLI outside the world
    t0 = time.perf_counter()
    losses, lines = _nn_cli(c, os.path.join(c.tmp, "nn_one"))
    ms = (time.perf_counter() - t0) * 1e3
    for grid in _nn_grids(c.world):
        tag = f"nn_{grid[0]}x{grid[1]}"
        got = k.pop(tag)
        if len(got) != len(losses):
            raise AssertionError(f"{tag}: {len(got)} steps")
        rel = _check(tag, max(abs(a - b) / abs(b) for a, b in
                              zip(got, losses)), cs.RANKS_TOL)
        _one_card(c, tag, ms, losses_rel=rel)
    # 9. ALS and PageRank, plain, each after one untimed call
    als_in, edges = _ml_inputs(c)
    _als(c, als_in, None)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = _als(c, als_in, None)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    errs = [_check("ALS factors", _rel(g.to(c.dev), w_), cs.RANKS_TOL)
            for g, w_ in zip(k.pop("als"), want)]
    _one_card(c, "als", ms, max_rel=max(errs))
    _pagerank(c, edges, None)
    want, _, ms = _pagerank(c, edges, None)
    rel = _check("PageRank", float(np.abs(k.pop("pagerank") - want).max())
                 / float(want.max()), cs.RANKS_TOL)
    _one_card(c, "pagerank", ms, max_rel=rel)
    # 10. the sparse conversion and product, the world of one
    trip, md, bd, od, fig = k.pop("sparse")
    ms, rel = cs.matrices_sparse_world_of_one(
        torch, np, c.mt, one, *[t.to(c.dev) for t in (md, bd, od)], fig,
        trip)
    _one_card(c, "sparse_multiply", ms, max_rel=rel, triplets="equal")


def rank_main(rank: int, world: int, tmp: str, log) -> None:
    c = Ctx(rank, world, tmp, log)
    c.mm.initialize_distributed(f"file://{tmp}/store", world, rank)
    try:
        for leg in LEGS:
            c.log(f"rank {rank}: {leg.__doc__.splitlines()[0]}")
            leg(c)
            c.torch.cuda.empty_cache()
    finally:
        c.mm.shutdown_distributed()
    if rank != 0:
        return
    references(c)
    if c.keep:
        raise AssertionError(f"unchecked results: {sorted(c.keep)}")
    with open(os.path.join(OUT, "figures.json"), "w") as f:
        json.dump(c.figures, f)


def main() -> int:
    world = world_size(sys.argv[1:])
    sys.path.insert(0, ROOT)
    from marlin_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.load_library()  # once, before the ranks load it
    print(f"the kernels built in {time.perf_counter() - t0:.1f} s", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        run_world(rank_main, world, tmp, OUT)
    with open(os.path.join(OUT, "figures.json")) as f:
        figures = json.load(f)
    print(json.dumps(dict(figures, world=world, cards=smi())))
    return 0


if __name__ == "__main__":
    sys.exit(main())
