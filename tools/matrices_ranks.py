#!/usr/bin/env python3
"""The matrices across ranks on several cards: one rank a card, one NCCL
world.

    python3 tools/matrices_ranks.py [WORLD]

Spawns WORLD processes (default: every card), rank r on card r, joined by
``mesh.initialize_distributed`` through a file store. On the (WORLD, 1)
mesh each rank:

- draws its blocks of two N x N f32 ``DenseVecMatrix.random`` (env ``N``,
  default 20000) and runs ``a.multiply(b)`` (auto: the RMM on blocks), a
  warm-up call and then ``REPS`` timed by CUDA events; it logs the bytes of
  its block and its peak memory. Rank 0 holds C against ``torch.matmul``
  of the gathered operands on its own card (1e-4 of the largest |entry|),
  timed alike: the one-card baseline;
- factors ``A = BlockMatrix.random(0, n, n) + n I`` (env ``LINALG_N``,
  default 8192, blocks of 1000) by LU (shrinking, block pivots), and
  ``A + Aᵀ`` (symmetric, diagonally dominant) by Cholesky (masked), on row
  blocks, a warm-up call and then one timed (the slowest rank's host
  clock); rank 0 holds the gathered factors against the world of one's on
  its card, timed alike (perm equal, 1e-4 of the largest |entry|);
- saves its block of an N x N matrix with ``save_sharded`` and reads its
  region back with ``load_sharded`` (bit for bit); after the world ends
  the parent restores the whole matrix onto card 0 and holds its CRC32
  against the one rank 0 took of the gathered matrix;
- fits ``lr(1.0, LR_ITERS)`` on row blocks of LR_M rows of a label and
  LR_D features (env ``LR_M``, default 1,000,003, so the last of four ranks
  holds a padded row): each rank's fused lr kernel sums its real rows, the
  all-reduce over the ranks goes between that sum and the update, and each
  rank launches the kernel once an iteration. A warm-up fit, then one timed
  (the slowest rank's host clock); rank 0 holds the weights against the
  world of one's fit of the same rows on its card (LR_TOL of the largest
  |weight|: the sum over ranks adds in another order).

Each rank's log is ``chiprun_out/matrices_ranks/rank{r}.log``; the parent
prints the ranks' logs and one JSON line of the figures. Exits non-zero
when any check fails, when a rank passes the world's deadline, or when
WORLD exceeds the cards (``tools/ranks_world.py``).
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time
import zlib

from ranks_world import ROOT, events, run_world, slowest, smi, world_size

OUT = os.path.join(ROOT, "chiprun_out", "matrices_ranks")
N = int(os.environ.get("N", 20000))
LINALG_N = int(os.environ.get("LINALG_N", 8192))
REPS = 3
TOL = 1e-4
LR_M = int(os.environ.get("LR_M", 1_000_003))
LR_D, LR_ITERS = 512, 30
# the ranks' float32 sums meet in another order than one card's; a float32
# fit reads 1.8e-07-3.5e-07 of max |w| from float64 at 10^7 rows (PERF.md
# §6), so 1e-5 leaves room for the order and none for a lost or doubled row
LR_TOL = 1e-5


def _crc(t) -> int:
    return zlib.crc32(t.detach().cpu().contiguous().numpy().tobytes())


def rank_main(rank: int, world: int, tmp: str, log) -> None:
    import torch
    import torch.distributed as dist

    import marlin_tpu_torch as mt
    from marlin_tpu_torch import mesh as mm
    from marlin_tpu_torch.io import checkpoint as ck
    from marlin_tpu_torch.ops.local import local_matmul

    figures = {}
    mm.initialize_distributed(f"file://{tmp}/store", world, rank)
    try:
        mesh = mm.create_mesh((world, 1))
        one = mm.Mesh(torch.device("cuda", rank))

        # (a) the multiply
        a = mt.DenseVecMatrix.random(0, N, N, mesh=mesh)
        b = mt.DenseVecMatrix.random(1, N, N, mesh=mesh)
        held = a.data.numel() * a.data.element_size()
        torch.cuda.synchronize()
        dist.barrier()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        c, ms = events(lambda: a.multiply(b, precision="high"), REPS)
        peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
        log(f"rank {rank}: block {tuple(a.data.shape)}, {held / 1e6:g} MB "
            f"held of each operand; multiply {ms:.3f} ms (CUDA events), "
            f"peak +{peak:.2f} GiB")
        figures.update(held_mb=held / 1e6, multiply_ms=slowest(ms),
                       multiply_peak_gib=slowest(peak))
        a_whole, b_whole, c_whole = a.logical(), b.logical(), c.logical()
        if rank == 0:
            ref, ms1 = events(lambda: local_matmul(a_whole, b_whole, "high"),
                              REPS)
            rel = float((c_whole - ref).abs().max() / ref.abs().max())
            log(f"rank 0: one card's torch.matmul {ms1:.3f} ms; C vs it "
                f"{rel:.3e} of max (tol {TOL})")
            if not rel <= TOL:
                raise AssertionError(f"the multiply differs: {rel}")
            figures.update(one_card_ms=ms1, multiply_rel=rel)
            del ref
        del a, b, c, a_whole, b_whole, c_whole
        torch.cuda.empty_cache()

        # (b) LU and Cholesky on row blocks
        n = LINALG_N
        eye = mt.BlockMatrix.from_array(n * torch.eye(n, device="cuda"),
                                        mesh)
        m = mt.BlockMatrix.random(0, n, n, mesh=mesh).add(eye)
        spd = m.add(m.transpose())
        for name, fn in (
                ("lu", lambda: m.lu_decompose(mode="dist",
                                              schedule="shrinking")),
                ("cholesky", lambda: spd.cholesky_decompose(
                    mode="dist", schedule="masked"))):
            fn()  # warm-up: the solver libraries' and the groups' set-up
            torch.cuda.synchronize()
            dist.barrier()
            t0 = time.perf_counter()
            got = fn()
            torch.cuda.synchronize()
            secs = slowest(time.perf_counter() - t0)
            factors = got if isinstance(got, tuple) else (got,)
            whole = [f.logical() if hasattr(f, "logical") else f
                     for f in factors]
            src = (m if name == "lu" else spd).logical()
            if rank == 0:
                mine = mt.BlockMatrix.from_array(src, one)

                def one_card():
                    if name == "lu":
                        return mine.lu_decompose(mode="dist",
                                                 schedule="shrinking")
                    return (mine.cholesky_decompose(mode="dist",
                                                    schedule="masked"),)

                one_card()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                ref = one_card()
                torch.cuda.synchronize()
                secs1 = time.perf_counter() - t0
                scale = float(src.abs().max())
                err = 0.0
                for g, r in zip(whole, ref):
                    r = r.data if hasattr(r, "data") else r
                    if g.dtype == torch.int64:
                        if not torch.equal(g, r):
                            raise AssertionError(f"{name}: perm differs")
                    else:
                        err = max(err, float((g - r).abs().max()) / scale)
                log(f"rank 0: {name} at {n}^2 on row blocks {secs:.3f} s, "
                    f"one card {secs1:.3f} s; factors vs one card {err:.3e} "
                    f"of max (tol {TOL})")
                if not err <= TOL:
                    raise AssertionError(f"{name} differs: {err}")
                figures.update({f"{name}_s": secs, f"{name}_one_card_s":
                                secs1, f"{name}_rel": err})
            del got, factors, whole, src
        del m, spd, eye
        torch.cuda.empty_cache()

        # (c) sharded checkpoints
        path = os.path.join(tmp, "sharded")
        m = mt.DenseVecMatrix.random(3, N, N, mesh=mesh)
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        ck.save_sharded(m, path)
        dist.barrier()
        back = ck.load_sharded(path, m.sharding)
        torch.cuda.synchronize()
        secs = slowest(time.perf_counter() - t0)
        if not torch.equal(back, m.data):
            raise AssertionError(f"rank {rank}: load_sharded differs")
        whole = m.logical()
        if rank == 0:
            figures.update(ckpt_s=secs, ckpt_crc=_crc(whole))
            log(f"rank 0: save_sharded + load_sharded {N}^2 over {world} "
                f"ranks {secs:.3f} s, each rank's region bit-identical")
        del m, back, whole
        torch.cuda.empty_cache()

        # (d) logistic regression on row blocks, the last rank's padded
        from marlin_tpu_torch.ops import lr_gradient as lg

        gen = torch.Generator(device="cuda").manual_seed(5)
        rows = torch.rand((LR_M, LR_D + 1), generator=gen,
                          device="cuda") * 2 - 1
        rows[:, 0] = (rows[:, 0] > 0).float()
        m = mt.DenseVecMatrix.from_array(rows, mesh)
        (r0, r1), _ = m.sharding.bounds(m._padded_shape)
        m.lr(1.0, LR_ITERS)  # warm-up: the kernel's library, the group
        torch.cuda.synchronize()
        dist.barrier()
        before = lg.lr_step.launches
        t0 = time.perf_counter()
        w = m.lr(1.0, LR_ITERS)
        secs = slowest(time.perf_counter() - t0)
        launches = lg.lr_step.launches - before
        log(f"rank {rank}: lr rows [{r0}, {r1}), {min(r1, LR_M) - r0} real; "
            f"{launches} kernel launches")
        if launches != LR_ITERS:
            raise AssertionError(f"rank {rank}: {launches} lr launches for "
                                 f"{LR_ITERS} iterations")
        if rank == 0:
            mine = mt.DenseVecMatrix.from_array(rows, one)
            mine.lr(1.0, LR_ITERS)
            t0 = time.perf_counter()
            w1 = mine.lr(1.0, LR_ITERS)
            secs1 = time.perf_counter() - t0
            rel = float(abs(w - w1).max() / abs(w1).max())
            log(f"rank 0: lr {LR_M} x {LR_D + 1}, {LR_ITERS} iterations on "
                f"row blocks {secs:.3f} s, one card {secs1:.3f} s; weights "
                f"vs one card {rel:.3e} of max (tol {LR_TOL})")
            if not rel <= LR_TOL:
                raise AssertionError(f"lr differs: {rel}")
            figures.update(lr_s=secs, lr_one_card_s=secs1, lr_rel=rel,
                           lr_padded_rows=int(m._padded_shape[0] - LR_M))
            del mine
        del rows, m
    finally:
        mm.shutdown_distributed()
    if rank == 0:
        with open(os.path.join(OUT, "figures.json"), "w") as f:
            json.dump(figures, f)


def main() -> int:
    import torch

    world = world_size(sys.argv[1:])
    with tempfile.TemporaryDirectory() as tmp:
        run_world(rank_main, world, tmp, OUT)
        with open(os.path.join(OUT, "figures.json")) as f:
            figures = json.load(f)
        sys.path.insert(0, ROOT)
        from marlin_tpu_torch.io import checkpoint as ck

        whole = ck.load_sharded(os.path.join(tmp, "sharded"),
                                torch.device("cuda", 0))
        if _crc(whole) != figures["ckpt_crc"]:
            raise AssertionError("the whole restore's CRC differs")
        print(f"parent: the {world}-rank save restored whole on one card, "
              f"CRC equal")
    print(json.dumps(dict(figures, world=world, cards=smi())))
    return 0


if __name__ == "__main__":
    sys.exit(main())
