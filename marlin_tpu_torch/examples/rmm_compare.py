"""Multiply-strategy comparison (counterpart of ``examples/rmm_compare.py``,
examples/RMMcompare.scala: args ``<A rows> <A cols> <B cols> <mode> [m k
n]``; the reference compares RMM variants, with only "RMMv2" live — :13-16,
:39-58). Every live strategy competes (explicit-split RMM, the
partitioner-scheduled contraction and broadcast: each one ``torch.matmul``
at world size 1); each is timed after a warm-up call and the winner
reported. ``tuned`` runs :func:`marlin_tpu_torch.tune_multiply`, which lands
each timed strategy in ``ProgramCosts`` under program ``"multiply"``."""

import sys

from marlin_tpu_torch.examples._common import die, millis


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 3:
        die("usage: rmm_compare <A rows> <A cols> <B cols> "
            "[mode: rmm|gspmd|broadcast|all|tuned] [m k n]")
    rows, k, cols = (int(x) for x in argv[:3])
    mode = argv[3] if len(argv) > 3 else "all"
    split = tuple(int(x) for x in argv[4:7]) if len(argv) >= 7 else None

    import marlin_tpu_torch as mt

    mesh = mt.create_mesh()
    a = mt.BlockMatrix.random(0, rows, k, mesh=mesh)
    b = mt.BlockMatrix.random(1, k, cols, mesh=mesh)
    mt.evaluate(a, b)

    if mode == "tuned":
        # the programmatic form of this whole example: time every viable
        # engine, cache the winner for strategy="tuned" dispatch
        table = mt.tune_multiply(a, b)
        for s, sec in table:
            print(f"{s}: {sec * 1e3:.1f} millis")
        print(f"fastest: {table[0][0]} ({table[0][1] * 1e3:.1f} millis)")
        return dict((s, sec * 1e3) for s, sec in table)

    strategies = ["rmm", "gspmd", "broadcast"] if mode == "all" else [mode]
    timings = {}
    for strategy in strategies:
        kwargs = {"split": split} if strategy == "rmm" else {}
        mt.evaluate(a.multiply(b, strategy=strategy, **kwargs))  # warm-up
        t0 = millis()
        mt.evaluate(a.multiply(b, strategy=strategy, **kwargs))
        timings[strategy] = millis() - t0
        print(f"{strategy}: {timings[strategy]:.1f} millis")
    best = min(timings, key=timings.get)
    print(f"fastest: {best} ({timings[best]:.1f} millis)")
    return timings


if __name__ == "__main__":
    main()
