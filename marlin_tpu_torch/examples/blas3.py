"""Three multiply modes (counterpart of ``examples/blas3.py``,
examples/BLAS3.scala: args ``<A rows> <A cols> <B cols> <mode> [m k n]``):
mode 1 = collect both to the host and multiply there,
mode 2 = broadcast one operand,
mode 3 = RMM with an explicit (m, k, n) split. The world has one device, so
an explicit split must multiply to 1: a larger one raises the ``ValueError``
the JAX package's ``build_rmm_mesh`` raises with too few devices."""

import sys

import numpy as np

from marlin_tpu_torch.examples._common import die, millis


USAGE = (
    "usage: blas3 <A rows> <A cols> <B cols> <mode> [m k n]\n"
    "  mode 1: collect to local then multiply\n"
    "  mode 2: broadcast one matrix then multiply\n"
    "  mode 3: RMM with explicit (m, k, n) split\n"
    "example: blas3 10000 10000 10000 3 2 2 2"
)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 4:
        die(USAGE)
    rows, k, cols, mode = (int(x) for x in argv[:4])

    import marlin_tpu_torch as mt

    mesh = mt.create_mesh()
    a = mt.DenseVecMatrix.random(0, rows, k, mesh=mesh)
    b = mt.DenseVecMatrix.random(1, k, cols, mesh=mesh)
    mt.evaluate(a, b)

    t0 = millis()
    if mode == 1:
        result = np.asarray(a.to_numpy() @ b.to_numpy())
        print(f"local multiply used {millis() - t0:.1f} millis, sum {result.sum():.4f}")
    elif mode == 2:
        c = mt.evaluate(a.multiply(b, strategy="broadcast"))
        print(f"broadcast multiply used {millis() - t0:.1f} millis, blocks {c.elements_count()}")
    elif mode == 3:
        split = tuple(int(x) for x in argv[4:7]) if len(argv) >= 7 else None
        c = mt.evaluate(a.multiply(b, strategy="rmm", split=split))
        print(f"rmm multiply split={split} used {millis() - t0:.1f} millis, blocks {c.elements_count()}")
    else:
        die(USAGE)


if __name__ == "__main__":
    main()
