"""Distributed vector inner product (counterpart of ``examples/blas1.py``,
examples/BLAS1.scala: args ``<local|dist> <vector length> <split num>``;
times a row-vector × column-vector dot in either mode)."""

import sys

from marlin_tpu_torch.examples._common import die, millis


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 3:
        die("usage: blas1 <local|dist> <vector length> <split num>")
    mode, length = argv[0], int(argv[1])
    if mode not in ("local", "dist"):
        die("the computing mode should either be 'local' or 'dist'")

    import marlin_tpu_torch as mt

    mesh = mt.create_mesh()
    x = mt.DistributedVector.random(0, length, mesh=mesh, column_major=False)
    y = mt.DistributedVector.random(1, length, mesh=mesh, column_major=True)
    mt.evaluate(x.data, y.data)
    t0 = millis()
    result = float(x.multiply(y, mode=mode))
    print(f"used time {millis() - t0:.1f} millis, inner product = {result:.6f}")
    return result


if __name__ == "__main__":
    main()
