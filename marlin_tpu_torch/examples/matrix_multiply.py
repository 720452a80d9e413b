"""Adaptive dense matrix multiply — the flagship benchmark.

Counterpart of ``examples/matrix_multiply.py`` (examples/MatrixMultiply.scala):
args ``<A rows> <A cols/B rows> <B cols> <parallelism> [broadcast threshold
MB]``; two random dense matrices generated on the device, the adaptive
multiply (broadcast vs CARMA-split RMM, one ``torch.matmul`` at world size
1), wall-clock printed. ``parallelism`` is read for the contract and, as in
the JAX CLI, not used.

Optionally pass ``--files a.txt b.txt`` to load the operands from row-text
files instead (BASELINE.md config 1 uses data/a.100.100 · data/b.100.100).
"""

import sys

from marlin_tpu_torch.examples._common import die, millis


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    files = None
    if "--files" in argv:
        i = argv.index("--files")
        files = argv[i + 1 : i + 3]
        if len(files) != 2:
            die("--files needs two paths: --files A.txt B.txt")
        del argv[i : i + 3]
    if len(argv) < 4 and files is None:
        die(
            "usage: matrix_multiply <A rows> <A cols/B rows> <B cols> <parallelism>"
            " [broadcast threshold MB]\n   or: matrix_multiply --files A.txt B.txt"
        )

    import marlin_tpu_torch as mt

    mesh = mt.create_mesh()
    if files:
        a = mt.load_matrix_file(files[0], mesh)
        b = mt.load_matrix_file(files[1], mesh)
    else:
        m, k, n = int(argv[0]), int(argv[1]), int(argv[2])
        a = mt.DenseVecMatrix.random(0, m, k, mesh=mesh)
        b = mt.DenseVecMatrix.random(1, k, n, mesh=mesh)
    threshold = float(argv[4]) if len(argv) > 4 else None
    mt.evaluate(a, b)

    t0 = millis()
    c = a.multiply(b, broadcast_threshold_mb=threshold)
    mt.evaluate(c)
    dt = millis() - t0
    flops = 2.0 * a.num_rows() * a.num_cols() * c.num_cols()
    print(f"used time {dt:.1f} millis, result blocks: {c.elements_count()}")
    print(f"effective {flops / dt / 1e6:.1f} GFLOP/s")
    return c


if __name__ == "__main__":
    main()
