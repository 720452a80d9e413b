"""Distributed block LU of a matrix loaded from text (counterpart of
``examples/lu_decompose.py``, examples/MatrixLUDecompose.scala: args
``<input path> <rows> <cols> <output path> <parallelism>``; loads a row-text
matrix, runs the dist-mode blocked LU, saves L and U as row text and the
permutation as one comma-separated line). The Spark tuning knobs in :26-37
have no analog — the block size comes from the config (``lu_base_size``)."""

import sys

from marlin_tpu_torch.examples._common import die, millis


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 4:
        die("usage: lu_decompose <input path> <rows> <cols> <output path> [parallelism]")
    path, rows, cols, out = argv[0], int(argv[1]), int(argv[2]), argv[3]
    if rows != cols:
        die("LU needs a square matrix")

    import marlin_tpu_torch as mt

    mesh = mt.create_mesh()
    a = mt.load_matrix_file(path, mesh)
    assert a.shape == (rows, cols), f"file holds {a.shape}, expected {(rows, cols)}"
    t0 = millis()
    l, u, p = a.lu_decompose(mode="dist")
    mt.evaluate(l, u)
    print(f"LU used {millis() - t0:.1f} millis")
    l.save_to_file_system(out + ".L")
    u.save_to_file_system(out + ".U")
    with open(out + ".perm", "w") as f:
        # one bulk read of the device permutation, not one per row
        f.write(",".join(map(str, p.cpu().tolist())))
    print(f"saved {out}.L / {out}.U / {out}.perm")


if __name__ == "__main__":
    main()
