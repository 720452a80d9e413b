"""ALS on a ratings file (counterpart of ``examples/als.py``,
examples/ALS.scala: args ``<input> <rank> <iterations> [lambda]``; input is
COO text — MovieLens-style ``user item rating [timestamp]`` lines, loaded
via loadCoordinateMatrix)."""

import sys

from marlin_tpu_torch.examples._common import die, millis


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 3:
        die("usage: als <input path> <rank> <iterations> [lambda]")
    path, rank, iterations = argv[0], int(argv[1]), int(argv[2])
    lam = float(argv[3]) if len(argv) > 3 else 0.01

    import marlin_tpu_torch as mt

    mesh = mt.create_mesh()
    ratings = mt.load_coordinate_matrix(path, mesh=mesh)
    print(f"loaded {ratings.nnz} ratings, shape {ratings.shape}")
    t0 = millis()
    model = ratings.als(rank=rank, iterations=iterations, lam=lam)
    dt = millis() - t0
    print(f"used time {dt:.1f} millis, train RMSE {model.rmse(ratings):.4f}")


if __name__ == "__main__":
    main()
