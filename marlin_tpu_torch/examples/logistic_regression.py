"""Full-batch logistic regression (counterpart of
``examples/logistic_regression.py``, examples/LogisticRegression.scala: args
``<iterations> <step size>``; the reference generates data and fits via
distributed mat-vec products with a custom co-partitioner :21-28 — here the
labels and features are one matrix on the device)."""

import sys

import numpy as np

from marlin_tpu_torch.examples._common import die, millis


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 1:
        die("usage: logistic_regression <iterations> [step size] [rows] [features]")
    iterations = int(argv[0])
    step = float(argv[1]) if len(argv) > 1 else 1.0
    rows = int(argv[2]) if len(argv) > 2 else 10000
    feats = int(argv[3]) if len(argv) > 3 else 100

    import marlin_tpu_torch as mt
    from marlin_tpu_torch.ml import logistic_regression

    mesh = mt.create_mesh()
    rng = np.random.default_rng(0)
    x = rng.standard_normal((rows, feats)).astype(np.float32)
    w_true = rng.standard_normal(feats)
    y = (x @ w_true > 0).astype(np.float32)
    data = mt.DenseVecMatrix.from_array(np.concatenate([y[:, None], x], axis=1), mesh)

    t0 = millis()
    model = logistic_regression(data, step_size=step, iterations=iterations)
    dt = millis() - t0
    acc = float((model.predict(x) == y).mean())
    print(f"used time {dt:.1f} millis, train accuracy {acc:.4f}")


if __name__ == "__main__":
    main()
