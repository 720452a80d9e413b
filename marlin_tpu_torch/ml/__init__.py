"""Machine-learning workloads on the port's matrices (counterpart of
``marlin_tpu/ml``). Ported so far: full-batch logistic regression; ALS, the
MLP trainer and PageRank wait (ROADMAP queue 1 item 10)."""

from .logistic_regression import logistic_regression, LogisticRegressionModel  # noqa: F401
