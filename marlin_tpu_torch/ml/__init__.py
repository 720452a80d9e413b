"""Machine-learning workloads on the port's matrices (counterpart of
``marlin_tpu/ml``): ALS, the MLP trainer, logistic regression and
PageRank."""

from .als import als_run, ALSModel  # noqa: F401
from .neural_network import NeuralNetwork, mlp_init, mlp_forward, train_step  # noqa: F401
from .logistic_regression import logistic_regression, LogisticRegressionModel  # noqa: F401
from .pagerank import (pagerank, build_transition_matrix,  # noqa: F401
                       build_transition_operator, TransitionOperator)
