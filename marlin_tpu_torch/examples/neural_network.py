"""Two-layer MLP training (counterpart of ``examples/neural_network.py``,
examples/NeuralNetwork.scala): MNIST (idx files) or a synthetic fallback;
block-sampled mini-batch SGD, one step per iteration on the device (see
marlin_tpu_torch/ml/neural_network.py). The weights go to
``/tmp/marlin_tpu_torch_nn_weights.*.csv``, apart from the JAX CLI's.

args: ``<images path | 'synthetic'> [labels path] [iterations] [hidden]
[learning rate] [batch size]``
"""

import sys

from marlin_tpu_torch.examples._common import die, millis

WEIGHTS = "/tmp/marlin_tpu_torch_nn_weights"


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 1:
        die(
            "usage: neural_network <images idx path | 'synthetic'> [labels idx path]"
            " [iterations] [hidden] [lr] [batch]"
        )
    images = None if argv[0] == "synthetic" else argv[0]
    labels_path = argv[1] if len(argv) > 1 and argv[1] != "-" else None
    iterations = int(argv[2]) if len(argv) > 2 else 200
    hidden = int(argv[3]) if len(argv) > 3 else 100
    lr = float(argv[4]) if len(argv) > 4 else 0.5
    batch = int(argv[5]) if len(argv) > 5 else 256

    import marlin_tpu_torch as mt
    from marlin_tpu_torch.io.mnist import load_or_synthesize
    from marlin_tpu_torch.ml import NeuralNetwork

    x, y = load_or_synthesize(images, labels_path)
    mesh = mt.create_mesh()
    data = mt.DenseVecMatrix.from_array(x, mesh)
    classes = int(y.max()) + 1

    nn = NeuralNetwork(input_dim=x.shape[1], hidden_dim=hidden,
                       output_dim=classes, learning_rate=lr)
    t0 = millis()
    params, losses = nn.train(data, y, iterations=iterations, batch_size=batch,
                              log_every=max(1, iterations // 10))
    dt = millis() - t0
    acc = nn.accuracy(params, data, y)
    print(f"training used {dt:.1f} millis ({dt / iterations:.2f} ms/iter), "
          f"final loss {losses[-1]:.5f}, train accuracy {acc:.4f}")
    nn.save_weights(params, WEIGHTS)
    print(f"weights saved to {WEIGHTS}.*.csv")


if __name__ == "__main__":
    main()
