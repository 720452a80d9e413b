"""End-to-end training demo with checkpoint-based fault tolerance
(counterpart of ``examples/distributed_training.py``): the MLP workload
(examples/NeuralNetwork.scala) on a (data-parallel, tensor-parallel) mesh,
stepped through a ResilientLoop that checkpoints every k steps.

The port's world is one device: the mesh is ``best_grid(1)`` = (1, 1), and
the whole batch and hidden dimension live on it. The multi-device form
(batch over "rows", hidden over "cols") waits for ``torch.distributed``
(ROADMAP queue 1 item 12).

args: ``[iterations] [hidden] [batch] [checkpoint dir]``
"""

import sys

import numpy as np

from marlin_tpu_torch.examples._common import millis


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    iterations = int(argv[0]) if len(argv) > 0 else 600
    hidden = int(argv[1]) if len(argv) > 1 else 64
    batch = int(argv[2]) if len(argv) > 2 else 256
    ckpt_dir = argv[3] if len(argv) > 3 else "/tmp/marlin_tpu_torch_dist_train"

    import torch

    import marlin_tpu_torch as mt
    from marlin_tpu_torch.io.mnist import synthetic_mnist
    from marlin_tpu_torch.mesh import best_grid
    from marlin_tpu_torch.ml.neural_network import mlp_forward, mlp_init, train_step
    from marlin_tpu_torch.utils import EventLog, ResilientLoop

    n_dev = 1
    dp, tp = best_grid(n_dev)
    mesh = mt.create_mesh((dp, tp))
    print(f"mesh: {dp} data-parallel x {tp} tensor-parallel over {n_dev} devices")

    x_np, y_np = synthetic_mnist(4096)
    classes = int(y_np.max()) + 1
    x = torch.as_tensor(x_np, device=mesh.device)
    y = torch.nn.functional.one_hot(
        torch.as_tensor(y_np, dtype=torch.long, device=mesh.device),
        classes).to(x.dtype)

    params = mlp_init(0, (x.shape[1], hidden, classes), device=mesh.device)

    log = EventLog(ckpt_dir + "/events.jsonl")

    def step(params, i):
        # the library's step (strided sampling, grad, SGD update)
        params, loss = train_step(params, x, y, i, batch, 1.0)
        log.event("step", step=i, loss=float(loss))
        return params, float(loss)

    loop = ResilientLoop(step, ckpt_dir, checkpoint_every=max(1, iterations // 5))
    t0 = millis()
    params, losses = loop.run(params, iterations)
    dt = millis() - t0

    with torch.no_grad():
        pred = mlp_forward(params, x).argmax(dim=-1)
    acc = float((pred.cpu().numpy() == y_np).mean())
    if losses:
        print(f"{len(losses)} steps in {dt:.0f} ms ({dt / len(losses):.1f} ms/step), "
              f"loss {losses[0]:.4f} -> {losses[-1]:.4f}, accuracy {acc:.3f}")
    else:
        print(f"checkpoint already at or past {iterations} steps — nothing to run; "
              f"accuracy {acc:.3f}")
    print(f"checkpoints + event log in {ckpt_dir}")


if __name__ == "__main__":
    main()
