"""End-to-end training demo with checkpoint-based fault tolerance
(counterpart of ``examples/distributed_training.py``): the MLP workload
(examples/NeuralNetwork.scala) on a (data-parallel, tensor-parallel) mesh,
stepped through a ResilientLoop that checkpoints every k steps.

The mesh is ``best_grid`` of the world's ranks: the sampled batch rows over
"rows", the hidden dimension over "cols" (``w0``'s columns, ``w1``'s rows),
one all-reduce of the second product over "cols" and of the gradients over
"rows" (``ml.neural_network.train_step(mesh=...)``). Without a process
group the world is one device; run as a module under ``torchrun`` it joins
the world itself (or call :func:`marlin_tpu_torch.mesh.
initialize_distributed`, then this ``main`` on every rank). Every rank keeps
the same whole params and checkpoints them into its own ``rank{r}``
directory below the checkpoint dir.

    torchrun --nproc-per-node 4 -m marlin_tpu_torch.examples.distributed_training 500

args: ``[iterations] [hidden] [batch] [checkpoint dir]``
"""

import os
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
    from marlin_tpu_torch import mesh as mm
    from marlin_tpu_torch.io.mnist import synthetic_mnist
    from marlin_tpu_torch.mesh import best_grid
    from marlin_tpu_torch.ml.neural_network import mlp_forward, mlp_init, train_step
    from marlin_tpu_torch.utils import EventLog, ResilientLoop

    n_dev = mm.world_size()
    dp, tp = best_grid(n_dev)
    mesh = mt.create_mesh((dp, tp))
    print(f"mesh: {dp} data-parallel x {tp} tensor-parallel over {n_dev} devices")
    run_dir = ckpt_dir
    if mm.distributed():
        run_dir = os.path.join(ckpt_dir, f"rank{torch.distributed.get_rank()}")

    x_np, y_np = synthetic_mnist(4096)
    classes = int(y_np.max()) + 1
    x = torch.as_tensor(x_np, device=mesh.device)
    y = torch.nn.functional.one_hot(
        torch.as_tensor(y_np, dtype=torch.long, device=mesh.device),
        classes).to(x.dtype)

    params = mlp_init(0, (x.shape[1], hidden, classes), device=mesh.device)

    log = EventLog(run_dir + "/events.jsonl")

    def step(params, i):
        # the library's step (strided sampling, grad, SGD update)
        params, loss = train_step(params, x, y, i, batch, 1.0, mesh=mesh)
        log.event("step", step=i, loss=float(loss))
        return params, float(loss)

    loop = ResilientLoop(step, run_dir, checkpoint_every=max(1, iterations // 5))
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
    from marlin_tpu_torch import mesh

    if int(os.environ.get("WORLD_SIZE", "1")) > 1:  # started by torchrun
        mesh.initialize_distributed()
    try:
        main()
    finally:
        mesh.shutdown_distributed()
