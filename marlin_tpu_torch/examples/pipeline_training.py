"""Pipeline-parallel LM training demo (counterpart of
``examples/pipeline_training.py``; no reference analog — the GPipe family
applied to the flagship model): the transformer's layer stack splits into one
stage group per rank of the mesh rows axis; microbatches of short sequences
stream through the stages, activations hopping rank to rank; embedding and
the LM head run outside the pipeline. The backward pipeline comes out of
autograd. Prints the loss trajectory and tokens/s.

args: ``<batch> <seq len> <steps> [d_model] [layers] [microbatch]``
(layers must divide by the mesh rows axis). Runs on one device as one
stage, or on every rank of a ``torch.distributed`` world
(:func:`marlin_tpu_torch.mesh.initialize_distributed`, then this ``main`` on
every rank; run as a module under ``torchrun``, it joins the world itself).
"""

import sys

from marlin_tpu_torch.examples._common import die, millis


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 3:
        die("usage: pipeline_training <batch> <seq len> <steps> [d_model] "
            "[layers] [microbatch]")
    batch = int(argv[0])
    seq = int(argv[1])
    steps = int(argv[2])
    d_model = int(argv[3]) if len(argv) > 3 else 128
    layers = int(argv[4]) if len(argv) > 4 else None
    microbatch = int(argv[5]) if len(argv) > 5 else None

    import numpy as np

    import marlin_tpu_torch as mt
    from marlin_tpu_torch.models import transformer as tt
    from marlin_tpu_torch.models.pipeline_lm import (pp_lm_train_step,
                                                     pp_stage_params)

    mesh = mt.create_mesh()
    stages = mesh.shape["rows"]
    if layers is None:
        layers = stages  # one block per stage
    heads = max(1, d_model // 64)
    vocab = 512
    toks = np.stack([tt.synthetic_stream(seq, vocab=vocab, seed=i, period=16,
                                         step=7) for i in range(batch)])

    params = tt.init_transformer(0, vocab, d_model, heads, layers,
                                 device=mesh.device)
    sp, outer = pp_stage_params(params, mesh)
    opt_state = tt.adam_init((sp, outer))
    print(f"pipeline: {stages} stages x {layers // stages} blocks, "
          f"batch {batch} x {seq} tokens")

    losses = []
    t0 = None
    for it in range(steps):
        sp, outer, opt_state, l = pp_lm_train_step(
            sp, outer, opt_state, toks, mesh, heads=heads,
            microbatch=microbatch, lr=3e-3)
        losses.append(float(l))  # sync point
        if it == 0:
            t0 = millis()  # time past the first (warm-up) step
    dt = (millis() - t0) / 1000.0 if steps > 1 else 0.0
    print(f"loss: {losses[0]:.4f} -> {losses[-1]:.4f} over {steps} steps")
    if steps > 1:
        print(f"throughput: {batch * seq * (steps - 1) / dt:,.0f} tok/s "
              f"({dt:.1f} s after compile)")
    return losses


if __name__ == "__main__":
    import os

    from marlin_tpu_torch import mesh

    if int(os.environ.get("WORLD_SIZE", "1")) > 1:  # started by torchrun
        mesh.initialize_distributed()
    try:
        main()
    finally:
        mesh.shutdown_distributed()
