"""Mixture-of-experts LM training demo (counterpart of
``examples/moe_training.py``; no reference analog): the FFN of every layer
routes each token to its top-k of E experts (GShard capacity routing,
``models/moe.py``), trained with Adam (the flash forward and backward
kernels on the card). Called on every rank of a ``torch.distributed``
world, the stream is sharded over the mesh's rows axis and the experts
with it (expert parallelism: two all-to-alls a MoE layer). Prints the loss
trajectory, the load-balance aux (1.0 = perfectly balanced routing),
tokens/s, and a greedy sample decoded through the exact single-token MoE
path.

args: ``<seq len> <steps> [n_experts] [top_k] [d_model] [layers]``
"""

import sys

from marlin_tpu_torch.examples._common import die, millis


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 2:
        die("usage: moe_training <seq len> <steps> [n_experts] [top_k] "
            "[d_model] [layers]")
    seq = int(argv[0])
    steps = int(argv[1])
    n_experts = int(argv[2]) if len(argv) > 2 else 8
    top_k = int(argv[3]) if len(argv) > 3 else 2
    d_model = int(argv[4]) if len(argv) > 4 else 128
    layers = int(argv[5]) if len(argv) > 5 else 2

    import torch

    import marlin_tpu_torch as mt
    from marlin_tpu_torch.models import TransformerLM
    from marlin_tpu_torch.models.moe import moe_ffn
    from marlin_tpu_torch.models.transformer import synthetic_stream

    mesh = mt.create_mesh()
    vocab = 512
    tokens = synthetic_stream(seq, vocab=vocab, period=16, step=7)

    lm = TransformerLM(vocab=vocab, d_model=d_model,
                       heads=max(1, d_model // 64), layers=layers,
                       learning_rate=3e-3, n_experts=n_experts,
                       moe_top_k=top_k)
    t0 = millis()
    params, losses = lm.train(tokens, steps=steps, mesh=mesh)
    dt = (millis() - t0) / 1000.0
    print(f"loss: {losses[0]:.4f} -> {losses[-1]:.4f} over {steps} steps")
    print(f"throughput: {seq * steps / dt:,.0f} tok/s ({dt:.1f} s)")

    # routing balance after training (the aux the loss regularized)
    emb = params["emb"]
    probe = emb[torch.as_tensor(tokens[:1024], device=emb.device).long()]
    _, aux = moe_ffn(params["l0"]["moe"], probe, mesh=None, top_k=top_k)
    print(f"layer-0 load-balance aux on a 1k-token probe: {float(aux):.3f} "
          f"(1.0 = balanced)")

    prompt = tokens[:16]
    sample = lm.generate(params, list(prompt), steps=32)
    print("greedy continuation:",
          list(map(int, sample[len(prompt):].tolist())))
    return losses


if __name__ == "__main__":
    main()
