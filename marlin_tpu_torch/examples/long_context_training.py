"""Long-context LM training demo (counterpart of
``examples/long_context_training.py``; no reference analog — the training
form of the long-context mandate): one long token stream, causal
transformer, ring or Ulysses attention (the flash forward and backward
kernels on the card), trained with Adam. Prints the loss trajectory and
tokens/s.

args: ``<seq len> <steps> [d_model] [heads] [layers] [ring|ulysses] [remat
0|1] [loss_chunk] [dtype]`` — ``loss_chunk`` runs the LM head over chunks
of tokens and ``dtype`` (``bfloat16``) selects mixed-precision activations.
``plan`` in place of the knob tail (``... [ring|ulysses] plan``) lets
:func:`marlin_tpu_torch.models.plan_context` pick every memory knob, one
measured training step per probed rung on the card (the CPU has no default
measure: it raises). After training, a greedy ``lm_generate`` sample
continues the stream from a short prompt. Called on every rank of a
``torch.distributed`` world, each rank of the mesh's rows axis trains on
its block of the stream.
"""

import sys

from marlin_tpu_torch.examples._common import die, millis


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 2:
        die("usage: long_context_training <seq len> <steps> [d_model] [heads] "
            "[layers] [ring|ulysses] [remat 0|1] [loss_chunk] [dtype] "
            "(or: ... [ring|ulysses] plan)")
    seq = int(argv[0])
    steps = int(argv[1])
    d_model = int(argv[2]) if len(argv) > 2 else 128
    heads = int(argv[3]) if len(argv) > 3 else 8
    layers = int(argv[4]) if len(argv) > 4 else 2
    attn = argv[5] if len(argv) > 5 else "ring"
    use_planner = len(argv) > 6 and argv[6] == "plan"
    if use_planner and len(argv) > 7:
        die("'plan' replaces the remaining knob args (the planner picks "
            "them); drop " + " ".join(argv[7:]))
    remat = bool(int(argv[6])) if len(argv) > 6 and not use_planner else False
    loss_chunk = int(argv[7]) if len(argv) > 7 else None
    compute_dtype = argv[8] if len(argv) > 8 else None

    import marlin_tpu_torch as mt
    from marlin_tpu_torch.models import TransformerLM, lm_generate
    from marlin_tpu_torch.models.transformer import synthetic_stream

    mesh = mt.create_mesh()
    vocab = 512
    tokens = synthetic_stream(seq, vocab=vocab, period=16, step=7)

    lm = TransformerLM(vocab=vocab, d_model=d_model, heads=heads,
                       layers=layers, attn=attn, remat=remat,
                       loss_chunk=loss_chunk, compute_dtype=compute_dtype)
    if use_planner:
        from marlin_tpu_torch.models import plan_context

        # plan for the ring the training step runs over: the sequence
        # shards across the mesh "rows" axis
        plan = plan_context(seq, lm, chips=mesh.shape["rows"], mesh=mesh)
        print(plan.describe())
        if not plan.fits:
            die("no knob set fits usable HBM — shard over more chips "
                "(plan_context(chips=...)) or shrink the model")
        lm = plan.model
        remat, loss_chunk, compute_dtype = lm.remat, lm.loss_chunk, \
            lm.compute_dtype
    lm.train(tokens, steps=1, mesh=mesh)  # warm-up
    t0 = millis()
    params, losses = lm.train(tokens, steps=steps, mesh=mesh)
    dt = millis() - t0
    tok_s = seq * steps / (dt / 1e3)
    print(f"seq={seq} d={d_model} heads={heads} layers={layers} {attn}"
          f"{' remat' if remat else ''}"
          f"{f' loss_chunk={loss_chunk}' if loss_chunk else ''}"
          f"{f' {compute_dtype}' if compute_dtype else ''}: "
          f"loss {losses[0]:.3f} -> "
          f"{losses[-1]:.3f} in {dt:.0f} millis ({tok_s / 1e3:.1f}k tok/s)")

    # KV-cached greedy decode continuing the training stream
    n_prompt = min(32, seq // 2)
    n_new = min(16, seq - n_prompt)
    out = lm_generate(params, tokens[:n_prompt], 0, heads=heads, steps=n_new,
                      max_len=n_prompt + n_new, temperature=0.0)
    cont = out[n_prompt:].cpu().numpy()
    match = int((cont == tokens[n_prompt:n_prompt + n_new]).sum())
    print(f"greedy continuation matches stream: {match}/{n_new} tokens")
    return losses


if __name__ == "__main__":
    main()
