"""Batched serving decode demo (counterpart of ``examples/decode_serving.py``;
no reference analog): train a small LM on a periodic stream, then decode a
RAGGED batch of prompts together with :func:`lm_generate_batch` — each row
continues from its own prompt length, per-step matmuls are (B, d) work —
and report batched vs one-at-a-time throughput.

args: ``<batch size> <prompt len> <steps> [d_model] [heads] [layers]
[temperature] [kv_heads]`` — rows get staggered prompt lengths around
``prompt len`` so the ragged path (per-row positions) really runs;
``kv_heads`` enables grouped-query attention (the KV cache shrinks by
``heads/kv_heads``).
"""

import sys

from marlin_tpu_torch.examples._common import die, millis


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 3:
        die("usage: decode_serving <batch size> <prompt len> <steps> "
            "[d_model] [heads] [layers] [temperature] [kv_heads]")
    batch = int(argv[0])
    prompt_len = int(argv[1])
    steps = int(argv[2])
    d_model = int(argv[3]) if len(argv) > 3 else 128
    heads = int(argv[4]) if len(argv) > 4 else 8
    layers = int(argv[5]) if len(argv) > 5 else 2
    temperature = float(argv[6]) if len(argv) > 6 else 0.0
    kv_heads = int(argv[7]) if len(argv) > 7 else None
    if prompt_len < batch:
        die("prompt len must be >= batch size (rows stagger by one token)")

    import numpy as np

    import marlin_tpu_torch as mt
    from marlin_tpu_torch.models import TransformerLM
    from marlin_tpu_torch.models.transformer import synthetic_stream

    mt.create_mesh()  # the configured device, or the refusal without one
    vocab, period = 512, 16
    lm = TransformerLM(vocab=vocab, d_model=d_model, heads=heads,
                       layers=layers, learning_rate=3e-3, kv_heads=kv_heads)
    stream = synthetic_stream(max(4096, 4 * prompt_len), vocab=vocab,
                              period=period, step=7, noise=0.05)
    params, losses = lm.train(stream, steps=30)

    # ragged batch: row b's prompt is the stream's first (prompt_len - b)
    # tokens — staggered starts exercise the per-row position bookkeeping
    prompts = [stream[: prompt_len - b].tolist() for b in range(batch)]

    # warm-up-then-time (the repo discipline): the first call of each shape
    # pays one-time costs (allocator growth, kernel loads)
    sample = prompts[: min(4, batch)]
    outs = lm.generate_batch(params, prompts, steps=steps,
                             temperature=temperature)  # warm (results kept)
    singles = [lm.generate(params, p, steps=steps,
                           temperature=temperature).cpu().numpy()
               for p in sample]  # warm each shape (results kept)
    t0 = millis()
    lm.generate_batch(params, prompts, steps=steps, temperature=temperature)
    batch_ms = millis() - t0
    t0 = millis()
    for p in sample:
        lm.generate(params, p, steps=steps, temperature=temperature).cpu()
    single_ms = (millis() - t0) / len(sample)

    # greedy rows must agree with the one-at-a-time path
    if temperature == 0.0:
        for got, want in zip(outs, singles):
            assert np.asarray(got).tolist() == want.tolist(), \
                "batched row diverged from single decode"

    tok_batch = batch * steps / (batch_ms / 1e3)
    tok_single = steps / (single_ms / 1e3)
    print(f"loss {losses[0]:.2f} -> {losses[-1]:.2f}; batch={batch} "
          f"steps={steps}: {tok_batch:.0f} tok/s batched vs "
          f"{tok_single:.0f} tok/s one-at-a-time "
          f"({tok_batch / max(tok_single, 1e-9):.1f}x)")
    return outs


if __name__ == "__main__":
    main()
