"""Long-sequence attention demo (counterpart of ``examples/attention.py``;
no reference analog — the long-context capability the rebuild adds; see
docs/parallelism.md). At world size 1 on the card both strategies run the
flash forward kernel (``csrc/flash_attention.cuh``) up to head dim 256.

args: ``<sequence length> [head dim] [causal 0|1] [heads] [strategy]``
``strategy``: "ring" (default) or "ulysses" (all-to-all head-parallel;
needs ``heads`` divisible by the mesh's "rows" axis).
"""

import sys

import numpy as np

from marlin_tpu_torch.examples._common import die, millis


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 1:
        die("usage: attention <sequence length> [head dim] [causal 0|1] "
            "[heads] [ring|ulysses]")
    seq = int(argv[0])
    d = int(argv[1]) if len(argv) > 1 else 128
    causal = bool(int(argv[2])) if len(argv) > 2 else True
    heads = int(argv[3]) if len(argv) > 3 else 0
    strategy = argv[4] if len(argv) > 4 else "ring"
    if strategy not in ("ring", "ulysses"):
        die(f"unknown strategy {strategy!r} (ring|ulysses)")
    if strategy == "ulysses" and not heads:
        die("ulysses needs an explicit head count (heads % mesh rows == 0)")

    import torch

    import marlin_tpu_torch as mt

    mesh = mt.create_mesh()
    rng = np.random.default_rng(0)
    shape = (heads, seq, d) if heads else (seq, d)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
               .to(mesh.device) for _ in range(3))

    attn = mt.ring_attention if strategy == "ring" else mt.ulysses_attention
    out = attn(q, k, v, mesh, causal=causal)  # warm-up
    float(out.sum())
    t0 = millis()
    out = attn(q, k, v, mesh, causal=causal)
    float(out.sum())
    dt = millis() - t0
    n_heads = heads or 1
    flops = 4.0 * n_heads * seq * seq * d * (0.5 if causal else 1.0)
    ring = mesh.shape.get("rows", 1)
    print(f"seq={seq} d={d} heads={n_heads} causal={causal} ring={ring} "
          f"{strategy}: {dt:.1f} millis, ~{flops / dt / 1e6:.1f} GFLOP/s")


if __name__ == "__main__":
    main()
