"""Times the flash forward, dK/dV and dQ kernels on the card at latent
attention's head widths, q/k 192 and v 128 (the (192, 128) instances),
against the same attention with v zero-padded to 192 (the 256-wide
instances, the only way the kernels ran it before), and at the square 128
for scale; prints ``ptxas`` registers and spills of every flash instance.
Each row names the forward's design (``fwd_design``: wgmma for bf16 at
(192, 128) and 128, mma.sync for f32 and the padded widths) and gives the
kernel's bound at 989 TFLOP/s bf16 or 165 TFLOP/s f32 (three TF32 passes)
beside its time.

    python tools/flash_mla_bench.py [--heads 16] [--seq 32768] [--reps 5]

Times are CUDA events around ``--reps`` launches after a warm-up launch;
TFLOP/s count what each kernel must do, per live (query, key) pair of the
causal panel: 2 (dqk + dv) forward, 4 (dqk + dv) dK/dV, 4 dqk + 2 dv dQ.
Prints one JSON line per (kernel, widths, dtype).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import re
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from marlin_tpu_torch.ops import _build  # noqa: E402
from marlin_tpu_torch.ops import flash_attention as fa  # noqa: E402


def ptxas_lines() -> list[str]:
    """The flash kernels' lines of ``-Xptxas -v``: each function's name,
    then its registers and spill stores."""
    out, name = [], None
    for line in _build.ptxas_report().splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
        elif name and "flash" in name and ("registers" in line
                                           or "spill" in line):
            out.append(f"{name}: {line.strip()}")
    return out


def timed(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def one(H, S, dqk, dv, dtype, reps, pad_v=False):
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(dqk + dv)
    q, k = (torch.randn((H, S, dqk), generator=g, device=dev).to(dtype)
            for _ in range(2))
    v = torch.randn((H, S, dv), generator=g, device=dev).to(dtype)
    do = torch.randn((H, S, dv), generator=g, device=dev).to(dtype)
    if pad_v:  # v and dO zero-padded to q's width: the 256-wide instances
        v, do = (torch.nn.functional.pad(t, (0, dqk - dv)) for t in (v, do))
    scale = 1.0 / math.sqrt(dqk)
    kw = dict(causal=True, scale=scale)
    m = torch.full((H, S), -1e30, device=dev)
    st = (m, torch.zeros_like(m),
          torch.zeros((H, S, v.shape[-1]), device=dev))
    fwd = lambda: fa.flash_attention_panel(q, k, v, *st, 0, 0, S, **kw)  # noqa
    m1, l1, acc = fwd()
    lse = m1 + torch.log(l1)
    delta = (do.float() * (acc / l1[..., None])).sum(-1)
    args = (q, k, v, do, lse, delta, 0, 0, S)
    pairs = H * S * (S + 1) / 2
    peak = 989e12 if dtype == torch.bfloat16 else 165e12
    design = fa.fwd_design(dtype, dqk, v.shape[-1], fa._tma_ready(q, k, v))
    rows = []
    for name, fn, per_pair in (
            ("fwd", fwd, 2 * (dqk + dv)),
            ("dkv", lambda: fa.flash_attention_bwd_dkv(*args, **kw),
             4 * (dqk + dv)),
            ("dq", lambda: fa.flash_attention_bwd_dq(*args, **kw),
             4 * dqk + 2 * dv)):
        ms = timed(fn, reps)
        rows.append({"kernel": name, "dtype": str(dtype).split(".")[-1],
                     "H": H, "S": S, "dqk": dqk, "dv": dv,
                     "instance": ("256, v padded" if pad_v else
                                  f"{dqk}x{dv}" if dqk != dv else str(dqk)),
                     "design": design if name == "fwd" else "mma_sync",
                     "ms": ms, "bound_ms": pairs * per_pair / peak * 1e3,
                     "tflop_s": pairs * per_pair / ms / 1e9})
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--heads", type=int, default=16)
    ap.add_argument("--seq", type=int, default=32768)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("flash_mla_bench: no CUDA card", file=sys.stderr)
        return 2
    _build.load_library()
    print(torch.cuda.get_device_name(0))
    for line in ptxas_lines():
        print(line)
    for dtype in (torch.bfloat16, torch.float32):
        cases = [(192, 128, False), (192, 128, True), (128, 128, False)]
        for dqk, dv, pad in cases:
            for row in one(args.heads, args.seq, dqk, dv, dtype, args.reps,
                           pad):
                print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
