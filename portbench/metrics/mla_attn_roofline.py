"""The latent-attention flash kernels against their roofline, in %: what
the forward, dK/dV and dQ kernels must do (``ops/lm_train.py:
attn_kernel_ops``, every live pair of the causal panel, the backward's
rebuilt scores included) at the card's dense bf16 peak, over those kernels'
device time; each kernel picked out by its name, counted where it lies
wholly inside the traced window, averaged over the cards. The shapes are
the ``dsv2_lite.train32k`` cell's, the one cell that lists the metric."""

import os
import re

from portbench import harness

CELL = "dsv2_lite.train32k"
_BWD = re.compile(r"flash_bwd_kernel<([^>]*)>")


def kind(name: str):
    """``"fwd"``, ``"dkv"`` or ``"dq"`` for a flash kernel's event name (the
    backward's last template argument says dK/dV), else None."""
    if "flash_fwd_kernel" in name:
        return "fwd"
    m = _BWD.search(name)
    if m:
        return "dkv" if m.group(1).split(",")[-1].strip() == "true" else "dq"
    return None


def read(run):
    if not run.trace or run.peak is None:
        return None
    cell = harness.resolve(CELL)
    op = harness.load_op(cell.pkg, cell.traffic["op"])
    ops = op.attn_kernel_ops(cell.cfg, cell.traffic)
    shares = []
    for t in run.trace:
        work = secs = 0.0
        for s, e, n in t["device"]:
            k = kind(n)
            if k is not None and 0.0 < s and e < t["window_s"]:
                work += ops[k]
                secs += e - s
        if secs > 0:
            shares.append(100.0 * work / run.peak["flop_s"] / secs)
    return sum(shares) / len(shares) if shares else None
