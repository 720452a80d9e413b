"""The calls' kernels against their roofline, in %: the least time the
cell's cards could take for the window's work (``mfu.bound_s``) over the
device time of every operation in the traced window, summed over the
cards' operations and averaged over the cards."""

import os

from portbench.harness import _module

_mfu = _module(os.path.join(os.path.dirname(__file__), "mfu.py"),
               "portbench_metric_mfu")


def read(run):
    least = _mfu.bound_s(run)
    if least is None or not run.trace:
        return None
    kernel_s = sum(t["kernel_s"] for t in run.trace) / len(run.trace)
    if kernel_s <= 0:
        return None
    return 100.0 * least / kernel_s
