"""Useful GFLOP/s: every call completed in the window, its FLOPs counted
from the shapes, over the window's wall time (rank 0's host clock), all
cards of the cell together."""


def read(run):
    if run.calls == 0 or run.window_s <= 0:
        return None
    return run.calls * run.flops / run.window_s / 1e9
