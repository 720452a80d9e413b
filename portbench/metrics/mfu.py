"""The whole call's share of the card's peak, in %: the least time the
cell's cards could take for the window's work (the larger of its FLOPs
over the dense bf16 tensor-core peak and its bytes over the memory
bandwidth, each times the cards) over the window's wall time. The peak is
the highest rate any implementation of these products reaches short of
fp8, so the share cannot pass 100 %."""


def bound_s(run):
    """Seconds the window's work takes at the cards' peaks."""
    if run.peak is None:
        return None
    return run.calls * max(run.flops / run.peak["flop_s"],
                           run.bytes / run.peak["byte_s"]) / run.chips


def read(run):
    least = bound_s(run)
    if least is None or run.calls == 0:
        return None
    return 100.0 * least / run.window_s
