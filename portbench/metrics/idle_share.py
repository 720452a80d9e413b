"""The device's idle share of the traced window, in %: 1 - the union of
its operations' intervals over the window; on several cards the idlest
card's."""


def read(run):
    if not run.trace:
        return None
    return max(100.0 * (1.0 - t["busy_s"] / t["window_s"]) for t in run.trace)
