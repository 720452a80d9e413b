"""NCCL kernels' share of rank 0's device time in the traced window, in %:
the collectives' part of the multiply across cards."""


def read(run):
    if not run.trace:
        return None
    dev = run.trace[0]["device"]
    total = sum(e - s for s, e, _ in dev)
    nccl = sum(e - s for s, e, n in dev if "nccl" in n.lower())
    if nccl <= 0 or total <= 0:
        return None
    return 100.0 * nccl / total
