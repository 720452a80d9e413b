"""The share of device time in operations that are not GEMMs, in %: in the
blocked LU the pivot blocks' getrf, the triangular solves, the row swaps
and the copies, beside its panel and trailing products (rank 0's device
operations; a GEMM or a collective by its kernel's name)."""


def read(run):
    if not run.trace:
        return None
    total = gemm = other = 0.0
    for s, e, n in run.trace[0]["device"]:
        low = n.lower()
        total += e - s
        if "gemm" in low and "nccl" not in low:
            gemm += e - s
        elif "nccl" not in low:
            other += e - s
    if total <= 0 or gemm <= 0:
        return None
    return 100.0 * other / total
