"""CARMA-inspired split selection.

The reference chooses how to split the (m, k, n) iteration space of a
distributed matmul by recursively halving the largest remaining dimension until
the core budget is spent (utils/MTUtils.scala:139-175, citing the CARMA paper
"Communication optimal parallel recursive rectangular matrix multiplication",
IPDPS'13; ``dimToSplit`` MTUtils.scala:204-213). Here the same heuristic picks
the shape of the 3-D device mesh used by :func:`marlin_tpu.parallel.rmm_matmul`
— i.e. it decides how many mesh slots each of m/k/n gets, which in turn decides
which ICI collectives XLA inserts (a k-split becomes a psum/reduce-scatter; an
m- or n-split is collective-free).
"""

from __future__ import annotations


def dim_to_split(m: float, k: float, n: float) -> int:
    """Index (0=m, 1=k, 2=n) of the largest current per-shard dimension —
    the dimension whose split saves the most communication (MTUtils.scala:204-213)."""
    dims = (m, k, n)
    return max(range(3), key=lambda i: dims[i])


def split_method(m: int, k: int, n: int, parallelism: int) -> tuple[int, int, int]:
    """Choose (m_split, k_split, n_split) with product <= parallelism by
    repeatedly halving the largest per-shard dimension (MTUtils.scala:150-175).

    Unlike the reference (which creates m·k·n Spark tasks and can oversubscribe
    cores), the product here must not exceed the device count: each (i, j, l)
    cell is one device, not one task.
    """
    if parallelism < 1:
        raise ValueError("parallelism must be >= 1")
    ms = ks = ns = 1
    cur_m, cur_k, cur_n = float(m), float(k), float(n)
    while ms * ks * ns * 2 <= parallelism:
        i = dim_to_split(cur_m, cur_k, cur_n)
        if i == 0:
            if cur_m < 2:
                break
            ms, cur_m = ms * 2, cur_m / 2
        elif i == 1:
            if cur_k < 2:
                break
            ks, cur_k = ks * 2, cur_k / 2
        else:
            if cur_n < 2:
                break
            ns, cur_n = ns * 2, cur_n / 2
    return ms, ks, ns


def near_square_split(parallelism: int) -> int:
    """The reference's near-square special case: split = ⌊(3·cores)^(1/3)⌋ used
    when m≈k≈n (DenseVecMatrix.scala:208-213). Retained for API parity; the
    mesh-based path clamps it to the device budget."""
    s = int(round((3.0 * parallelism) ** (1.0 / 3.0)))
    return max(1, s)
