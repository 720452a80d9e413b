"""PageRank over an edge-list file (counterpart of ``examples/pagerank.py``,
examples/PageRank.scala: args ``<file> <iterations> [link num]``; file lines
are ``src dst`` pairs; without a file, a random graph of ``link num`` nodes
is used)."""

import os
import sys

import numpy as np

from marlin_tpu_torch.examples._common import die, millis


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 1:
        die("usage: pagerank <edge file | 'random'> [iterations] [node count]")
    source = argv[0]
    iterations = int(argv[1]) if len(argv) > 1 else 20
    n = int(argv[2]) if len(argv) > 2 else 8

    import marlin_tpu_torch as mt
    from marlin_tpu_torch.ml import (build_transition_matrix,
                                     build_transition_operator, pagerank)

    mesh = mt.create_mesh()
    if source != "random":
        if not os.path.exists(source):
            die(f"edge file not found: {source} (pass 'random' for a generated graph)")
        edges = []
        with open(source) as f:
            for line in f:
                parts = line.split()
                if len(parts) >= 2:
                    edges.append((int(parts[0]), int(parts[1])))
    else:
        rng = np.random.default_rng(0)
        edges = [(int(s), int(d)) for s, d in rng.integers(0, n, (4 * n, 2)) if s != d]
    num_nodes = max(max(s, d) for s, d in edges) + 1
    if len(edges) > 100_000 or num_nodes > 2_000:
        # graph scale: keep the edge list sparse end to end
        link = build_transition_operator(edges, mesh=mesh)
    else:
        link = mt.BlockMatrix.from_array(build_transition_matrix(edges), mesh)

    t0 = millis()
    ranks = pagerank(link, iterations=iterations)
    print(f"used time {millis() - t0:.1f} millis")
    top = np.argsort(-ranks)[:10]
    for i in top:
        print(f"node {i}: {ranks[i]:.6f}")


if __name__ == "__main__":
    main()
