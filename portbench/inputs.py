"""Inputs drawn on the card from the seed, in a few large calls.

Rows are drawn in chunks of ``chunk`` rows, each chunk from a generator
seeded by (seed, tag, chunk index): a rank draws only its own rows, and the
check draws them again, alike whatever the number of ranks.
"""

from __future__ import annotations

import torch


def generator(seed: int, tag: int, index: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed((seed * 1_000_003 + tag * 7_919 + index) % 2 ** 63)
    return g


def uniform_rows(seed: int, tag: int, r0: int, r1: int, cols: int, chunk: int,
                 device, out: torch.Tensor | None = None) -> torch.Tensor:
    """Rows ``[r0, r1)`` of a matrix of entries uniform on [-1, 1), in
    float32, written into ``out`` (``(r1 - r0) x cols``) when given."""
    if out is None:
        out = torch.empty((r1 - r0, cols), dtype=torch.float32, device=device)
    for c in range(r0 // chunk, -(-r1 // chunk)):
        c0, c1 = c * chunk, (c + 1) * chunk
        part = torch.rand((chunk, cols), generator=generator(seed, tag, c,
                                                             device),
                          dtype=torch.float32, device=device)
        lo, hi = max(c0, r0), min(c1, r1)
        out[lo - r0:hi - r0].copy_(part[lo - c0:hi - c0]).mul_(2).sub_(1)
        del part
    return out
