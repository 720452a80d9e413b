"""C = A @ B, in float64 (the judge) or as TF32 would compute it."""

from __future__ import annotations

import torch


def product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in float64."""
    return a.double() @ b.double()


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32's 10 mantissa bits, to nearest (ties
    to even), as the tensor cores read a float32 operand."""
    bits = x.contiguous().view(torch.int32)
    bias = 0xFFF + ((bits >> 13) & 1)
    return ((bits + bias) & ~0x1FFF).view(torch.float32)
