"""Fused (lazy) evaluation of matrix expressions.

Counterpart of ``marlin_tpu/lazy.py``. The reference defers work by building
RDD lineage that runs only when an action forces it; the JAX package traces a
function over matrices with ``jax.jit``, so a chain of ``multiply``, ``add``,
``transpose``, ``sum`` becomes one compiled program with one dispatch. Here
:func:`fuse` hands the function to ``torch.compile``: dynamo traces through
the matrix methods (plain Python objects around a tensor) into ONE graph
(``fullgraph=True`` by default, so a function that cannot be one graph
raises instead of silently splitting), and the backend compiles it — on the
card inductor fuses the elementwise work into the kernels around the
products.

Inside a compiled trace the per-product TF32 gate
(:func:`~marlin_tpu_torch.ops.local.precision_scope`) and the multiply cost
hook (``parallel.matmul._capture_matmul_cost``) step aside: a graph cannot
hold their locks, and the JAX package's jitted chains land no cost rows
either. :func:`fuse` enters one scope at the configured ``matmul_precision``
around each call instead, so a whole fused chain runs at that precision.

:func:`grad` is the counterpart of ``jax.grad`` over matrix arguments: it
returns matrix-typed cotangents whose pad region is zero, and composes with
:func:`fuse` (a fused scalar loss differentiates through the compiled graph).
As with jit, shapes are part of the compiled program (a new operand geometry
recompiles), and host-side terminal ops (``to_numpy``, ``float(...)``,
``save``) belong outside a fused function.
"""

from __future__ import annotations

import copy
import functools

import torch

from .ops.local import precision_scope

__all__ = ["fuse", "grad"]


def fuse(fn=None, **compile_kwargs):
    """``torch.compile`` for matrix-level functions: one graph, one compiled
    dispatch for the whole expression chain.

    >>> @fuse
    ... def step(a, b, c):
    ...     return a.multiply(b).add(c).multiply(2.0)
    >>> out = step(a, b, c)   # one graph

    Usable bare or as a decorator factory (``@fuse(backend="aot_eager")``);
    takes ``torch.compile``'s keyword arguments, with ``fullgraph`` True
    unless given. An exception the function raises while it is traced (an
    operand shape check) propagates as itself."""
    if fn is None:
        return functools.partial(fuse, **compile_kwargs)
    compile_kwargs.setdefault("fullgraph", True)
    compiled = torch.compile(fn, **compile_kwargs)

    @functools.wraps(fn)
    def run(*args, **kwargs):
        with precision_scope(None):
            try:
                return compiled(*args, **kwargs)
            except torch._dynamo.exc.Unsupported as exc:
                if not isinstance(exc.__cause__,
                                  torch._dynamo.exc.ObservedException):
                    raise
                # the function raised while being traced (a shape check):
                # raise its own error, as jit raises it at trace time
                fn(*args, **kwargs)
                raise

    return run


def _with_data(mat, data):
    """A shallow copy of a matrix or vector object with ``data`` replaced."""
    out = copy.copy(mat)
    out.data = data
    return out


def grad(fn, argnums=0):
    """The gradient of a scalar-valued function of matrices (``jax.grad``):
    returns a function of the same arguments giving, for each argument in
    ``argnums`` (an int or a tuple), its cotangent as the argument's own
    type (``DenseVecMatrix``, ``BlockMatrix``, ``DistributedVector``), shape
    and padding, the pad region zero."""
    nums = (argnums,) if isinstance(argnums, int) else tuple(argnums)

    @functools.wraps(fn)
    def gradient(*args, **kwargs):
        args = list(args)
        leaves = []
        for i in nums:
            leaf = args[i].data.detach().requires_grad_(True)
            leaves.append(leaf)
            args[i] = _with_data(args[i], leaf)
        with torch.enable_grad():
            out = fn(*args, **kwargs)
            if not (isinstance(out, torch.Tensor) and out.dim() == 0):
                raise TypeError("grad needs a function with a scalar tensor "
                                f"output, got {type(out).__name__}")
            gs = torch.autograd.grad(out, leaves, allow_unused=True)
        cots = []
        for i, leaf, g in zip(nums, leaves, gs):
            g = torch.zeros_like(leaf) if g is None else g
            mask = getattr(args[i], "_mask_padded", None)
            cots.append(_with_data(args[i], (mask(g) if mask else g).detach()))
        return cots[0] if isinstance(argnums, int) else tuple(cots)

    return gradient
