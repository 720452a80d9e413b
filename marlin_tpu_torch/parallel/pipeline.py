"""GPipe-style pipeline parallelism over a mesh axis.

Counterpart of ``marlin_tpu/parallel/pipeline.py``. The model's stages live
on successive ranks of a mesh axis, microbatches stream through them, and
the activations hop stage to stage. The schedule is the JAX package's:
``M + S - 1`` ticks (M microbatches, S stages); at each tick every rank
applies its stage to its current activation and passes the result on.
Bubble ticks (rank ``s`` idle while ``t - s`` is outside ``[0, M)``) run the
stage anyway, on zeros, and their results are masked, so every rank builds
the same graph. Only the last stage banks its outputs; one sum over the
axis at the end collects and replicates them (every other rank's buffer is
zero).

The hop is :class:`~marlin_tpu_torch.parallel.collectives.Shift`, a
differentiable ``ppermute``: its forward sends to ``s + 1`` and receives from
``s - 1``, its backward sends the gradient the other way; the collection is
a differentiable all-reduce. Autograd through the tick loop then gives the
mirrored backward pipeline, as ``scan`` does in JAX. The stage parameters
and the input are logical (the same on every rank): each rank takes its own
stage's slice, and the backward gathers every stage's gradients and sums
the input's, so every rank ends with the logical gradients.

The pipeline composes with tensor parallelism on one mesh, as the JAX
package's does when stage weights are also sharded over another axis
(``NamedSharding(mesh, P("rows", None, "cols"))``): ``placement`` names,
for each stacked leaf, a :class:`~marlin_tpu_torch.mesh.Sharding` whose
first dimension is the pipeline axis and whose other dimensions may split
over the other axes. Each rank then takes its block of its stage's slice,
and the backward gathers the blocks' gradients over those axes before the
stages' over the pipeline axis, so the contract above still holds. There
is no partitioner here, so ``stage_fn`` issues the activation collectives
itself, over the process group of the split axis:
:class:`~marlin_tpu_torch.parallel.collectives.Replicate` before a product
by a column-split block, :class:`~marlin_tpu_torch.parallel.collectives.
AllReduce` after a product by a row-split one (ROADMAP queue 3 item 10).
"""

from __future__ import annotations

import torch

from ..mesh import ROWS, Sharding, default_mesh
from . import collectives as col

__all__ = ["pipeline_apply", "stack_stage_params", "split_microbatches"]


def _tree_map(fn, *trees):
    """``fn`` over the leaves of nested dicts, lists and tuples (the param
    trees of the pipeline and the trainers)."""
    t = trees[0]
    if isinstance(t, dict):
        return {k: _tree_map(fn, *(x[k] for x in trees)) for k in t}
    if isinstance(t, (list, tuple)):
        return type(t)([_tree_map(fn, *xs) for xs in zip(*trees)])
    return fn(*trees)


def _leaves(tree) -> list:
    """The leaves of a tree, in :func:`_tree_map`'s order."""
    if isinstance(tree, dict):
        return [x for k in tree for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def stack_stage_params(per_stage: list, mesh=None, axis: str = ROWS):
    """Stack a list of per-stage param trees along a new leading axis, one
    entry per stage of ``axis`` — what :func:`pipeline_apply` expects as
    ``stage_params``."""
    mesh = mesh or default_mesh()
    n = mesh.shape[axis]
    if len(per_stage) != n:
        raise ValueError(
            f"{len(per_stage)} stage param sets for a {n}-stage axis {axis!r}")
    return _tree_map(lambda *xs: torch.stack(xs), *per_stage)


def split_microbatches(x, microbatch: int):
    """(batch, ...) -> (M, microbatch, ...). The batch must divide evenly —
    pipelining resizes no data; pad upstream if needed."""
    b = x.shape[0]
    if microbatch < 1 or b % microbatch:
        raise ValueError(
            f"batch {b} must be a multiple of microbatch {microbatch}")
    return x.reshape(b // microbatch, microbatch, *x.shape[1:])


def _placements(stage_params, placement) -> list:
    """Each leaf's :class:`Sharding` (``None``: whole), in :func:`_leaves`'
    order. ``placement`` is a tree like ``stage_params``; a dict may leave
    out the leaves that stay whole."""
    if isinstance(stage_params, dict):
        placement = placement or {}
        return [sh for k in stage_params
                for sh in _placements(stage_params[k], placement.get(k))]
    if isinstance(stage_params, (list, tuple)):
        placement = placement or [None] * len(stage_params)
        return [sh for t, p in zip(stage_params, placement)
                for sh in _placements(t, p)]
    return [placement]


def _split_dims(sh: Sharding | None, mesh, axis: str) -> tuple:
    """The ``(dim, axis)`` pairs a leaf's stage slice is split over (dims
    of the slice, without the stage dimension); ``()`` for a whole one."""
    if sh is None:
        return ()
    if sh.mesh != mesh or not sh.spec or sh.spec[0] != axis \
            or axis in sh.spec[1:]:
        raise ValueError(f"a stage leaf's placement {sh.spec} must be a "
                         f"Sharding of this mesh with the pipeline axis "
                         f"{axis!r} on its first dimension alone")
    return tuple((d, a) for d, a in enumerate(sh.spec[1:]) if a is not None)


class _StageInputs(torch.autograd.Function):
    """``_StageInputs.apply(mesh, axis, splits, x, *leaves)``: ``x`` and
    this rank's slice of each stacked leaf, cut to this rank's block where
    ``splits`` (one :func:`_split_dims` a leaf) names a split. Backward sums
    ``x``'s gradient over the axis (only stage 0 reads it) and gathers each
    leaf's gradient over its split axes, then over the stages, in one node,
    so every rank issues these collectives in the same order."""

    @staticmethod
    def forward(ctx, mesh, axis, splits, x, *leaves):
        ctx.meta = (mesh, axis, splits)
        s = mesh.index(axis)
        mine = []
        for leaf, split in zip(leaves, splits):
            leaf = leaf[s]
            for d, a in split:
                leaf = col.block(leaf, mesh, a, d)
            mine.append(leaf.clone())
        return (x.clone(), *mine)

    @staticmethod
    def backward(ctx, gx, *gl):
        mesh, axis, splits = ctx.meta
        gx = col.all_reduce_sum(gx, mesh, axis)
        out = []
        for g, split in zip(gl, splits):
            for d, a in split:
                g = col.all_gather_cat(g, mesh, a, d)
            out.append(col.all_gather_cat(g.unsqueeze(0), mesh, axis, 0))
        return (None, None, None, gx, *out)


def pipeline_apply(stage_params, stage_fn, x, mesh=None, axis: str = ROWS,
                   microbatch: int | None = None, placement=None):
    """Run ``x`` through ``S = mesh.shape[axis]`` pipeline stages.

    ``stage_params``: a tree whose every leaf has leading axis ``S`` (stage
    ``s``'s slice is that stage's parameters) — see
    :func:`stack_stage_params`. ``stage_fn(params_s, xs) -> ys`` maps one
    stage over one microbatch; ``ys`` must have ``xs``'s shape.

    ``x``: ``(batch, ...)``; ``microbatch`` divides ``batch`` (default: the
    largest divisor of the batch giving at least S microbatches, else 1).
    Returns ``stage_{S-1}(... stage_0(x))`` with ``x``'s shape on every
    rank. Differentiable end to end.

    **Requirement on** ``stage_fn``: bubble ticks evaluate it on *all-zero*
    activations (the schedule computes every tick and masks dead results
    out), so ``stage_fn`` must give finite outputs — and finite gradients —
    on zero inputs. A stage that divides by a norm, takes a log, or
    otherwise blows up at 0 yields inf/NaN whose backward products can
    poison gradients even though the output is masked (0 · NaN is NaN).
    Guard such ops with an epsilon (the LM blocks' rmsnorm adds 1e-6).

    ``placement``: a tree like ``stage_params`` (a dict may leave leaves
    out) of :class:`~marlin_tpu_torch.mesh.Sharding` or ``None``, each
    ``Sharding(mesh, (axis, ...))`` with the other dimensions split over
    other mesh axes or not. ``stage_fn`` then gets this rank's blocks and
    must issue the collectives over those axes itself (see the module
    docstring), the same on every rank of a line and on every tick, bubbles
    included. Each leaf's gradient is its logical one on every rank, so a
    whole leaf the split part of ``stage_fn`` reads must get its gradient
    whole there too (read it before the ``Replicate``). ``None`` (the
    default): every leaf whole.
    """
    mesh = mesh or default_mesh()
    n_stages = mesh.shape[axis]
    if microbatch is None:
        microbatch = max(1, x.shape[0] // n_stages)
        while x.shape[0] % microbatch:
            microbatch -= 1
    xm = split_microbatches(x, microbatch)
    n_micro = xm.shape[0]
    leaves = _leaves(stage_params)
    splits = tuple(_split_dims(sh, mesh, axis)
                   for sh in _placements(stage_params, placement))
    if mesh.ranks is None:  # every axis of size 1: each block is whole
        s = 0
        mine = [leaf[0] for leaf in leaves]
    else:
        s = mesh.index(axis)
        xm, *mine = _StageInputs.apply(mesh, axis, splits, xm, *leaves)
    it = iter(mine)
    p_s = _tree_map(lambda _: next(it), stage_params)
    dev = xm.device
    first = torch.tensor(s == 0, device=dev)
    last = torch.tensor(s == n_stages - 1, device=dev)
    recv = torch.zeros(xm.shape[1:], dtype=xm.dtype, device=dev)
    outs = [torch.zeros_like(recv) for _ in range(n_micro)]
    n_ticks = n_micro + n_stages - 1
    for t in range(n_ticks):
        mb = t - s  # the microbatch this stage works on this tick
        act_in = torch.where(first, xm[min(t, n_micro - 1)], recv)
        y = stage_fn(p_s, act_in)
        idx = min(max(mb, 0), n_micro - 1)
        write = torch.tensor(0 <= mb < n_micro, device=dev) & last
        outs[idx] = torch.where(write, y, outs[idx])
        if mesh.ranks is not None and t < n_ticks - 1:
            recv = col.Shift.apply(y, mesh, axis)
    out = torch.stack(outs)
    if mesh.ranks is not None:
        out = col.AllReduce.apply(torch.where(last, out, 0.0), mesh, axis)
    return out.reshape(x.shape)
