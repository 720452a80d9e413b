"""Pipeline-parallel causal-LM training: the transformer's layer stack as
GPipe stages.

Counterpart of ``marlin_tpu/models/pipeline_lm.py``. :class:`~.transformer.
TransformerLM` is the context-parallel trainer (one long sequence around the
ring); this is the batch regime: many short sequences, the layer stack split
into ``S = mesh.shape[axis]`` stage groups on successive ranks, microbatches
of sequences streaming through
(:func:`~marlin_tpu_torch.parallel.pipeline.pipeline_apply`). Attention
inside a stage is per-sequence causal self-attention
(:func:`.transformer._prefill_attn`: dense below 2048 tokens, the flash
forward kernel from there). Embedding, final norm and the LM head run outside
the pipeline. Params come from :func:`.transformer.init_transformer` (dense
FFN; a layer count divisible by the stage count); Adam is the trainer's
(``optax.adam``'s rules, :func:`.transformer.adam_init`).

From 2048 tokens a stage's attention is the flash forward alone, which has
no backward here, and the JAX package's ``jax.grad`` of this loss raises
``NotImplementedError`` there (``pallas_call`` has no JVP rule). So does the
port, when gradients are wanted, rather than return an output whose
attention gradient would be silently missing (ROADMAP queue 3).

pp x tp: with ``placement=pp_tp_placement(mesh)`` the stage weights split
over a second axis the Megatron way (``wq``, ``wk``, ``wv``, ``w1`` by
columns, ``wo``, ``w2`` by rows, the norms whole), as the JAX package
computes when the caller places them so with ``NamedSharding``. A block
then runs this rank's run of query and KV heads and its columns of the
FFN: :class:`~marlin_tpu_torch.parallel.collectives.Replicate` before the
q/k/v and ``w1`` products, an all-reduce over the axis after ``wo`` and
after ``w2`` (``pipeline_apply``'s placement; ROADMAP queue 3 item 10).
"""

from __future__ import annotations

import functools

import torch

from ..mesh import COLS, ROWS, Sharding, default_mesh
from ..ops.local import precision_scope
from ..parallel import collectives as col
from ..parallel.pipeline import pipeline_apply, stack_stage_params
from .transformer import (_PREFILL_FLASH_MIN, AdamState, _adam_update,
                          _gelu, _head_logits, _ints, _leaves, _n_layers,
                          _prefill_attn, _rmsnorm, _tree_map)

__all__ = ["pp_stage_params", "pp_tp_placement", "pp_lm_loss",
           "pp_lm_train_step"]

_COL_SPLIT = ("wq", "wk", "wv", "w1")
_ROW_SPLIT = ("wo", "w2")


def _pp_block(lp, x, heads: int, tp=None):
    """One transformer block over a (T, d) sequence with dense/flash causal
    self-attention — the stage-local form of ``transformer._block`` (the
    sequence lives whole on the stage's rank). ``tp``: ``(mesh, axis)``
    when ``lp`` holds this rank's Megatron blocks over ``axis`` (its query
    and KV heads are ``wq``'s and ``wk``'s columns over the head size)."""
    T, d = x.shape
    if T >= _PREFILL_FLASH_MIN and torch.is_grad_enabled() and any(
            t.requires_grad for t in [x, *_leaves(lp)]):
        raise NotImplementedError(
            f"pipeline LM gradients at {T} tokens: from {_PREFILL_FLASH_MIN} "
            f"tokens a stage's attention is the flash forward kernel, which "
            f"has no backward here (the JAX package's jax.grad raises "
            f"NotImplementedError there as well); train on sequences shorter "
            f"than {_PREFILL_FLASH_MIN} tokens")
    cd = x.dtype
    dh = d // heads
    h = _rmsnorm(x, lp["ln1"])
    if tp:
        h = col.Replicate.apply(h, *tp)
    qh = lp["wq"].shape[1] // dh
    q = (h @ lp["wq"].to(cd)).reshape(T, qh, dh)
    kvh = lp["wk"].shape[1] // dh
    k = (h @ lp["wk"].to(cd)).reshape(T, kvh, dh)
    v = (h @ lp["wv"].to(cd)).reshape(T, kvh, dh)
    if kvh != qh:  # GQA broadcast, as in _block
        k, v = (t.repeat_interleave(qh // kvh, dim=1) for t in (k, v))
    o = _prefill_attn(q, k, v, cd).reshape(T, qh * dh) @ lp["wo"].to(cd)
    if tp:
        o = col.AllReduce.apply(o, *tp)
    x = x + o
    h = _rmsnorm(x, lp["ln2"])
    if tp:
        h = col.Replicate.apply(h, *tp)
    f = _gelu(h @ lp["w1"].to(cd)) @ lp["w2"].to(cd)
    if tp:
        f = col.AllReduce.apply(f, *tp)
    return x + f


def pp_stage_params(params, mesh=None, axis: str = ROWS):
    """Re-shape ``init_transformer`` params into pipeline form: the L layer
    dicts stack into S stage groups of L/S layers (leaves gain leading
    (S, L/S) axes). Returns ``(stage_params, outer)``, ``outer`` holding the
    ``emb``/``ln_f`` leaves the pipeline does not touch."""
    mesh = mesh or default_mesh()
    n_stages = mesh.shape[axis]
    n_layers = _n_layers(params)
    if n_layers % n_stages:
        raise ValueError(
            f"{n_layers} layers do not split into {n_stages} pipeline "
            f"stages; choose layers divisible by the {axis!r} axis")
    per = n_layers // n_stages
    if any("moe" in params[f"l{i}"] for i in range(n_layers)):
        raise ValueError(
            "pipeline LM supports dense-FFN layers; run MoE models through "
            "TransformerLM (expert parallelism) instead")
    stages = []
    for s in range(n_stages):
        group = [params[f"l{s * per + j}"] for j in range(per)]
        stages.append(_tree_map(lambda *xs: torch.stack(xs), *group))
    outer = {"emb": params["emb"], "ln_f": params["ln_f"]}
    return stack_stage_params(stages, mesh, axis), outer


def pp_tp_placement(mesh=None, axis: str = ROWS, tp_axis: str = COLS) -> dict:
    """The Megatron placement of :func:`pp_stage_params`' stage weights
    over ``tp_axis``, for ``placement=`` of :func:`pp_lm_loss` and
    :func:`pp_lm_train_step`: ``wq``, ``wk``, ``wv`` and ``w1`` split by
    columns, ``wo`` and ``w2`` by rows, ``ln1`` and ``ln2`` whole — where
    the JAX package's caller ``device_put``s each leaf with
    ``NamedSharding(mesh, P(axis, None, None, tp_axis))`` or ``P(axis,
    None, tp_axis, None)``."""
    mesh = mesh or default_mesh()
    by_cols = Sharding(mesh, (axis, None, None, tp_axis))
    by_rows = Sharding(mesh, (axis, None, tp_axis, None))
    return {**dict.fromkeys(_COL_SPLIT, by_cols),
            **dict.fromkeys(_ROW_SPLIT, by_rows)}


def _tp_axis(placement, stage_params, mesh, axis: str, heads: int):
    """The axis ``placement`` splits the stage weights over (``None`` when
    it names no split); raises ``ValueError`` for any other placement than
    :func:`pp_tp_placement`'s, or heads that do not divide by the axis."""
    splits = {k: sh.spec for k, sh in (placement or {}).items()
              if sh is not None and any(a is not None for a in sh.spec[1:])}
    if not splits:
        return None
    axes = {a for spec in splits.values() for a in spec[1:] if a is not None}
    tp_axis = axes.pop()
    want = {k: sh.spec for k, sh in
            pp_tp_placement(mesh, axis, tp_axis).items()}
    if axes or splits != want:
        raise ValueError(f"the pipelined LM splits its stage weights over a "
                         f"second axis the Megatron way only "
                         f"(pp_tp_placement); got {splits}")
    n = mesh.shape[tp_axis]
    dh = stage_params["wq"].shape[-2] // heads
    kvh = stage_params["wk"].shape[-1] // dh
    if heads % n or kvh % n:
        raise ValueError(f"{heads} heads and {kvh} KV heads must each "
                         f"divide by the {tp_axis!r} axis ({n}) to split "
                         f"over it")
    return tp_axis


def _stage_fn(heads, tp, p_stage, x_mb):
    """This stage's L/S blocks over a (mb, T, d) microbatch, one sequence at
    a time (the JAX package ``vmap``s the rows)."""
    for j in range(p_stage["wq"].shape[0]):
        lp = {k: v[j] for k, v in p_stage.items()}
        x_mb = torch.stack([_pp_block(lp, row, heads, tp) for row in x_mb])
    return x_mb


def pp_lm_loss(stage_params, outer, tokens, mesh=None, heads: int = 4,
               axis: str = ROWS, microbatch: int | None = None,
               placement=None):
    """Mean next-token NLL over a (B, T) token batch with the layer stack
    pipelined over ``axis``, an f32 0-d tensor with its autograd graph (the
    backward pipeline comes out of autograd). Products in IEEE f32.
    ``placement``: ``None`` (every stage weight whole on its stage's ranks)
    or :func:`pp_tp_placement`'s, which splits them over its axis."""
    mesh = mesh or default_mesh()
    tp_axis = _tp_axis(placement, stage_params, mesh, axis, heads)
    tp = (mesh, tp_axis) if tp_axis and mesh.ranks is not None else None
    emb = outer["emb"]
    tokens = _ints(tokens, emb.device)
    with precision_scope("highest"):
        x = emb[tokens[:, :-1]]                           # (B, T-1, d)
        x = pipeline_apply(stage_params,
                           functools.partial(_stage_fn, heads, tp), x, mesh,
                           axis=axis, microbatch=microbatch,
                           placement=placement)
        x = _rmsnorm(x, outer["ln_f"])
        logp = torch.log_softmax(_head_logits(x, emb), dim=-1)
        tgt = tokens[:, 1:]
        return -torch.gather(logp, -1, tgt[..., None]).mean()


def pp_lm_train_step(stage_params, outer, opt_state: AdamState, tokens, mesh,
                     heads: int = 4, axis: str = ROWS,
                     microbatch: int | None = None, lr: float = 3e-3,
                     placement=None):
    """One Adam step over ``(stage_params, outer)`` jointly (``opt_state``
    from ``adam_init((stage_params, outer))``): stage gradients flow back
    through the reversed pipeline, embedding and head gradients directly.
    With a ``placement`` (:func:`pp_lm_loss`) Adam still runs on the
    logical gradients and returns logical params. Returns
    ``(stage_params, outer, opt_state, loss)``."""
    tree = _tree_map(lambda p: p.detach().requires_grad_(True),
                     (stage_params, outer))
    with precision_scope("highest"):
        loss = pp_lm_loss(tree[0], tree[1], tokens, mesh, heads, axis,
                          microbatch, placement)
        grads = iter(torch.autograd.grad(loss, _leaves(tree)))
    grads = _tree_map(lambda _: next(grads), tree)
    (stage_params, outer), opt_state = _adam_update(
        _tree_map(torch.Tensor.detach, tree), grads, opt_state, lr)
    return stage_params, outer, opt_state, loss.detach()
