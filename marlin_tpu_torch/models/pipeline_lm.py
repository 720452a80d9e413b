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
"""

from __future__ import annotations

import functools

import torch

from ..mesh import ROWS, default_mesh
from ..ops.local import precision_scope
from ..parallel.pipeline import pipeline_apply, stack_stage_params
from .transformer import (_PREFILL_FLASH_MIN, AdamState, _adam_update,
                          _gelu, _head_logits, _ints, _leaves, _n_layers,
                          _prefill_attn, _rmsnorm, _tree_map)

__all__ = ["pp_stage_params", "pp_lm_loss", "pp_lm_train_step"]


def _pp_block(lp, x, heads: int):
    """One transformer block over a (T, d) sequence with dense/flash causal
    self-attention — the stage-local form of ``transformer._block`` (the
    sequence lives whole on the stage's rank)."""
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
    q = (h @ lp["wq"].to(cd)).reshape(T, heads, dh)
    kvh = lp["wk"].shape[1] // dh
    k = (h @ lp["wk"].to(cd)).reshape(T, kvh, dh)
    v = (h @ lp["wv"].to(cd)).reshape(T, kvh, dh)
    if kvh != heads:  # GQA broadcast, as in _block
        k, v = (t.repeat_interleave(heads // kvh, dim=1) for t in (k, v))
    o = _prefill_attn(q, k, v, cd).reshape(T, d)
    x = x + o @ lp["wo"].to(cd)
    h = _rmsnorm(x, lp["ln2"])
    return x + _gelu(h @ lp["w1"].to(cd)) @ lp["w2"].to(cd)


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


def _stage_fn(heads, p_stage, x_mb):
    """This stage's L/S blocks over a (mb, T, d) microbatch, one sequence at
    a time (the JAX package ``vmap``s the rows)."""
    for j in range(p_stage["wq"].shape[0]):
        lp = {k: v[j] for k, v in p_stage.items()}
        x_mb = torch.stack([_pp_block(lp, row, heads) for row in x_mb])
    return x_mb


def pp_lm_loss(stage_params, outer, tokens, mesh=None, heads: int = 4,
               axis: str = ROWS, microbatch: int | None = None):
    """Mean next-token NLL over a (B, T) token batch with the layer stack
    pipelined over ``axis``, an f32 0-d tensor with its autograd graph (the
    backward pipeline comes out of autograd). Products in IEEE f32."""
    mesh = mesh or default_mesh()
    emb = outer["emb"]
    tokens = _ints(tokens, emb.device)
    with precision_scope("highest"):
        x = emb[tokens[:, :-1]]                           # (B, T-1, d)
        x = pipeline_apply(stage_params, functools.partial(_stage_fn, heads),
                           x, mesh, axis=axis, microbatch=microbatch)
        x = _rmsnorm(x, outer["ln_f"])
        logp = torch.log_softmax(_head_logits(x, emb), dim=-1)
        tgt = tokens[:, 1:]
        return -torch.gather(logp, -1, tgt[..., None]).mean()


def pp_lm_train_step(stage_params, outer, opt_state: AdamState, tokens, mesh,
                     heads: int = 4, axis: str = ROWS,
                     microbatch: int | None = None, lr: float = 3e-3):
    """One Adam step over ``(stage_params, outer)`` jointly (``opt_state``
    from ``adam_init((stage_params, outer))``): stage gradients flow back
    through the reversed pipeline, embedding and head gradients directly.
    Returns ``(stage_params, outer, opt_state, loss)``."""
    tree = _tree_map(lambda p: p.detach().requires_grad_(True),
                     (stage_params, outer))
    with precision_scope("highest"):
        loss = pp_lm_loss(tree[0], tree[1], tokens, mesh, heads, axis,
                          microbatch)
        grads = iter(torch.autograd.grad(loss, _leaves(tree)))
    grads = _tree_map(lambda _: next(grads), tree)
    (stage_params, outer), opt_state = _adam_update(
        _tree_map(torch.Tensor.detach, tree), grads, opt_state, lr)
    return stage_params, outer, opt_state, loss.detach()
