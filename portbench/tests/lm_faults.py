"""Faults planted under the DeepSeek-V2 cell's timed path, for the tests
that see ``correct`` come out false. Each takes ``setattr`` (pytest's
``monkeypatch.setattr``) and alters the port as it runs, leaving the
reference as it is. A weight a fault stops using stays in the graph at
zero weight (:func:`_unused`), so the step runs and its gradient is 0."""

from __future__ import annotations

import contextlib

import torch


def _unused(*weights):
    """0, reached from ``weights``: keeps them in autograd's graph."""
    return sum(w.sum() for w in weights) * 0


def mla_rope_dropped(setattr=setattr):
    """q_pe and k_pe go into attention unrotated."""
    from marlin_tpu_torch.models import deepseek as ds

    setattr(ds, "apply_rope", lambda x, cos, sin: x)


def mla_latent_norm_dropped(setattr=setattr):
    """The latent c is lifted to k_nope and v without its RMSNorm (the
    block's other norms, taken outside the attention, stay)."""
    from marlin_tpu_torch.models import deepseek as ds
    from marlin_tpu_torch.models import transformer as tt

    orig_mla, orig_norm, inside = ds.mla_attention, tt._rmsnorm, []

    @contextlib.contextmanager
    def within():
        inside.append(1)
        try:
            yield
        finally:
            inside.pop()

    def mla(*args, **kwargs):
        with within():
            return orig_mla(*args, **kwargs)

    setattr(ds, "mla_attention", mla)
    setattr(tt, "_rmsnorm",
            lambda x, g, eps=1e-6: (x + _unused(g).to(x.dtype)) if inside
            else orig_norm(x, g, eps))


def _wrap_moe(setattr, change):
    from marlin_tpu_torch.models import moe

    orig = moe.deepseek_moe_ffn

    def ffn(mp, h, cfg):
        out, aux = orig(change(mp), h, cfg)
        return out + _unused(*mp.values()).to(out.dtype), aux

    setattr(moe, "deepseek_moe_ffn", ffn)


def moe_shared_dropped(setattr=setattr):
    """The shared experts left out of every MoE layer."""
    _wrap_moe(setattr, lambda mp: {k: v for k, v in mp.items()
                                   if not k.startswith("shared_")})


def moe_held_expert_skipped(setattr=setattr):
    """The first held expert's tokens get nothing from it."""
    _wrap_moe(setattr, lambda mp: dict(
        mp, w_down=torch.cat([mp["w_down"][:1] * 0, mp["w_down"][1:]])))


def _wrap_adam(setattr, step):
    from marlin_tpu_torch.models import transformer as tt

    orig = tt._adam_update

    def update(params, grads, state, lr):
        return step(orig, params, grads, state, lr)

    setattr(tt, "_adam_update", update)


def lm_grad_scaled(setattr=setattr):
    """Every gradient 10 % too large where Adam takes it."""
    from marlin_tpu_torch.parallel.pipeline import _tree_map

    _wrap_adam(setattr, lambda orig, params, grads, state, lr: orig(
        params, _tree_map(lambda g: g * 1.1, grads), state, lr))


def lm_params_unchanged(setattr=setattr):
    """Adam's moments advance, but the parameters come back as they were."""
    _wrap_adam(setattr, lambda orig, params, grads, state, lr:
               (params, orig(params, grads, state, lr)[1]))


def lm_lr_scaled(setattr=setattr):
    """The parameters move at 1.1 times the learning rate."""
    _wrap_adam(setattr, lambda orig, params, grads, state, lr:
               orig(params, grads, state, 1.1 * lr))


def lm_update_reversed(setattr=setattr):
    """The parameters move up the gradient instead of down."""
    _wrap_adam(setattr, lambda orig, params, grads, state, lr:
               orig(params, grads, state, -lr))
