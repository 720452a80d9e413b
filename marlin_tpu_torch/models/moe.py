"""Mixture-of-experts FFN: grouped capacity routing (GShard / Switch).

Counterpart of ``marlin_tpu/models/moe.py``, at world size 1. Every token
routes to its top-k of E experts; each expert takes at most
``c_g = ceil(g·k·cf/E)`` tokens per group of ``g``, the first choices of all
tokens outranking every second choice (choice-major priority), and a token
whose choice overflows loses it (its kept choices renormalize). Dispatch and
combine are (g, E, c_g) one-hot tensors contracted with ``torch.einsum``, as
the JAX package contracts them with ``jnp.einsum``; no hand-written kernel is
involved. Routing and the load-balance statistics run in f32.

Memory: the dispatch tensor is O(g·E·c_g) per group, so :func:`moe_ffn`
loops over groups and, with ``remat_groups``, runs each one under
``torch.utils.checkpoint`` so that autograd keeps only one group's dispatch
tensor at a time (the JAX package's ``lax.scan`` + ``jax.checkpoint``).

Expert parallelism: the JAX package places the expert axis over a mesh axis
and lets XLA insert the all-to-alls. The port's mesh is a world of one, so
:func:`shard_moe_params` is the identity and an axis of more than one device
raises ``NotImplementedError`` (ROADMAP queue 1 item 12).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..config import resolve_device
from ..mesh import ROWS
from ..ops.local import precision_scope
from ..parallel.ring_attention import _world_of_one
from .transformer import _f32_einsum, _gelu

__all__ = ["init_moe", "moe_ffn", "moe_decode_ffn", "moe_capacity",
           "shard_moe_params"]


def init_moe(key, d_model: int, d_ff: int, n_experts: int,
             dtype=torch.float32, device=None) -> dict:
    """Router and per-expert FFN params: ``wg`` (d, E), ``w1`` (E, d, ff),
    ``w2`` (E, ff, d). ``key`` is an int seed or a ``torch.Generator`` (then
    its device is used); the draws differ from ``jax.random``'s (carry JAX
    weights over with :func:`marlin_tpu_torch.interop.lm_params_from_numpy`)."""
    if n_experts < 2:
        raise ValueError(f"n_experts must be >= 2, got {n_experts}")
    if isinstance(key, torch.Generator):
        gen, dev = key, key.device
    else:
        dev = resolve_device(device)
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(key))

    def normal(shape, scale):
        return torch.randn(shape, generator=gen, device=dev).to(dtype) * scale

    s = 1.0 / math.sqrt(d_model)
    return {"wg": normal((d_model, n_experts), s),
            "w1": normal((n_experts, d_model, d_ff), s),
            "w2": normal((n_experts, d_ff, d_model), 1.0 / math.sqrt(d_ff))}


def moe_capacity(group: int, n_experts: int, top_k: int,
                 capacity_factor: float) -> int:
    """Per-expert slot count for one routing group."""
    return max(1, math.ceil(group * top_k * capacity_factor / n_experts))


def shard_moe_params(params, mesh, axis: str = ROWS):
    """Place the expert tensors with their expert axis over ``axis``. At
    world size 1 placement is the identity: returns ``params`` (one
    :func:`init_moe` dict or a whole transformer params dict) unchanged, and
    raises for an axis of more than one device."""
    _world_of_one(mesh, axis, "expert sharding")
    return params


def _route_group(xg, valid, wg, top_k: int, cap: int):
    """One group's routing: the (g, E, cap) dispatch and combine tensors and
    the group's load-balance statistics, all in f32. Position-in-expert is a
    cumsum over the (k·g, E) choice-major one-hots, so every token's first
    choice outranks all second choices."""
    g = xg.shape[0]
    e = wg.shape[1]
    gates = torch.softmax(xg.float() @ wg.float(), dim=-1)   # (g, E)
    topv, topi = torch.topk(gates, top_k, dim=-1)             # (g, k)
    topv = topv / topv.sum(dim=-1, keepdim=True)
    # (k, g, E) one-hots, masked to live (non-padding) rows
    oh = F.one_hot(topi.t(), e).float() * valid[None, :, None]
    pos = torch.cumsum(oh.reshape(top_k * g, e), dim=0).reshape(top_k, g, e)
    pos = (pos * oh).to(torch.int64)                          # 1-based
    # a choice that was not made (pos 0) or overflowed gets a zero row: the
    # JAX package's one_hot(pos - 1) with its -1 -> zero convention
    keep = (pos > 0) & (pos <= cap)
    slots = torch.arange(cap, device=xg.device)
    disp_k = (((pos - 1)[..., None] == slots) & keep[..., None]).float()
    dispatch = disp_k.sum(dim=0)                              # (g, E, cap)
    kept = disp_k.sum(dim=(2, 3))                             # (k, g)
    w = topv.t() * kept                                       # dropped: 0
    w = w / torch.clamp(w.sum(dim=0, keepdim=True), min=1e-9)
    combine = (disp_k * w[:, :, None, None]).sum(dim=0)       # (g, E, cap)
    n_live = torch.clamp(valid.sum(), min=1.0)
    frac = oh[0].sum(dim=0) / n_live
    mean_gate = (gates * valid[:, None]).sum(dim=0) / n_live
    return dispatch, combine, frac, mean_gate


def moe_ffn(mp: dict, x, mesh=None, axis: str = ROWS, top_k: int = 2,
            capacity_factor: float = 1.25, group_size: int | None = 4096,
            precision: str = "high", remat_groups: bool = True):
    """MoE position-wise FFN over ``x`` (tokens, d). Returns ``(out, aux)``:
    the combined expert outputs (``x``'s shape and dtype) and the scalar
    Switch load-balance loss ``E · Σ_e frac_e · mean_gate_e`` (1.0 is
    perfectly balanced). ``precision`` "high" runs the expert products in
    ``x``'s dtype with TF32 off, "default" narrows their operands to bf16;
    routing is always f32. ``mesh`` only checks ``E % mesh.shape[axis]``
    and that the axis is a world of one."""
    if precision not in ("high", "default"):
        raise ValueError(f"unknown moe precision: {precision!r}")
    s, d = x.shape
    e = mp["wg"].shape[1]
    if not 1 <= top_k <= e:
        raise ValueError(f"top_k ({top_k}) must be in [1, n_experts={e}]")
    if mesh is not None:
        if e % mesh.shape[axis]:
            raise ValueError(
                f"n_experts ({e}) must be a multiple of mesh axis {axis!r} "
                f"({mesh.shape[axis]}) so each device holds whole experts")
        _world_of_one(mesh, axis, "expert parallelism")
    g = min(group_size, s) if group_size else s
    cap = moe_capacity(g, e, top_k, capacity_factor)
    n_groups = -(-s // g)
    pad = n_groups * g - s
    cd = torch.bfloat16 if precision == "default" else x.dtype
    w1, w2 = mp["w1"].to(cd), mp["w2"].to(cd)
    xp = F.pad(x, (0, 0, 0, pad)) if pad else x
    live = (torch.arange(n_groups * g, device=x.device) < s).float()
    xg = xp.reshape(n_groups, g, d)
    lg = live.reshape(n_groups, g)

    def one_group(xgi, lgi, wg, w1, w2):
        dispatch, combine, frac, mean_gate = _route_group(xgi, lgi, wg, top_k,
                                                          cap)
        xin = _f32_einsum("gec,gd->ecd", dispatch.to(cd), xgi.to(cd))
        h = _gelu(_f32_einsum("ecd,edf->ecf", xin.to(cd), w1)).to(cd)
        yo = _f32_einsum("ecf,efd->ecd", h, w2).to(cd)
        out = _f32_einsum("gec,ecd->gd", combine.to(cd), yo)
        return out.to(x.dtype), frac, mean_gate

    with precision_scope("highest"):
        if n_groups == 1:
            out, frac, mean_gate = one_group(xg[0], lg[0], mp["wg"], w1, w2)
            return out[:s], e * torch.sum(frac * mean_gate)
        remat = remat_groups and torch.is_grad_enabled()
        outs, stats = [], []
        for i in range(n_groups):
            args = (xg[i], lg[i], mp["wg"], w1, w2)
            o, frac, mean_gate = (
                checkpoint(one_group, *args, use_reentrant=False) if remat
                else one_group(*args))
            outs.append(o)
            stats.append(torch.sum(frac * mean_gate))
        # the groups' statistics weighted by each group's live fraction
        wts = lg.sum(dim=1) / torch.clamp(lg.sum(), min=1.0)
        aux = e * torch.sum(torch.stack(stats) * wts)
        return torch.cat(outs)[:s], aux


def moe_decode_ffn(mp: dict, h, top_k: int = 2):
    """Decode-time MoE over one token (``h`` (d,)) or one token a row
    (``h`` (B, d), the JAX package's ``vmap``): route each to its top-k
    experts by gathering those experts' weights — exact, with no capacity.
    Expert products in ``h``'s dtype, routing in f32; returns ``h``'s shape
    and dtype."""
    single = h.dim() == 1
    hb = h[None] if single else h
    gates = torch.softmax(hb.float() @ mp["wg"].float(), dim=-1)
    topv, topi = torch.topk(gates, top_k, dim=-1)             # (B, k)
    topv = topv / topv.sum(dim=-1, keepdim=True)
    cd = h.dtype
    w1 = mp["w1"][topi].to(cd)                                # (B, k, d, ff)
    w2 = mp["w2"][topi].to(cd)                                # (B, k, ff, d)
    hh = _gelu(torch.einsum("bd,bkdf->bkf", hb, w1)).to(cd)
    out = torch.einsum("bkf,bkfd->bkd", hh, w2)
    out = torch.sum(out * topv[..., None].to(out.dtype), dim=1).to(cd)
    return out[0] if single else out
