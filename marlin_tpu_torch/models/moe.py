"""Mixture-of-experts FFN: grouped capacity routing (GShard / Switch).

Counterpart of ``marlin_tpu/models/moe.py``. Every token routes to its
top-k of E experts; each expert takes at most ``c_g = ceil(g·k·cf/E)``
tokens per group of ``g``, the first choices of all tokens outranking every
second choice (choice-major priority), and a token whose choice overflows
loses it (its kept choices renormalize). Dispatch and combine are
(g, E, c_g) one-hot tensors contracted with ``torch.einsum``, as the JAX
package contracts them with ``jnp.einsum``; no hand-written kernel is
involved. Routing and the load-balance statistics run in f32.

Memory: the dispatch tensor is O(g·E·c_g) per group, so :func:`moe_ffn`
loops over groups and, with ``remat_groups``, runs each one under
``torch.utils.checkpoint`` so that autograd keeps only one group's dispatch
tensor at a time (the JAX package's ``lax.scan`` + ``jax.checkpoint``).

Expert parallelism: the JAX package places the expert axis over a mesh axis
and lets XLA insert the all-to-alls. Here, on a mesh over
``torch.distributed`` ranks:

- :func:`shard_moe_params` cuts each expert tensor to this rank's ``E/p``
  experts (its block of the expert axis), and ``_gather_moe_params`` joins
  them back whole;
- :func:`moe_ffn` keeps the logical contract (every rank passes all the
  tokens): every rank routes every token, runs its own experts' batches,
  and the partial outputs are summed over the axis;
- ``_moe_ffn_shards`` is the sequence-sharded trainer's: each rank routes
  its own rows, one all-to-all sends each expert's batch to the rank that
  owns the expert, and one brings the outputs back. Groups are laid over
  the whole stream as in the JAX package; where a group spans ranks, the
  ranks exchange its choice counts (a few integers an expert) so that every
  token gets the slot the whole group would give it, and the owner sums the
  group's partial batches.

A mesh that is not over ranks but has more than one device on the expert
axis raises ``ValueError``.

DeepSeekMoE (:func:`deepseek_moe_ffn`, DeepSeek-V2's layer, in a world of
one) routes differently: softmax scores over every routed expert in f32,
greedy top-k with the scores as weights (no renormalisation), no capacity
and so no dropped token, ``n_shared_experts`` SiLU-gated experts that every
token passes, and the sequence-wise expert-level balance term. The layer
holds a range of the routed experts and computes their part of the result:
the tokens routed to them are gathered by expert, each held expert runs one
gate/up/down product set over its tokens, and the outputs are added back
weighted (the experts' grouped products, with no one-hot dispatch tensor).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..config import resolve_device
from ..mesh import ROWS, Sharding, over_ranks
from ..obs import trace as obs_trace
from ..obs.metrics import get_registry
from ..ops.local import precision_scope
from ..parallel import collectives as col
from .deepseek import swiglu
from .transformer import _f32_einsum, _gelu

__all__ = ["init_moe", "moe_ffn", "moe_decode_ffn", "moe_capacity",
           "shard_moe_params", "init_deepseek_moe", "deepseek_moe_ffn"]


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


def _check_experts(e: int, mesh, axis: str) -> bool:
    """Raise unless ``e`` experts divide over ``mesh``'s ``axis``; returns
    whether the mesh lies over ranks (:func:`~marlin_tpu_torch.mesh.
    over_ranks`)."""
    if mesh is None:
        return False
    if e % mesh.shape[axis]:
        raise ValueError(
            f"n_experts ({e}) must be a multiple of mesh axis {axis!r} "
            f"({mesh.shape[axis]}) so each device holds whole experts")
    return over_ranks(mesh, (axis,))


def _map_moe(params, fn):
    """``fn`` over one :func:`init_moe` dict, or over every layer's ``moe``
    dict of a whole transformer params dict (other leaves pass through)."""
    if "wg" in params:
        return fn(params)
    return {k: dict(v, moe=fn(v["moe"]))
            if isinstance(v, dict) and "moe" in v else v
            for k, v in params.items()}


def shard_moe_params(params, mesh, axis: str = ROWS):
    """Place the expert tensors with their expert axis over ``axis``: on a
    mesh over ranks each ``w1``/``w2`` is cut to this rank's ``E/p`` experts
    (a copy, so the whole tensor can be freed); the router ``wg`` stays
    whole. Takes one :func:`init_moe` dict or a whole transformer params
    dict. Off a rank mesh (or with ``mesh`` None) it returns ``params``
    unchanged."""

    def place(mp):
        e = mp["wg"].shape[1]
        if not _check_experts(e, mesh, axis) or mp["w1"].shape[0] != e:
            return mp
        spec = Sharding(mesh, (axis, None, None))
        return dict(mp, w1=spec.local(mp["w1"]).clone(),
                    w2=spec.local(mp["w2"]).clone())

    return _map_moe(params, place)


def _gather_moe_params(params, mesh, axis: str = ROWS):
    """The inverse of :func:`shard_moe_params`: every rank's experts joined
    whole on every rank (a collective: every rank of the axis calls it)."""

    def join(mp):
        e = mp["wg"].shape[1]
        if not _check_experts(e, mesh, axis) or mp["w1"].shape[0] == e:
            return mp
        return dict(mp, w1=col.all_gather_cat(mp["w1"], mesh, axis, 0),
                    w2=col.all_gather_cat(mp["w2"], mesh, axis, 0))

    return _map_moe(params, join)


def _choices(xg, valid, wg, top_k: int):
    """Each row's gates (rows, E), its top-k weights renormalized (rows, k)
    and its choices as (k, rows, E) one-hots masked to live rows; f32."""
    e = wg.shape[1]
    gates = torch.softmax(xg.float() @ wg.float(), dim=-1)
    topv, topi = torch.topk(gates, top_k, dim=-1)
    topv = topv / topv.sum(dim=-1, keepdim=True)
    oh = F.one_hot(topi.t(), e).float() * valid[None, :, None]
    return gates, topv, oh


def _dispatch(oh, topv, cap: int, base):
    """The (rows, E, cap) dispatch and combine tensors of a run of rows of
    one group. Position-in-expert is 1-based: ``base`` (k, E) holds the
    slots each expert's choice ``c`` finds taken before the run's first row
    (every earlier choice of the group, and choice ``c`` of its earlier
    rows), and the run's own rows count on from there (choice-major)."""
    pos = torch.cumsum(oh, dim=1) + base[:, None, :]
    pos = (pos * oh).to(torch.int64)
    # a choice that was not made (pos 0) or overflowed gets a zero row: the
    # JAX package's one_hot(pos - 1) with its -1 -> zero convention
    keep = (pos > 0) & (pos <= cap)
    slots = torch.arange(cap, device=oh.device)
    disp_k = (((pos - 1)[..., None] == slots) & keep[..., None]).float()
    dispatch = disp_k.sum(dim=0)                              # (g, E, cap)
    kept = disp_k.sum(dim=(2, 3))                             # (k, g)
    w = topv.t() * kept                                       # dropped: 0
    w = w / torch.clamp(w.sum(dim=0, keepdim=True), min=1e-9)
    combine = (disp_k * w[:, :, None, None]).sum(dim=0)       # (g, E, cap)
    return dispatch, combine


def _earlier_choices(counts):
    """(k, E) counts of a group's choices -> the slots each choice finds
    taken by the group's earlier choices (an exclusive sum over k)."""
    return torch.cumsum(counts, dim=0) - counts


def _route_group(xg, valid, wg, top_k: int, cap: int):
    """One group's routing: the (g, E, cap) dispatch and combine tensors and
    the group's load-balance statistics, all in f32."""
    gates, topv, oh = _choices(xg, valid, wg, top_k)
    dispatch, combine = _dispatch(oh, topv, cap,
                                  _earlier_choices(oh.sum(dim=1)))
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
    routing is always f32.

    ``mesh`` checks ``E % mesh.shape[axis]``. On a mesh over ranks every
    rank passes the same ``x`` and ``mp`` with its own experts
    (:func:`shard_moe_params`; whole expert tensors are cut here): it
    routes every token, runs its experts' batches, and the partial outputs
    are summed over the axis, so every rank returns the whole result, and
    autograd gives every rank the whole gradient of ``x`` and ``wg`` and its
    own experts' gradients."""
    if precision not in ("high", "default"):
        raise ValueError(f"unknown moe precision: {precision!r}")
    s, d = x.shape
    e = mp["wg"].shape[1]
    if not 1 <= top_k <= e:
        raise ValueError(f"top_k ({top_k}) must be in [1, n_experts={e}]")
    ranks = _check_experts(e, mesh, axis)
    g = min(group_size, s) if group_size else s
    cap = moe_capacity(g, e, top_k, capacity_factor)
    n_groups = -(-s // g)
    pad = n_groups * g - s
    cd = torch.bfloat16 if precision == "default" else x.dtype
    wg, w1, w2 = mp["wg"], mp["w1"], mp["w2"]
    p = mesh.shape[axis] if ranks else 1
    own = slice(0, e)
    if ranks:
        el = e // p
        if w1.shape[0] == e and p > 1:  # whole experts: this rank's rows
            w1, w2 = (col.Scatter.apply(w, mesh, axis, 0) for w in (w1, w2))
        elif w1.shape[0] != el:
            raise ValueError(f"expert tensors hold {w1.shape[0]} experts; a "
                             f"rank of {p} holds {el} of {e}")
        own = slice(mesh.index(axis) * el, (mesh.index(axis) + 1) * el)
        # each rank computes its experts' share of the output; the shares'
        # gradients of x and wg are summed back over the axis
        x, wg = (col.Replicate.apply(t, mesh, axis) for t in (x, wg))
    w1, w2 = w1.to(cd), w2.to(cd)
    xp = F.pad(x, (0, 0, 0, pad)) if pad else x
    live = (torch.arange(n_groups * g, device=x.device) < s).float()
    xg = xp.reshape(n_groups, g, d)
    lg = live.reshape(n_groups, g)

    def one_group(xgi, lgi, wg, w1, w2):
        dispatch, combine, frac, mean_gate = _route_group(xgi, lgi, wg, top_k,
                                                          cap)
        dispatch, combine = dispatch[:, own], combine[:, own]
        xin = _f32_einsum("gec,gd->ecd", dispatch.to(cd), xgi.to(cd))
        h = _gelu(_f32_einsum("ecd,edf->ecf", xin.to(cd), w1)).to(cd)
        yo = _f32_einsum("ecf,efd->ecd", h, w2).to(cd)
        out = _f32_einsum("gec,ecd->gd", combine.to(cd), yo)
        return out.to(x.dtype), frac, mean_gate

    with precision_scope("highest"):
        if n_groups == 1:
            out, frac, mean_gate = one_group(xg[0], lg[0], wg, w1, w2)
            out, aux = out[:s], e * torch.sum(frac * mean_gate)
        else:
            remat = remat_groups and torch.is_grad_enabled()
            outs, stats = [], []
            for i in range(n_groups):
                args = (xg[i], lg[i], wg, w1, w2)
                o, frac, mean_gate = (
                    checkpoint(one_group, *args, use_reentrant=False) if remat
                    else one_group(*args))
                outs.append(o)
                stats.append(torch.sum(frac * mean_gate))
            # the groups' statistics weighted by each group's live fraction
            wts = lg.sum(dim=1) / torch.clamp(lg.sum(), min=1.0)
            aux = e * torch.sum(torch.stack(stats) * wts)
            out = torch.cat(outs)[:s]
        if ranks:  # every rank's aux is the whole one: each adds 1/p of it
            out = col.AllReduce.apply(out, mesh, axis)
            aux = col.AllReduce.apply(aux / p, mesh, axis)
        return out, aux


def _segments(start: int, rows: int, g: int) -> list[tuple[int, int, int]]:
    """The groups of ``g`` positions that the block ``[start, start +
    rows)`` of the stream meets: ``(group, first row, end row)`` in block
    rows."""
    out = []
    for gid in range(start // g, (start + rows - 1) // g + 1):
        out.append((gid, max(start, gid * g) - start,
                    min(start + rows, (gid + 1) * g) - start))
    return out


def _moe_ffn_shards(mp: dict, h, shards, top_k: int = 2,
                    capacity_factor: float = 1.25,
                    group_size: int | None = 4096, precision: str = "high"):
    """The MoE FFN over this rank's rows ``h`` (``shards.rows``, d) of a
    stream sharded over ``shards.axis`` (``models/transformer.py:
    _SeqShards``), with this rank's experts (:func:`shard_moe_params`).
    Routes as :func:`moe_ffn` routes the whole stream (groups of ``g``
    positions from position 0; positions at or past ``shards.seq`` are not
    live); one all-to-all takes each expert's batches to the rank that owns
    it and one brings the outputs back. Returns ``(out, aux)``: this rank's
    rows of the output and its share of the load-balance term (the shares
    sum over the axis to :func:`moe_ffn`'s aux)."""
    if precision not in ("high", "default"):
        raise ValueError(f"unknown moe precision: {precision!r}")
    mesh, axis = shards.mesh, shards.axis
    p = mesh.shape[axis]
    rank = mesh.index(axis)
    e = mp["wg"].shape[1]
    if not 1 <= top_k <= e:
        raise ValueError(f"top_k ({top_k}) must be in [1, n_experts={e}]")
    _check_experts(e, mesh, axis)
    el = e // p
    w1, w2 = mp["w1"], mp["w2"]
    if w1.shape[0] == e and p > 1:
        w1, w2 = (col.Scatter.apply(w, mesh, axis, 0) for w in (w1, w2))
    s, rows, d = shards.seq, shards.rows, h.shape[1]
    g = min(group_size, s) if group_size else s
    cap = moe_capacity(g, e, top_k, capacity_factor)
    n_groups = -(-shards.padded // g)
    cd = torch.bfloat16 if precision == "default" else h.dtype
    dev = h.device
    # every rank's segments, padded to the longest list: the all-to-alls
    # move the same shapes on every rank
    segs = [_segments(r * rows, rows, g) for r in range(p)]
    n_seg = max(len(x) for x in segs)
    gids = torch.tensor([[gid for gid, _, _ in x] + [n_groups] * (n_seg -
                                                                  len(x))
                         for x in segs], device=dev).reshape(-1)
    mine = segs[rank]
    with precision_scope("highest"):
        live = (shards.start + torch.arange(rows, device=dev)
                < s).float()
        gates, topv, oh = _choices(h, live, mp["wg"], top_k)
        # each group's choice and live counts from every rank that holds a
        # part of it (integers: the sums are exact and equal everywhere)
        counts = torch.zeros((n_groups, p, top_k * e + 1), device=dev)
        for gid, a, b in mine:
            counts[gid, rank, :-1] = oh[:, a:b].sum(dim=1).reshape(-1)
            counts[gid, rank, -1] = live[a:b].sum()
        counts = col.all_reduce_sum(counts, mesh, axis)
        choice = counts[..., :-1].reshape(n_groups, p, top_k, e)
        n_live = counts[..., -1].sum(dim=1)                   # (groups,)
        total = choice.sum(dim=1)                             # (groups, k, E)
        before = choice[:, :rank].sum(dim=1)
        xin, combines = [], []
        aux = torch.zeros((), dtype=torch.float32, device=dev)
        for gid, a, b in mine:
            dispatch, combine = _dispatch(
                oh[:, a:b], topv[a:b], cap,
                _earlier_choices(total[gid]) + before[gid])
            xin.append(_f32_einsum("tec,td->ecd", dispatch.to(cd),
                                   h[a:b].to(cd)).to(cd))
            combines.append(combine)
            # frac (no gradient) is the whole group's; the gate sum this
            # rank's part of it: the parts add up over the ranks
            nl = torch.clamp(n_live[gid], min=1.0)
            frac = total[gid, 0] / nl
            gate_sum = (gates[a:b] * live[a:b, None]).sum(dim=0)
            aux = aux + (n_live[gid] / s) * torch.sum(frac * gate_sum / nl)
        # (segments, E, cap, d) -> rank j gets every segment's batches for
        # its experts; a group's parts from several ranks are summed
        xin += [torch.zeros_like(xin[0])] * (n_seg - len(xin))
        send = torch.stack(xin).reshape(n_seg, p, el, cap, d).transpose(0, 1)
        recv = col.AllToAll.apply(send.contiguous(), mesh, axis)
        batch = torch.zeros((n_groups + 1, el, cap, d), dtype=cd, device=dev)
        batch = batch.index_add(0, gids, recv.reshape(p * n_seg, el, cap, d))
        hid = _gelu(_f32_einsum("gecd,edf->gecf", batch[:n_groups],
                                w1.to(cd))).to(cd)
        yo = _f32_einsum("gecf,efd->gecd", hid, w2.to(cd)).to(cd)
        yo = F.pad(yo, (0, 0, 0, 0, 0, 0, 0, 1))              # the dummy
        back = yo.index_select(0, gids).reshape(p, n_seg, el, cap, d)
        got = col.AllToAll.apply(back, mesh, axis)            # [j]: owner j
        got = got.transpose(0, 1).reshape(n_seg, e, cap, d)
        out = torch.cat([_f32_einsum("tec,ecd->td", c.to(cd), got[j])
                         for j, c in enumerate(combines)])
        return out.to(h.dtype), e * aux


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


# ------------------------------------------------------------ DeepSeekMoE


def init_deepseek_moe(normal, cfg) -> dict:
    """A DeepSeekMoE layer's params from ``normal(*shape)`` (a draw of the
    init distribution): the router ``wg`` (d, E) over every routed expert,
    the held experts' ``w_gate``/``w_up`` (E_held, d, f) and ``w_down``
    (E_held, f, d), and the shared experts fused into one SiLU FFN of width
    ``n_shared_experts * f`` (``shared_gate``, ``shared_up``,
    ``shared_down``), as ``modeling_deepseek`` builds them."""
    d, f = cfg.d_model, cfg.moe_d_ff
    lo, hi = cfg.held
    fs = cfg.n_shared_experts * f
    mp = {"wg": normal(d, cfg.n_routed_experts),
          "w_gate": normal(hi - lo, d, f), "w_up": normal(hi - lo, d, f),
          "w_down": normal(hi - lo, f, d)}
    if fs:
        mp.update(shared_gate=normal(d, fs), shared_up=normal(d, fs),
                  shared_down=normal(fs, d))
    return mp


_moe_families = None


def _moe_metrics():
    """(tokens dispatched to held experts, counted at every dispatch; the
    last dispatch's largest held-expert load over the held mean)."""
    global _moe_families
    if _moe_families is None:
        reg = get_registry()
        _moe_families = (
            reg.counter("marlin_moe_dispatched_tokens_total",
                        "(token, expert) pairs routed to the experts a "
                        "DeepSeekMoE layer holds, at every dispatch (a "
                        "remat recompute dispatches again)"),
            reg.gauge("marlin_moe_held_load_ratio",
                      "The last dispatch's largest held-expert load over "
                      "the mean load of the held experts"))
    return _moe_families


def deepseek_moe_ffn(mp: dict, h, cfg):
    """DeepSeekMoE over ``h`` (tokens, d) in a world of one (``cfg`` a
    :class:`~.deepseek.DeepSeekConfig`); returns ``(out, aux)`` in ``h``'s
    dtype and f32. ``modeling_deepseek``'s ``MoEGate`` and
    ``DeepseekV2MoE``, term by term:

    - scores ``softmax(h W_g)`` over all ``n_routed_experts`` in f32; each
      token's greedy top ``experts_per_token`` with their scores times
      ``routed_scaling_factor`` as weights (``norm_topk_prob`` false);
    - ``aux = sum_e ce_e * mean_t(score_te)``, ``ce_e`` expert ``e``'s
      share of the choices over its uniform share (the sequence-wise term
      at one sequence; the caller scales it by ``aux_loss_alpha``);
    - the held experts ``cfg.held`` run over the tokens routed to them, with
      no capacity: each expert's tokens are gathered (one host read of the
      experts' counts sizes the groups), run through its SiLU FFN in
      ``h``'s dtype and added back at their weights in f32; the shared
      experts run over every token.

    The experts that are not held add nothing: their part of the result is
    the other chips' of an expert-parallel deployment."""
    n, d = h.shape
    e, k = cfg.n_routed_experts, cfg.experts_per_token
    lo, hi = cfg.held
    with obs_trace.span("moe.route"):
        scores = torch.softmax(h.float() @ mp["wg"].float(), dim=-1)
        topv, topi = torch.topk(scores, k, dim=-1)
        topv = topv * cfg.routed_scaling_factor
        flat = topi.reshape(-1)
        counts = torch.bincount(flat, minlength=e)
        aux = torch.sum(counts.float() / (n * k / e) * scores.mean(dim=0))
    with obs_trace.span("moe.dispatch"):
        # every (token, choice) slot by expert; the held experts' run of
        # them is sized by the layer's one host read
        order = torch.argsort(flat, stable=True)
        sizes = counts.tolist()
        pick = order[sum(sizes[:lo]):sum(sizes[:hi])]
        sizes = sizes[lo:hi]
        tok = pick // k
        xs = h[tok]
        chosen, families = sum(sizes), _moe_metrics()
        families[0].inc(chosen)
        if sizes:
            families[1].set(max(sizes) * len(sizes) / chosen if chosen
                            else 0.0)
    with obs_trace.span("moe.experts"):
        # the held experts' weights cast once, not once an expert
        w_gate, w_up, w_down = (mp[key].to(h.dtype)
                                for key in ("w_gate", "w_up", "w_down"))
        parts, start = [], 0
        for j, size in enumerate(sizes):
            if size:
                parts.append(swiglu(xs[start:start + size], w_gate[j],
                                    w_up[j], w_down[j]))
            start += size
        shared = None
        if "shared_gate" in mp:
            shared = swiglu(h, mp["shared_gate"], mp["shared_up"],
                            mp["shared_down"])
    with obs_trace.span("moe.combine"):
        out = torch.zeros((n, d), dtype=torch.float32, device=h.device)
        if parts:
            y = torch.cat(parts).float() * topv.reshape(-1)[pick][:, None]
            out = out.index_add(0, tok, y)
        out = out.to(h.dtype)
        if shared is not None:
            out = out + shared
    return out, aux
