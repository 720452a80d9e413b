"""The causal transformer LM: training (in a world of one or with the stream
sharded over ranks), generation and paged decode.

Counterpart of ``marlin_tpu/models/transformer.py``: init, the training half
(``transformer_forward``, ``lm_loss`` with the chunked LM head,
``lm_train_step`` with Adam, ``TransformerLM.train``; ``remat`` and
``mlp_chunk`` recompute through ``torch.utils.checkpoint``), the dense and
flash prefill, the cached decode step, ``lm_generate`` /
``lm_generate_batch``, the paged trio ``init_kv_pages`` /
``lm_prefill_paged`` / ``lm_decode_paged`` with ``kv_page_copy``, and the
dense-slab pair ``lm_prefill_slot`` / ``lm_decode_rows`` over
``init_kv_slab``. Names, parameter layout (``emb``,
``l{i}.{wq,wk,wv,wo,ln1,ln2,w1,w2}`` or, in a mixture-of-experts layer,
``l{i}.moe.{wg,w1,w2}`` in place of ``w1``/``w2``; ``ln_f``) and contracts
are the JAX package's; every program takes the ``moe`` routing tuple
(``models/moe.py``). Training runs ring and Ulysses attention
(``parallel/``); ``offload_residuals`` parks the remat checkpoints' block
inputs in pinned host memory between the forward and the backward
(:class:`_ResidualOffload`). On a mesh over ``torch.distributed`` ranks the
stream is sharded over the mesh's ``rows`` axis, as the JAX package's GSPMD
shards its residual stream: each rank holds its block of the padded
stream from the embedding to the loss (:class:`_SeqShards`), attention runs
on the blocks, a MoE layer's experts are spread over the same axis, and
the replicated parameters' gradients are summed over it before Adam; the
caller passes and gets back the whole params.

Differences that follow from PyTorch:

- No jit and no buffer donation. Programs run eagerly, and the KV caches and
  the page slab are updated IN PLACE (``index_put_`` / ``copy_``); the
  functions still return them, so callers read as with JAX.
- The attention kernels are hand-written CUDA (``ops/``): the paged decode
  kernel behind ``lm_decode_paged(kernel="pallas")``, the flash panel behind
  prompts of ``_PREFILL_FLASH_MIN`` tokens or more and behind training's
  attention, and the flash backward kernels in training. Everything else is
  plain PyTorch; products run in IEEE f32 (TF32 off inside every entry
  point), as the JAX package's f32 products do on the CPU.
- Sampling replays the JAX package's streams: the keys, splits and Gumbel
  noise come from the threefry port (:mod:`marlin_tpu_torch.threefry`), so a
  sampled token equals the reference's wherever the logits agree.
- ``gelu`` is the tanh form, as ``jax.nn.gelu``'s default.
"""

from __future__ import annotations

import dataclasses
import functools
import inspect
import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .. import threefry
from ..config import get_config, resolve_device
from ..mesh import ROWS, default_mesh, distributed, over_ranks
from ..obs import trace as obs_trace
from ..ops import flash_attention as _flash
from ..ops.local import precision_scope
from ..ops.paged_attention import paged_decode_attention
from ..parallel import collectives as col
from ..parallel.pipeline import _leaves, _tree_map
from ..parallel.ring_attention import (resolve_attention_backend,
                                       ring_attention, ring_attention_shard,
                                       ring_padded_len)
from ..parallel.ulysses import (ulysses_attention, ulysses_attention_shard,
                                ulysses_padded_len)
from . import deepseek as _ds

__all__ = ["TransformerLM", "init_transformer", "transformer_forward",
           "lm_loss", "lm_value_and_grad", "lm_train_step", "AdamState",
           "adam_init",
           "lm_generate", "lm_generate_batch", "init_kv_slab",
           "lm_prefill_slot", "lm_decode_rows", "init_kv_pages",
           "lm_prefill_paged", "lm_decode_paged", "kv_page_copy",
           "resolve_decode_kernel", "synthetic_stream"]

_MASKED = -1e30
# the MoE routing knobs (top_k, capacity_factor, group) a MoE layer uses
# when the caller passes no ``moe`` tuple, as in the JAX package
_MOE_DEFAULTS = (2, 1.25, 4096)

def synthetic_stream(seq: int, vocab: int = 64, seed: int = 0,
                     period: int = 8, step: int = 3,
                     noise: float = 0.1) -> np.ndarray:
    """A learnable token stream for demos/tests: a short repeating pattern
    with a ``noise`` fraction of random tokens (the JAX package's, numpy)."""
    rng = np.random.default_rng(seed)
    base = np.tile(np.arange(period) * step % vocab, seq // period + 1)[:seq]
    rand = rng.integers(0, vocab, seq)
    return np.where(rng.random(seq) < 1.0 - noise, base, rand).astype(np.int32)


def init_transformer(key, vocab: int, d_model: int, heads: int, layers: int,
                     d_ff: int | None = None, dtype=torch.float32,
                     kv_heads: int | None = None, n_experts: int | None = None,
                     moe_every: int = 1, device=None, arch=None) -> dict:
    """Scaled-normal init with a tied embedding; ``kv_heads`` enables GQA
    (wk/wv project to ``kv_heads·dh``). ``n_experts`` turns the FFN of every
    ``moe_every``-th layer (from layer ``moe_every - 1``) into a
    mixture-of-experts (:func:`~.moe.init_moe` under the layer's ``"moe"``
    key, in place of ``w1``/``w2``). ``key`` is an int seed of a
    ``torch.Generator`` on ``device``; the draws differ from ``jax.random``'s
    (carry JAX weights over with
    :func:`marlin_tpu_torch.interop.lm_params_from_numpy`).

    ``arch`` (a :class:`~.deepseek.DeepSeekConfig`) draws a DeepSeek-V2
    model instead (:func:`~.deepseek.init_deepseek`), for callers of
    :func:`lm_train_step` that hold no ``TransformerLM``; the other
    arguments must then be the config's sizes and the toy model's
    defaults."""
    if arch is not None:
        if (vocab, d_model, heads, layers, d_ff, kv_heads, n_experts) != (
                arch.vocab, arch.d_model, arch.heads, arch.layers, None,
                None, None):
            raise ValueError("sizes that are not the config's: a DeepSeek "
                             "config sets vocab, d_model, heads and layers, "
                             "and takes no d_ff, kv_heads or n_experts")
        return _ds.init_deepseek(key, arch, dtype, device)
    d_ff = d_ff or 4 * d_model
    kvh = heads if kv_heads is None else kv_heads
    if kvh < 1 or heads % kvh:
        raise ValueError(f"kv_heads ({kvh}) must divide heads ({heads})")
    if moe_every < 1:
        raise ValueError(f"moe_every must be >= 1, got {moe_every}")
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(key))

    def normal(shape, scale):
        return (torch.randn(shape, generator=gen, device=dev).to(dtype)
                * scale)

    kv_dim = (d_model // heads) * kvh
    s = 1.0 / math.sqrt(d_model)
    p = {"emb": normal((vocab, d_model), 0.02)}
    for i in range(layers):
        lp = {
            "wq": normal((d_model, d_model), s),
            "wk": normal((d_model, kv_dim), s),
            "wv": normal((d_model, kv_dim), s),
            "wo": normal((d_model, d_model), s),
            "ln1": torch.ones(d_model, dtype=dtype, device=dev),
            "ln2": torch.ones(d_model, dtype=dtype, device=dev),
        }
        if n_experts is not None and (i + 1) % moe_every == 0:
            from .moe import init_moe

            lp["moe"] = init_moe(gen, d_model, d_ff, n_experts, dtype)
        else:
            lp["w1"] = normal((d_model, d_ff), s)
            lp["w2"] = normal((d_ff, d_model), 1.0 / math.sqrt(d_ff))
        p[f"l{i}"] = lp
    p["ln_f"] = torch.ones(d_model, dtype=dtype, device=dev)
    return p


def _n_layers(params: dict) -> int:
    """Layer count from the params dict (the ``l{i}`` naming scheme)."""
    return sum(1 for k in params if k.startswith("l") and k[1:].isdigit())


def _layer(params: dict, i: int) -> dict:
    return params[f"l{i}"]


def _rmsnorm(x, g, eps: float = 1e-6):
    """Statistics in f32 whatever the activation dtype; output in x's."""
    xf = x.float()
    y = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (y * g).to(x.dtype)


def _gelu(x):
    return F.gelu(x, approximate="tanh")


def _mlp(h, lp, cd, chunk: int | None = None):
    """The position-wise FFN, optionally over ``chunk``-token slices, each
    recomputed in the backward (``torch.utils.checkpoint``): the (seq, d_ff)
    GELU intermediate then never exceeds (chunk, d_ff). Positions are
    independent, so slicing is exact."""
    if chunk is not None and chunk < 1:
        raise ValueError(f"mlp_chunk must be >= 1 or None, got {chunk}")
    w1, w2 = lp["w1"].to(cd), lp["w2"].to(cd)

    def one(hc):
        return _gelu(hc @ w1) @ w2

    if chunk is None or h.shape[0] <= chunk:
        return one(h)
    seq = h.shape[0]
    n_full = seq // chunk
    outs = [checkpoint(one, h[i * chunk:(i + 1) * chunk], use_reentrant=False)
            for i in range(n_full)]
    if seq % chunk:
        outs.append(one(h[n_full * chunk:]))
    return torch.cat(outs)


def _moe_knobs(moe) -> tuple:
    """The MoE routing tuple ``(top_k, capacity_factor, group)``: the
    caller's, else :data:`_MOE_DEFAULTS`."""
    return _MOE_DEFAULTS if moe is None else tuple(moe)


def _ffn(h, lp, cd, moe=None, mesh=None, precision: str = "high",
         chunk: int | None = None, shards=None):
    """The FFN over a (tokens, d) block: the layer's MoE
    (:func:`~.moe.moe_ffn`, grouped routing with the knobs of ``moe``; on
    this rank's rows of a sharded stream ``shards`` the expert-parallel
    :func:`~.moe._moe_ffn_shards`) or the dense GELU FFN (``chunk`` as
    :func:`_mlp`'s). Returns ``(out, aux)``, ``aux`` the MoE load-balance
    term (an exact f32 zero for a dense layer; this rank's share of it on
    shards)."""
    if "moe" in lp:
        from .moe import _moe_ffn_shards, moe_ffn

        tk, cf, gs = _moe_knobs(moe)
        if shards is not None:
            return _moe_ffn_shards(lp["moe"], h, shards, top_k=tk,
                                   capacity_factor=cf, group_size=gs,
                                   precision=precision)
        return moe_ffn(lp["moe"], h, mesh=mesh, top_k=tk, capacity_factor=cf,
                       group_size=gs, precision=precision)
    return (_mlp(h, lp, cd, chunk),
            torch.zeros((), dtype=torch.float32, device=h.device))


def _decode_ffn(h, lp, cd, moe=None):
    """The decode FFN over one token a row (``h`` (B, d)): MoE layers route
    each row exactly to its top-k experts (:func:`~.moe.moe_decode_ffn`)."""
    if "moe" in lp:
        from .moe import moe_decode_ffn

        return moe_decode_ffn(lp["moe"], h, top_k=_moe_knobs(moe)[0])
    return _mlp(h, lp, cd)


def _f32_einsum(eq: str, a, b):
    """An einsum with at least f32 results (the JAX package's
    ``preferred_element_type=f32``): bf16 operands are widened first, which
    is exact (the products of two bf16 values fit in f32); f64 ones (a
    reference run) stay f64."""
    dt = torch.promote_types(torch.promote_types(a.dtype, b.dtype),
                             torch.float32)
    return torch.einsum(eq, a.to(dt), b.to(dt))


def _head_logits(x, emb):
    """LM head with f32 logits whatever the activation dtype: the embedding is
    rounded to x's dtype, then both are widened (exactly) for an f32
    product — never a bf16-rounded logit."""
    return x.float() @ emb.to(x.dtype).float().t()


def _cdtype(compute_dtype, params) -> torch.dtype:
    if compute_dtype is None:
        return params["emb"].dtype
    if isinstance(compute_dtype, torch.dtype):
        return compute_dtype
    return getattr(torch, str(compute_dtype))


def _inference(fn):
    """Entry points run without autograd and with TF32 off."""
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with torch.no_grad(), precision_scope("highest"):
            return fn(*args, **kwargs)
    return wrapper


def _host(v) -> np.ndarray:
    return v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _ints(v, device) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=torch.long)
    return torch.as_tensor(np.asarray(v).astype(np.int64), device=device)


def _page_ids(table, pages, device) -> torch.Tensor:
    """A block table as a long tensor on ``device``; one that arrives from
    the host is checked against the slab first (the decode kernel reads
    through the ids unchecked)."""
    if not (isinstance(table, torch.Tensor) and table.device.type != "cpu"):
        t = _host(table)
        n = next(iter(pages.values()))[0].shape[0]
        if t.size and (t.min() < 0 or t.max() >= n):
            raise ValueError(f"block table holds page ids outside [0, {n})")
    return _ints(table, device)


# ------------------------------------------------------------- sampling


def _pick_tokens(temperature, top_p, top_k, logits, sub):
    """Greedy at temperature 0, else top-k -> nucleus (top-p) -> categorical
    over the last axis, one key for the whole call (``lm_generate`` and
    ``lm_generate_batch``). ``top_k`` None / ``top_p`` None disable their
    filters."""
    if not float(temperature) > 0.0:
        return torch.argmax(logits, dim=-1)
    t = torch.tensor(max(float(temperature), 1e-6), dtype=torch.float32,
                     device=logits.device)
    l = logits / t
    if top_k is not None:
        kth = torch.topk(l, top_k, dim=-1).values[..., -1:]
        l = torch.where(l < kth, -math.inf, l)
    if top_p is not None:
        # nucleus by rank: keep the smallest prefix of descending-probability
        # tokens whose exclusive mass is below top_p (rank 0 always stays)
        order = torch.argsort(-l, dim=-1, stable=True)
        srt = torch.gather(l, -1, order)
        probs = torch.softmax(srt, dim=-1)
        tp = torch.tensor(float(top_p), dtype=torch.float32, device=l.device)
        keep = (torch.cumsum(probs, dim=-1) - probs) < tp
        keep[..., 0] = True
        keep = torch.gather(keep, -1, torch.argsort(order, dim=-1))
        l = torch.where(keep, l, -math.inf)
    return threefry.categorical(sub, l)


def _pick_token_row(temperature, top_p, top_k, logits, keys):
    """Per-row sampling, every knob a (B,) vector: temperature 0 = greedy
    argmax, ``top_k`` 0 = no rank filter, ``top_p`` 1.0 = no nucleus filter;
    ``keys`` (B, 2) are the rows' streams. Top-k is by rank (exactly k
    survivors). Rows are sampled only when some temperature is positive (a
    host check: pass numpy knobs to keep it off the device)."""
    greedy = torch.argmax(logits, dim=-1)
    temperature = _host(temperature).astype(np.float32)
    if not np.any(temperature > 0):
        return greedy
    dev = logits.device
    temp = torch.as_tensor(temperature, device=dev)
    tp = torch.as_tensor(_host(top_p).astype(np.float32), device=dev)
    tk = torch.as_tensor(_host(top_k).astype(np.int64), device=dev)
    l = logits / torch.clamp(temp, min=1e-6)[:, None]
    order = torch.argsort(-l, dim=-1, stable=True)
    srt = torch.gather(l, -1, order)
    ranks = torch.arange(l.shape[-1], device=dev)[None, :]
    srt = torch.where((tk[:, None] <= 0) | (ranks < tk[:, None]), srt,
                      -math.inf)
    probs = torch.softmax(srt, dim=-1)
    keep = (torch.cumsum(probs, dim=-1) - probs) < tp[:, None]
    keep[:, 0] = True
    srt = torch.where(keep, srt, -math.inf)
    sampled = threefry.categorical(
        keys, torch.gather(srt, -1, torch.argsort(order, dim=-1)))
    return torch.where(temp > 0, sampled, greedy)


def _row_keys(seeds, steps, device) -> torch.Tensor:
    """The per-row sampling streams ``fold_in(key(seed), step)``, (B, 2):
    depend only on (seed, step), never on the slot or the batch."""
    s = _ints(seeds, device) & 0xFFFFFFFF
    base = torch.stack([torch.zeros_like(s), s], dim=-1)
    return threefry.fold_in(base, _ints(steps, device))


# ------------------------------------------------------------- decode step


def _decode_step(params, x, caches, pos, heads: int, moe=None):
    """Cached decode at ``pos``: ``x`` is the embedded token in the compute
    dtype, ``caches`` maps layer -> (k, v). Batched form: ``x`` (B, d),
    caches (B, L, kv_heads, dh), ``pos`` (B,); the JAX package's single-row
    form (``x`` (d,), caches (L, kv_heads, dh), int ``pos``) is accepted too.
    Attention runs grouped (kv_heads, group) with f32 scores and softmax and
    positions ``> pos`` masked. The caches are written IN PLACE at ``pos``;
    returns ``(logits, caches)`` with f32 logits."""
    single = x.dim() == 1
    if single:
        x = x[None]
        caches = {n: (k[None], v[None]) for n, (k, v) in caches.items()}
    B, d = x.shape
    dh = d // heads
    cd = x.dtype
    rows = torch.arange(B, device=x.device)
    pos = _ints(pos, x.device).reshape(B)
    for i in range(_n_layers(params)):
        lp = _layer(params, i)
        ck, cv = caches[f"l{i}"]
        L, kvh = ck.shape[1], ck.shape[2]
        h = _rmsnorm(x, lp["ln1"])
        q = (h @ lp["wq"].to(cd)).reshape(B, kvh, heads // kvh, dh)
        ck[rows, pos] = (h @ lp["wk"].to(cd)).reshape(B, kvh, dh).to(ck.dtype)
        cv[rows, pos] = (h @ lp["wv"].to(cd)).reshape(B, kvh, dh).to(cv.dtype)
        s = _f32_einsum("bkgd,btkd->bkgt", q, ck) / math.sqrt(dh)
        live = torch.arange(L, device=x.device)[None, :] <= pos[:, None]
        s = torch.where(live[:, None, None, :], s, _MASKED)
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bkgt,btkd->bkgd", p.to(cd), cv.to(cd))
        x = x + o.reshape(B, d) @ lp["wo"].to(cd)
        x = x + _decode_ffn(_rmsnorm(x, lp["ln2"]), lp, cd, moe)
    logits = _head_logits(_rmsnorm(x, params["ln_f"]), params["emb"])
    if single:
        return logits[0], {n: (k[0], v[0]) for n, (k, v) in caches.items()}
    return logits, caches


# ----------------------------------------------------------------- prefill


# Prompts at/above this length prefill through the flash kernel instead of
# the dense (heads, P, P) score tensor, as in the JAX package.
_PREFILL_FLASH_MIN = 2048


def _prefill_attn(q, k, v, cdtype):
    """Causal self-attention over the whole prompt, (P, heads, dh) -> same.
    Short prompts: one dense score tensor. From :data:`_PREFILL_FLASH_MIN`:
    the flash panel over all heads in one call, the prompt padded to the JAX
    package's block contract (1024 multiples above 1024, else 128) with
    ``valid_len`` masking the pad; no score matrix is ever held."""
    P, heads, dh = q.shape
    scale = 1.0 / math.sqrt(dh)
    if P < _PREFILL_FLASH_MIN:
        causal = torch.ones((P, P), dtype=torch.bool, device=q.device).tril()
        s = _f32_einsum("phd,thd->hpt", q, k) * scale
        s = torch.where(causal[None], s, _MASKED)
        return torch.einsum("hpt,thd->phd", torch.softmax(s, dim=-1).to(cdtype),
                            v.to(cdtype))
    m = 1024 if P > 1024 else 128
    pp = -(-P // m) * m
    qh, kh, vh = (F.pad(t, (0, 0, 0, 0, 0, pp - P)).permute(1, 0, 2)
                  for t in (q, k, v))
    # resolved through the module so a check can swap in the plain version
    out, _ = _flash.flash_attention_single_panel(qh, kh, vh, P, causal=True,
                                                 scale=scale)
    return out.permute(1, 0, 2)[:P].to(cdtype)


def _prefill_hidden(params, prompt, heads: int, max_len: int, cdtype,
                    moe=None):
    """The whole prompt in one parallel forward: final-norm hidden states
    (P, d) and per-layer KV caches (max_len, kv_heads, dh) in ``cdtype``."""
    P = prompt.shape[0]
    d = params["emb"].shape[1]
    dh = d // heads
    dev = params["emb"].device
    x = params["emb"][prompt].to(cdtype)
    caches = {}
    for i in range(_n_layers(params)):
        lp = _layer(params, i)
        kvh = lp["wk"].shape[1] // dh
        h = _rmsnorm(x, lp["ln1"])
        q = (h @ lp["wq"].to(cdtype)).reshape(P, heads, dh)
        k, v = ((h @ lp[w].to(cdtype)).reshape(P, kvh, dh) for w in ("wk", "wv"))
        cache = []
        for t in (k, v):
            c = torch.zeros((max_len, kvh, dh), dtype=cdtype, device=dev)
            c[:P] = t
            cache.append(c)
        caches[f"l{i}"] = tuple(cache)
        if kvh != heads:
            k, v = (t.repeat_interleave(heads // kvh, dim=1) for t in (k, v))
        o = _prefill_attn(q, k, v, cdtype)
        x = x + o.reshape(P, d) @ lp["wo"].to(cdtype)
        x = x + _ffn(_rmsnorm(x, lp["ln2"]), lp, cdtype, moe)[0]
    return _rmsnorm(x, params["ln_f"]), caches


def _prefill(params, prompt, heads: int, max_len: int, cdtype, moe=None):
    """Final-position logits + caches (the single-sequence prefill)."""
    x, caches = _prefill_hidden(params, prompt, heads, max_len, cdtype, moe)
    return _head_logits(x[-1], params["emb"]), caches


# ---------------------------------------------------------------- generate


@_inference
def lm_generate(params, prompt, key, heads: int, max_len: int, steps: int,
                temperature=0.0, compute_dtype=None, top_p=None,
                top_k: int | None = None, moe=None):
    """KV-cached autoregressive decode: batched prefill of the prompt, then
    ``steps - 1`` decode steps. ``key`` is an int seed or key words
    (``jax.random.key_data``); one split per sampled token, as the JAX
    package draws. ``compute_dtype`` runs the residual stream and the caches
    in that dtype (logits and softmax stay f32); ``moe`` is the MoE layers'
    ``(top_k, capacity_factor, group)``. Returns the ``(n_prompt + steps,)``
    token tensor on the params' device."""
    _ds.refuse_latent(params, "lm_generate")
    dev = params["emb"].device
    prompt = _ints(prompt, dev)
    n = prompt.shape[0]
    if n + steps > max_len:
        raise ValueError(
            f"prompt ({n}) + steps ({steps}) exceeds max_len ({max_len}); "
            f"raise max_len or shorten the request")
    cd = _cdtype(compute_dtype, params)
    pick = functools.partial(_pick_tokens, temperature, top_p, top_k)
    sample = float(temperature) > 0.0
    key = threefry.as_key(key, dev)
    logits0, caches = _prefill(params, prompt, heads, max_len, cd, moe)
    key, sub = threefry.split(key)
    tokens = torch.zeros(max_len, dtype=torch.long, device=dev)
    tokens[:n] = prompt
    tokens[n] = pick(logits0, sub)
    caches = {name: (k[None], v[None]) for name, (k, v) in caches.items()}
    for pos in range(n, n + steps - 1):
        x = params["emb"][tokens[pos:pos + 1]].to(cd)
        logits, caches = _decode_step(params, x, caches, [pos], heads, moe)
        if sample:
            key, sub = threefry.split(key)
        tokens[pos + 1] = pick(logits[0], sub)
    return tokens[:n + steps]


@_inference
def lm_generate_batch(params, prompts, lengths, key, heads: int,
                      max_len: int, steps: int, temperature=0.0,
                      compute_dtype=None, top_p=None,
                      top_k: int | None = None, moe=None):
    """Batched KV-cached decode of ragged prompts: ``prompts`` (B, P) padded
    to a common P, ``lengths`` (B,) the true lengths; each row continues from
    its own position. Returns (B, max_len) tokens; row b's generation fills
    ``[lengths[b], lengths[b] + steps)``. Sampling knobs as
    :func:`lm_generate` (one key per step for the whole batch)."""
    _ds.refuse_latent(params, "lm_generate_batch")
    dev = params["emb"].device
    prompts = _ints(prompts, dev)
    lengths = _ints(lengths, dev)
    B, P = prompts.shape
    if P + steps > max_len:
        raise ValueError(
            f"padded prompt ({P}) + steps ({steps}) exceeds max_len "
            f"({max_len}); raise max_len or shorten the request")
    cd = _cdtype(compute_dtype, params)
    pick = functools.partial(_pick_tokens, temperature, top_p, top_k)
    sample = float(temperature) > 0.0
    key = threefry.as_key(key, dev)
    rows = torch.arange(B, device=dev)
    hidden, per_row = zip(*(_prefill_hidden(params, prompts[b], heads, max_len,
                                            cd, moe) for b in range(B)))
    caches = {name: tuple(torch.stack([c[name][j] for c in per_row])
                          for j in range(2)) for name in per_row[0]}
    hlast = torch.stack(hidden)[rows, lengths - 1]
    key, sub = threefry.split(key)
    tokens = torch.zeros((B, max_len), dtype=torch.long, device=dev)
    tokens[:, :P] = prompts
    tokens[rows, lengths] = pick(_head_logits(hlast, params["emb"]), sub)
    for t in range(steps - 1):
        pos = lengths + t
        x = params["emb"][tokens[rows, pos]].to(cd)
        logits, caches = _decode_step(params, x, caches, pos, heads, moe)
        if sample:
            key, sub = threefry.split(key)
        tokens[rows, pos + 1] = pick(logits, sub)
    return tokens


# -------------------------------------------------------- dense-slab serving
# The serving engine's control backend (``ServeEngine(paged=False)``): one
# persistent KV slab per bucket, a slot a row, each slot's cache as long as
# the bucket's prompt plus its steps. Per-row results depend only on the row
# (the same math as lm_generate; sampled rows draw fold_in(key(seed), step)),
# never on which rows share a step.


def init_kv_slab(params, rows: int, max_len: int, heads: int,
                 compute_dtype=None):
    """Zeroed persistent KV pool on the params' device: layer -> (k, v), each
    (rows, max_len, kv_heads, dh) in the compute dtype, one slot a row."""
    _ds.refuse_latent(params, "init_kv_slab")
    d = params["emb"].shape[1]
    dh = d // heads
    kvh = params["l0"]["wk"].shape[1] // dh
    dt = _cdtype(compute_dtype, params)
    dev = params["emb"].device
    return {f"l{i}": tuple(torch.zeros((rows, max_len, kvh, dh), dtype=dt,
                                       device=dev) for _ in range(2))
            for i in range(_n_layers(params))}


@_inference
def lm_prefill_slot(params, caches, tokens, slot, prompt, length, heads: int,
                    max_len: int, seed=0, temperature=0.0, top_p=None,
                    top_k=None, compute_dtype=None, moe=None):
    """Prefill one prompt into slot ``slot`` of a slab.

    ``caches`` (from :func:`init_kv_slab`) and ``tokens`` (rows, max_len)
    are updated IN PLACE (the JAX package donates them) and returned.
    ``prompt`` (P,) is padded to the bucket width, ``length`` its true
    length. The slot's whole cache row is written (a previous occupant's K/V
    is overwritten), and its token row becomes ``prompt + first_token``.
    Returns ``(caches, tokens, first_token)``, the token a 0-d tensor."""
    _ds.refuse_latent(params, "lm_prefill_slot")
    dev = params["emb"].device
    prompt = _ints(prompt, dev)
    P = prompt.shape[0]
    if P + 1 > max_len:
        raise ValueError(f"bucket prompt width {P} leaves no room for a "
                         f"generated token within max_len {max_len}")
    slot, length = int(slot), int(length)
    cd = _cdtype(compute_dtype, params)
    x, row_caches = _prefill_hidden(params, prompt, heads, max_len, cd, moe)
    # causal attention: positions < length never see the pad tail, so the
    # hidden state at length - 1 is the unpadded prompt's last position
    logits = _head_logits(x[length - 1:length], params["emb"])
    first = _pick_token_row(
        np.float32([temperature]), np.float32([1.0 if top_p is None else top_p]),
        np.int64([0 if top_k is None else top_k]), logits,
        _row_keys([seed], [0], dev))[0]
    for name, kv in caches.items():
        for slab, row in zip(kv, row_caches[name]):
            slab[slot].copy_(row)
    tokens[slot].zero_()
    tokens[slot, :P] = prompt
    tokens[slot, length] = first
    return caches, tokens, first


@_inference
def lm_decode_rows(params, caches, tokens, positions, steps_done, seeds,
                   temperature, top_p, top_k, heads: int, max_len: int,
                   compute_dtype=None, moe=None):
    """One decode step for every slot of a slab.

    ``caches``/``tokens`` are updated IN PLACE and returned. Per-row vectors
    (rows,): ``positions`` each row's last written position (free slots pass
    0: a harmless dummy step inside their own row), ``steps_done`` the
    emitted-token count feeding the row's sampling stream, ``seeds``,
    ``temperature``, ``top_p``, ``top_k`` the sampling knobs (0 temperature
    = greedy; pass numpy to keep the greedy check on the host). Writes each
    row's next token at ``positions + 1`` and returns ``(caches, tokens,
    next_tokens)``."""
    _ds.refuse_latent(params, "lm_decode_rows")
    dev = params["emb"].device
    B = tokens.shape[0]
    rows = torch.arange(B, device=dev)
    cd = _cdtype(compute_dtype, params)
    # a free slot (position 0) writes inside its own row, never past it
    pos = torch.clamp(_ints(positions, dev), max=max_len - 2)
    x = params["emb"][tokens[rows, pos]].to(cd)
    logits, caches = _decode_step(params, x, caches, pos, heads, moe)
    nxt = _pick_token_row(temperature, top_p, top_k, logits,
                          _row_keys(seeds, steps_done, dev))
    tokens[rows, pos + 1] = nxt.to(tokens.dtype)
    return caches, tokens, nxt


# ------------------------------------------------------------ paged serving
# The KV pool is one page slab (num_pages, page_len, kv_heads, dh) per layer,
# shared by every bucket; a row's cache is a host-side block table of page
# ids covering positions [0, W*page_len). Page 0 is the dummy: table entries
# past a row's allocation, and whole tables of free or prefilling rows, point
# at it, so out-of-extent reads are masked and out-of-extent writes land where
# nothing valid lives. serving/kvpool.py owns the host side.


def init_kv_pages(params, num_pages: int, page_len: int, heads: int,
                  compute_dtype=None):
    """Zeroed page slab on the params' device: layer -> (k, v), each
    (num_pages, page_len, kv_heads, dh) in the compute dtype."""
    _ds.refuse_latent(params, "init_kv_pages")
    if num_pages < 2:
        raise ValueError(f"num_pages must be >= 2 (page 0 is the dummy), "
                         f"got {num_pages}")
    if page_len < 1:
        raise ValueError(f"page_len must be >= 1, got {page_len}")
    d = params["emb"].shape[1]
    dh = d // heads
    kvh = params["l0"]["wk"].shape[1] // dh
    dt = _cdtype(compute_dtype, params)
    dev = params["emb"].device
    return {f"l{i}": tuple(torch.zeros((num_pages, page_len, kvh, dh),
                                       dtype=dt, device=dev)
                           for _ in range(2))
            for i in range(_n_layers(params))}


@_inference
def lm_prefill_paged(params, pages, table, chunk, chunk_start, length,
                     heads: int, page_len: int, seed=0, temperature=0.0,
                     top_p=None, top_k=None, compute_dtype=None, moe=None):
    """One chunk of a paged prefill.

    ``pages`` is the slab (updated in place and returned); ``table`` this
    row's block table (W_t,) of page ids in position order (dummy 0 past the
    allocation); ``chunk`` (C,) prompt tokens from absolute position
    ``chunk_start`` (zero-padded past the prompt). Contract: ``C`` and
    ``chunk_start`` are multiples of ``page_len`` and the chunk's pages lie
    inside the table. The chunk attends causally over the row's earlier
    pages (its own earlier chunks, or a shared prefix) and itself, then
    writes exactly the ``C/page_len`` pages it covers — never a shared page
    before ``chunk_start``. Returns ``(pages, first)``, ``first`` the sampled
    token after position ``length - 1`` (meaningful on the final chunk)."""
    _ds.refuse_latent(params, "lm_prefill_paged")
    dev = params["emb"].device
    table = _page_ids(table, pages, dev)
    chunk = _ints(chunk, dev)
    chunk_start, length = int(chunk_start), int(length)
    C = chunk.shape[0]
    if C % page_len:
        raise ValueError(f"chunk width {C} must be a multiple of "
                         f"page_len {page_len}")
    if chunk_start % page_len:
        raise ValueError(f"chunk_start {chunk_start} must be a multiple of "
                         f"page_len {page_len}")
    cp = C // page_len
    s_page = chunk_start // page_len
    Wt = table.shape[0]
    if s_page + cp > Wt:
        raise ValueError(f"chunk pages [{s_page}, {s_page + cp}) exceed the "
                         f"table's {Wt}")
    L = Wt * page_len
    cd = _cdtype(compute_dtype, params)
    d = params["emb"].shape[1]
    dh = d // heads
    scale = 1.0 / math.sqrt(dh)
    x = params["emb"][chunk].to(cd)
    cols = torch.arange(C, device=dev)
    live = (torch.arange(L, device=dev)[None, None, :]
            <= (chunk_start + cols)[None, :, None])
    own = table[s_page:s_page + cp]
    for i in range(_n_layers(params)):
        lp = _layer(params, i)
        pk, pv = pages[f"l{i}"]
        kvh = lp["wk"].shape[1] // dh
        h = _rmsnorm(x, lp["ln1"])
        q = (h @ lp["wq"].to(cd)).reshape(C, heads, dh)
        k = (h @ lp["wk"].to(cd)).reshape(C, kvh, dh)
        v = (h @ lp["wv"].to(cd)).reshape(C, kvh, dh)
        # the row's context by block table, with the chunk spliced in at its
        # absolute position; positions past the causal frontier are masked
        kk = pk[table].reshape(L, kvh, dh)
        vv = pv[table].reshape(L, kvh, dh)
        kk[chunk_start:chunk_start + C] = k.to(kk.dtype)
        vv[chunk_start:chunk_start + C] = v.to(vv.dtype)
        if kvh != heads:
            kk, vv = (t.repeat_interleave(heads // kvh, dim=1) for t in (kk, vv))
        s = _f32_einsum("phd,thd->hpt", q, kk) * scale
        s = torch.where(live, s, _MASKED)
        o = torch.einsum("hpt,thd->phd", torch.softmax(s, dim=-1).to(cd),
                         vv.to(cd))
        x = x + o.reshape(C, d) @ lp["wo"].to(cd)
        x = x + _ffn(_rmsnorm(x, lp["ln2"]), lp, cd, moe)[0]
        # the chunk's own pages, exactly the cp table slots it covers
        pk[own] = k.to(pk.dtype).reshape(cp, page_len, kvh, dh)
        pv[own] = v.to(pv.dtype).reshape(cp, page_len, kvh, dh)
    xf = _rmsnorm(x, params["ln_f"])
    idx = min(max(length - 1 - chunk_start, 0), C - 1)
    logits = _head_logits(xf[idx:idx + 1], params["emb"])
    first = _pick_token_row(
        np.float32([temperature]), np.float32([1.0 if top_p is None else top_p]),
        np.int64([0 if top_k is None else top_k]), logits,
        _row_keys([seed], [0], dev))
    return pages, first[0]


def resolve_decode_kernel(kernel: str = "auto", device=None) -> str:
    """A decode-attention backend setting as a concrete backend. ``'auto'`` is
    ``'pallas'`` (the CUDA kernel) when ``device`` (default: the configured
    one) is a CUDA device and ``'gather'`` on the CPU, where the kernel's
    plain version loops page by page; the JAX package's ``'auto'`` likewise
    picks its kernel on a TPU and ``'gather'`` elsewhere."""
    if kernel == "auto":
        dev = torch.device(device if device is not None
                           else get_config().device)
        kernel = "pallas" if dev.type == "cuda" else "gather"
    if kernel not in ("pallas", "gather"):
        raise ValueError(f"decode kernel must be 'auto', 'pallas' or "
                         f"'gather', got {kernel!r}")
    return kernel


def _scatter_kv_entries(pk, pv, k_new, v_new, pids, off):
    """Write row b's new K/V entry to ``(pids[b], off[b])`` of the slab, in
    place. Dummy rows all target page 0 offset 0; which of them lands last is
    irrelevant, nothing valid reads page 0."""
    pk[pids, off] = k_new
    pv[pids, off] = v_new
    return pk, pv


def _decode_paged_pallas(params, pages, tables, pos, x, heads: int,
                         page_len: int, moe=None):
    """The kernel decode body: batched projections, the new K/V entry written
    to the slab FIRST (the kernel's length-masked read then covers it, as
    :func:`_decode_step` updates its cache before attending), then one
    :func:`~marlin_tpu_torch.ops.paged_attention.paged_decode_attention`
    call per layer over the slab in place. Returns f32 logits."""
    B = tables.shape[0]
    rows = torch.arange(B, device=x.device)
    cd = x.dtype
    d = x.shape[-1]
    dh = d // heads
    pids = tables[rows, pos // page_len]
    off = pos % page_len
    lengths = (pos + 1).to(torch.int32)  # the just-written entry is live
    tables32 = tables.to(torch.int32)
    for i in range(_n_layers(params)):
        lp = _layer(params, i)
        pk, pv = pages[f"l{i}"]
        kvh = pk.shape[2]
        h = _rmsnorm(x, lp["ln1"])
        q = (h @ lp["wq"].to(cd)).reshape(B, kvh, heads // kvh, dh)
        k = (h @ lp["wk"].to(cd)).reshape(B, kvh, dh)
        v = (h @ lp["wv"].to(cd)).reshape(B, kvh, dh)
        _scatter_kv_entries(pk, pv, k.to(pk.dtype), v.to(pv.dtype), pids, off)
        o = paged_decode_attention(q.to(pk.dtype), pk, pv, tables32, lengths)
        x = x + o.to(cd).reshape(B, d) @ lp["wo"].to(cd)
        x = x + _decode_ffn(_rmsnorm(x, lp["ln2"]), lp, cd, moe)
    return _head_logits(_rmsnorm(x, params["ln_f"]), params["emb"])


@_inference
def lm_decode_paged(params, pages, tables, positions, cur_tokens,
                    steps_done, seeds, temperature, top_p, top_k,
                    heads: int, page_len: int, compute_dtype=None,
                    moe=None, kernel: str = "auto"):
    """One decode step for every row of a bucket over the paged pool.

    ``pages`` is the slab (updated in place and returned); ``tables`` (B, W)
    block tables, all-dummy (zero) for free or prefilling rows, which compute
    a harmless step against page 0; ``positions`` each row's last written
    position, ``cur_tokens`` its last emitted token; ``steps_done``,
    ``seeds``, ``temperature``, ``top_p``, ``top_k`` the per-row sampling
    vectors (0 temperature = greedy; pass them as numpy to keep the
    greedy/sampled check on the host).

    ``kernel`` selects the attention backend (``'auto'`` through
    :func:`resolve_decode_kernel`):
    ``'gather'`` gathers each row's context by block table and runs the same
    :func:`_decode_step` math as ``lm_generate``, then writes back the one
    entry each row produced; ``'pallas'`` runs the CUDA kernel over the slab
    in place (the plain version on the CPU). Greedy streams agree (logits to
    float reassociation). Returns ``(pages, next_tokens)``."""
    _ds.refuse_latent(params, "lm_decode_paged")
    dev = params["emb"].device
    kernel = resolve_decode_kernel(kernel, dev)
    tables = _page_ids(tables, pages, dev)
    B, W = tables.shape
    L = W * page_len
    rows = torch.arange(B, device=dev)
    cd = _cdtype(compute_dtype, params)
    pos = torch.clamp(_ints(positions, dev), max=L - 1)
    x = params["emb"][_ints(cur_tokens, dev)].to(cd)
    if kernel == "pallas":
        logits = _decode_paged_pallas(params, pages, tables, pos, x, heads,
                                      page_len, moe)
    else:
        ctx = {name: tuple(t[tables].reshape(B, L, *t.shape[2:]) for t in kv)
               for name, kv in pages.items()}
        logits, ctx = _decode_step(params, x, ctx, pos, heads, moe)
        pids = tables[rows, pos // page_len]
        off = pos % page_len
        for name, (pk, pv) in pages.items():
            ck, cv = ctx[name]
            _scatter_kv_entries(pk, pv, ck[rows, pos], cv[rows, pos], pids,
                                off)
    nxt = _pick_token_row(temperature, top_p, top_k, logits,
                          _row_keys(seeds, steps_done, dev))
    return pages, nxt


@torch.no_grad()
def kv_page_copy(pages, src: int, dst: int):
    """Copy page ``src`` onto page ``dst`` across every layer's K and V, in
    place — the device half of copy-on-write prefix sharing."""
    src, dst = int(src), int(dst)
    for kv in pages.values():
        for t in kv:
            t[dst].copy_(t[src])
    return pages


# ---------------------------------------------------------------- training
# One long token stream per step (the context-parallel regime). Parameters
# stay in the params dict; gradients come from torch.autograd, through the
# flash kernels' autograd function. In a world of one (or on a mesh whose
# axes all have size 1) ring and Ulysses attention run their home panel over
# the whole stream. On a mesh over ranks the stream is sharded: each rank
# holds its block of the (padded) sequence from the embedding to the loss
# (:class:`_SeqShards`), attention runs on the blocks
# (``ring_attention_shard``, ``ulysses_attention_shard``), the MoE layers
# send each expert's batch to the rank that owns it, and each rank's loss
# covers its own rows.


_ATTN_BACKENDS = {"ring": "auto", "ring_flash": "flash", "ring_xla": "xla"}
# the mesh axis the training stream is sharded over
_SEQ_AXIS = ROWS


@dataclasses.dataclass(frozen=True)
class _SeqShards:
    """The training stream over a rank mesh: ``seq`` positions padded to
    ``padded`` (the attention's block rule, :func:`_seq_shards`) and cut
    into ``mesh.shape[axis]`` blocks of ``rows``; this rank holds the one
    from ``start``, of which the first ``n_valid`` rows are positions before
    ``seq``."""

    mesh: object
    axis: str
    seq: int
    padded: int
    rows: int
    start: int

    @property
    def n_valid(self) -> int:
        return max(0, min(self.rows, self.seq - self.start))


def _seq_shards(mesh, seq: int, attn: str, head_dim: int,
                device) -> _SeqShards:
    """The layout of a ``seq``-position stream over ``mesh``'s sequence
    axis, padded once to the rule of ``attn``: Ulysses' slab rule, or ring
    attention's panel rule for the backend ``attn`` resolves to."""
    p = mesh.shape[_SEQ_AXIS]
    if attn == "ulysses":
        padded = ulysses_padded_len(seq, p)
    else:
        flash = resolve_attention_backend(_ATTN_BACKENDS[attn], device,
                                          head_dim) == "flash"
        padded = ring_padded_len(seq, p, flash)
    rows = padded // p
    return _SeqShards(mesh, _SEQ_AXIS, seq, padded, rows,
                      mesh.index(_SEQ_AXIS) * rows)


def _train_mesh(mesh):
    """``mesh``, else the default mesh inside a process group (else None,
    the world of one)."""
    if mesh is None and distributed():
        return default_mesh()
    return mesh


def _block(lp, x, heads: int, mesh, attn: str, precision: str,
           mlp_chunk: int | None = None, moe=None, shards=None):
    """One pre-norm block over the (seq, d) stream — or over this rank's
    rows of it, ``shards`` — attention through ring (``attn`` names its
    backend) or Ulysses attention over (heads, seq, dh) views of the
    projections, then the FFN — the layer's MoE (:func:`~.moe.moe_ffn`,
    routing knobs from ``moe``) or the dense one. Returns ``(x, aux)``,
    ``aux`` the MoE load-balance term (an exact f32 zero for a dense
    layer)."""
    seq, d = x.shape
    dh = d // heads
    cd = x.dtype  # activations carry the compute dtype; params stay f32
    h = _rmsnorm(x, lp["ln1"])

    def split_heads(w):
        nh = w.shape[1] // dh  # kv_heads < heads under GQA
        return (h @ w.to(cd)).reshape(seq, nh, dh).transpose(0, 1)

    q, k, v = split_heads(lp["wq"]), split_heads(lp["wk"]), split_heads(lp["wv"])
    if k.shape[0] != heads:
        # GQA: each group of query heads attends to its shared K/V head; the
        # gradient of the repeat sums over the group
        group = heads // k.shape[0]
        k, v = (t.repeat_interleave(group, dim=0) for t in (k, v))
    if shards is not None:
        if attn in _ATTN_BACKENDS:
            o = ring_attention_shard(q, k, v, shards.mesh, shards.seq,
                                     shards.axis, causal=True,
                                     backend=_ATTN_BACKENDS[attn],
                                     precision=precision)
        else:
            o = ulysses_attention_shard(q, k, v, shards.mesh, shards.seq,
                                        shards.axis, causal=True,
                                        precision=precision)
    elif attn in _ATTN_BACKENDS:
        o = ring_attention(q, k, v, mesh, causal=True, precision=precision,
                           backend=_ATTN_BACKENDS[attn])
    else:
        o = ulysses_attention(q, k, v, mesh, causal=True, precision=precision)
    x = x + o.transpose(0, 1).reshape(seq, d).to(cd) @ lp["wo"].to(cd)
    out, aux = _ffn(_rmsnorm(x, lp["ln2"]), lp, cd, moe, mesh=mesh,
                    precision=precision, chunk=mlp_chunk, shards=shards)
    return x + out, aux


class _ResidualOffload:
    """Saved-tensor hooks that park the block input a remat checkpoint saves
    in host memory: the JAX package's ``_OFFLOAD_POLICY``, which offloads
    only the residual it names ``marlin_resid``. The pack hook copies that
    one tensor (matched by storage and shape) into pinned host memory with
    ``non_blocking=True`` and leaves every other saved tensor where it is;
    the unpack hook brings it back to its device when the backward recomputes
    the block. Bytes move, no arithmetic changes, so the loss and gradients
    equal the plain remat run's bit for bit. ``moved`` counts the tensors
    the pack hook has copied to the host. The hooks keep the residual's
    address and shape only: autograd keeps them as long as the saved
    tensor, and a reference would pin the residual on the device."""

    moved = 0

    def __init__(self, resid: torch.Tensor):
        self.key = (resid.data_ptr(), resid.shape)

    def pack(self, t):
        if (t.data_ptr(), t.shape) != self.key:
            return t
        host = torch.empty(t.shape, dtype=t.dtype, device="cpu",
                           pin_memory=t.device.type == "cuda")
        host.copy_(t, non_blocking=True)
        _ResidualOffload.moved += 1
        return (t.device, host)

    @staticmethod
    def unpack(packed):
        if isinstance(packed, tuple):
            dev, host = packed
            return host.to(dev, non_blocking=True)
        return packed


def _remat_block(blk, lp, x, offload: bool):
    """``blk(lp, x)`` recomputed in the backward, keeping only ``x`` —
    parked on the host with ``offload``."""
    if not offload:
        return checkpoint(blk, lp, x, use_reentrant=False)
    hooks = _ResidualOffload(x)
    with torch.autograd.graph.saved_tensors_hooks(hooks.pack, hooks.unpack):
        return checkpoint(blk, lp, x, use_reentrant=False)


def _trunk(params, tokens, mesh, heads, attn, remat, precision,
           compute_dtype=None, mlp_chunk=None, offload_residuals=False,
           moe=None, shards=None, arch=None):
    """Final-norm hidden states (seq, d_model) and the summed MoE aux: the
    forward minus the LM head. ``remat`` recomputes each block in the
    backward (``torch.utils.checkpoint``), keeping only the block inputs;
    ``offload_residuals`` (needs ``remat``) keeps those in pinned host
    memory (:class:`_ResidualOffload`). ``mesh`` None is the default mesh.
    With ``shards`` (a rank mesh) ``tokens`` are the whole stream's ids and
    the result is this rank's ``(shards.rows, d_model)`` block (the pad past
    ``seq`` embeds token 0 and is masked downstream) and its share of the
    aux. ``arch`` (a :class:`~.deepseek.DeepSeekConfig`) runs DeepSeek-V2's
    blocks (:func:`~.deepseek.deepseek_block`: MLA through the ring
    backend ``attn`` names, in a world of one, and the SiLU or DeepSeekMoE
    FFN); ``heads``, ``mlp_chunk`` and ``moe`` are then not read."""
    if attn not in (*_ATTN_BACKENDS, "ulysses"):
        raise ValueError(f"unknown attention strategy: {attn!r}")
    if arch is not None:
        if shards is not None:
            _ds.refuse_latent(params, "a mesh over ranks")
        if attn not in _ATTN_BACKENDS:
            raise ValueError(f"latent attention runs the ring backends "
                             f"{sorted(_ATTN_BACKENDS)}, not {attn!r}")
    if offload_residuals:
        if not remat:
            raise ValueError("offload_residuals requires remat=True (without "
                             "remat there are no residual checkpoints to "
                             "offload)")
        trees = [params[f"l{i}"] for i in range(_n_layers(params))]
        if any(set(t) != set(trees[0]) for t in trees[1:]):
            raise ValueError(
                "offload_residuals stacks the layers into one scan, which "
                "needs uniform layer structure — moe_every > 1 mixes MoE "
                "and dense FFN layers; use moe_every=1 or drop the offload")
    ids = _ints(tokens, params["emb"].device)
    if shards is not None:  # embed this rank's block of the padded stream
        ids = F.pad(ids, (0, shards.padded - ids.shape[0]))
        ids = ids[shards.start:shards.start + shards.rows]
    x = params["emb"][ids]
    if compute_dtype is not None:
        x = x.to(_cdtype(compute_dtype, params))
    if arch is None:
        blk = functools.partial(_block, heads=heads, mesh=mesh, attn=attn,
                                precision=precision, mlp_chunk=mlp_chunk,
                                moe=moe, shards=shards)
    else:
        cos, sin = _ds.rope_tables(arch, x.shape[0], x.device)
        blk = functools.partial(_ds.deepseek_block, cfg=arch, cos=cos,
                                sin=sin, backend=_ATTN_BACKENDS[attn],
                                precision=precision)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(_n_layers(params)):
        lp = _layer(params, i)
        x, a = (_remat_block(blk, lp, x, offload_residuals) if remat
                else blk(lp, x))
        aux = aux + a
    eps = 1e-6 if arch is None else arch.rms_norm_eps
    return _rmsnorm(x, params["ln_f"], eps), aux


def _shards_for(params, tokens, mesh, heads, attn):
    """The stream's layout over ``mesh`` when it lies over ranks, else None
    (``tokens`` the positions the trunk runs over)."""
    if not over_ranks(mesh, (_SEQ_AXIS,)):
        return None
    d = params["emb"].shape[1]
    return _seq_shards(mesh, len(tokens), attn, d // heads,
                       params["emb"].device)


def _lm_head(params):
    """The LM head's ``(vocab, d)`` weight: ``head`` where the model has
    one (untied, as DeepSeek-V2's), else the tied embedding."""
    return params["head"] if "head" in params else params["emb"]


def transformer_forward(params: dict, tokens, mesh=None, heads: int = 4,
                        attn: str = "ring", remat: bool = False,
                        precision: str = "high", compute_dtype=None,
                        mlp_chunk: int | None = None,
                        offload_residuals: bool = False, moe=None,
                        arch=None):
    """f32 logits (seq, vocab) for next-token prediction over ``tokens``
    (seq,). ``attn``: ``"ring"`` (backend picked by
    :func:`~marlin_tpu_torch.parallel.ring_attention.resolve_attention_backend`),
    ``"ring_flash"`` / ``"ring_xla"`` (pinned), or ``"ulysses"``. ``moe``:
    the MoE layers' ``(top_k, capacity_factor, group)``; ``arch``: a
    :class:`~.deepseek.DeepSeekConfig` for a DeepSeek-V2 model. On a rank
    mesh the trunk runs on each rank's block of the stream and the logits
    are gathered whole on every rank."""
    mesh = _train_mesh(mesh)
    shards = _shards_for(params, tokens, mesh, heads, attn)
    with precision_scope("highest"):
        x, _ = _trunk(params, tokens, mesh, heads, attn, remat, precision,
                      compute_dtype, mlp_chunk, offload_residuals, moe,
                      shards, arch)
        logits = _head_logits(x, _lm_head(params))
        if shards is None:
            return logits
        logits = col.Gather.apply(logits, shards.mesh, shards.axis, 0)
        return logits[:shards.seq]


def _chunked_nll(x, emb, targets, chunk: int, weight=None):
    """Summed next-token NLL over ``chunk``-token slices of the LM head, each
    recomputed in the backward, so the (seq, vocab) logits are never held
    whole; the remainder is projected after the full chunks. ``weight``
    (seq,) scales each position's term (0 masks it)."""

    def nll_sum(xc, tc, wc=None):
        logp = torch.log_softmax(_head_logits(xc, emb), dim=-1)
        nll = -torch.gather(logp, 1, tc[:, None])[:, 0]
        return (nll if wc is None else nll * wc).sum()

    seq = x.shape[0]
    n_full = seq // chunk
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(n_full):
        s = slice(i * chunk, (i + 1) * chunk)
        w = () if weight is None else (weight[s],)
        total = total + checkpoint(nll_sum, x[s], targets[s], *w,
                                   use_reentrant=False)
    if seq % chunk:
        s = slice(n_full * chunk, seq)
        total = total + nll_sum(x[s], targets[s],
                                *(() if weight is None else (weight[s],)))
    return total


def lm_loss(params, tokens, mesh=None, heads: int = 4, attn: str = "ring",
            remat: bool = False, precision: str = "high",
            loss_chunk: int | None = None, compute_dtype=None,
            mlp_chunk: int | None = None, offload_residuals: bool = False,
            moe=None, moe_aux_weight: float = 1e-2, arch=None):
    """Mean next-token cross-entropy over the stream, an f32 scalar tensor
    with its autograd graph. ``loss_chunk`` runs the LM head over that many
    tokens at a time (:func:`_chunked_nll`); ``compute_dtype`` runs the
    activations in that dtype (the loss stays f32). For MoE models
    ``moe_aux_weight`` times the summed Switch load-balance term joins the
    loss (``moe`` carries the routing knobs); a dense model's term is an
    exact zero, as in the JAX package. ``arch`` (a
    :class:`~.deepseek.DeepSeekConfig`) trains a DeepSeek-V2 model: the
    head is its untied ``head``, and ``moe_aux_weight`` scales its MoE
    layers' sequence-wise balance terms (``aux_loss_alpha``).

    On a mesh over ranks each rank runs its block of the stream and the NLL
    of its own rows; the value is their sum over the sequence axis (the
    loss of the whole stream, on every rank), and autograd gives each rank
    its own rows' share of the gradients (:func:`lm_value_and_grad` sums
    them)."""
    if loss_chunk is not None and loss_chunk < 1:
        raise ValueError(f"loss_chunk must be >= 1 or None, got {loss_chunk}")
    emb = _lm_head(params)
    tokens = _ints(tokens, emb.device)
    tgt = tokens[1:]
    mesh = _train_mesh(mesh)
    shards = _shards_for(params, tgt, mesh, heads, attn)
    with precision_scope("highest"):
        x, aux = _trunk(params, tokens[:-1], mesh, heads, attn, remat,
                        precision, compute_dtype, mlp_chunk,
                        offload_residuals, moe, shards, arch)
        if shards is not None:
            return _shard_loss(x, aux, emb, tgt, shards, loss_chunk,
                               moe_aux_weight)
        if loss_chunk is None:
            logp = torch.log_softmax(_head_logits(x, emb), dim=-1)
            nll = -torch.gather(logp, 1, tgt[:, None]).mean()
        else:
            nll = _chunked_nll(x, emb, tgt, loss_chunk) / tgt.shape[0]
        return nll + moe_aux_weight * aux


def _shard_loss(x, aux, emb, tgt, shards: _SeqShards, loss_chunk,
                moe_aux_weight):
    """The loss from this rank's block: the NLL of its rows (the pad rows
    weighted 0, so every rank's backward runs through the whole trunk and
    its collectives) over ``seq``, plus its aux share, summed over the
    sequence axis (:class:`~marlin_tpu_torch.parallel.collectives.AllReduce`:
    the backward leaves each rank its own share)."""
    tgt = F.pad(tgt, (0, shards.padded - tgt.shape[0]))
    tgt = tgt[shards.start:shards.start + shards.rows]
    live = (torch.arange(shards.rows, device=x.device)
            < shards.n_valid).to(torch.float32)
    if loss_chunk is None:
        logp = torch.log_softmax(_head_logits(x, emb), dim=-1)
        nll = -(torch.gather(logp, 1, tgt[:, None])[:, 0] * live).sum()
    else:
        nll = _chunked_nll(x, emb, tgt, loss_chunk, live)
    share = nll / shards.seq + moe_aux_weight * aux
    return col.AllReduce.apply(share, shards.mesh, shards.axis)


class AdamState(NamedTuple):
    """Adam's state, laid out as ``optax.scale_by_adam``'s: the step
    ``count`` (a host int) and the first and second moments ``mu``/``nu``,
    each a params-shaped dict of f32 tensors."""

    count: int
    mu: dict
    nu: dict


_ADAM_B1, _ADAM_B2, _ADAM_EPS = 0.9, 0.999, 1e-8  # optax.adam's defaults


def adam_init(params: dict) -> AdamState:
    """Zero moments for ``params`` — ``optax.adam(lr).init(params)``."""
    zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)  # noqa: E731
    return AdamState(0, _tree_map(zeros, params), _tree_map(zeros, params))


@torch.no_grad()
def _adam_update(params, grads, state: AdamState, lr: float):
    """One ``optax.adam(lr)`` step, optax's formula term by term:
    ``mu = (1-b1)·g + b1·mu``, ``nu = (1-b2)·g² + b2·nu``, bias corrections
    ``1 - b^count`` in f32, ``update = mu_hat / (sqrt(nu_hat) + eps)``,
    ``param + (-lr)·update``."""
    count = state.count + 1
    bc1 = float(1 - np.float32(_ADAM_B1) ** np.float32(count))
    bc2 = float(1 - np.float32(_ADAM_B2) ** np.float32(count))
    mu = _tree_map(lambda g, m: (1 - _ADAM_B1) * g + _ADAM_B1 * m,
                   grads, state.mu)
    nu = _tree_map(lambda g, n: (1 - _ADAM_B2) * (g * g) + _ADAM_B2 * n,
                   grads, state.nu)

    def step(p, m, n):
        u = (m / bc1) / (torch.sqrt(n / bc2) + _ADAM_EPS)
        return (p + (-lr) * u).to(p.dtype)

    return _tree_map(step, params, mu, nu), AdamState(count, mu, nu)


def _expert_leaf(path: tuple) -> bool:
    """Whether the leaf at ``path`` is an expert tensor (``l{i}.moe.w1`` or
    ``w2``): each rank of a mesh holds its own experts' rows of it."""
    return len(path) == 3 and path[1] == "moe" and path[2] in ("w1", "w2")


def _paths(tree, prefix=()) -> list:
    """The key paths of a params dict's leaves, in :func:`_leaves`'s
    order."""
    if isinstance(tree, dict):
        return [p for k in tree for p in _paths(tree[k], (*prefix, k))]
    return [prefix]


def lm_value_and_grad(params, tokens, *args, **kwargs):
    """:func:`lm_loss` (same arguments) and its gradient by autograd — what
    ``jax.value_and_grad(lm_loss)`` gives. Returns ``(loss, grads)``: the
    loss a 0-d tensor on the device, ``grads`` params-shaped. Forward and
    backward run with TF32 off. On a rank mesh each rank's gradient of a
    replicated leaf covers its own rows, so they are summed over the
    sequence axis in one flat all-reduce (in the leaves' order, the same on
    every rank); the expert tensors' gradients are each rank's own."""
    mesh = inspect.signature(lm_loss).bind(params, tokens, *args,
                                           **kwargs).arguments.get("mesh")
    mesh = _train_mesh(mesh)
    leaves = _tree_map(lambda p: p.detach().requires_grad_(True), params)
    with precision_scope("highest"):
        loss = lm_loss(leaves, tokens, *args, **kwargs)
        grads = list(torch.autograd.grad(loss, _leaves(leaves)))
    if over_ranks(mesh, (_SEQ_AXIS,)):
        shared = [i for i, path in enumerate(_paths(leaves))
                  if not _expert_leaf(path)]
        summed = col.all_reduce_leaves([grads[i] for i in shared], mesh,
                                       _SEQ_AXIS)
        for i, g in zip(shared, summed):
            grads[i] = g
    it = iter(grads)
    return loss.detach(), _tree_map(lambda _: next(it), leaves)


def lm_train_step(params, opt_state: AdamState, tokens, mesh, heads: int,
                  attn: str, remat: bool, precision: str, lr: float,
                  loss_chunk: int | None = None, compute_dtype=None,
                  mlp_chunk: int | None = None,
                  offload_residuals: bool = False, moe=None,
                  moe_aux_weight=1e-2, arch=None):
    """One Adam step on the stream ``tokens``: :func:`lm_value_and_grad`,
    then the update. Returns ``(params, opt_state, loss)`` — new params and
    state (the inputs are left as they were) and the loss as a 0-d tensor on
    the device. The step is the span ``lm.step``, its update ``lm.adam``."""
    with obs_trace.span("lm.step"):
        loss, grads = lm_value_and_grad(
            params, tokens, mesh, heads, attn, remat, precision, loss_chunk,
            compute_dtype, mlp_chunk, offload_residuals, moe, moe_aux_weight,
            arch)
        with obs_trace.span("lm.adam"):
            params, opt_state = _adam_update(params, grads, opt_state, lr)
        return params, opt_state, loss


@dataclasses.dataclass
class TransformerLM:
    """Trainer and serving facade in the style of the JAX package's
    ``TransformerLM``: ``init_params``, ``train``, ``generate``,
    ``generate_batch``."""

    vocab: int = 256
    d_model: int = 64
    heads: int = 4
    layers: int = 2
    d_ff: int | None = None
    learning_rate: float = 3e-3
    seed: int = 0
    attn: str = "ring"  # "ring" | "ring_flash" | "ring_xla" | "ulysses"
    remat: bool = False
    precision: str = "high"  # "default" = bf16 operands in attention
    loss_chunk: int | None = None  # the LM head over chunks of tokens
    # activations and KV caches in this dtype (e.g. "bfloat16"); params f32
    compute_dtype: str | None = None
    # the FFN over chunks of tokens: caps the (seq, d_ff) GELU intermediate
    mlp_chunk: int | None = None
    # remat checkpoints' block inputs in pinned host memory (needs remat)
    offload_residuals: bool = False
    # grouped-query attention: heads // kv_heads query heads per K/V head
    kv_heads: int | None = None
    # mixture-of-experts FFN (models/moe.py): n_experts switches every
    # moe_every-th layer's FFN to that many experts; top_k, capacity and
    # group are the routing knobs, aux_weight scales the load-balance term
    n_experts: int | None = None
    moe_every: int = 1
    moe_top_k: int = _MOE_DEFAULTS[0]
    moe_capacity_factor: float = _MOE_DEFAULTS[1]
    moe_group: int = _MOE_DEFAULTS[2]
    moe_aux_weight: float = 1e-2
    # a DeepSeek-V2 model (models/deepseek.py: MLA and DeepSeekMoE) in
    # place of the toy blocks; build with TransformerLM.deepseek
    arch: _ds.DeepSeekConfig | None = None

    @classmethod
    def deepseek(cls, arch: _ds.DeepSeekConfig, **kwargs) -> "TransformerLM":
        """A trainer of the DeepSeek-V2 model ``arch``, its sizes taken
        from the config; ``kwargs`` set the trainer's other fields
        (``moe_aux_weight`` is the config's ``aux_loss_alpha``)."""
        return cls(vocab=arch.vocab, d_model=arch.d_model, heads=arch.heads,
                   layers=arch.layers, arch=arch, **kwargs)

    def _moe(self) -> tuple | None:
        if self.n_experts is None:
            return None
        return (self.moe_top_k, self.moe_capacity_factor, self.moe_group)

    def init_params(self, dtype=torch.float32, device=None) -> dict:
        if self.arch is not None:
            return _ds.init_deepseek(self.seed, self.arch, dtype, device)
        return init_transformer(self.seed, self.vocab, self.d_model,
                                self.heads, self.layers, self.d_ff, dtype,
                                self.kv_heads, self.n_experts, self.moe_every,
                                device=device)

    def train_step(self, params, opt_state: AdamState, tokens, mesh=None):
        """One :func:`lm_train_step` with this trainer's settings; returns
        ``(params, opt_state, loss)``."""
        return lm_train_step(
            params, opt_state, tokens, mesh, self.heads, self.attn,
            self.remat, self.precision, self.learning_rate, self.loss_chunk,
            self.compute_dtype, self.mlp_chunk, self.offload_residuals,
            self._moe(), self.moe_aux_weight, self.arch)

    def train(self, tokens, steps: int = 20, mesh=None, params=None,
              checkpoint_dir: str | None = None, checkpoint_every: int = 0,
              log_every: int = 0, resume: bool = False):
        """Train on one long token stream with Adam at ``learning_rate``
        (:func:`lm_train_step`); returns ``(params, losses)``. Params start
        from ``init_params()`` on the configured device unless given; the
        tokens go to the params' device.

        On a mesh over ranks (``mesh``, or the default one inside a process
        group) the stream is sharded over the ranks of its sequence axis
        (:func:`lm_loss`), and a MoE model's experts over the same axis
        (:func:`~.moe.shard_moe_params`: each rank keeps its experts and
        their Adam moments). The caller passes the whole params and gets
        the whole params back, the same on every rank; the experts are
        gathered before every checkpoint and at the end.

        With ``checkpoint_dir`` and ``checkpoint_every``, ``{"params",
        "opt_state"}`` is saved as generation ``it + 1`` after every
        ``checkpoint_every``-th step (:func:`~marlin_tpu_torch.io.checkpoint.
        save_checkpoint`, the JAX package's layout). ``resume=True`` (the
        port's addition: the JAX trainer only saves) first restores the
        newest generation there that verifies, falling back past corrupt
        ones, and runs the steps after it; ``losses`` then holds those
        steps' losses alone."""
        from .moe import _gather_moe_params, shard_moe_params

        mesh = _train_mesh(mesh)
        params = params if params is not None else self.init_params()
        tokens = _ints(tokens, params["emb"].device)
        experts = self.n_experts is not None

        def logical(tree):  # the whole experts again, on every rank
            return _gather_moe_params(tree, mesh) if experts else tree

        def local(tree):  # this rank's experts
            return shard_moe_params(tree, mesh) if experts else tree

        opt_state = adam_init(params)
        start = 0
        if checkpoint_dir and resume:
            from ..utils.failure import restore_latest

            state, start = restore_latest(
                {"params": params, "opt_state": opt_state}, checkpoint_dir,
                who="TransformerLM.train")
            if state is not None:
                params, opt_state = state["params"], state["opt_state"]
        params = local(params)
        opt_state = opt_state._replace(mu=local(opt_state.mu),
                                       nu=local(opt_state.nu))
        losses = []
        for it in range(start, steps):
            params, opt_state, loss = self.train_step(params, opt_state,
                                                      tokens, mesh)
            losses.append(float(loss))
            if log_every and (it + 1) % log_every == 0:
                print(f"step {it + 1}: loss {losses[-1]:.4f}")
            if checkpoint_dir and checkpoint_every and \
                    (it + 1) % checkpoint_every == 0:
                from ..io.checkpoint import save_checkpoint

                state = {"params": logical(params),
                         "opt_state": opt_state._replace(
                             mu=logical(opt_state.mu),
                             nu=logical(opt_state.nu))}
                # every rank holds the same state: the mesh's first rank
                # writes it, every rank reads it on resume
                if not over_ranks(mesh) or col.mesh_index(mesh) == 0:
                    save_checkpoint(state, checkpoint_dir, it + 1)
        return logical(params), losses

    def generate(self, params, prompt, steps: int = 32,
                 max_len: int | None = None, temperature=0.0, top_p=None,
                 top_k: int | None = None, seed: int | None = None):
        """Sample ``steps`` tokens continuing ``prompt`` (:func:`lm_generate`,
        key ``key(seed)``, default the model's seed)."""
        if max_len is None:
            max_len = len(prompt) + steps
        return lm_generate(params, prompt, self.seed if seed is None else seed,
                           heads=self.heads, max_len=max_len, steps=steps,
                           temperature=temperature, top_p=top_p, top_k=top_k,
                           compute_dtype=self.compute_dtype, moe=self._moe())

    def generate_batch(self, params, prompts, steps: int = 32,
                       max_len: int | None = None, temperature=0.0,
                       top_p=None, top_k: int | None = None,
                       seed: int | None = None):
        """Batched decode over a list of ragged prompts: pads them to a
        common length, runs :func:`lm_generate_batch`, returns a list of 1-D
        numpy arrays, each ``prompt + steps`` tokens."""
        lengths = np.array([len(p) for p in prompts], np.int32)
        P = int(lengths.max())
        padded = np.zeros((len(prompts), P), np.int32)
        for i, p in enumerate(prompts):
            padded[i, :len(p)] = np.asarray(p)
        if max_len is None:
            max_len = P + steps
        out = lm_generate_batch(params, padded, lengths,
                                self.seed if seed is None else seed,
                                heads=self.heads, max_len=max_len,
                                steps=steps, temperature=temperature,
                                top_p=top_p, top_k=top_k,
                                compute_dtype=self.compute_dtype,
                                moe=self._moe())
        out = out.cpu().numpy()
        return [out[i, :lengths[i] + steps] for i in range(len(prompts))]
