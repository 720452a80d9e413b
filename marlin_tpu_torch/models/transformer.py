"""The causal transformer LM, serving half: generation and paged decode.

Counterpart of ``marlin_tpu/models/transformer.py`` for what serving runs:
init, the dense and flash prefill, the cached decode step, ``lm_generate`` /
``lm_generate_batch``, and the paged trio ``init_kv_pages`` /
``lm_prefill_paged`` / ``lm_decode_paged`` with ``kv_page_copy``. Names,
parameter layout (``emb``, ``l{i}.{wq,wk,wv,wo,ln1,ln2,w1,w2}``, ``ln_f``) and
contracts are the JAX package's; training (``lm_loss``, ``lm_train_step``,
ring/Ulysses attention), mixture-of-experts layers and the dense-slab
programs (``init_kv_slab``, ``lm_prefill_slot``, ``lm_decode_rows``) are not
ported yet (ROADMAP).

Differences that follow from PyTorch:

- No jit and no buffer donation. Programs run eagerly, and the KV caches and
  the page slab are updated IN PLACE (``index_put_`` / ``copy_``); the
  functions still return them, so callers read as with JAX.
- Two attention kernels are hand-written CUDA (``ops/``): the paged decode
  kernel behind ``lm_decode_paged(kernel="pallas")`` and the flash panel
  behind prompts of ``_PREFILL_FLASH_MIN`` tokens or more. Everything else is
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
import math

import numpy as np
import torch
import torch.nn.functional as F

from .. import threefry
from ..config import get_config, resolve_device
from ..ops import flash_attention as _flash
from ..ops.local import precision_scope
from ..ops.paged_attention import paged_decode_attention

__all__ = ["TransformerLM", "init_transformer", "lm_generate",
           "lm_generate_batch", "init_kv_pages", "lm_prefill_paged",
           "lm_decode_paged", "kv_page_copy", "resolve_decode_kernel",
           "synthetic_stream"]

_MASKED = -1e30
_NO_MOE = ("mixture-of-experts layers (models/moe.py) are not ported yet "
           "(ROADMAP queue 10)")


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
                     moe_every: int = 1, device=None) -> dict:
    """Scaled-normal init with a tied embedding; ``kv_heads`` enables GQA
    (wk/wv project to ``kv_heads·dh``). ``key`` is an int seed of a
    ``torch.Generator`` on ``device``; the draws differ from ``jax.random``'s
    (carry JAX weights over with
    :func:`marlin_tpu_torch.interop.lm_params_from_numpy`)."""
    if n_experts is not None:
        raise NotImplementedError(_NO_MOE)
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
        p[f"l{i}"] = {
            "wq": normal((d_model, d_model), s),
            "wk": normal((d_model, kv_dim), s),
            "wv": normal((d_model, kv_dim), s),
            "wo": normal((d_model, d_model), s),
            "ln1": torch.ones(d_model, dtype=dtype, device=dev),
            "ln2": torch.ones(d_model, dtype=dtype, device=dev),
            "w1": normal((d_model, d_ff), s),
            "w2": normal((d_ff, d_model), 1.0 / math.sqrt(d_ff)),
        }
    p["ln_f"] = torch.ones(d_model, dtype=dtype, device=dev)
    return p


def _n_layers(params: dict) -> int:
    """Layer count from the params dict (the ``l{i}`` naming scheme)."""
    return sum(1 for k in params if k.startswith("l") and k[1:].isdigit())


def _layer(params: dict, i: int) -> dict:
    lp = params[f"l{i}"]
    if "moe" in lp:
        raise NotImplementedError(_NO_MOE)
    return lp


def _rmsnorm(x, g):
    """Statistics in f32 whatever the activation dtype; output in x's."""
    xf = x.float()
    y = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + 1e-6)
    return (y * g).to(x.dtype)


def _gelu(x):
    return F.gelu(x, approximate="tanh")


def _mlp(h, lp, cd):
    return _gelu(h @ lp["w1"].to(cd)) @ lp["w2"].to(cd)


def _f32_einsum(eq: str, a, b):
    """An einsum with f32 results: bf16 operands are widened first, which is
    exact (the products of two bf16 values fit in f32)."""
    return torch.einsum(eq, a.float(), b.float())


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


def _decode_step(params, x, caches, pos, heads: int):
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
        x = x + _mlp(_rmsnorm(x, lp["ln2"]), lp, cd)
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


def _prefill_hidden(params, prompt, heads: int, max_len: int, cdtype):
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
        x = x + _mlp(_rmsnorm(x, lp["ln2"]), lp, cdtype)
    return _rmsnorm(x, params["ln_f"]), caches


def _prefill(params, prompt, heads: int, max_len: int, cdtype):
    """Final-position logits + caches (the single-sequence prefill)."""
    x, caches = _prefill_hidden(params, prompt, heads, max_len, cdtype)
    return _head_logits(x[-1], params["emb"]), caches


# ---------------------------------------------------------------- generate


@_inference
def lm_generate(params, prompt, key, heads: int, max_len: int, steps: int,
                temperature=0.0, compute_dtype=None, top_p=None,
                top_k: int | None = None):
    """KV-cached autoregressive decode: batched prefill of the prompt, then
    ``steps - 1`` decode steps. ``key`` is an int seed or key words
    (``jax.random.key_data``); one split per sampled token, as the JAX
    package draws. ``compute_dtype`` runs the residual stream and the caches
    in that dtype (logits and softmax stay f32). Returns the ``(n_prompt +
    steps,)`` token tensor on the params' device."""
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
    logits0, caches = _prefill(params, prompt, heads, max_len, cd)
    key, sub = threefry.split(key)
    tokens = torch.zeros(max_len, dtype=torch.long, device=dev)
    tokens[:n] = prompt
    tokens[n] = pick(logits0, sub)
    caches = {name: (k[None], v[None]) for name, (k, v) in caches.items()}
    for pos in range(n, n + steps - 1):
        x = params["emb"][tokens[pos:pos + 1]].to(cd)
        logits, caches = _decode_step(params, x, caches, [pos], heads)
        if sample:
            key, sub = threefry.split(key)
        tokens[pos + 1] = pick(logits[0], sub)
    return tokens[:n + steps]


@_inference
def lm_generate_batch(params, prompts, lengths, key, heads: int,
                      max_len: int, steps: int, temperature=0.0,
                      compute_dtype=None, top_p=None,
                      top_k: int | None = None):
    """Batched KV-cached decode of ragged prompts: ``prompts`` (B, P) padded
    to a common P, ``lengths`` (B,) the true lengths; each row continues from
    its own position. Returns (B, max_len) tokens; row b's generation fills
    ``[lengths[b], lengths[b] + steps)``. Sampling knobs as
    :func:`lm_generate` (one key per step for the whole batch)."""
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
                                            cd) for b in range(B)))
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
        logits, caches = _decode_step(params, x, caches, pos, heads)
        if sample:
            key, sub = threefry.split(key)
        tokens[rows, pos + 1] = pick(logits, sub)
    return tokens


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
                     top_p=None, top_k=None, compute_dtype=None):
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
        x = x + _mlp(_rmsnorm(x, lp["ln2"]), lp, cd)
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
                         page_len: int):
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
        x = x + _mlp(_rmsnorm(x, lp["ln2"]), lp, cd)
    return _head_logits(_rmsnorm(x, params["ln_f"]), params["emb"])


@_inference
def lm_decode_paged(params, pages, tables, positions, cur_tokens,
                    steps_done, seeds, temperature, top_p, top_k,
                    heads: int, page_len: int, compute_dtype=None,
                    kernel: str = "auto"):
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
                                      page_len)
    else:
        ctx = {name: tuple(t[tables].reshape(B, L, *t.shape[2:]) for t in kv)
               for name, kv in pages.items()}
        logits, ctx = _decode_step(params, x, ctx, pos, heads)
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


@dataclasses.dataclass
class TransformerLM:
    """Serving facade in the style of the JAX package's ``TransformerLM``:
    ``init_params``, ``generate``, ``generate_batch``. ``train`` waits for
    the training slice."""

    vocab: int = 256
    d_model: int = 64
    heads: int = 4
    layers: int = 2
    d_ff: int | None = None
    learning_rate: float = 3e-3
    seed: int = 0
    # activations and KV caches in this dtype (e.g. "bfloat16"); params f32
    compute_dtype: str | None = None
    # grouped-query attention: heads // kv_heads query heads per K/V head
    kv_heads: int | None = None
    n_experts: int | None = None
    moe_every: int = 1

    def init_params(self, dtype=torch.float32, device=None) -> dict:
        return init_transformer(self.seed, self.vocab, self.d_model,
                                self.heads, self.layers, self.d_ff, dtype,
                                self.kv_heads, self.n_experts, self.moe_every,
                                device=device)

    def train(self, *args, **kwargs):
        raise NotImplementedError(
            "training (lm_loss, lm_train_step, ring/Ulysses attention) is not "
            "ported yet (ROADMAP queue 10)")

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
                           compute_dtype=self.compute_dtype)

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
                                compute_dtype=self.compute_dtype)
        out = out.cpu().numpy()
        return [out[i, :lengths[i] + steps] for i in range(len(prompts))]
