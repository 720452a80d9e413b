"""DeepSeek-V2 in plain PyTorch float32: the reference the port's trainer is
held to, the benchmark's copy of ``marlin_tpu_torch/models/
deepseek_v2_reference.py`` (the program's tests hold the port to that one).
It imports no kernel and no module of the port, and follows
``modeling_deepseek.py`` (huggingface.co/deepseek-ai/DeepSeek-V2-Lite) and
the DeepSeek-V2 paper (arXiv:2405.04434) at ``q_lora_rank`` None.

Parameters are a dict in the port's layout (``x @ W``): ``emb`` and
``head`` (vocab, d), ``ln_f``, and per layer ``l{i}`` the norms ``ln1``,
``ln2``, ``wq`` (d, H dqk), ``wkv_a`` (d, r + dr), ``kv_norm`` (r,),
``wkv_b`` (r, H (dn + dv)), ``wo`` (H dv, d), and ``w_gate``, ``w_up``,
``w_down`` (dense) or ``moe``: ``wg`` (d, E), the held experts' ``w_gate``,
``w_up`` (E_held, d, f) and ``w_down`` (E_held, f, d), and the shared experts
as one SiLU FFN ``shared_gate``, ``shared_up``, ``shared_down`` of width
``n_shared_experts f`` (what ``DeepseekV2MLP(intermediate_size=f *
n_shared_experts)`` is). The config is a dict of the port's
``DeepSeekConfig`` field names (``dataclasses.asdict`` of one).

Every product is float32 with TF32 off (the flags are set for the length of
each call and put back). Departures from ``modeling_deepseek.py``, each at
its line:

- the returned loss includes ``aux_loss_alpha`` times the balance terms,
  which ``AddAuxiliaryLoss`` adds to the gradient only: the gradients are
  the same;
- attention runs over blocks of query rows against the keys up to the
  block's end (each block's probabilities rebuilt in the backward), so 32K
  positions fit on a card: the same sums in another order;
- a held range of routed experts: the others' part of the output is left
  out, as one chip of an expert-parallel deployment leaves it to the
  others (the router keeps every expert);
- RoPE is applied in float32 (``modeling_deepseek`` casts its tables to
  the activations' dtype).

``rnd`` rounds every product's operands (the control one precision below
bf16: :func:`fp8_e4m3`).
"""

from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint


def fp8_e4m3(x):
    """``x`` rounded to float8 e4m3 under one per-tensor scale (its largest
    magnitude at e4m3's 448), as fp8 training scales its operands; the
    gradient passes straight through."""
    amax = x.detach().abs().max().clamp(min=1e-30)
    s = amax / 448.0
    q = (x.detach() / s).to(torch.float8_e4m3fn).to(x.dtype) * s
    return x + (q - x).detach()


def _mm(a, b, rnd):
    return a @ b if rnd is None else rnd(a) @ rnd(b)


def rms_norm(x, w, eps):
    """``DeepseekV2RMSNorm``."""
    var = x.pow(2).mean(-1, keepdim=True)
    return w * (x * torch.rsqrt(var + eps))


def _mscale(scale, mscale):
    return 1.0 if scale <= 1 else 0.1 * mscale * math.log(scale) + 1.0


def rope_tables(cfg, seq, device):
    """``DeepseekV2YarnRotaryEmbedding``'s ``cos``/``sin`` caches, (seq,
    qk_rope_head_dim) float32."""
    dim, base = cfg["qk_rope_head_dim"], cfg["rope_theta"]
    factor, orig = cfg["rope_factor"], cfg["rope_original_max_position"]

    def corr(rot):
        return (dim * math.log(orig / (rot * 2 * math.pi))) / (
            2 * math.log(base))

    pos = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    freq_extra = 1.0 / (base ** pos)
    freq_inter = 1.0 / (factor * base ** pos)
    low = max(math.floor(corr(cfg["rope_beta_fast"])), 0)
    high = min(math.ceil(corr(cfg["rope_beta_slow"])), dim - 1)
    if low == high:
        high += 0.001
    ramp = torch.clamp((torch.arange(dim // 2, dtype=torch.float32,
                                     device=device) - low) / (high - low),
                       0, 1)
    inv_freq_mask = 1.0 - ramp
    inv_freq = freq_inter * (1 - inv_freq_mask) + freq_extra * inv_freq_mask
    t = torch.arange(seq, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv_freq)
    m = (_mscale(factor, cfg["rope_mscale"])
         / _mscale(factor, cfg["rope_mscale_all_dim"]))
    emb = torch.cat((freqs, freqs), dim=-1)
    return emb.cos() * m, emb.sin() * m


def rotate_half(x):
    x1, x2 = x[..., :x.shape[-1] // 2], x[..., x.shape[-1] // 2:]
    return torch.cat((-x2, x1), dim=-1)


def apply_rope(x, cos, sin):
    """``apply_rotary_pos_emb`` on ``x`` (heads, seq, d): the interleaved
    pairs gathered into halves, then rotated."""
    h, s, d = x.shape
    x = x.view(h, s, d // 2, 2).transpose(3, 2).reshape(h, s, d)
    return x * cos[None] + rotate_half(x) * sin[None]


def _attend(q, k, v, i0, scale, rnd):
    """Rows ``i0..`` of causal attention: ``q`` (H, b, dqk) against the keys
    ``k``, ``v`` up to the block's end."""
    s = _mm(q, k.transpose(1, 2), rnd) * scale
    qpos = i0 + torch.arange(q.shape[1], device=q.device)
    kpos = torch.arange(k.shape[1], device=q.device)
    s = s.masked_fill(kpos[None, :] > qpos[:, None], float("-inf"))
    p = torch.softmax(s, dim=-1, dtype=torch.float32)
    return _mm(p, v, rnd)


def attention(q, k, v, scale, block, rnd=None):
    """Causal softmax attention over blocks of ``block`` query rows (the
    departure noted above), each block's probabilities rebuilt in the
    backward."""
    outs = []
    for i0 in range(0, q.shape[1], block):
        i1 = min(i0 + block, q.shape[1])
        args = (q[:, i0:i1], k[:, :i1], v[:, :i1], i0, scale, rnd)
        outs.append(checkpoint(_attend, *args, use_reentrant=False)
                    if torch.is_grad_enabled() else _attend(*args))
    return torch.cat(outs, dim=1)


def mla(lp, h, cfg, cos, sin, block, rnd=None):
    """``DeepseekV2Attention.forward`` (``q_lora_rank`` None, no bias)."""
    seq = h.shape[0]
    nh, dn, dr, dv = (cfg["heads"], cfg["qk_nope_head_dim"],
                      cfg["qk_rope_head_dim"], cfg["v_head_dim"])
    r = cfg["kv_lora_rank"]
    q = _mm(h, lp["wq"], rnd).view(seq, nh, dn + dr).transpose(0, 1)
    q_nope, q_pe = torch.split(q, [dn, dr], dim=-1)
    compressed_kv = _mm(h, lp["wkv_a"], rnd)
    compressed_kv, k_pe = torch.split(compressed_kv, [r, dr], dim=-1)
    k_pe = k_pe.view(seq, 1, dr).transpose(0, 1)
    kv = _mm(rms_norm(compressed_kv, lp["kv_norm"], cfg["rms_norm_eps"]),
             lp["wkv_b"], rnd).view(seq, nh, dn + dv).transpose(0, 1)
    k_nope, value_states = torch.split(kv, [dn, dv], dim=-1)
    q_pe, k_pe = apply_rope(q_pe, cos, sin), apply_rope(k_pe, cos, sin)
    query_states = torch.cat((q_nope, q_pe), dim=-1)
    key_states = torch.cat((k_nope, k_pe.expand(nh, seq, dr)), dim=-1)
    m = _mscale(cfg["rope_factor"], cfg["rope_mscale_all_dim"])
    scale = (dn + dr) ** -0.5 * m * m
    out = attention(query_states, key_states, value_states, scale, block, rnd)
    return _mm(out.transpose(0, 1).reshape(seq, nh * dv), lp["wo"], rnd)


def mlp(h, w_gate, w_up, w_down, rnd=None):
    """``DeepseekV2MLP``: down(silu(gate(h)) * up(h))."""
    return _mm(torch.nn.functional.silu(_mm(h, w_gate, rnd))
               * _mm(h, w_up, rnd), w_down, rnd)


def moe(mp, h, cfg, rnd=None):
    """``MoEGate`` (softmax, greedy top-k, no renormalisation, the
    sequence-wise balance term at one sequence) and ``DeepseekV2MoE``'s
    training path over the held experts, plus the shared experts. Returns
    ``(out, aux)``, ``aux`` without ``aux_loss_alpha``."""
    n = h.shape[0]
    e, k = cfg["n_routed_experts"], cfg["experts_per_token"]
    lo, hi = cfg["held_experts"] or (0, e)
    logits = _mm(h, mp["wg"], rnd)  # routing: rounded too in the control
    scores = logits.softmax(dim=-1, dtype=torch.float32)
    topk_weight, topk_idx = torch.topk(scores, k=k, dim=-1, sorted=False)
    topk_weight = topk_weight * cfg["routed_scaling_factor"]
    ce = torch.zeros(e, device=h.device)
    ce.scatter_add_(0, topk_idx.reshape(-1),
                    torch.ones(n * k, device=h.device)).div_(n * k / e)
    aux = (ce * scores.mean(dim=0)).sum()
    x = h.repeat_interleave(k, dim=0)
    flat = topk_idx.reshape(-1)
    y = torch.zeros_like(x)
    for i in range(lo, hi):  # the held experts only (departure above)
        sel = flat == i
        if sel.any():
            j = i - lo
            y[sel] = mlp(x[sel], mp["w_gate"][j], mp["w_up"][j],
                         mp["w_down"][j], rnd)
    y = (y.view(n, k, -1) * topk_weight.unsqueeze(-1)).sum(dim=1)
    if "shared_gate" in mp:
        y = y + mlp(h, mp["shared_gate"], mp["shared_up"],
                    mp["shared_down"], rnd)
    return y, aux


def layer(lp, x, cfg, cos, sin, block, rnd=None):
    """``DeepseekV2DecoderLayer``: pre-norm attention, then the dense MLP or
    the MoE. Returns ``(x, aux)``."""
    eps = cfg["rms_norm_eps"]
    x = x + mla(lp, rms_norm(x, lp["ln1"], eps), cfg, cos, sin, block, rnd)
    h = rms_norm(x, lp["ln2"], eps)
    if "moe" in lp:
        out, aux = moe(lp["moe"], h, cfg, rnd)
    else:
        out = mlp(h, lp["w_gate"], lp["w_up"], lp["w_down"], rnd)
        aux = torch.zeros((), device=x.device)
    return x + out, aux


def hidden(params, tokens, cfg, block=1024, rnd=None):
    """The final-normed hidden states (seq, d) over ``tokens`` and the summed
    balance terms; each layer rebuilt in the backward."""
    x = params["emb"][tokens]
    cos, sin = rope_tables(cfg, tokens.shape[0], x.device)
    aux = torch.zeros((), device=x.device)
    i = 0
    while f"l{i}" in params:
        args = (params[f"l{i}"], x, cfg, cos, sin, block, rnd)
        x, a = (checkpoint(layer, *args, use_reentrant=False)
                if torch.is_grad_enabled() else layer(*args))
        aux = aux + a
        i += 1
    return rms_norm(x, params["ln_f"], cfg["rms_norm_eps"]), aux


def _nll_sum(x, head, tgt, rnd):
    logp = torch.log_softmax(_mm(x, head.t(), rnd), dim=-1)
    return -torch.gather(logp, 1, tgt[:, None]).sum()


def _tf32_off():
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return old


def _tf32_restore(old):
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = old


def logits(params, tokens, cfg, block=1024):
    """float32 logits (seq, vocab) over ``tokens``, without gradients."""
    old = _tf32_off()
    try:
        with torch.no_grad():
            x, _ = hidden(params, tokens, cfg, block)
            return x @ params["head"].t()
    finally:
        _tf32_restore(old)


def loss(params, tokens, cfg, aux_alpha, block=1024, chunk=4096, rnd=None):
    """Mean next-token NLL over ``tokens[1:]`` (the vocabulary the head
    holds) plus ``aux_alpha`` times the summed balance terms, with its
    graph."""
    old = _tf32_off()
    try:
        x, aux = hidden(params, tokens[:-1], cfg, block, rnd)
        tgt = tokens[1:]
        total = torch.zeros((), device=x.device)
        for i0 in range(0, x.shape[0], chunk):
            total = total + checkpoint(_nll_sum, x[i0:i0 + chunk],
                                       params["head"], tgt[i0:i0 + chunk],
                                       rnd, use_reentrant=False)
        return total / tgt.shape[0] + aux_alpha * aux
    finally:
        _tf32_restore(old)


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        return [p for key in tree for p in _leaves(tree[key],
                                                   (*prefix, key))]
    return [(prefix, tree)]


def loss_and_grads(params, tokens, cfg, aux_alpha, block=1024, chunk=4096,
                   rnd=None):
    """:func:`loss` and its gradient by autograd: ``(loss, grads)``,
    ``grads`` a dict of key paths (tuples) to float32 tensors."""
    paths = _leaves(params)
    live = {}
    for path, t in paths:
        node = live
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = t.detach().float().requires_grad_(True)
    value = loss(live, tokens, cfg, aux_alpha, block, chunk, rnd)
    flat = [t for _, t in _leaves(live)]
    old = _tf32_off()
    try:
        grads = torch.autograd.grad(value, flat)
    finally:
        _tf32_restore(old)
    return value.detach(), {path: g for (path, _), g in zip(paths, grads)}
