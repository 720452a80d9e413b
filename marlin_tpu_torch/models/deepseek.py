"""DeepSeek-V2's block on the port's trainer: multi-head latent attention
(MLA) with decoupled YaRN RoPE, and SiLU-gated feed-forward layers, dense
or DeepSeekMoE (:func:`~.moe.deepseek_moe_ffn`).

The equations are ``modeling_deepseek.py``'s (DeepSeek-V2, arXiv:2405.04434),
term by term, at ``q_lora_rank`` None (DeepSeek-V2-Lite's):

- Attention. ``q = h Wq`` split per head into ``q_nope`` (``qk_nope_head_dim``)
  and ``q_pe`` (``qk_rope_head_dim``); ``[c, k_pe] = h Wkv_a``, the latent
  ``c`` (``kv_lora_rank``) RMS-normed and lifted per head to ``[k_nope, v] =
  norm(c) Wkv_b``; one ``k_pe`` is shared by every head. ``q_pe`` and ``k_pe``
  take YaRN RoPE in the interleaved layout (pairs ``(2i, 2i+1)`` gathered
  into halves, then ``x cos + rotate_half(x) sin``); the heads attend
  causally with q/k ``[nope, pe]`` (``dqk`` = 192) and v ``dv`` = 128 wide,
  at the softmax scale ``mscale(factor, mscale_all_dim)² / sqrt(dqk)``,
  through ring attention in a world of one: the flash kernels' (192, 128)
  instances on the card.
- YaRN. Frequencies ``theta^(-2i/d)`` below the correction range (``beta_fast``
  rotations at ``original_max_position_embeddings``) are kept, those above it
  (``beta_slow``) divided by ``factor``, with a linear ramp between;
  ``cos``/``sin`` carry ``mscale(factor, mscale) / mscale(factor,
  mscale_all_dim)`` (1 when the two are equal, as in V2-Lite).
- FFN. ``(silu(h W_gate) * (h W_up)) W_down``: ``intermediate_size`` wide in
  the first ``first_k_dense_replace`` layers, DeepSeekMoE after them.
- The LM head is untied (``params["head"]``, ``(vocab, d)``).

Parameters (``x @ W`` layout, as the rest of the port): ``emb``, ``head``,
``ln_f`` and per layer ``l{i}.{ln1, ln2, wq, wkv_a, kv_norm, wkv_b, wo}`` with
``w_gate``/``w_up``/``w_down`` (dense) or ``moe`` (:func:`~.moe.
init_deepseek_moe`). Precision: activations and product operands in the
compute dtype (bf16 for DeepSeek-V2's mixed precision), master weights f32;
norm statistics, RoPE tables, the router and the softmax statistics f32.

Serving paths (prefill, decode, the engine) take no MLA model: they raise
(:func:`refuse_latent`). Over ranks an MLA model raises too.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from ..config import resolve_device
from ..obs import trace as obs_trace
from . import transformer as _tt

__all__ = ["DeepSeekConfig", "init_deepseek", "refuse_latent",
           "yarn_inv_freq", "rope_tables", "apply_rope", "mla_attention",
           "swiglu"]


@dataclasses.dataclass(frozen=True)
class DeepSeekConfig:
    """A DeepSeek-V2 model as ``TransformerLM`` and ``init_transformer`` take
    it: the published ``config.json`` keys by their meaning.
    ``n_routed_experts`` is the router's width; ``held_experts`` the range
    ``[start, stop)`` of them this process holds (all by default: with fewer,
    an MoE layer computes its own experts' part of the result, as one chip of
    an expert-parallel deployment does). ``moe_layer_freq`` and
    ``first_k_dense_replace`` place the MoE layers as ``modeling_deepseek``
    does."""

    vocab: int
    d_model: int
    layers: int
    heads: int
    kv_lora_rank: int
    qk_nope_head_dim: int
    qk_rope_head_dim: int
    v_head_dim: int
    d_ff: int
    moe_d_ff: int
    n_routed_experts: int
    n_shared_experts: int
    experts_per_token: int
    first_k_dense_replace: int
    held_experts: tuple[int, int] | None = None
    moe_layer_freq: int = 1
    routed_scaling_factor: float = 1.0
    rope_theta: float = 10000.0
    rope_factor: float = 40.0
    rope_original_max_position: int = 4096
    rope_beta_fast: float = 32.0
    rope_beta_slow: float = 1.0
    rope_mscale: float = 0.707
    rope_mscale_all_dim: float = 0.707
    rms_norm_eps: float = 1e-6
    init_std: float = 0.006

    def __post_init__(self):
        e = self.n_routed_experts
        lo, hi = self.held
        if not 0 <= lo <= hi <= e:
            raise ValueError(f"held_experts {self.held_experts} must lie in "
                             f"[0, {e}]")
        if not 1 <= self.experts_per_token <= e:
            raise ValueError(f"experts_per_token ({self.experts_per_token}) "
                             f"must be in [1, {e}]")
        if self.qk_rope_head_dim % 2:
            raise ValueError("qk_rope_head_dim must be even")

    @property
    def held(self) -> tuple[int, int]:
        return self.held_experts or (0, self.n_routed_experts)

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    @property
    def softmax_scale(self) -> float:
        m = yarn_mscale(self.rope_factor, self.rope_mscale_all_dim)
        return m * m / math.sqrt(self.qk_head_dim)

    def is_moe(self, i: int) -> bool:
        return (self.n_routed_experts > 0
                and i >= self.first_k_dense_replace
                and i % self.moe_layer_freq == 0)


def init_deepseek(key, cfg: DeepSeekConfig, dtype=torch.float32,
                  device=None) -> dict:
    """Normal(0, ``cfg.init_std``) matrices (the paper's 0.006) and unit
    norms, drawn from a ``torch.Generator`` seeded with ``key`` on
    ``device``; the held experts only."""
    from .moe import init_deepseek_moe

    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(key))

    def normal(*shape):
        return (torch.randn(shape, generator=gen, device=dev)
                * cfg.init_std).to(dtype)

    def ones(n):
        return torch.ones(n, dtype=dtype, device=dev)

    d, h = cfg.d_model, cfg.heads
    p = {"emb": normal(cfg.vocab, d)}
    for i in range(cfg.layers):
        lp = {"ln1": ones(d), "ln2": ones(d),
              "wq": normal(d, h * cfg.qk_head_dim),
              "wkv_a": normal(d, cfg.kv_lora_rank + cfg.qk_rope_head_dim),
              "kv_norm": ones(cfg.kv_lora_rank),
              "wkv_b": normal(cfg.kv_lora_rank,
                              h * (cfg.qk_nope_head_dim + cfg.v_head_dim)),
              "wo": normal(h * cfg.v_head_dim, d)}
        if cfg.is_moe(i):
            lp["moe"] = init_deepseek_moe(normal, cfg)
        else:
            lp.update(w_gate=normal(d, cfg.d_ff), w_up=normal(d, cfg.d_ff),
                      w_down=normal(cfg.d_ff, d))
        p[f"l{i}"] = lp
    p["head"] = normal(cfg.vocab, d)
    p["ln_f"] = ones(d)
    return p


def refuse_latent(params: dict, what: str) -> None:
    """Raise for an MLA model (its first layer has a latent
    down-projection) on a path that does not take one."""
    lp = params.get("l0")
    if isinstance(lp, dict) and "wkv_a" in lp:
        raise ValueError(
            f"{what}: multi-head latent attention (a DeepSeek-V2 model) runs "
            f"only in training in a world of one; serving paths and a mesh "
            f"over ranks do not take it")


# ------------------------------------------------------------------- RoPE


def yarn_mscale(scale: float, mscale: float) -> float:
    """``yarn_get_mscale``: 1 at ``scale <= 1``, else ``0.1 mscale ln(scale)
    + 1``."""
    return 1.0 if scale <= 1 else 0.1 * mscale * math.log(scale) + 1.0


def _correction_dim(rotations: float, dim: int, base: float,
                    max_pos: int) -> float:
    return (dim * math.log(max_pos / (rotations * 2 * math.pi))) / (
        2 * math.log(base))


def yarn_inv_freq(cfg: DeepSeekConfig, device=None) -> torch.Tensor:
    """The YaRN inverse frequencies ``(qk_rope_head_dim // 2,)`` in f32
    (``DeepseekV2YarnRotaryEmbedding._set_cos_sin_cache``)."""
    dim, base = cfg.qk_rope_head_dim, cfg.rope_theta
    pos = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    extra = 1.0 / base ** pos
    inter = 1.0 / (cfg.rope_factor * base ** pos)
    low = max(math.floor(_correction_dim(
        cfg.rope_beta_fast, dim, base, cfg.rope_original_max_position)), 0)
    high = min(math.ceil(_correction_dim(
        cfg.rope_beta_slow, dim, base, cfg.rope_original_max_position)),
        dim - 1)
    if low == high:
        high += 0.001
    ramp = torch.clamp((torch.arange(dim // 2, dtype=torch.float32,
                                     device=device) - low) / (high - low),
                       0, 1)
    mask = 1.0 - ramp
    return inter * (1 - mask) + extra * mask


def rope_tables(cfg: DeepSeekConfig, seq: int, device=None):
    """``(cos, sin)``, each ``(seq, qk_rope_head_dim)`` f32, for positions
    ``0..seq-1``, scaled by YaRN's attention mscale ratio."""
    inv = yarn_inv_freq(cfg, device)
    t = torch.arange(seq, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv)
    emb = torch.cat((freqs, freqs), dim=-1)
    m = (yarn_mscale(cfg.rope_factor, cfg.rope_mscale)
         / yarn_mscale(cfg.rope_factor, cfg.rope_mscale_all_dim))
    return emb.cos() * m, emb.sin() * m


def apply_rope(x, cos, sin):
    """RoPE on ``x`` (``(seq, ..., d)``; ``cos``/``sin`` ``(seq, d)``) in
    ``modeling_deepseek``'s interleaved layout: each pair ``(2i, 2i+1)`` is
    gathered into the halves ``[evens, odds]``, then ``x cos +
    rotate_half(x) sin``. In f32; returns ``x``'s dtype."""
    shape = x.shape
    xf = x.float().reshape(*shape[:-1], shape[-1] // 2, 2).transpose(-1, -2)
    xf = xf.reshape(shape)
    lead = (slice(None),) + (None,) * (x.dim() - 2)
    c, s = cos[lead], sin[lead]
    half = shape[-1] // 2
    rot = torch.cat((-xf[..., half:], xf[..., :half]), dim=-1)
    return (xf * c + rot * s).to(x.dtype)


# ---------------------------------------------------------------- the block


def swiglu(h, w_gate, w_up, w_down):
    """``(silu(h W_gate) * (h W_up)) W_down``, operands in ``h``'s dtype."""
    cd = h.dtype
    return (F.silu(h @ w_gate.to(cd)) * (h @ w_up.to(cd))) @ w_down.to(cd)


def mla_attention(lp: dict, h, cfg: DeepSeekConfig, cos, sin,
                  backend: str = "auto", precision: str = "high"):
    """Multi-head latent attention over the normed stream ``h`` (seq, d),
    causal, in a world of one (module docstring); returns the output
    projection (seq, d) in ``h``'s dtype."""
    from ..parallel.ring_attention import ring_attention

    seq, cd = h.shape[0], h.dtype
    nh, dn, dr, dv = (cfg.heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
                      cfg.v_head_dim)
    with obs_trace.span("mla.proj"):
        q = (h @ lp["wq"].to(cd)).view(seq, nh, dn + dr)
        c, k_pe = (h @ lp["wkv_a"].to(cd)).split(
            [cfg.kv_lora_rank, dr], dim=-1)
        kv = (_tt._rmsnorm(c, lp["kv_norm"], cfg.rms_norm_eps)
              @ lp["wkv_b"].to(cd)).view(seq, nh, dn + dv)
        k_nope, v = kv.split([dn, dv], dim=-1)
        q = torch.cat((q[..., :dn], apply_rope(q[..., dn:], cos, sin)),
                      dim=-1)
        k_pe = apply_rope(k_pe, cos, sin)[:, None].expand(seq, nh, dr)
        k = torch.cat((k_nope, k_pe), dim=-1)
    with obs_trace.span("mla.attn"):
        o = ring_attention(q.transpose(0, 1), k.transpose(0, 1),
                           v.transpose(0, 1), causal=True,
                           scale=cfg.softmax_scale, backend=backend,
                           precision=precision)
    with obs_trace.span("mla.proj"):
        return o.transpose(0, 1).reshape(seq, nh * dv).to(cd) @ \
            lp["wo"].to(cd)


def deepseek_block(lp: dict, x, cfg: DeepSeekConfig, cos, sin,
                   backend: str = "auto", precision: str = "high"):
    """One pre-norm DeepSeek-V2 decoder layer over the (seq, d) stream:
    MLA, then the dense SiLU FFN or DeepSeekMoE. Returns ``(x, aux)``,
    ``aux`` the MoE balance statistic (an exact f32 zero for a dense
    layer)."""
    from .moe import deepseek_moe_ffn

    eps = cfg.rms_norm_eps
    x = x + mla_attention(lp, _tt._rmsnorm(x, lp["ln1"], eps), cfg, cos,
                          sin, backend, precision)
    h = _tt._rmsnorm(x, lp["ln2"], eps)
    if "moe" in lp:
        out, aux = deepseek_moe_ffn(lp["moe"], h, cfg)
    else:
        out = swiglu(h, lp["w_gate"], lp["w_up"], lp["w_down"])
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x + out, aux
