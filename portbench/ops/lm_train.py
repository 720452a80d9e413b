"""One training step of a DeepSeek-V2 model through the port's trainer
(``TransformerLM.train_step`` -> ``lm_train_step`` -> ``lm_loss``): forward,
backward and the Adam update of every parameter held, on one stream of
``seq + 1`` token ids drawn uniform over the vocabulary the card holds (the
trunk runs over ``seq`` positions). Every call starts from the same state,
the seed's weights (normal, the configuration's ``init_std``) and Adam's
moments at step 0, so every call costs what any step costs.

A call's FLOPs are three times the forward's, counted from the shapes:
every projection ``2 m k n`` over the tokens it sees, the routed experts at
the expected ``experts_per_token * held / n_routed_experts`` experts a
token, causal attention ``2 * S (S + 1) / 2 * H * (dqk + dv)``, the head
over the vocabulary slice. Recompute and the update are not counted. Bytes
are Adam's: the parameters, gradients and both moments read and the
parameters and moments written, 4 bytes each.

``keep`` reduces a call's output on the card to the loss and, for every
parameter, a digest of the step's new first moment ``m`` (``0.1 g`` at step
0) and of the parameter's change ``u``: ``|m|``, ``m``'s projection on a
seeded normal vector, ``|u|`` and ``u . m``. ``check`` digests the plain float32
reference's step alike (``reference/deepseek_v2.py``, on the weights and
tokens drawn again from the seed; ``u`` is Adam's first step from its
gradients, :func:`adam_first_step`) and compares, each gap over the
reference's norm and each number the largest over the kept calls:

- ``loss_gap``: the loss's gap over the reference's loss;
- ``grad_proj_gap``: the root mean square over the parameters, the routed
  experts and their router left out, of the moment's projection gap (a gap
  ``e`` projects to about ``|e|``);
- ``expert_norm_gap``: the same of the moment's norm gap over the routed
  experts and their router;
- ``update_norm_gap``: the same of the change's norm gap over every
  parameter (1 where nothing changes, 0.1 at a tenth too large a rate);
- ``update_dir_gap``: the same of the gap of the cosine between ``u`` and
  ``m`` over every parameter (1 where nothing changes, 2 for a step up the
  gradient).

Each but the loss is a mean over the parameters: the largest of some
hundred leaves' gaps swings from seed to seed, and in bf16 it is set by the routed leaves,
whose tokens change where a sixth and a seventh score nearly tie. Not
compared: the largest norm gap over the parameters (bf16 biases the
program's gradient norms by 1-3 %, the control's rounding does not), the
routed leaves' projection gap (set by those routing flips) and the
change's projection (step 0's change is about ``-lr sign(g)``, so it is set
by the signs of the smallest gradients), each of which the control moves
less than three times as far as the program.

The control is the reference with every product's operands rounded to
float8 e4m3.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.inputs import generator
from portbench.reference import deepseek_v2 as ref

TAG_W, TAG_T, TAG_R = 11, 12, 13
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8  # optax.adam's defaults
ROUTED = ("wg", "w_gate", "w_up", "w_down")  # under an MoE layer's "moe"


# ------------------------------------------------------------------ shapes


def arch(cfg) -> dict:
    """The model as the port's ``DeepSeekConfig`` fields (and the
    reference's config dict): the published widths, the router over the
    published number of experts, the held range."""
    rope = cfg["rope_scaling"]
    return dict(
        vocab=cfg["vocab_size"], d_model=cfg["hidden_size"],
        layers=cfg["num_hidden_layers"], heads=cfg["num_attention_heads"],
        kv_lora_rank=cfg["kv_lora_rank"],
        qk_nope_head_dim=cfg["qk_nope_head_dim"],
        qk_rope_head_dim=cfg["qk_rope_head_dim"],
        v_head_dim=cfg["v_head_dim"], d_ff=cfg["intermediate_size"],
        moe_d_ff=cfg["moe_intermediate_size"],
        n_routed_experts=cfg["published"]["n_routed_experts"],
        n_shared_experts=cfg["n_shared_experts"],
        experts_per_token=cfg["num_experts_per_tok"],
        first_k_dense_replace=cfg["first_k_dense_replace"],
        held_experts=tuple(cfg["held_experts"]),
        moe_layer_freq=cfg["moe_layer_freq"],
        routed_scaling_factor=float(cfg["routed_scaling_factor"]),
        rope_theta=float(cfg["rope_theta"]),
        rope_factor=float(rope["factor"]),
        rope_original_max_position=rope["original_max_position_embeddings"],
        rope_beta_fast=float(rope["beta_fast"]),
        rope_beta_slow=float(rope["beta_slow"]),
        rope_mscale=float(rope["mscale"]),
        rope_mscale_all_dim=float(rope["mscale_all_dim"]),
        rms_norm_eps=float(cfg["rms_norm_eps"]),
        init_std=float(cfg["assumed"]["init_std"]))


def _is_moe(a, i) -> bool:
    return (i >= a["first_k_dense_replace"]
            and i % a["moe_layer_freq"] == 0)


def shapes(cfg) -> dict:
    """Every parameter's shape by key path, in the port's layout and
    order."""
    a = arch(cfg)
    d, h, v = a["d_model"], a["heads"], a["vocab"]
    r, dn, dr, dv = (a["kv_lora_rank"], a["qk_nope_head_dim"],
                     a["qk_rope_head_dim"], a["v_head_dim"])
    lo, hi = a["held_experts"]
    f, fs = a["moe_d_ff"], a["n_shared_experts"] * a["moe_d_ff"]
    out = {("emb",): (v, d)}
    for i in range(a["layers"]):
        lp = {"ln1": (d,), "ln2": (d,), "wq": (d, h * (dn + dr)),
              "wkv_a": (d, r + dr), "kv_norm": (r,),
              "wkv_b": (r, h * (dn + dv)), "wo": (h * dv, d)}
        for key, shape in lp.items():
            out[(f"l{i}", key)] = shape
        if _is_moe(a, i):
            moe = {"wg": (d, a["n_routed_experts"]),
                   "w_gate": (hi - lo, d, f), "w_up": (hi - lo, d, f),
                   "w_down": (hi - lo, f, d)}
            if fs:
                moe.update(shared_gate=(d, fs), shared_up=(d, fs),
                           shared_down=(fs, d))
            for key, shape in moe.items():
                out[(f"l{i}", "moe", key)] = shape
        else:
            for key, shape in (("w_gate", (d, a["d_ff"])),
                               ("w_up", (d, a["d_ff"])),
                               ("w_down", (a["d_ff"], d))):
                out[(f"l{i}", key)] = shape
    out[("head",)] = (v, d)
    out[("ln_f",)] = (d,)
    return out


def n_params(cfg) -> int:
    return sum(math.prod(s) for s in shapes(cfg).values())


def forward_flops(cfg, seq: int) -> float:
    """FLOPs of one forward over ``seq`` positions (module docstring)."""
    a = arch(cfg)
    d, h, v = a["d_model"], a["heads"], a["vocab"]
    r, dn, dr, dv = (a["kv_lora_rank"], a["qk_nope_head_dim"],
                     a["qk_rope_head_dim"], a["v_head_dim"])
    lo, hi = a["held_experts"]
    e, k, f = a["n_routed_experts"], a["experts_per_token"], a["moe_d_ff"]
    proj = 2 * (d * h * (dn + dr) + d * (r + dr) + r * h * (dn + dv)
                + h * dv * d)
    per_token = 2 * d * v  # the head
    for i in range(a["layers"]):
        per_token += proj
        if _is_moe(a, i):
            per_token += (2 * d * e + 6 * d * a["n_shared_experts"] * f
                          + k * (hi - lo) / e * 6 * d * f)
        else:
            per_token += 6 * d * a["d_ff"]
    attn = a["layers"] * attn_pairs(seq, h) * 2 * (dn + dr + dv)
    return seq * per_token + attn


def attn_pairs(seq: int, heads: int) -> float:
    """Live (query, key) pairs of causal attention over ``seq`` positions,
    all heads."""
    return heads * seq * (seq + 1) / 2


def attn_kernel_ops(cfg, traffic) -> dict:
    """What each flash kernel must do in one launch over a layer's heads
    (every live pair, the backward's rebuilt scores included): the forward
    ``2 (dqk + dv)``, dK/dV ``4 (dqk + dv)`` and dQ ``4 dqk + 2 dv`` FLOPs a
    pair."""
    a = arch(cfg)
    dqk, dv = a["qk_nope_head_dim"] + a["qk_rope_head_dim"], a["v_head_dim"]
    pairs = attn_pairs(traffic["seq"], a["heads"])
    return {"fwd": pairs * 2 * (dqk + dv), "dkv": pairs * 4 * (dqk + dv),
            "dq": pairs * (4 * dqk + 2 * dv)}


def counts(cfg, traffic) -> tuple[float, float]:
    """(FLOPs, bytes) of one call."""
    return (3.0 * forward_flops(cfg, traffic["seq"]),
            7.0 * 4.0 * n_params(cfg))


# ------------------------------------------------------------------ inputs


def draw_params(seed: int, cfg, device) -> dict:
    """The weights in the port's layout: each matrix normal with the
    configuration's ``init_std`` from its own generator, the norms ones;
    float32."""
    std = float(cfg["assumed"]["init_std"])
    params: dict = {}
    for i, (path, shape) in enumerate(shapes(cfg).items()):
        if path[-1] in ("ln1", "ln2", "kv_norm", "ln_f"):
            t = torch.ones(shape, dtype=torch.float32, device=device)
        else:
            t = torch.randn(shape, generator=generator(seed, TAG_W, i, device),
                            dtype=torch.float32, device=device).mul_(std)
        node = params
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = t
    return params


def draw_tokens(seed: int, cfg, traffic, device) -> torch.Tensor:
    return torch.randint(0, cfg["vocab_size"], (traffic["seq"] + 1,),
                         generator=generator(seed, TAG_T, 0, device),
                         device=device)


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        return [p for key in tree for p in _leaves(tree[key],
                                                   (*prefix, key))]
    return [(prefix, tree)]


def adam_first_step(p, g, lr: float):
    """The change Adam's first step makes to ``p`` from the gradient ``g``:
    optax's formula at count 1 with its defaults, in float32 as the
    trainer computes it, ``p - lr m_hat / (sqrt(v_hat) + eps) - p`` with
    ``m = (1 - b1) g`` and ``v = (1 - b2) g^2`` and the bias corrections
    ``1 - b`` rounded to float32."""
    bc1 = float(1 - np.float32(ADAM_B1))
    bc2 = float(1 - np.float32(ADAM_B2))
    u = (((1 - ADAM_B1) * g) / bc1) / (
        torch.sqrt(((1 - ADAM_B2) * (g * g)) / bc2) + ADAM_EPS)
    return (p + (-lr) * u) - p


def digest(seed: int, rows) -> torch.Tensor:
    """(leaves, 4) on the host from each leaf's (new first moment m, change
    of the parameter u), in the leaves' order of :func:`shapes`: |m|,
    m . r, |u| and u . m, with r a normal vector drawn from (seed, leaf
    index); summed in float32 on the card, one copy to the host."""
    out = []
    for i, (m, u) in enumerate(rows):
        m, u = m.float().reshape(-1), u.float().reshape(-1)
        r = torch.randn(m.shape, generator=generator(seed, TAG_R, i, m.device),
                        dtype=torch.float32, device=m.device)
        out.append(torch.stack([torch.linalg.vector_norm(m), torch.dot(m, r),
                                torch.linalg.vector_norm(u), torch.dot(u, m)]))
        del r
    return torch.stack(out).double().cpu()


def _rel(gap, scale):
    """gap / scale, where scale is 0: 0 for no gap and inf for one; NaN
    reads inf."""
    with np.errstate(divide="ignore", invalid="ignore"):
        rel = np.where(scale > 0, gap / scale, np.where(gap > 0, np.inf, 0.0))
    return np.where(np.isnan(rel), np.inf, rel)


def leaf_gaps(k, w) -> dict:
    """Per leaf, a kept digest ``k`` against the reference's ``w``
    (:func:`digest`'s columns): the first moment's norm and projection gap
    over the reference's norm (a gap ``e`` projects to about ``|e|``), the
    change's norm gap over the reference change's norm, and the gap of the
    cosine between change and moment over the reference's (0 for a leaf
    that does not change)."""
    def cos(d):
        return np.where(d[:, 0] * d[:, 2] > 0,
                        d[:, 3] / np.maximum(d[:, 0] * d[:, 2], 1e-300), 0.0)

    return {"grad_norm": _rel(np.abs(k[:, 0] - w[:, 0]), w[:, 0]),
            "grad_proj": _rel(np.abs(k[:, 1] - w[:, 1]), w[:, 0]),
            "update_norm": _rel(np.abs(k[:, 2] - w[:, 2]), w[:, 2]),
            "update_dir": _rel(np.abs(cos(k) - cos(w)), np.abs(cos(w)))}


# -------------------------------------------------------------------- case


class Case:
    def __init__(self, ctx, cfg, traffic):
        from marlin_tpu_torch.models import (DeepSeekConfig, TransformerLM,
                                             adam_init)

        if ctx.world != 1:
            raise ValueError("the lm_train traffic runs in a world of one")
        self.ctx, self.cfg, self.traffic = ctx, cfg, traffic
        self.flops, self.bytes = counts(cfg, traffic)
        self.order = list(shapes(cfg))
        self.lr = float(cfg["assumed"]["learning_rate"])
        self.model = TransformerLM.deepseek(
            DeepSeekConfig(**arch(cfg)), attn=traffic["attn"],
            remat=traffic["remat"], precision=traffic["precision"],
            loss_chunk=traffic["loss_chunk"],
            compute_dtype=traffic["compute_dtype"], learning_rate=self.lr,
            moe_aux_weight=float(cfg["assumed"]["aux_loss_alpha"]))
        self.params = draw_params(ctx.seed, cfg, ctx.device)
        self.opt = adam_init(self.params)
        self.tokens = draw_tokens(ctx.seed, cfg, traffic, ctx.device)

    def call(self):
        return self.model.train_step(self.params, self.opt, self.tokens)

    def keep(self, out):
        new, opt, loss = out
        mu, new, old = dict(_leaves(opt.mu)), dict(_leaves(new)), dict(
            _leaves(self.params))
        return {"loss": float(loss), "digest": digest(
            self.ctx.seed, ((mu[p], new[p] - old[p]) for p in self.order))
            .numpy()}

    def reference(self, params, rnd=None) -> dict:
        """The reference's step from ``params`` kept alike: its loss, its
        first moment ``(1 - b1) g`` and Adam's first change of every
        parameter from its gradients; ``rnd`` rounds its products'
        operands."""
        loss, grads = ref.loss_and_grads(
            params, self.tokens, arch(self.cfg),
            float(self.cfg["assumed"]["aux_loss_alpha"]),
            block=self.traffic["check_block"],
            chunk=self.traffic["loss_chunk"], rnd=rnd)
        by_path = dict(_leaves(params))
        rows = ((((1 - ADAM_B1) * grads[p]),
                 adam_first_step(by_path[p], grads[p], self.lr))
                for p in self.order)
        return {"loss": float(loss),
                "digest": digest(self.ctx.seed, rows).numpy()}

    def control(self):
        """The reference with every product's operands rounded to float8
        e4m3 (one precision below the configuration's bf16), kept alike."""
        return self.reference(self.params, rnd=ref.fp8_e4m3)

    def release(self):
        del self.model, self.params, self.opt

    def routed(self) -> np.ndarray:
        """Which leaves are the routed experts' and their router's."""
        return np.array([len(p) == 3 and p[1] == "moe" and p[2] in ROUTED
                         for p in self.order])

    def check(self, kept) -> dict:
        want = self.reference(draw_params(self.ctx.seed, self.cfg,
                                          self.ctx.device))
        return numbers(kept, want, self.routed())


def _rms(x) -> float:
    """The root mean square of ``x`` (0 when empty)."""
    return float(np.sqrt(np.mean(np.square(x)))) if x.size else 0.0


def numbers(kept, want, routed) -> dict:
    """Every number of the check, each ``[gap, scale]``, the largest over
    the kept calls (module docstring)."""
    w = want["digest"]
    reduce = {  # number: (leaf_gaps column, leaves)
        "grad_proj_gap": ("grad_proj", ~routed),
        "expert_norm_gap": ("grad_norm", routed),
        "update_norm_gap": ("update_norm", slice(None)),
        "update_dir_gap": ("update_dir", slice(None))}
    out = {"loss_gap": [0.0, abs(want["loss"])]}
    out.update({n: [0.0, 1.0] for n in reduce})
    for k in kept:
        if k["digest"].shape != w.shape:
            return {n: [float("inf"), 1.0] for n in out}
        gap = abs(k["loss"] - want["loss"])
        out["loss_gap"][0] = max(out["loss_gap"][0],
                                 gap if math.isfinite(gap) else math.inf)
        per_leaf = leaf_gaps(k["digest"], w)
        for name, (col, rows) in reduce.items():
            out[name][0] = max(out[name][0], _rms(per_leaf[col][rows]))
    return out
