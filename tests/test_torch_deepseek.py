"""DeepSeek-V2 (latent attention, DeepSeekMoE) on the port's trainer against
the plain float32 reference (``models/deepseek_v2_reference.py``) on seeded
random weights, at a tiny size: d 64, 2 heads, q/k 48 (32 + 16 rotary) and v
32, 8 routed experts of which 4 are held, 3 a token, 1 shared, vocabulary
128, one dense and two MoE layers, 64 tokens. Everything runs in float32 on
the CPU (the plain flash panels), so the program and the reference differ
only in the order of their sums: the flash panels' online softmax against
the reference's blocked softmax, the grouped expert products against its
per-expert masks. Over three layers that is a few f32 ulps of the largest
entry (the worst seen: 1.3e-6 of it), so each comparison allows 1e-4 of the
largest entry of the reference, well under the 1e-2 a lost term costs.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import pytest
import torch

from marlin_tpu_torch.models import deepseek as ds
from marlin_tpu_torch.models import deepseek_v2_reference as ref
from marlin_tpu_torch.models import moe as moe_mod
from marlin_tpu_torch.models import transformer as tt
from marlin_tpu_torch.parallel.pipeline import _leaves

REL = 1e-4  # of the reference's largest entry (module docstring)
ALPHA = 0.001  # aux_loss_alpha of DeepSeek-V2-Lite's config


# DeepSeek-V2-Lite's published shape (huggingface.co/deepseek-ai/
# DeepSeek-V2-Lite, config.json)
V2_LITE = dict(vocab=102400, d_model=2048, layers=27, heads=16,
               kv_lora_rank=512, qk_nope_head_dim=128, qk_rope_head_dim=64,
               v_head_dim=128, d_ff=10944, moe_d_ff=1408, n_routed_experts=64,
               n_shared_experts=2, experts_per_token=6,
               first_k_dense_replace=1)


def tiny(**changes) -> ds.DeepSeekConfig:
    base = dict(vocab=128, d_model=64, layers=3, heads=2, kv_lora_rank=32,
                qk_nope_head_dim=32, qk_rope_head_dim=16, v_head_dim=32,
                d_ff=96, moe_d_ff=24, n_routed_experts=8, n_shared_experts=1,
                experts_per_token=3, first_k_dense_replace=1,
                held_experts=(0, 4), init_std=0.1,
                rope_original_max_position=16)
    return ds.DeepSeekConfig(**{**base, **changes})


def params_of(cfg, seed=3):
    return ds.init_deepseek(seed, cfg, device="cpu")


def tokens_of(n=65, vocab=128, seed=1):
    return torch.randint(0, vocab, (n,),
                         generator=torch.Generator().manual_seed(seed))


def assert_close(got, want, rel=REL):
    got, want = got.detach().double(), want.detach().double()
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    assert err <= rel * scale + 1e-12, (err, scale)


def test_config_of_v2_lite():
    cfg = ds.DeepSeekConfig(**V2_LITE)
    assert (cfg.qk_head_dim, cfg.v_head_dim, cfg.held) == (192, 128, (0, 64))
    # mscale(40, 0.707)^2 / sqrt(192)
    m = 0.1 * 0.707 * math.log(40) + 1
    assert cfg.softmax_scale == pytest.approx(m * m / math.sqrt(192))
    assert [cfg.is_moe(i) for i in range(3)] == [False, True, True]
    with pytest.raises(ValueError, match="held_experts"):
        ds.DeepSeekConfig(**V2_LITE, held_experts=(8, 65))


def test_rope_tables_match_reference():
    """YaRN's frequency ramp and mscale, and the interleaved layout, at the
    published settings."""
    cfg = ds.DeepSeekConfig(**V2_LITE)
    cos, sin = ds.rope_tables(cfg, 300)
    rc, rs = ref.rope_tables(dataclasses.asdict(cfg), 300, "cpu")
    assert torch.equal(cos, rc) and torch.equal(sin, rs)
    x = torch.randn(300, 3, 64, generator=torch.Generator().manual_seed(0))
    got = ds.apply_rope(x, cos, sin)
    want = ref.apply_rope(x.transpose(0, 1), rc, rs).transpose(0, 1)
    assert_close(got, want, 1e-6)
    # a rotation: each interleaved pair keeps its length
    assert_close(got.norm(dim=-1), x.norm(dim=-1), 1e-5)


@pytest.mark.parametrize("held", [(0, 4), (0, 8), (3, 8)])
def test_logits_match_reference(held):
    cfg = tiny(held_experts=held)
    p = params_of(cfg)
    tok = tokens_of()[:-1]
    got = tt.transformer_forward(p, tok, arch=cfg)
    want = ref.logits(p, tok, dataclasses.asdict(cfg), block=16)
    assert got.shape == (64, 128)
    assert_close(got, want)


def _grads(cfg, p, tok, remat, loss_chunk):
    loss, g = tt.lm_value_and_grad(p, tok, None, cfg.heads, "ring", remat,
                                   "high", loss_chunk, None, None, False,
                                   None, ALPHA, cfg)
    return loss, dict(zip(tt._paths(g), _leaves(g)))


@pytest.mark.parametrize("remat,loss_chunk", [(True, 16), (False, None)])
def test_loss_and_every_gradient_match_reference(remat, loss_chunk):
    cfg = tiny()
    p = params_of(cfg)
    tok = tokens_of()
    loss, grads = _grads(cfg, p, tok, remat, loss_chunk)
    want_loss, want = ref.loss_and_grads(p, tok, dataclasses.asdict(cfg),
                                         ALPHA, block=16, chunk=16)
    assert float(loss) == pytest.approx(float(want_loss), rel=1e-6)
    assert set(grads) == set(want)
    for path, g in grads.items():
        assert g.shape == want[path].shape, path
        assert_close(g, want[path])
    # every leaf is reached: the held experts, the shared ones, the router
    assert all(float(want[path].abs().max()) > 0 for path in want)


def test_one_adam_step_matches_reference():
    """``TransformerLM.train_step`` (``lm_train_step``: the gradients, then
    ``optax.adam``'s update) against the reference's gradients through the
    same formula written out."""
    cfg = tiny()
    model = tt.TransformerLM.deepseek(cfg, remat=True, loss_chunk=16,
                                      learning_rate=3e-3,
                                      moe_aux_weight=ALPHA)
    p = params_of(cfg)
    tok = tokens_of()
    new, state, loss = model.train_step(p, tt.adam_init(p), tok)
    _, want = ref.loss_and_grads(p, tok, dataclasses.asdict(cfg), ALPHA,
                                 block=16, chunk=16)
    got = dict(zip(tt._paths(new), _leaves(new)))
    mu = dict(zip(tt._paths(state.mu), _leaves(state.mu)))
    nu = dict(zip(tt._paths(state.nu), _leaves(state.nu)))
    old = dict(zip(tt._paths(p), _leaves(p)))
    assert state.count == 1
    for path, g in want.items():
        # the moments against the reference's gradient; the update (at
        # step 1 the bias corrections are 0.1 and 0.001) from them, in f32
        assert_close(mu[path], 0.1 * g)
        assert_close(nu[path], 0.001 * g * g)
        upd = (mu[path] / 0.1) / (torch.sqrt(nu[path] / 0.001) + 1e-8)
        # old + (-lr) u rounds to the parameter's f32 ulp (1.2e-7 at the
        # norms' 1.0), so old - new is held to two ulps of the largest old
        ulp = torch.finfo(torch.float32).eps * float(old[path].abs().max())
        err = float((old[path] - got[path] - 3e-3 * upd).abs().max())
        assert err <= 2 * ulp, (path, err, ulp)


def _layer_input(cfg, n=64, seed=7):
    return torch.randn(n, cfg.d_model,
                       generator=torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("ranges", [[(0, 4), (4, 8)],
                                    [(0, 2), (2, 5), (5, 8)]])
def test_expert_shares_add_up_to_the_whole_layer(ranges):
    """Disjoint held ranges covering every expert: the parts their layers
    give, with the shared expert (every share computes it) counted once,
    add up to the uncut reference's layer."""
    whole = tiny(held_experts=(0, 8))
    mp = params_of(whole)["l1"]["moe"]
    h = _layer_input(whole)
    want, _ = ref.moe(mp, h, dataclasses.asdict(whole))
    shared = ref.mlp(h, mp["shared_gate"], mp["shared_up"],
                     mp["shared_down"])
    total = torch.zeros_like(want)
    for lo, hi in ranges:
        part = dict(mp, w_gate=mp["w_gate"][lo:hi], w_up=mp["w_up"][lo:hi],
                    w_down=mp["w_down"][lo:hi])
        out, _ = moe_mod.deepseek_moe_ffn(part, h, tiny(held_experts=(lo,
                                                                      hi)))
        total = total + out - shared
    assert_close(total + shared, want)


def test_dropless_under_skew():
    """A router biased so that one expert is in every token's top 3 (three
    times its even share, past any capacity a Switch layer would give it):
    every token reaches it, and the layer still equals the reference."""
    cfg = tiny(held_experts=(0, 4))
    mp = params_of(cfg)["l1"]["moe"]
    h = _layer_input(cfg)
    mp = dict(mp, wg=mp["wg"].clone())
    mp["wg"][:, 0] = 0.0
    h = h.clone()
    h[:, 0] = 5.0  # feature 0 lifts expert 0's logit for every token
    mp["wg"][0, 0] = 10.0
    before = moe_mod._moe_metrics()[0].value
    out, aux = moe_mod.deepseek_moe_ffn(mp, h, cfg)
    top = torch.topk(torch.softmax(h @ mp["wg"], -1), 3, -1).indices
    assert bool((top == 0).any(-1).all())  # expert 0 is every token's choice
    held = int(((top >= 0) & (top < 4)).sum())
    assert moe_mod._moe_metrics()[0].value - before == held
    assert moe_mod._moe_metrics()[1].value >= 64 * 4 / held
    want, want_aux = ref.moe(mp, h, dataclasses.asdict(cfg))
    assert_close(out, want)
    assert float(aux) == pytest.approx(float(want_aux), rel=1e-6)


@pytest.mark.parametrize("seed", [7, 8])
def test_aux_loss_matches_reference(seed):
    """The sequence-wise expert-level balance term over all 8 experts,
    whatever range is held."""
    cfg = tiny(held_experts=(2, 6))
    mp = params_of(cfg, seed)["l1"]["moe"]
    h = _layer_input(cfg, seed=seed)
    _, aux = moe_mod.deepseek_moe_ffn(mp, h, cfg)
    _, want = ref.moe(mp, h, dataclasses.asdict(cfg))
    assert float(aux) == pytest.approx(float(want), rel=1e-6)
    # 1.0 when every expert takes its even share at even scores
    assert float(aux) > 0.5


def test_trainer_learns_a_pattern():
    """``TransformerLM.train`` on a repeating stream: the loss falls."""
    cfg = tiny()
    model = tt.TransformerLM.deepseek(cfg, learning_rate=3e-3, remat=True,
                                      moe_aux_weight=ALPHA)
    stream = tt.synthetic_stream(65, vocab=128, period=8, noise=0.0)
    _, losses = model.train(stream, steps=8,
                            params=params_of(cfg))
    assert len(losses) == 8 and losses[-1] < losses[0] - 0.5


def test_latent_model_refuses_serving_and_ranks(monkeypatch):
    cfg = tiny()
    model = tt.TransformerLM.deepseek(cfg)
    p = params_of(cfg)
    with pytest.raises(ValueError, match="latent attention"):
        model.generate(p, [1, 2, 3], steps=2)
    with pytest.raises(ValueError, match="latent attention"):
        model.generate_batch(p, [[1, 2], [3]], steps=2)
    for fn, args in ((tt.lm_generate, (p, [1, 2], 0, 2, 8, 2)),
                     (tt.init_kv_pages, (p, 4, 8, 2)),
                     (tt.init_kv_slab, (p, 2, 8, 2))):
        with pytest.raises(ValueError, match="latent attention"):
            fn(*args)
    with pytest.raises(ValueError, match="ring backends"):
        tt.lm_loss(p, tokens_of(), heads=2, attn="ulysses", arch=cfg)
    # a stream laid over ranks
    monkeypatch.setattr(tt, "_shards_for", lambda *a: object())
    with pytest.raises(ValueError, match="over ranks"):
        tt.lm_loss(p, tokens_of(), heads=2, arch=cfg)


def test_init_checks_the_config():
    cfg = tiny()
    with pytest.raises(ValueError, match="not the config's"):
        tt.init_transformer(0, 64, cfg.d_model, cfg.heads, cfg.layers,
                            device="cpu", arch=cfg)
    p = tt.TransformerLM.deepseek(cfg, seed=5).init_params(device="cpu")
    # the held experts only, the router over all of them, an untied head
    assert p["l1"]["moe"]["w_gate"].shape == (4, 64, 24)
    assert p["l1"]["moe"]["wg"].shape == (64, 8)
    assert "head" in p and "w_gate" in p["l0"] and "moe" not in p["l0"]
    np.testing.assert_allclose(float(p["l0"]["wq"].std()), 0.1, rtol=0.1)
