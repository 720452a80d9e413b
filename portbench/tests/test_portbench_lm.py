"""The DeepSeek-V2 training cell (``dsv2_lite.train32k``): its configuration
against the catalog's, its counts against a hand count, a tiny run on the
CPU that is correct, the faults its check has to catch, its two per-layer
readers on made-up events, and the benchmark's reference against the
program's copy."""

from __future__ import annotations

import dataclasses
import os
from types import SimpleNamespace

import pytest
import torch

from portbench import harness
from portbench.reference import deepseek_v2 as bench_ref
from portbench.tests import _lm_tiny, _tiny, lm_faults

CATALOG = {  # the catalog's DeepSeek-V2-Lite config, numbers at top level
    "first_k_dense_replace": 1, "hidden_size": 2048,
    "intermediate_size": 10944, "kv_lora_rank": 512,
    "max_position_embeddings": 163840, "moe_intermediate_size": 1408,
    "moe_layer_freq": 1, "n_group": 1, "n_routed_experts": 64,
    "n_shared_experts": 2, "num_attention_heads": 16,
    "num_experts_per_tok": 6, "num_hidden_layers": 27,
    "num_key_value_heads": 16, "qk_nope_head_dim": 128,
    "qk_rope_head_dim": 64, "rms_norm_eps": 1e-06, "rope_theta": 10000,
    "routed_scaling_factor": 1, "topk_group": 1, "v_head_dim": 128,
    "vocab_size": 102400}


def _op():
    return harness.load_op(harness.PKG, "lm_train")


def test_the_configuration_is_the_catalogs_cut_as_listed():
    cell = harness.resolve(_lm_tiny.CELL)
    cfg = cell.cfg
    changed = sorted(k for k, v in CATALOG.items() if cfg[k] != v)
    assert changed == sorted(cfg["reduced"])
    assert all(cfg["published"][k] == CATALOG[k] for k in cfg["reduced"])
    assert (cfg["n_routed_experts"], cfg["vocab_size"],
            cfg["num_hidden_layers"]) == (8, 12800, 14)
    assert cfg["held_experts"] == [0, 8]
    assert cfg["rope_scaling"]["factor"] == 40
    assert cell.chips == 1 and cell.traffic["seq"] == 32768
    # 1.439 B parameters held; Adam's state and the step fit the card
    assert _op().n_params(cfg) == pytest.approx(1.4386e9, rel=1e-3)


def test_counts_against_a_hand_count():
    """One layer of each kind at a tiny shape, every product counted by
    hand."""
    c = _lm_tiny.cell()
    cfg, tr = c.cfg, dict(c.traffic, seq=10)
    cfg.update(num_hidden_layers=2)
    d, h, v, r, dn, dr, dv = 64, 2, 128, 32, 32, 16, 32
    proj = 2 * (d * h * (dn + dr) + d * (r + dr) + r * h * (dn + dv)
                + h * dv * d)
    dense = 2 * 3 * d * 96
    # router over 8, one shared of 24, 3 choices of 8 experts, 4 held
    moe = 2 * d * 8 + 2 * 3 * d * 24 + (3 * 4 / 8) * 2 * 3 * d * 24
    head = 2 * d * v
    attn = 2 * (10 * 11 / 2) * h * (dn + dr + dv)
    fwd = 10 * (2 * proj + dense + moe + head) + 2 * attn
    flops, nbytes = _op().counts(cfg, tr)
    assert flops == pytest.approx(3 * fwd, rel=1e-12)
    n = (2 * v * d + d + 2 * (2 * d + d * h * (dn + dr) + d * (r + dr) + r
                             + r * h * (dn + dv) + h * dv * d)
         + 3 * d * 96 + d * 8 + 3 * 4 * d * 24 + 3 * d * 24)
    assert nbytes == 7 * 4 * n
    ops = _op().attn_kernel_ops(cfg, tr)
    pairs = h * 10 * 11 / 2
    assert ops == {"fwd": pairs * 2 * 80, "dkv": pairs * 4 * 80,
                   "dq": pairs * (4 * 48 + 2 * 32)}


def test_tiny_run_is_correct():
    out = _tiny.run(_lm_tiny.cell())
    assert out["correct"], out["compared"]
    assert set(out["compared"]) == {"loss_gap", "grad_proj_gap",
                                    "expert_norm_gap", "update_norm_gap",
                                    "update_dir_gap"}
    assert set(out["metrics"]) == {"gflop_s", "setup_s"}
    assert out["attempted"] >= 1


def test_traced_tiny_run_reads_the_moe_spans():
    out = _tiny.run(_lm_tiny.cell(), trace=True)
    assert out["correct"]
    # a CPU run has no peak and no device events: its window is one idle
    # gap, which may fall inside an MoE span or not
    assert out["metrics"]["moe_idle_share"]["value"] in (0.0, 100.0)
    assert "mla_attn_roofline" not in out["metrics"]


@pytest.mark.parametrize("fault", [
    lm_faults.mla_rope_dropped, lm_faults.mla_latent_norm_dropped,
    lm_faults.moe_shared_dropped, lm_faults.moe_held_expert_skipped,
    lm_faults.lm_grad_scaled, lm_faults.lm_params_unchanged,
    lm_faults.lm_lr_scaled, lm_faults.lm_update_reversed])
def test_fault_makes_the_run_incorrect(fault, monkeypatch):
    fault(monkeypatch.setattr)
    out = _tiny.run(_lm_tiny.cell())
    assert out["correct"] is False
    assert any(c["value"] > c["limit"] for c in out["compared"].values())


def test_the_checks_adam_step_is_the_trainers():
    """The change the check holds the program's against (Adam's first step
    from the reference's gradients) is the trainer's own update, bit for
    bit, on the same gradients."""
    from marlin_tpu_torch.models import transformer as tt

    gen = torch.Generator().manual_seed(3)
    params = {"a": torch.randn(300, generator=gen) * 0.006,
              "b": torch.ones(7)}
    grads = {"a": torch.randn(300, generator=gen) * 1e-5,
             "b": torch.tensor([0.0, 1e-9, -1e-9, 1e-3, -2.0, 5e-8, 3e-7])}
    new, _ = tt._adam_update(params, grads, tt.adam_init(params), 4.2e-4)
    for k in params:
        assert torch.equal(_op().adam_first_step(params[k], grads[k], 4.2e-4),
                           new[k] - params[k])


def _reader(name):
    return harness._module(os.path.join(harness.PKG, "metrics", name + ".py"),
                           "portbench_metric_" + name)


def test_mla_attn_roofline_counts_whole_flash_kernels():
    cell = harness.resolve(_lm_tiny.CELL)
    ops = _op().attn_kernel_ops(cell.cfg, cell.traffic)
    peak = {"flop_s": 989e12}
    fwd = "void flash_fwd::flash_fwd_kernel<__nv_bfloat16, 192, 128, true>"
    dkv = ("void (anonymous namespace)::flash_bwd_kernel<__nv_bfloat16, "
           "192, 128, true, true>(Args)")
    dq = dkv.replace("true, true>", "true, false>")
    dev = [(0.0, 0.5, fwd),            # touches the window's start: out
           (1.0, 1.1, fwd), (1.1, 1.2, dkv), (1.2, 1.3, dq),
           (1.3, 1.4, "ampere_bf16_gemm"),
           (9.9, 10.0, dq)]            # touches its end: out
    run = SimpleNamespace(peak=peak, trace=[{"window_s": 10.0,
                                             "device": dev}])
    want = 100 * (ops["fwd"] + ops["dkv"] + ops["dq"]) / 989e12 / 0.3
    assert _reader("mla_attn_roofline").read(run) == pytest.approx(want)
    run.trace[0]["device"] = dev[4:5]
    assert _reader("mla_attn_roofline").read(run) is None
    assert _reader("mla_attn_roofline").read(
        SimpleNamespace(peak=peak, trace=None)) is None


def test_moe_idle_share_counts_gaps_in_moe_spans():
    dev = [(0.0, 2.0, "k"), (3.0, 6.0, "k"), (6.5, 10.0, "k")]
    host = [(2.4, 2.6, "marlin.moe.dispatch"), (6.0, 6.5, "marlin.mla.attn")]
    run = SimpleNamespace(trace=[{"window_s": 10.0, "device": dev,
                                  "host": host}])
    assert _reader("moe_idle_share").read(run) == pytest.approx(10.0)


def test_the_benchmarks_reference_is_the_programs():
    """The copy under ``portbench/reference`` and the program's
    ``models/deepseek_v2_reference.py`` give the same loss and gradients."""
    from marlin_tpu_torch.models import deepseek as ds
    from marlin_tpu_torch.models import deepseek_v2_reference as prog_ref

    cfg = ds.DeepSeekConfig(
        vocab=64, d_model=32, layers=2, heads=2, kv_lora_rank=16,
        qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16, d_ff=48,
        moe_d_ff=16, n_routed_experts=4, n_shared_experts=1,
        experts_per_token=2, first_k_dense_replace=1, held_experts=(1, 3),
        init_std=0.1)
    p = ds.init_deepseek(0, cfg, device="cpu")
    tok = torch.randint(0, 64, (33,), generator=torch.Generator()
                        .manual_seed(0))
    a = bench_ref.loss_and_grads(p, tok, dataclasses.asdict(cfg), 1e-3, 8, 8)
    b = prog_ref.loss_and_grads(p, tok, dataclasses.asdict(cfg), 1e-3, 8, 8)
    assert torch.equal(a[0], b[0])
    assert all(torch.equal(a[1][k], b[1][k]) for k in a[1])
