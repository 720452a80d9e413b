"""The DeepSeek-V2 cell at a size a CPU test run holds: the published
layout at tiny widths, float32 compute (the cell's bf16 limits are set for
the card's size; at f32 a sound run reads near zero). The weights are drawn
at std 0.05: at the configuration's 0.006 and these widths the attention
scores are near 0, so that where a token sits hardly matters, and a dropped
rotation moves the gradients by less than the limits allow."""

from __future__ import annotations

from portbench import harness

CELL = "dsv2_lite.train32k"
CFG = dict(hidden_size=64, num_attention_heads=2, kv_lora_rank=32,
           qk_nope_head_dim=32, qk_rope_head_dim=16, v_head_dim=32,
           intermediate_size=96, moe_intermediate_size=24,
           num_hidden_layers=3, vocab_size=128, num_experts_per_tok=3,
           n_shared_experts=1, n_routed_experts=4, held_experts=[0, 4],
           published={"n_routed_experts": 8, "vocab_size": 1024,
                      "num_hidden_layers": 6})
INIT_STD = 0.05
TRAFFIC = dict(seq=64, loss_chunk=16, check_block=16,
               compute_dtype="float32", precision="high")


def cell(root: str = harness.ROOT):
    c = harness.resolve(CELL, root)
    c.cfg.update(CFG)
    c.cfg["assumed"] = dict(c.cfg["assumed"], init_std=INIT_STD)
    c.traffic.update(TRAFFIC)
    return c
