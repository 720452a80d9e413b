#!/usr/bin/env python3
"""Per-parameter readings behind the DeepSeek-V2 cell's check
(``dsv2_lite.train32k``), at the cell's size on one card:

    python3 tools/dsv2_check_readings.py --seeds 1 2 3 --control-seeds 1 \\
        --f32-seeds 1 --fault-seeds 1 --out dsv2_readings.jsonl

For each seed the plain float32 reference's step is digested once
(``portbench/ops/lm_train.py:digest``: the loss, and per parameter the new
first moment's norm and projection, the change's norm and its product with
the moment), with the experts it routes each token to in every MoE layer.
Then one call of the program is digested under each variant:

- ``program``: the timed path as the cell runs it (bf16 compute);
- ``frozen``: the same, every MoE layer routing each token to the
  reference's experts (the scores are still the program's own);
- ``f32``: the program in float32 compute with TF32 off;
- ``control``: the reference with every product's operands in float8 e4m3;
- each planted fault of ``portbench/tests/lm_faults.py``.

Writes one JSON line a reading (``seed``, ``variant``, ``loss``,
``digest``: a row a parameter, in ``paths``' order; the reference's are
``variant`` ``reference``), and prints each reading's numbers of the check.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from types import SimpleNamespace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

FAULTS = ("lm_params_unchanged", "lm_lr_scaled", "lm_update_reversed",
          "lm_grad_scaled", "mla_rope_dropped", "mla_latent_norm_dropped",
          "moe_shared_dropped", "moe_held_expert_skipped")


class Patches:
    """``setattr`` that remembers what it replaced; :meth:`undo` puts it
    back."""

    def __init__(self):
        self.old = []

    def setattr(self, obj, name, value):
        self.old.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    def undo(self):
        while self.old:
            obj, name, value = self.old.pop()
            setattr(obj, name, value)


def _key(torch, wg):
    """A router's identity across the program and the reference: its first
    entries, rounded to bf16."""
    return tuple(wg.detach().reshape(-1)[:4].to(torch.bfloat16).float()
                 .tolist())


def record_routes(torch, ref, patches, routes):
    """Has the reference record each MoE layer's chosen experts in
    ``routes`` (router key -> (tokens, k) indices)."""
    orig = ref.moe

    def moe(mp, h, cfg, rnd=None):
        if rnd is None:
            with torch.no_grad():
                scores = (h.detach() @ mp["wg"].detach()).softmax(
                    dim=-1, dtype=torch.float32)
                routes[_key(torch, mp["wg"])] = torch.topk(
                    scores, k=cfg["experts_per_token"], dim=-1).indices
        return orig(mp, h, cfg, rnd)

    patches.setattr(ref, "moe", moe)


def freeze_routes(torch, patches, routes):
    """Has the program's MoE layers take the experts in ``routes``."""
    from marlin_tpu_torch.models import moe as pm

    orig, now = pm.deepseek_moe_ffn, [None]

    def ffn(mp, h, cfg):
        now[0] = routes[_key(torch, mp["wg"])]
        return orig(mp, h, cfg)

    class Torch:
        def __getattr__(self, name):
            return getattr(torch, name)

        @staticmethod
        def topk(scores, k, dim=-1):
            return scores.gather(-1, now[0]), now[0]

    patches.setattr(pm, "deepseek_moe_ffn", ffn)
    patches.setattr(pm, "torch", Torch())


def main(argv) -> int:
    ap = argparse.ArgumentParser(prog="tools/dsv2_check_readings.py")
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--f32-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--out", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from portbench import harness
    from portbench.tests import lm_faults

    cell = harness.resolve("dsv2_lite.train32k")
    op = harness.load_op(cell.pkg, cell.traffic["op"])
    device = torch.device(args.device)
    f32 = dict(cell.traffic, compute_dtype="float32", precision="high")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    out = open(args.out, "w")

    def emit(seed, variant, kept, want, secs):
        line = {"seed": seed, "variant": variant, "loss": kept["loss"],
                "call_s": secs, "digest": kept["digest"].tolist()}
        out.write(json.dumps(line) + "\n")
        out.flush()
        if want is not None:
            nums = op.numbers([kept], want, routed)
            print(json.dumps({"seed": seed, "variant": variant, **{
                n: (g / s if s else float("inf"))
                for n, (g, s) in sorted(nums.items())}}), flush=True)

    def timed(fn):
        t = time.perf_counter()
        kept = fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return kept, time.perf_counter() - t

    paths = None
    for seed in args.seeds:
        ctx = SimpleNamespace(seed=seed, device=device, mesh=None, rank=0,
                              world=1)
        case = op.Case(ctx, cell.cfg, cell.traffic)
        routed = case.routed()
        if paths is None:
            paths = ["/".join(p) for p in case.order]
            out.write(json.dumps({"paths": paths}) + "\n")
        routes, patches = {}, Patches()
        record_routes(torch, op.ref, patches, routes)
        want, secs = timed(lambda: case.reference(case.params))
        patches.undo()
        emit(seed, "reference", want, None, secs)
        variants = [("program", None), ("frozen", lambda p: freeze_routes(
            torch, p, routes))]
        if seed in args.fault_seeds:
            variants += [(f, lambda p, f=f: getattr(lm_faults, f)(p.setattr))
                         for f in FAULTS]
        for variant, plant in variants:
            p = Patches()
            if plant is not None:
                plant(p)
            try:
                kept, secs = timed(lambda: case.keep(case.call()))
            finally:
                p.undo()
            emit(seed, variant, kept, want, secs)
        if seed in args.control_seeds:
            kept, secs = timed(case.control)
            emit(seed, "control", kept, want, secs)
        case.release()
        del case
        torch.cuda.empty_cache()
        if seed in args.f32_seeds:
            case = op.Case(ctx, cell.cfg, f32)
            kept, secs = timed(lambda: case.keep(case.call()))
            emit(seed, "f32", kept, want, secs)
            case.release()
            del case
            torch.cuda.empty_cache()
    out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
